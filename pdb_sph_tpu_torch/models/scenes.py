"""Named scenes (initial conditions) of the port.

The same three scenes as `pdb_sph_tpu/models/scenes.py`, box-relative in
the same way, drawn from a seeded `torch.Generator` on the CPU and then
moved to `device`, so a seed gives the same particles on every device.
`torch` and `jax.random` give different numbers for one seed: the two
packages agree in distribution, not bit for bit.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..state import SimState, make_state


def standard(cfg: SimConfig, gen: torch.Generator) -> torch.Tensor:
    """Uniform random in the cube [0, wall/2)^3."""
    return torch.rand((cfg.n, 3), generator=gen) * (0.5 * cfg.wall)


def dam_break(cfg: SimConfig, gen: torch.Generator) -> torch.Tensor:
    """A column [0, wall/4] x [0, wall] x [0, wall/2] against the x=0 wall."""
    u = torch.rand((cfg.n, 3), generator=gen)
    w = cfg.wall
    return u * torch.tensor([0.25 * w, w, 0.5 * w], dtype=torch.float32)


def blowup(cfg: SimConfig, gen: torch.Generator) -> torch.Tensor:
    """Uniform in a wall/4-radius ball at the box centre (~15x rest
    density at the reference's number density)."""
    d = torch.randn((cfg.n, 3), generator=gen)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    r = 0.25 * cfg.wall * torch.rand((cfg.n, 1), generator=gen) ** (1.0 / 3.0)
    return 0.5 * cfg.wall + d * r


SCENE_FNS = {
    "standard": standard,
    "dam_break": dam_break,
    "blowup": blowup,
}


def spawn(cfg: SimConfig, scene: str, seed: int = 0,
          device: torch.device | str = "cpu") -> SimState:
    if scene not in SCENE_FNS:
        raise ValueError(f"unknown scene {scene!r}; have {sorted(SCENE_FNS)}")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = SCENE_FNS[scene](cfg, gen).to(torch.float32)
    return make_state(x.to(device))
