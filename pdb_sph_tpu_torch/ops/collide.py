"""Finalize: velocity update and the ordered 6-wall collision response.

The torch counterpart of `pdb_sph_tpu/ops/collide.py`, which documents the
semantics: the reference's sequential wall order (each wall reads what the
previous one wrote), a bounce only on outward velocity and a final clamp,
or with `strict_reference_collide` the reference's `v != 0` test and no
clamp.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from .smoothing import f32

# (axis, is_upper) in the reference's order (src/FluidSimulator.cu:362-439)
_WALL_ORDER = ((1, False), (1, True), (0, False), (2, False), (0, True),
               (2, True))


def _bounce(cfg: SimConfig, pos, vel, axis: int, upper: bool):
    w = f32(cfg.wall if upper else 0.0)
    cd = f32(cfg.collision_damp)
    pa, va = pos[:, axis], vel[:, axis]
    if cfg.strict_reference_collide:
        hit = (pa > w if upper else pa < w) & (va != 0.0)
    else:
        hit = (pa > w) & (va > 0.0) if upper else (pa < w) & (va < 0.0)

    t_coll = (pa - w) / torch.where(va == 0.0, torch.ones_like(va), va)
    pos_rw = pos - vel * (f32(1.0 - cd) * t_coll)[:, None]
    pos_rw[:, axis] = 2.0 * w - pos_rw[:, axis]
    vel_rf = vel.clone()
    vel_rf[:, axis] = vel_rf[:, axis] * -1.0
    vel_rf = vel_rf * cd

    pos = torch.where(hit[:, None], pos_rw, pos)
    vel = torch.where(hit[:, None], vel_rf, vel)
    return pos, vel


def finalize(cfg: SimConfig, p: torch.Tensor, last_frame: torch.Tensor):
    """v = (p - last_frame)/dt, then the 6 sequential wall responses.

    Returns new tensors (x_new, v_new); `p` and `last_frame` are not
    written, so they may be views of reused buffers."""
    v = (p - last_frame) / f32(cfg.dt)
    for axis, upper in _WALL_ORDER:
        p, v = _bounce(cfg, p, v, axis, upper)
    if not cfg.strict_reference_collide:
        p = torch.clamp(p, 0.0, f32(cfg.wall))
    return p, v
