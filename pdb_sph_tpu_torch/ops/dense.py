"""Dense O(n^2) all-pairs PBF step: the parity oracle.

The torch counterpart of `pdb_sph_tpu/ops/dense.py`. It is also the port's
own oracle on the card, where the JAX package is not available. Usable only
at small n (a few thousand).
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from . import smoothing
from .collide import finalize
from .integrate import predict


def _pair_rd2(p: torch.Tensor):
    d = p[:, None, :] - p[None, :, :]
    return torch.sum(d * d, dim=-1), d


def density_lambda_dense(cfg: SimConfig, p: torch.Tensor) -> torch.Tensor:
    """All-pairs lambda (src/FluidSimulator.cu:222-284)."""
    rd2, _ = _pair_rd2(p)
    mask = rd2 < smoothing.f32(cfg.h2)
    w, g2 = smoothing.density_terms(cfg, rd2, mask)
    return smoothing.lambda_from_sums(cfg, w.sum(dim=1), g2.sum(dim=1))


def density_dense(cfg: SimConfig, p: torch.Tensor) -> torch.Tensor:
    """All-pairs rho."""
    rd2, _ = _pair_rd2(p)
    mask = rd2 < smoothing.f32(cfg.h2)
    w, _ = smoothing.density_terms(cfg, rd2, mask)
    return w.sum(dim=1)


def project_dense(cfg: SimConfig, p: torch.Tensor,
                  lam: torch.Tensor) -> torch.Tensor:
    """All-pairs delta_p (src/FluidSimulator.cu:286-343)."""
    rd2, d = _pair_rd2(p)
    mask = rd2 < smoothing.f32(cfg.h2)
    s = smoothing.delta_p_scale(cfg, rd2, lam[:, None], lam[None, :], mask)
    return torch.sum(s[:, :, None] * d, dim=1)


def solve_dense(cfg: SimConfig, p: torch.Tensor) -> torch.Tensor:
    """The solver_iters-iteration Jacobi constraint loop."""
    for _ in range(cfg.solver_iters):
        lam = density_lambda_dense(cfg, p)
        p = p + project_dense(cfg, p, lam)
    return p


def step_dense(cfg: SimConfig, x: torch.Tensor, v: torch.Tensor):
    """One full step: predict -> solve -> finalize, order kept."""
    p, _ = predict(cfg, x, v)
    p = solve_dense(cfg, p)
    return finalize(cfg, p, last_frame=x)
