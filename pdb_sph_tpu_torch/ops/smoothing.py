"""SPH smoothing-kernel math shared by every backend of the port.

The torch counterpart of `pdb_sph_tpu/ops/smoothing.py`, operation for
operation: the same formulas in the same order, every constant rounded to
float32 where JAX rounds it (`f32`), so that the two agree to float32
rounding. Conventions: pairs with rd2 >= h^2 contribute zero; the self pair
is included in the density sum and contributes zero to both gradient sums.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig

# rd2 floor: keeps the self pair (rd2 == 0) finite through rsqrt
EPS = 1e-16


def f32(x: float) -> float:
    """x rounded to float32 (the port's `jnp.float32(x)`), as a Python float
    so that it multiplies a tensor of any device without a transfer."""
    return float(np.float32(x))


def pair_distance(rd2: torch.Tensor) -> torch.Tensor:
    """r as rd2 * rsqrt(rd2), zero-safe via a tiny clamp
    (pdb_sph_tpu/ops/smoothing.py:25-34)."""
    rd2 = torch.clamp_min(rd2, f32(EPS))
    return rd2 * torch.rsqrt(rd2)


def poly6(cfg: SimConfig, rd2: torch.Tensor) -> torch.Tensor:
    """W_poly6(r) = coeff * (h^2 - r^2)^3 for r < h, else 0."""
    t = torch.clamp_min(cfg.h2 - rd2, 0.0)
    return f32(cfg.poly6_coeff) * t * t * t


def density_terms(cfg: SimConfig, rd2: torch.Tensor, mask: torch.Tensor):
    """Per-pair (W_poly6, |grad C|^2) terms, zero where `mask` is False."""
    rd2 = torch.where(mask, rd2, torch.full_like(rd2, cfg.h2))
    t = cfg.h2 - rd2
    w = f32(cfg.poly6_coeff) * t * t * t
    rd = pair_distance(rd2)
    a = f32(cfg.lambda_grad_coeff) * (cfg.h - rd) * (cfg.h - rd)
    g2 = a * a * rd2
    zero = torch.zeros_like(rd2)
    return torch.where(mask, w, zero), torch.where(mask, g2, zero)


def lambda_from_sums(cfg: SimConfig, rho: torch.Tensor,
                     sum_grad2: torch.Tensor) -> torch.Tensor:
    """lambda_i = -C_i / (sum|grad C|^2 + eps), C_i = rho/rho0 - 1."""
    c = rho * f32(cfg.inv_rho0) - 1.0
    return -c / (sum_grad2 + f32(cfg.relaxation_eps))


def delta_p_scale(cfg: SimConfig, rd2: torch.Tensor, lam_i: torch.Tensor,
                  lam_j: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scalar s with the pair's position correction s * (p_i - p_j)."""
    rd2 = torch.where(mask, rd2, torch.full_like(rd2, cfg.h2))
    rd = pair_distance(rd2)
    k = f32(-cfg.spiky_grad_coeff * cfg.inv_rho0)
    s = k * (cfg.h - rd) * (cfg.h - rd) * (lam_i + lam_j + f32(cfg.s_corr))
    return torch.where(mask, s, torch.zeros_like(s))
