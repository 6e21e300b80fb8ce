"""Predictor (semi-implicit Euler), as `pdb_sph_tpu/ops/integrate.py`."""

from __future__ import annotations

import torch

from ..config import SimConfig
from .smoothing import f32


def predict(cfg: SimConfig, x: torch.Tensor, v: torch.Tensor):
    """Returns (p_predicted, v_predicted); callers keep x as last frame."""
    g = torch.tensor([0.0, cfg.gravity, 0.0], dtype=torch.float32,
                     device=x.device)
    v1 = (v + f32(cfg.dt) * g) * f32(cfg.velocity_damp)
    p = x + f32(cfg.dt) * v1
    return p, v1
