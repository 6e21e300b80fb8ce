"""Predictor (semi-implicit Euler), as `pdb_sph_tpu/ops/integrate.py`."""

from __future__ import annotations

import functools

import torch

from ..config import SimConfig
from .smoothing import f32


@functools.cache
def gravity_vector(gravity: float, device: torch.device) -> torch.Tensor:
    """(3,) float32 (0, gravity, 0) on `device`, made once per value and
    device: a tensor built from host values is a copy that, on a card,
    waits for the stream's queued work, so no step may build one."""
    return torch.tensor([0.0, gravity, 0.0], dtype=torch.float32,
                        device=device)


def predict(cfg: SimConfig, x: torch.Tensor, v: torch.Tensor):
    """Returns (p_predicted, v_predicted); callers keep x as last frame."""
    v1 = (v + f32(cfg.dt) * gravity_vector(cfg.gravity, x.device)) \
        * f32(cfg.velocity_damp)
    p = x + f32(cfg.dt) * v1
    return p, v1
