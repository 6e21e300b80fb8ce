"""Particle state of the PyTorch port.

As in `pdb_sph_tpu.state`, slot i of the arrays refers to different
particles from step to step (the state comes back cell-sorted); `ids`
carries each particle's spawn index through every permutation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SimState(NamedTuple):
    """All tensors on one device; float32 / int32."""

    x: torch.Tensor     # (n, 3) positions
    v: torch.Tensor     # (n, 3) velocities
    ids: torch.Tensor   # (n,)   spawn index
    step: torch.Tensor  # ()     step counter


class StepDiagnostics(NamedTuple):
    """Observability of one state (`core.step.diagnostics_fn`): 0-dim
    tensors on the state's device, the fields of
    `pdb_sph_tpu.state.StepDiagnostics` in its order."""

    mean_density: torch.Tensor     # () mean SPH density
    max_density_err: torch.Tensor  # () max |rho/rho0 - 1|
    max_speed: torch.Tensor        # () max |v|
    n_escaped: torch.Tensor        # () int32, outside [-0.25, wall + 0.25]^3
    n_overflow: torch.Tensor       # () int32, neighbour-table drops (always 0)
    plan_overflow: torch.Tensor    # () int32, window-plan truncations (0)
    nan_detected: torch.Tensor     # () bool, any non-finite x or v


def make_state(x: torch.Tensor, v: torch.Tensor | None = None) -> SimState:
    """State at rest (v = 0 unless given) with ids 0..n-1, on x's device."""
    n = x.shape[0]
    x = x.to(torch.float32)
    v = torch.zeros_like(x) if v is None else v.to(x.device, torch.float32)
    return SimState(
        x=x,
        v=v,
        ids=torch.arange(n, dtype=torch.int32, device=x.device),
        step=torch.zeros((), dtype=torch.int32, device=x.device),
    )
