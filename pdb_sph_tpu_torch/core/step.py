"""The step and the rollout of the port.

One step of the `window` backend (the counterpart of the JAX package's
`pallas` backend, pdb_sph_tpu/core/step.py:46-127):

    predict -> cell ids                       ops.integrate, ops.hashgrid
    stable sort by cell id, gather p, x, ids  ops.hashgrid.sort_by_cell
    candidate-window plan                     ops.cuda_pbf.build_plan
    solver_iters x (density -> project)       ops.cuda_pbf.solve
    finalize with the 6-wall collision        ops.collide.finalize

`dense` runs the all-pairs oracle instead. As in the reference, the state
comes back cell-sorted; `ids` carries each particle's spawn index.
`diagnostics_fn` measures a state (density, speed, escapes, NaN) for the
runner's metrics.

A `Stepper` holds the config, the device (the card unless the caller asks
for the CPU), and what the solve reuses from step to step: the two
ping-pong buffers and the pair kernels' scratch. A `Rollout` runs many
steps as a Python loop with no host synchronisation inside it, summing the
per-step stats vector [table_overflow, plan_overflow, nonfinite] on the device.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import SimConfig
from ..ops import cuda_pbf, dense, hashgrid
from ..ops.collide import finalize
from ..ops.integrate import predict
from ..ops.smoothing import f32
from ..state import SimState, StepDiagnostics
from ..utils.platform import resolve_device

BACKENDS = ("window", "dense", "auto")

Mark = Callable[[str], None]


def resolve_backend(backend: str) -> str:
    """`auto` is the window backend, on the CPU and on the card alike."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    return "window" if backend == "auto" else backend


def _stats(overflow2: torch.Tensor, x: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    finite = torch.isfinite(x).all() & torch.isfinite(v).all()
    return torch.cat([overflow2, (~finite).to(torch.int32)[None]])


def sort_cells(cfg: SimConfig, cid: torch.Tensor):
    """(sorted_cid (n_pad,), order (n,) int64): the stable sort of n cell
    ids padded to whole own-chunks. Padding takes the id num_nb_cells and
    sorts after every real particle, so the first n entries of the order
    are exactly the real particles."""
    n = cid.shape[0]
    n_pad = cuda_pbf.pad_to_chunks(cfg, n)
    cid_pad = torch.cat([cid, cid.new_full((n_pad - n,), cfg.num_nb_cells)])
    sorted_cid, order = hashgrid.sort_by_cell(cfg, cid_pad)
    return sorted_cid, order[:n]


def step_fn(cfg: SimConfig, backend: str, state: SimState,
            bufs: tuple[torch.Tensor, torch.Tensor] | None = None,
            with_stats: bool = False, mark: Mark | None = None,
            scratch: cuda_pbf.PairScratch | None = None):
    """One step. with_stats=True also returns the (3,) int32 vector
    [table_overflow, plan_overflow, nonfinite] (both overflows are 0: no
    structure of the port has a capacity). `mark(name)`, if given, is
    called after each stage, for stage timing. `bufs` and `scratch` are
    the solve's (cuda_pbf.solve)."""
    backend = resolve_backend(backend)
    if mark is None:
        def mark(_name):
            return None
    zero2 = torch.zeros((2,), dtype=torch.int32, device=state.x.device)

    if backend == "dense":
        x, v = dense.step_dense(cfg, state.x, state.v)
        out = SimState(x=x, v=v, ids=state.ids, step=state.step + 1)
        return (out, _stats(zero2, x, v)) if with_stats else out

    p, _ = predict(cfg, state.x, state.v)
    cid = hashgrid.cell_ids(cfg, p)
    mark("predict+cell_ids")

    sorted_cid, order = sort_cells(cfg, cid)
    p_s, last_s, ids_s = p[order], state.x[order], state.ids[order]
    mark("sort+gather")

    plan = cuda_pbf.build_plan(cfg, sorted_cid)
    mark("plan")

    p_solved = cuda_pbf.solve(cfg, p_s, plan, bufs, mark, scratch)
    x, v = finalize(cfg, p_solved, last_s)
    mark("finalize")

    out = SimState(x=x, v=v, ids=ids_s, step=state.step + 1)
    if with_stats:
        overflow = torch.stack([zero2[0], plan.n_overflow])
        return out, _stats(overflow, x, v)
    return out


def diagnostics_fn(cfg: SimConfig, state: SimState) -> StepDiagnostics:
    """Observability of the current state (pdb_sph_tpu/core/step.py:130-176),
    every field a 0-dim tensor on the state's device.

    The JAX package measures rho in plain XLA over a cell table with a
    capacity and masks the particles that table dropped. Here rho comes
    from the density kernel's rho output over the window plan of the
    state's own cell sort, which has no capacity: no particle is left out,
    and n_overflow is 0. Only a particle with a non-finite position, whose
    rho means nothing, is left out of the density fields. The sorted
    positions and rho live in buffers of their own, so a Stepper's
    ping-pong buffers are never touched.
    """
    x, n = state.x, state.x.shape[0]
    sorted_cid, order = sort_cells(cfg, hashgrid.cell_ids(cfg, x))
    plan = cuda_pbf.build_plan(cfg, sorted_cid)
    p4 = torch.zeros((sorted_cid.shape[0], 4), dtype=torch.float32,
                     device=x.device)
    p4[:n, :3] = x[order]
    rho = cuda_pbf.density_rho(cfg, p4, plan, n)[:n, 3]

    measured = torch.isfinite(p4[:n, :3]).all(dim=1)
    zero = torch.zeros_like(rho)
    n_meas = measured.sum().clamp_min(1)
    err = (rho * f32(cfg.inv_rho0) - 1.0).abs()
    outside = (x < -0.25) | (x > cfg.wall + 0.25)
    finite = torch.isfinite(x).all() & torch.isfinite(state.v).all()
    return StepDiagnostics(
        mean_density=torch.where(measured, rho, zero).sum() / n_meas,
        max_density_err=torch.where(measured, err, zero).max(),
        max_speed=torch.linalg.vector_norm(state.v, dim=1).max(),
        n_escaped=outside.any(dim=1).sum().to(torch.int32),
        n_overflow=torch.zeros((), dtype=torch.int32, device=x.device),
        plan_overflow=plan.n_overflow,
        nan_detected=~finite,
    )


class Stepper:
    """SimState -> SimState for one config, backend and device."""

    def __init__(self, cfg: SimConfig, backend: str = "auto",
                 device: torch.device | str = "cuda"):
        cfg.validate()
        self.cfg = cfg
        self.backend = resolve_backend(backend)
        self.device = resolve_device(device)
        self.bufs = self.scratch = None
        if self.backend == "window":
            n_pad = cuda_pbf.pad_to_chunks(cfg, cfg.n)
            self.bufs = tuple(
                torch.zeros((n_pad, 4), dtype=torch.float32,
                            device=self.device) for _ in range(2))
            # only the card's kernels write a scratch
            if self.device.type == "cuda":
                self.scratch = cuda_pbf.alloc_scratch(cfg, n_pad,
                                                      self.device)

    def step(self, state: SimState, with_stats: bool = False,
             mark: Mark | None = None):
        if state.x.shape != (self.cfg.n, 3):
            raise ValueError(f"state has {tuple(state.x.shape)} positions, "
                             f"config n = {self.cfg.n}")
        if state.x.device != self.device:
            raise ValueError(f"state on {state.x.device}, stepper on "
                             f"{self.device}")
        return step_fn(self.cfg, self.backend, state, self.bufs,
                       with_stats=with_stats, mark=mark,
                       scratch=self.scratch)

    def __call__(self, state: SimState) -> SimState:
        return self.step(state)


class Rollout:
    """`unroll_steps` steps per call, queued without a host sync; with
    stats, returns (state, stats summed over the steps)."""

    def __init__(self, cfg: SimConfig, backend: str = "auto",
                 unroll_steps: int = 1, with_stats: bool = False,
                 device: torch.device | str = "cuda"):
        if unroll_steps < 1:
            raise ValueError(f"unroll_steps must be >= 1, got {unroll_steps}")
        self.stepper = Stepper(cfg, backend, device)
        self.unroll_steps = unroll_steps
        self.with_stats = with_stats

    def __call__(self, state: SimState):
        if not self.with_stats:
            for _ in range(self.unroll_steps):
                state = self.stepper.step(state)
            return state
        total = torch.zeros((3,), dtype=torch.int32,
                            device=self.stepper.device)
        for _ in range(self.unroll_steps):
            state, stats = self.stepper.step(state, with_stats=True)
            total += stats
        return state, total


def make_step(cfg: SimConfig, backend: str = "auto",
              device: torch.device | str = "cuda") -> Stepper:
    return Stepper(cfg, backend, device)


def make_rollout(cfg: SimConfig, backend: str = "auto", unroll_steps: int = 1,
                 with_stats: bool = False,
                 device: torch.device | str = "cuda") -> Rollout:
    return Rollout(cfg, backend, unroll_steps, with_stats, device)
