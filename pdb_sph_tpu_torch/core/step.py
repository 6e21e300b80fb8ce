"""The step and the rollout of the port.

One step of the `window` backend (the counterpart of the JAX package's
`pallas` backend, pdb_sph_tpu/core/step.py:46-127):

    predict -> cell ids                       ops.integrate, ops.hashgrid
    stable sort by cell id, gather p, x, ids  ops.hashgrid.sort_by_cell
    candidate-window plan                     ops.cuda_pbf.build_plan
    solver_iters x (density -> project)       ops.cuda_pbf.solve
    finalize with the 6-wall collision        ops.collide.finalize

`cell` solves over the cell table instead (ops.hashgrid.build_grid,
ops.cell_list.solve_cell_list, plain torch, the JAX package's `cell`
backend): the table has a capacity, and the particles it drops keep their
predicted position and are counted in the stats' table_overflow. `dense`
runs the all-pairs oracle. As in the reference, the state
comes back cell-sorted; `ids` carries each particle's spawn index.
`diagnostics_fn` measures a state (density, speed, escapes, NaN) for the
runner's metrics.

A `Stepper` holds the config, the device (the card unless the caller asks
for the CPU), and what the solve reuses from step to step: the two
ping-pong buffers, the pair kernels' scratch, and the step's constant
tensors (`make_constants`), all made when it is built. A step of any
backend then reads nothing back from the card and copies nothing from the
host: every shape follows from the config, and every choice that depends
on the data is made on the device. `chip_smoke.py` holds it to that on the
card by running steps under `torch.cuda.set_sync_debug_mode("error")`.

So a `Rollout` on a card runs every backend as a CUDA graph, the
counterpart of the JAX rollout's jitted scan on every backend: its first
call captures one step (`CapturedStep`, whose body is `step_into`), and
every call replays it once a step. On the CPU a Rollout is a Python loop
over `Stepper.step`. Either way it sums the per-step stats vector
[table_overflow, plan_overflow, nonfinite] on the device.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch

from ..config import SimConfig
from ..ops import cell_list, cuda_pbf, dense, hashgrid
from ..ops.collide import finalize
from ..ops.integrate import gravity_vector, predict
from ..ops.smoothing import f32
from ..state import SimState, StepDiagnostics
from ..utils.platform import resolve_device

BACKENDS = ("window", "cell", "dense", "auto")

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
    [table_overflow, plan_overflow, nonfinite]: the cell table's drops on
    the `cell` backend; the window plan has no capacity, so plan_overflow
    is 0. `mark(name)`, if given, is
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

    if backend == "cell":
        sorted_cid, order = hashgrid.sort_by_cell(cfg, cid)
    else:
        sorted_cid, order = sort_cells(cfg, cid)
    p_s, last_s, ids_s = p[order], state.x[order], state.ids[order]
    mark("sort+gather")

    if backend == "cell":
        grid = hashgrid.build_grid(cfg, sorted_cid, order)
        overflow = torch.stack([grid.n_overflow, zero2[0]])
        p_solved = cell_list.solve_cell_list(cfg, p_s, grid)
        mark("solve")
    else:
        plan = cuda_pbf.build_plan(cfg, sorted_cid)
        overflow = torch.stack([zero2[0], plan.n_overflow])
        mark("plan")
        p_solved = cuda_pbf.solve(cfg, p_s, plan, bufs, mark, scratch)
    x, v = finalize(cfg, p_solved, last_s)
    mark("finalize")

    out = SimState(x=x, v=v, ids=ids_s, step=state.step + 1)
    return (out, _stats(overflow, x, v)) if with_stats else out


def diagnostics_fn(cfg: SimConfig, state: SimState,
                   scratch: cuda_pbf.PairScratch | None = None
                   ) -> StepDiagnostics:
    """Observability of the current state (pdb_sph_tpu/core/step.py:130-176),
    every field a 0-dim tensor on the state's device.

    The JAX package measures rho in plain XLA over a cell table with a
    capacity and masks the particles that table dropped. Here rho comes
    from the density kernel's rho output over the window plan of the
    state's own cell sort, which has no capacity: no particle is left out,
    and n_overflow is 0. Only a particle with a non-finite position, whose
    rho means nothing, is left out of the density fields. The sorted
    positions and rho live in buffers of their own, so a Stepper's
    ping-pong buffers are never touched; its pair-kernel scratch may be
    passed as `scratch` (else the kernel's wrapper allocates one).
    """
    x, n = state.x, state.x.shape[0]
    sorted_cid, order = sort_cells(cfg, hashgrid.cell_ids(cfg, x))
    plan = cuda_pbf.build_plan(cfg, sorted_cid)
    p4 = torch.zeros((sorted_cid.shape[0], 4), dtype=torch.float32,
                     device=x.device)
    p4[:n, :3] = x[order]
    rho = cuda_pbf.density_rho(cfg, p4, plan, n, scratch=scratch)[:n, 3]

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


def make_constants(cfg: SimConfig, device: torch.device) -> None:
    """Make the step's constant tensors on `device` now (each is kept per
    value and device: `ops.integrate.gravity_vector`,
    `ops.cuda_pbf.window_offsets`), so that no step, plan or capture
    builds one from host values."""
    gravity_vector(cfg.gravity, device)
    cuda_pbf.window_offsets(cfg.nb_grid_width, device)


class Stepper:
    """SimState -> SimState for one config, backend and device."""

    def __init__(self, cfg: SimConfig, backend: str = "auto",
                 device: torch.device | str = "cuda"):
        cfg.validate()
        self.cfg = cfg
        self.backend = resolve_backend(backend)
        self.device = resolve_device(device)
        make_constants(cfg, self.device)
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

    def check(self, state: SimState) -> None:
        """Raise unless `state` has this config's size on this device."""
        if state.x.shape != (self.cfg.n, 3):
            raise ValueError(f"state has {tuple(state.x.shape)} positions, "
                             f"config n = {self.cfg.n}")
        if state.x.device != self.device:
            raise ValueError(f"state on {state.x.device}, stepper on "
                             f"{self.device}")

    def step(self, state: SimState, with_stats: bool = False,
             mark: Mark | None = None):
        self.check(state)
        return step_fn(self.cfg, self.backend, state, self.bufs,
                       with_stats=with_stats, mark=mark,
                       scratch=self.scratch)

    def __call__(self, state: SimState) -> SimState:
        return self.step(state)


def step_into(stepper: Stepper, state: Sequence[torch.Tensor],
              acc: Sequence[torch.Tensor]) -> None:
    """One step of `stepper` that writes the next state back into the
    tensors of `state` (x, v, ids, step) and adds its stats into acc[0]:
    the body that a Rollout captures."""
    out, stats = stepper.step(SimState(*state), with_stats=True)
    for dst, src in zip(state, out):
        dst.copy_(src)
    acc[0].add_(stats)


class CapturedStep:
    """A step captured once as a CUDA graph, then replayed once a step.

    `body(state, acc)` runs one step: it reads the tensors of `state`,
    writes the next state back into them with `copy_`, and adds what it
    measures into the tensors of `acc` (`step_into` is one). Built from a
    first state and zero accumulators, this clones them into the graph's
    static tensors, runs the body once eagerly on other copies and throws
    the result away (the warm-up: it builds the kernels and fixes each pair
    kernel's persistent grid; its launches are real and count), then
    captures the body on `torch.cuda.graph`'s side stream. Whatever else
    the body reads (a Stepper's buffers and scratch, the constants) keeps
    its address for the graph's lifetime, which `release` ends. A failed
    capture or replay raises: nothing falls back to running the body
    eagerly."""

    def __init__(self, body: Callable, state: Sequence[torch.Tensor],
                 acc: Sequence[torch.Tensor]):
        body(tuple(t.clone() for t in state), tuple(t.clone() for t in acc))
        self.state = tuple(t.clone() for t in state)
        self.acc = tuple(t.clone() for t in acc)
        self.graph = torch.cuda.CUDAGraph()
        with cuda_pbf.captured_launches() as self.launches:
            with torch.cuda.graph(self.graph):
                body(self.state, self.acc)

    def __call__(self, state: Sequence[torch.Tensor], steps: int):
        """`steps` steps from `state`, whose tensors are copied in and never
        written: (clones of the final state's tensors, clones of the
        accumulators, zeroed first)."""
        for a in self.acc:
            a.zero_()
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        for _ in range(steps):
            self.graph.replay()
        cuda_pbf.add_replays(self.launches, steps)
        return (tuple(t.clone() for t in self.state),
                tuple(t.clone() for t in self.acc))

    def release(self) -> None:
        """Free the graph, and with it its memory pool, and the static
        tensors; the step cannot replay afterwards."""
        self.graph.reset()
        self.state = self.acc = ()


class Rollout:
    """`unroll_steps` steps per call, or `steps` (a final partial chunk
    runs on the same buffers and graph); with stats, returns (state, stats
    summed over the steps). The caller's state is never written, and what
    comes back aliases none of the rollout's tensors.

    On a card, every backend runs as a CUDA graph (`CapturedStep`,
    captured at the first call; the cell step's tables live in the graph's
    memory pool); on the CPU the steps run as a Python loop over
    `Stepper.step`."""

    def __init__(self, cfg: SimConfig, backend: str = "auto",
                 unroll_steps: int = 1, with_stats: bool = False,
                 device: torch.device | str = "cuda"):
        if unroll_steps < 1:
            raise ValueError(f"unroll_steps must be >= 1, got {unroll_steps}")
        self.stepper = Stepper(cfg, backend, device)
        self.unroll_steps = unroll_steps
        self.with_stats = with_stats
        self.graphed = self.stepper.device.type == "cuda"
        self.captured: CapturedStep | None = None

    def __call__(self, state: SimState, steps: int | None = None):
        steps = self.unroll_steps if steps is None else steps
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        self.stepper.check(state)
        total = torch.zeros((3,), dtype=torch.int32,
                            device=self.stepper.device)
        if self.graphed:
            if self.captured is None:
                self.captured = CapturedStep(
                    functools.partial(step_into, self.stepper), state,
                    (total,))
            out, (total,) = self.captured(state, steps)
            state = SimState(*out)
        else:
            for _ in range(steps):
                state, stats = self.stepper.step(state, with_stats=True)
                total += stats
        return (state, total) if self.with_stats else state


def make_step(cfg: SimConfig, backend: str = "auto",
              device: torch.device | str = "cuda") -> Stepper:
    return Stepper(cfg, backend, device)


def make_rollout(cfg: SimConfig, backend: str = "auto", unroll_steps: int = 1,
                 with_stats: bool = False,
                 device: torch.device | str = "cuda") -> Rollout:
    return Rollout(cfg, backend, unroll_steps, with_stats, device)
