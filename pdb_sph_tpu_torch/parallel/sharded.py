"""Multi-device scale-out: the load-balanced sub-row (zx-key) domain
decomposition of `pdb_sph_tpu/parallel/sharded.py`, on torch.distributed.

The hash grid is cut along the lexicographic (z-row, x-cell) key
key = z_cell * W + x_cell, rank d owning keys [b_d, b_{d+1}). Each rank
runs the same program on its own slab (there is no SPMD compiler: one
process a rank, the collectives of `comm.Group` in place of the mesh's):

    boundary update   all_gather of per-rank loads, one move per boundary
    predict, then     migration (two shifts a hop, D - 1 hops: what is
                      bound farther goes on through the ranks between)
    local sort        of own particles and their ghosts, frozen for the step
    solver_iters x    ghost exchange (two shifts), density, project
    finalize locally

Everything the JAX module decides on the host (`ParallelConfig`, the
initial bounds, the capacities) is numpy, copied so that both packages
size every buffer identically. Every buffer has a fixed capacity with a
validity flag, and every cut is counted in the stats vector
[active, migration_overflow, merge_overflow, ghost_overflow,
plan_or_table_overflow]; no step reads a value back to the host.

Backends: `window` runs the port's pair kernels on each rank (the JAX
`pallas` backend, with the passes restricted per chunk: `restrict_plan`),
`cell` the cell table (`ops/cell_list.py`). A one-rank run has no group
and, on the window backend, takes the fast path `_step_single`, which is
`core.step.step_fn` itself plus the active-slot masks; on a card its
ShardedRollout runs its step, on either backend, as a CUDA graph, as
`core.step.Rollout` does. So does a ShardedRollout of several NCCL ranks,
one card each, on either backend: the step's collectives (one
all_gather of the loads, two shifts a migration hop, D - 1 hops, two of
the ghosts per solver iteration: 2 D + 5, nine at D = 2, thirteen at
D = 4) are captured with it and meet at every replay,
since every rank replays the same number of steps. gloo ranks stay
eager: gloo stages every collective through host memory, which waits for
the card.

Two tiers size the buffers, as in JAX (sharded.py:244-292): the spawn
tier (`ParallelConfig.create`, slack for the collapse to come) and, once
the fluid settles, the compact tier (`ParallelConfig.compact`, 1.1x the
current state's occupancy). A run moves between them by collect ->
`ParallelConfig` -> distribute and a new rollout, whose graph is captured
anew; `ShardedRollout.release` frees the old tier's graph, buffers and
scratch first (`launch.rollout_ranks(retier=)`, the runner's
`--retier-at` and its fallback). From one state the two tiers hold the
same particles in the same slots and sort them to the same valid prefix:
only the padding after it differs, which no window reaches, so their steps
agree bit for bit as long as the move rule makes the same moves (it reads
one capacity: no strip over the tier's mig_capacity is donated).

Deliberate differences from the JAX module: the move rule
(`_move_bounds`) donates no strip whose population exceeds `mig_capacity`,
so a balance move cannot overflow the migration buffer (an ADVICE fault),
and it has no recipient limit, where JAX keeps the recipient under
capacity - capacity / 8, which stops the boundaries of the compact tier;
and the migration (`_migrate`) takes a particle bound several ranks
away all the way within the step, where JAX takes it one rank, counts an
overflow and leaves it off its slab for the step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import SimConfig
from ..core.step import CapturedStep, make_constants, sort_cells
from ..ops import cell_list, cuda_pbf, hashgrid
from ..ops.collide import finalize
from ..ops.integrate import predict
from ..ops.smoothing import f32
from ..state import SimState
from ..utils.platform import resolve_device
from .comm import Group

SENTINEL = 1.0e9
BACKENDS = ("window", "cell")


class ShardedState(NamedTuple):
    """One rank's share of the simulation state.

    x, v: (cap, 3) float32; inactive slots hold SENTINEL / 0.
    ids: (cap,) int32 spawn index; -1 marks an inactive slot.
    bounds: (D + 2,) int32 [step_counter, b_0, ..., b_D], the same on every
        rank: the slab boundaries in zx-key units (b_0 = 0, b_D = W * W);
        the counter drives the parity-alternating boundary moves.
    """

    x: torch.Tensor
    v: torch.Tensor
    ids: torch.Tensor
    bounds: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Capacities of the sharded layout, all per rank
    (pdb_sph_tpu/parallel/sharded.py:109-292, numerically identical)."""

    n_devices: int
    capacity: int          # local particle slots
    mig_capacity: int      # per-direction migration slots
    ghost_capacity: int    # per-direction ghost slots
    rebalance: bool = True  # occupancy-tracking boundary moves each step
    ghost_rows: int = 2    # z-rows of the ghost band per side (1 needs
                           # nb_cell >= 2h)
    z_cells_hi: int = 0    # even-split z range when not rebalancing

    @staticmethod
    def create(cfg: SimConfig, n_devices: int, slack: float = 1.6,
               state: SimState | None = None, rebalance: bool = True,
               ghost_slack: float = 2.5, mig_slack: float = 3.0,
               ghost_rows: int = 2, occ_slack: float = 1.5):
        """Size the per-rank buffers: capacity from n * slack / D, floored
        at occ_slack x the worst slab of the initial split of `state`;
        ghost and migration slots from the state's boundary-band and
        one-row populations (or capacity and capacity / 2 without one).
        One rank gets the plain path's size (n rounded up to 128)."""
        if n_devices == 1:
            cap = int(np.ceil(cfg.n / 128) * 128)
            return ParallelConfig(
                n_devices=1, capacity=cap, mig_capacity=128,
                ghost_capacity=128, rebalance=False, z_cells_hi=0,
                ghost_rows=ghost_rows)
        cap = int(np.ceil(cfg.n * slack / n_devices / 128) * 128)
        w = cfg.nb_grid_width
        z_hi = min(w, int(np.ceil((cfg.wall * 1.25) / cfg.nb_cell)))
        ghost_cap = mig_cap = None
        if state is not None:
            b = initial_bounds(cfg, n_devices, state=state,
                               rebalance=rebalance, z_cells_hi=z_hi)
            key = _np_zxkey(cfg, _host(state.x))
            dest = np.searchsorted(b[1:-1], key, side="right")
            occ_max = int(np.bincount(dest, minlength=n_devices).max())
            cap = max(cap, int(np.ceil(occ_max * occ_slack / 128) * 128))
            lo, hi = b[dest], b[dest + 1]

            def worst(band):
                return max(
                    int(np.bincount(dest[key < lo + band],
                                    minlength=n_devices).max(initial=0)),
                    int(np.bincount(dest[key >= hi - band],
                                    minlength=n_devices).max(initial=0)))

            def round_up(x, lo_clip, hi_clip):
                return int(min(max(-(-int(np.ceil(x)) // 128) * 128,
                                   lo_clip), hi_clip))

            ghost_cap = round_up(ghost_slack * worst(ghost_rows * w + 2),
                                 256, cap)
            mig_cap = round_up(mig_slack * worst(w), 256, cap)
        return ParallelConfig(
            n_devices=n_devices,
            capacity=cap,
            mig_capacity=(mig_cap if mig_cap is not None
                          else max(128, -(-(cap // 2) // 128) * 128)),
            ghost_capacity=ghost_cap if ghost_cap is not None else cap,
            rebalance=rebalance,
            z_cells_hi=z_hi,
            ghost_rows=ghost_rows)

    @staticmethod
    def compact(cfg: SimConfig, n_devices: int, state: SimState,
                occ_slack: float = 1.1, ghost_slack: float = 1.1,
                mig_slack: float = 2.0, ghost_rows: int = 2,
                prior: "ParallelConfig | None" = None):
        """The settled tier: every buffer re-sized from the current state
        with tight slacks; `prior` carries its rebalance and ghost_rows."""
        if state is None:
            raise ValueError("the compact tier sizes from the current "
                             "state; pass state=")
        rebalance = prior.rebalance if prior is not None else True
        if prior is not None:
            ghost_rows = prior.ghost_rows
        return ParallelConfig.create(
            cfg, n_devices, slack=1.0, state=state, ghost_slack=ghost_slack,
            mig_slack=mig_slack, ghost_rows=ghost_rows, occ_slack=occ_slack,
            rebalance=rebalance)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _min_slab_keys(cfg: SimConfig) -> int:
    """Minimum slab width in zx-keys: 2 z-rows + 2 cells, so ghosts and
    migrants only ever come from the adjacent rank."""
    return 2 * cfg.nb_grid_width + 2


def _ghost_band_keys(cfg: SimConfig, ghost_rows: int) -> int:
    """Ghost-band depth in keys per side: ghost_rows z-rows plus a 2-key
    margin for the x-split corner of a boundary that cuts a row."""
    return ghost_rows * cfg.nb_grid_width + 2


def _validate_geometry(cfg: SimConfig, pcfg: ParallelConfig) -> None:
    """Refuse a decomposition that would break the exchange invariants
    (pdb_sph_tpu/parallel/sharded.py:314-351)."""
    D = pcfg.n_devices
    w = cfg.nb_grid_width
    if D > 1:
        z_range = w if pcfg.rebalance else (pcfg.z_cells_hi or w)
        if z_range * w < D * _min_slab_keys(cfg):
            raise ValueError(
                f"{D} slabs over {z_range} z-rows ({z_range * w} zx-keys) "
                f"leaves a slab under {_min_slab_keys(cfg)} keys (2 z-rows "
                "+ 2 cells); the boundary-band ghost exchange needs that "
                "minimum per slab (use fewer devices or a finer grid)")
    for name in ("capacity", "mig_capacity", "ghost_capacity"):
        val = getattr(pcfg, name)
        if val <= 0 or val % 128 != 0:
            raise ValueError(f"{name} ({val}) must be a positive multiple "
                             "of 128")
    if pcfg.ghost_rows not in (1, 2):
        raise ValueError(f"ghost_rows ({pcfg.ghost_rows}) must be 1 or 2")
    if pcfg.ghost_rows == 1 and cfg.nb_cell < 2 * cfg.h:
        raise ValueError(
            f"ghost_rows=1 (h-band mode) requires nb_cell >= 2h so one "
            f"boundary row covers every consumed lambda's h-neighborhood "
            f"(nb_cell={cfg.nb_cell}, h={cfg.h})")


def _np_zxkey(cfg: SimConfig, x: np.ndarray) -> np.ndarray:
    """Host-side zx-key (int64) of (n, 3) positions, clamped into the
    grid."""
    W = cfg.nb_grid_width
    cz = np.clip((x[:, 2] / cfg.nb_cell).astype(np.int64), 0, W - 1)
    cx = np.clip((x[:, 0] / cfg.nb_cell).astype(np.int64), 0, W - 1)
    return cz * W + cx


def initial_bounds(cfg: SimConfig, n_devices: int,
                   state: SimState | None = None, rebalance: bool = True,
                   z_cells_hi: int = 0) -> np.ndarray:
    """(D + 1,) int32 slab boundaries in zx-key units: with a state and
    rebalancing, the quantile split of the key histogram (exact to one
    x-cell) kept at the minimum slab width; otherwise an even split of
    [0, z_hi * W)."""
    D = n_devices
    W = cfg.nb_grid_width
    K = W * W
    if D == 1:
        return np.array([0, K], np.int32)
    min_w = _min_slab_keys(cfg)
    if state is None or not rebalance:
        k_hi = (z_cells_hi or W) * W
        b = np.array([-(-d * k_hi // D) for d in range(D)] + [K], np.int64)
        return b.astype(np.int32)
    key = _np_zxkey(cfg, _host(state.x))
    cum = np.cumsum(np.bincount(key, minlength=K))
    n = int(cum[-1])
    b = np.zeros(D + 1, np.int64)
    b[D] = K
    for d in range(1, D):
        cand = int(np.searchsorted(cum, n * d // D, side="left")) + 1
        lo = b[d - 1] + min_w
        hi = K - min_w * (D - d)
        b[d] = min(max(cand, lo), hi)
    return b.astype(np.int32)


# ---------------------------------------------------------------------------
# device side: one rank's step
# ---------------------------------------------------------------------------

def _zxkey(cfg: SimConfig, p: torch.Tensor) -> torch.Tensor:
    """Device-side zx-key of (n, 3) positions (see _np_zxkey); clamped
    before the integer conversion, as `hashgrid.cell_ids` is. The x and z
    columns are a strided view: an index list would be a tensor copied
    from the host at every step, which a CUDA graph cannot capture."""
    w = cfg.nb_grid_width
    xz = torch.nan_to_num(p[:, ::2] * f32(1.0 / cfg.nb_cell), nan=0.0)
    xz = xz.clamp_(0, w - 1).to(torch.int32)
    return xz[:, 1] * w + xz[:, 0]


def _pack_rows(mask: torch.Tensor, capacity: int):
    """(idx (capacity,) int64, ok (capacity,) bool, n_over () int32): the
    indices of up to `capacity` True slots, in input order, first; the
    validity of each packed slot; how many did not fit. Slots past the
    capacity scatter into one spare entry, which is sliced off."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    total = mask.sum()
    tgt = torch.where(mask & (pos < capacity), pos, capacity)
    idx = torch.zeros((capacity + 1,), dtype=torch.int64, device=mask.device)
    idx = idx.scatter_(0, tgt, torch.arange(n, device=mask.device))[:capacity]
    ok = torch.arange(capacity, device=mask.device) < total
    n_over = (total - capacity).clamp_(min=0).to(torch.int32)
    return idx, ok, n_over


def _inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """inv with inv[order[i]] = i: one scatter, not an argsort."""
    return torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))


def _move_scales(cfg: SimConfig) -> tuple[int, ...]:
    """Boundary-move strip widths in keys, coarse to fine: one z-row, a
    W // 8 sub-row strip, one key."""
    w = cfg.nb_grid_width
    scales = [w]
    if w // 8 > 1:
        scales.append(w // 8)
    scales.append(1)
    return tuple(scales)


def _move_bounds(cfg: SimConfig, pcfg: ParallelConfig, brow: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """The move rule of `_update_bounds` (sharded.py:465-515) as a pure
    function of the gathered populations g (D, 1 + 2 * scales): per rank
    its load, then the populations of its first and last strip at each
    scale. Boundary i moves toward the heavier side by the largest strip
    that keeps |L - R| non-increasing, with the donor at least the minimum
    width; even boundaries move on even steps. A strip of more than
    mig_capacity particles is not donated (it would overflow the migration
    buffer), and the next finer scale is tried instead.

    JAX also keeps the recipient under capacity - capacity / 8. The port
    has no recipient limit: 2 strip <= L - R gives R + strip <= L <=
    capacity, so a move never raises the larger load, and that margin
    guards nothing. On the compact tier, sized at 1.1x the worst slab, the
    margin lies under a balanced rank's load (0.9625x the worst slab): the
    boundaries stop, the loads drift with the flow, and a rank overflows
    its capacity (the merge drops particles)."""
    D = pcfg.n_devices
    min_w = _min_slab_keys(cfg)
    ctr, b = brow[0], brow[1:]
    c = g[:, 0]
    ii = torch.arange(1, D, device=g.device)
    L, R = c[ii - 1], c[ii]
    diff = L - R
    w_left = b[ii] - b[ii - 1]
    w_right = b[ii + 1] - b[ii]
    eligible = (ii % 2) == (ctr % 2)
    shift = torch.zeros((D - 1,), dtype=torch.int32, device=g.device)
    for k, s in enumerate(_move_scales(cfg)):
        down_rc = g[ii - 1, 2 + 2 * k]   # rank i-1's last strip, given down
        up_rc = g[ii, 1 + 2 * k]         # rank i's first strip, given up
        free = shift == 0
        can_down = (free & eligible & (diff > 0) & (2 * down_rc <= diff)
                    & (w_left >= min_w + s) & (down_rc <= pcfg.mig_capacity))
        can_up = (free & eligible & (diff < 0) & (2 * up_rc <= -diff)
                  & (w_right >= min_w + s) & (up_rc <= pcfg.mig_capacity))
        shift = torch.where(can_down, -s, torch.where(can_up, s, shift))
    b = b.clone()
    b[1:D] += shift.to(b.dtype)
    return torch.cat([(ctr + 1)[None], b])


def _strip_pops(cfg: SimConfig, brow: torch.Tensor, rank: int,
                active: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """(1 + 2 * scales,) int32: rank's load, then the populations of its
    first and last strip at each scale (one row of `_move_bounds`'s g)."""
    lo, hi = brow[1 + rank], brow[2 + rank]
    pops = [active.sum()]
    for s in _move_scales(cfg):
        pops.append((active & (key < lo + s)).sum())
        pops.append((active & (key >= hi - s)).sum())
    return torch.stack(pops).to(torch.int32)


def _update_bounds(cfg: SimConfig, pcfg: ParallelConfig, group: Group,
                   brow: torch.Tensor, active: torch.Tensor,
                   key: torch.Tensor) -> torch.Tensor:
    """Gather every rank's load and strip populations, then move."""
    g = group.all_gather(_strip_pops(cfg, brow, group.rank, active, key))
    return _move_bounds(cfg, pcfg, brow, g)


def chunk_keep(cfg: SimConfig, sorted_cid: torch.Tensor, lo, hi):
    """(keep_d, keep_p): the own-chunks the density pass needs (own keys
    plus one inner ghost ring, the key band [lo - W - 1, hi + W + 1)) and
    those the project pass needs (own keys), for a rank owning zx-keys
    [lo, hi) (sharded.py:617-630). A chunk that reaches into a band is
    kept whole."""
    w = cfg.nb_grid_width
    cid = sorted_cid.view(-1, cfg.geom.own).long()
    kc = (cid // (w * w)) * w + cid % w
    keep_d = ((kc >= lo - w - 1) & (kc < hi + w + 1)).any(dim=1)
    keep_p = ((kc >= lo) & (kc < hi)).any(dim=1)
    return keep_d, keep_p


def _local_set(cfg: SimConfig, p, active, ghosts, gok):
    """(positions, valid, cell ids) of a rank's particles followed by its
    ghosts; invalid slots take cell id num_nb_cells, which sorts after
    every real particle."""
    combined, ok = p, active
    if ghosts is not None:
        combined, ok = torch.cat([p, ghosts]), torch.cat([active, gok])
    cid = torch.where(ok, hashgrid.cell_ids(cfg, combined),
                      cfg.num_nb_cells)
    return combined, ok, cid


class _Work(NamedTuple):
    """What one rank's window solve reuses from step to step."""

    bufs: tuple[torch.Tensor, torch.Tensor]
    scratch: cuda_pbf.PairScratch | None


def _window_plans(cfg: SimConfig, cid, z_bounds):
    """(order, plan, plan_d, plan_p) of a rank's local set with cell ids
    `cid`: its stable cell sort (whose first entries are the valid slots,
    in input order, and whose tail the invalid ones, a padding that no
    window reaches), the window plan of the sorted ids, and that plan
    restricted for the density and the project pass (the plan itself
    without z_bounds)."""
    sorted_cid, order = sort_cells(cfg, cid)
    plan = plan_d = plan_p = cuda_pbf.build_plan(cfg, sorted_cid)
    if z_bounds is not None:
        keep_d, keep_p = chunk_keep(cfg, sorted_cid, *z_bounds)
        plan_d = cuda_pbf.restrict_plan(cfg, plan, keep_d)
        plan_p = cuda_pbf.restrict_plan(cfg, plan, keep_p)
    return order, plan, plan_d, plan_p


def _solve_window(cfg: SimConfig, cap: int, p, active, exchange, ghosts0,
                  gok0, z_bounds, work: _Work):
    """One rank's constraint solve on the pair kernels (the JAX
    `_solve_pallas`, sharded.py:567-664). The local set and its ghosts are
    sorted once; inactive slots take cell id num_nb_cells, so the plan never
    offers them as candidates, and their rows carry 0, never the sentinel.
    With z_bounds (lo, hi), the density pass runs on the chunks of own keys
    plus the inner ghost ring (plan_d), the project pass on own keys
    (plan_p). Each iteration takes fresh ghost positions into the frozen
    slots. Returns (p_solved, plan_overflow)."""
    combined, ok, cid = _local_set(cfg, p, active, ghosts0, gok0)
    n_loc = combined.shape[0]
    order, plan, plan_d, plan_p = _window_plans(cfg, cid, z_bounds)
    inv = _inverse_permutation(order)
    ok_s = ok[order][:, None]
    a, b = work.bufs
    for it in range(cfg.solver_iters):
        if it and exchange is not None:
            combined = torch.cat([p, exchange(p)[0]])
        elif it:
            combined = p
        p_s = torch.where(ok_s, combined[order], 0.0)
        a[:n_loc, :3] = p_s
        cuda_pbf.density_pass(cfg, a, plan_d, n_loc, out=b,
                              scratch=work.scratch)
        cuda_pbf.project_pass(cfg, b, plan_p, n_loc, out=a,
                              scratch=work.scratch)
        dp = (a[:n_loc, :3] - p_s)[inv][:cap]
        p = p + torch.where(active[:, None], dp, 0.0)
    return p, plan.n_overflow


def _solve_cell(cfg: SimConfig, cap: int, p, active, exchange, ghosts0,
                gok0):
    """One rank's constraint solve on the cell table (the JAX `_solve_cell`,
    sharded.py:518-564); inactive slots take cell id num_nb_cells and stay
    out of the table and its overflow count. Returns (p_solved,
    table_overflow)."""
    combined, _, cid = _local_set(cfg, p, active, ghosts0, gok0)
    sorted_cid, order = hashgrid.sort_by_cell(cfg, cid)
    inv = _inverse_permutation(order)
    grid = hashgrid.build_grid(cfg, sorted_cid, order,
                               ignore_cell=cfg.num_nb_cells)
    for it in range(cfg.solver_iters):
        if it and exchange is not None:
            combined = torch.cat([p, exchange(p)[0]])
        elif it:
            combined = p
        p_s = combined[order]
        tx, ty, tz = cell_list.position_tables(cfg, grid, p_s)
        tlam = cell_list.density_lambda_tables(cfg, tx, ty, tz, grid)
        dd = cell_list.project_tables(cfg, tx, ty, tz, tlam, grid)
        zeros = torch.zeros_like(p_s[:, 0])
        dp_s = torch.stack([hashgrid.gather_table(cfg, grid, d, zeros)
                            for d in dd], dim=1)
        p = p + torch.where(active[:, None], dp_s[inv][:cap], 0.0)
    return p, grid.n_overflow


def _diag(cfg: SimConfig, active, x_new, v_new) -> torch.Tensor:
    """(3,) float32 [max_speed, n_escaped, nan_detected] of one rank."""
    speed = torch.where(active, torch.linalg.vector_norm(v_new, dim=1), 0.0)
    out = active & ((x_new < -0.25) | (x_new > cfg.wall + 0.25)).any(dim=1)
    finite = (torch.isfinite(torch.where(active[:, None], x_new, 0.0)).all()
              & torch.isfinite(v_new).all())
    return torch.stack([speed.max(), out.sum().float(),
                        (~finite).float()])


def _step_single(cfg: SimConfig, pcfg: ParallelConfig, work: _Work, x, v,
                 ids, brow):
    """The one-rank window path (the JAX `_step_single_pallas`): the plain
    step's sort, plan, solve and finalize (core.step.step_fn), with
    inactive slots sorted last and carrying 0 into the kernels. With every
    slot active it is that step, bit for bit."""
    active = ids >= 0
    p, _ = predict(cfg, x, v)
    cid = torch.where(active, hashgrid.cell_ids(cfg, p), cfg.num_nb_cells)
    sorted_cid, order = sort_cells(cfg, cid)
    ids_s = ids[order]
    active_s = ids_s >= 0
    p_s = torch.where(active_s[:, None], p[order], 0.0)
    last_s = torch.where(active_s[:, None], x[order], 0.0)
    plan = cuda_pbf.build_plan(cfg, sorted_cid)
    p_solved = cuda_pbf.solve(cfg, p_s, plan, work.bufs,
                              scratch=work.scratch)
    x_new, v_new = finalize(cfg, p_solved, last_s)
    x_new = torch.where(active_s[:, None], x_new, SENTINEL)
    v_new = torch.where(active_s[:, None], v_new, 0.0)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    stats = torch.stack([active_s.sum().to(torch.int32), zero, zero, zero,
                         plan.n_overflow])
    return (x_new, v_new, ids_s, brow, stats,
            _diag(cfg, active_s, x_new, v_new))


def _ghost_masks(cfg: SimConfig, pcfg: ParallelConfig, group: Group, active,
                 key, lo, hi):
    """(left band, right band) of the active slots a rank ships to each
    neighbour; an edge rank ships nothing outward."""
    band = _ghost_band_keys(cfg, pcfg.ghost_rows)
    none = torch.zeros_like(active)
    left = active & (key < lo + band) if group.rank > 0 else none
    right = (active & (key >= hi - band) if group.rank < group.size - 1
             else none)
    return left, right


def _ghost_exchange(pcfg: ParallelConfig, group: Group, left, right):
    """exchange(p) -> (ghost positions (2 * ghost_capacity, 3), valid):
    the frozen ghost slots filled from p (what the left neighbour sends,
    then the right's), and the ghost overflow of the packing."""
    l_idx, l_ok, l_over = _pack_rows(left, pcfg.ghost_capacity)
    r_idx, r_ok, r_over = _pack_rows(right, pcfg.ghost_capacity)

    def exchange(p_now):
        def buf(idx, ok):
            return torch.cat([torch.where(ok[:, None], p_now[idx], SENTINEL),
                              ok[:, None].float()], dim=1)

        from_left = group.shift(buf(r_idx, r_ok), +1)
        from_right = group.shift(buf(l_idx, l_ok), -1)
        gp = torch.cat([from_left[:, :3], from_right[:, :3]])
        gok = torch.cat([from_left[:, 3], from_right[:, 3]]) > 0.5
        return torch.where(gok[:, None], gp, SENTINEL), gok

    return exchange, l_over + r_over


def _migrate(cfg: SimConfig, pcfg: ParallelConfig, group: Group, b, p, last,
             ids, active):
    """Send each particle whose predicted key left the slab to its owner
    and pack the stayers and arrivals into the capacity
    (sharded.py:772-827). A hop is one exchange with the adjacent ranks;
    after it the arrivals bound farther go on, D - 1 hops in all, so every
    particle reaches its owner within the step. Returns (p, last, ids,
    active, mig_overflow, merge_overflow); mig_overflow counts the
    particles a full migration buffer left behind.

    JAX sends one hop and counts every particle bound farther, which then
    spends the step off its slab. A step's travel is the solve's
    correction at the step before plus this step's motion: in a blowup at
    D = 8 (the soak's config) one particle in 250 steps crossed a slab of
    the minimum width that way, and the 1M blowup's first steps, at speeds
    near 100, cross two slabs at D = 4."""
    D, me = pcfg.n_devices, group.rank

    def dest_of(q):
        return (_zxkey(cfg, q)[:, None] >= b[None, 1:D]).sum(dim=1)

    dest, mig_over = dest_of(p), 0

    def send(rows, mask):
        q, lst, rid = rows
        idx, ok, over = _pack_rows(mask, pcfg.mig_capacity)
        ids_f = torch.where(ok, rid[idx], -1).view(torch.float32)
        buf = torch.cat([torch.where(ok[:, None], q[idx], SENTINEL),
                         torch.where(ok[:, None], lst[idx], SENTINEL),
                         ok[:, None].float(), ids_f[:, None]], dim=1)
        return buf, over

    def unpack(buf):
        ok = buf[:, 6] > 0.5
        bids = buf[:, 7].contiguous().view(torch.int32)
        return buf[:, 0:3], buf[:, 3:6], torch.where(ok, bids, -1), ok

    rows, ok, parts = (p, last, ids), active, []
    for hop in range(D - 1):
        if hop:   # the arrivals, some bound farther
            dest = dest_of(rows[0])
        left, right = ok & (dest < me), ok & (dest > me)
        stay = ok & ~left & ~right
        parts.append((torch.where(stay[:, None], rows[0], SENTINEL),
                      torch.where(stay[:, None], rows[1], SENTINEL),
                      torch.where(stay, rows[2], -1), stay))
        buf_l, over_l = send(rows, left)
        buf_r, over_r = send(rows, right)
        from_right = group.shift(buf_l, -1)   # their left-goers arrive here
        from_left = group.shift(buf_r, +1)
        mig_over = mig_over + over_l + over_r
        *rows, ok = (torch.cat(t) for t in zip(unpack(from_left),
                                                unpack(from_right)))
    parts.append((*rows, ok))   # the last hop's arrivals are home
    all_p, all_last, all_ids, all_ok = (torch.cat(t) for t in zip(*parts))
    idx, ok, merge_over = _pack_rows(all_ok, pcfg.capacity)
    return (torch.where(ok[:, None], all_p[idx], SENTINEL),
            torch.where(ok[:, None], all_last[idx], SENTINEL),
            torch.where(ok, all_ids[idx], -1), ok,
            mig_over, merge_over)


def _shard_step(cfg: SimConfig, pcfg: ParallelConfig, backend: str,
                group: Group | None, work: _Work | None, x, v, ids, brow):
    """One rank's step (the JAX `_shard_step`, sharded.py:738-911).
    Returns (x, v, ids, bounds, stats (5,) int32, diag (3,) float32)."""
    D, cap = pcfg.n_devices, pcfg.capacity
    if D == 1 and backend == "window":
        return _step_single(cfg, pcfg, work, x, v, ids, brow)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    active = ids >= 0
    if D > 1 and pcfg.rebalance:
        brow = _update_bounds(cfg, pcfg, group, brow, active,
                              _zxkey(cfg, x))
    b = brow[1:]

    p, _ = predict(cfg, x, v)
    p = torch.where(active[:, None], p, SENTINEL)
    last = torch.where(active[:, None], x, SENTINEL)

    exchange = ghosts0 = gok0 = z_bounds = None
    mig_over = merge_over = ghost_over = zero
    if D > 1:
        p, last, ids, active, mig_over, merge_over = _migrate(
            cfg, pcfg, group, b, p, last, ids, active)
        lo, hi = b[group.rank], b[group.rank + 1]
        left, right = _ghost_masks(cfg, pcfg, group, active,
                                   _zxkey(cfg, p), lo, hi)
        exchange, ghost_over = _ghost_exchange(pcfg, group, left, right)
        ghosts0, gok0 = exchange(p)
        z_bounds = (lo, hi)

    if backend == "window":
        p, struct_over = _solve_window(cfg, cap, p, active, exchange,
                                       ghosts0, gok0, z_bounds, work)
    else:
        p, struct_over = _solve_cell(cfg, cap, p, active, exchange, ghosts0,
                                     gok0)

    x_new, v_new = finalize(cfg, p, last)
    x_new = torch.where(active[:, None], x_new, SENTINEL)
    v_new = torch.where(active[:, None], v_new, 0.0)
    stats = torch.stack([active.sum().to(torch.int32), mig_over, merge_over,
                         ghost_over, struct_over])
    return x_new, v_new, ids, brow, stats, _diag(cfg, active, x_new, v_new)


# ---------------------------------------------------------------------------
# the objects a caller holds: step, rollout, diagnostics
# ---------------------------------------------------------------------------

def _check_group(pcfg: ParallelConfig, group: Group | None) -> None:
    size = 1 if group is None else group.size
    if size != pcfg.n_devices:
        raise ValueError(f"ParallelConfig has {pcfg.n_devices} devices, the "
                         f"group {size} ranks (one rank runs without one)")


class ShardedStepper:
    """One rank's sharded step for one (cfg, pcfg, backend): it holds the
    rank's ping-pong buffers and pair-kernel scratch, allocated once, and
    makes the step's constant tensors (core.step.make_constants).

    `step(sst)` -> (sst, stats (5,), diag (3,)) of this rank;
    `sst -> (sst, stats (D, 5), diag (D, 3))` gathers every rank's rows:
    stats [active, migration_overflow, merge_overflow, ghost_overflow,
    plan_or_table_overflow], diag [max_speed, n_escaped, nan_detected]."""

    def __init__(self, cfg: SimConfig, pcfg: ParallelConfig,
                 group: Group | None = None, backend: str = "window",
                 device: torch.device | str = "cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown sharded backend {backend!r}; have "
                             f"{BACKENDS}")
        cfg.validate()
        _validate_geometry(cfg, pcfg)
        _check_group(pcfg, group)
        self.cfg, self.pcfg, self.group = cfg, pcfg, group
        self.backend = backend
        self.device = resolve_device(device)
        make_constants(cfg, self.device)
        self.work = None
        if backend == "window":
            n_loc = pcfg.capacity + (2 * pcfg.ghost_capacity
                                     if pcfg.n_devices > 1 else 0)
            n_pad = cuda_pbf.pad_to_chunks(cfg, n_loc)
            bufs = tuple(torch.zeros((n_pad, 4), dtype=torch.float32,
                                     device=self.device) for _ in range(2))
            scratch = (cuda_pbf.alloc_scratch(cfg, n_pad, self.device)
                       if self.device.type == "cuda" else None)
            self.work = _Work(bufs, scratch)

    def check(self, sst: ShardedState) -> None:
        """Raise unless `sst` has this rank's capacity on this device."""
        if sst.x.shape != (self.pcfg.capacity, 3) \
                or sst.x.device != self.device:
            raise ValueError(f"state of {tuple(sst.x.shape)} on "
                             f"{sst.x.device}; the stepper has capacity "
                             f"{self.pcfg.capacity} on {self.device}")

    def step(self, sst: ShardedState):
        self.check(sst)
        x, v, ids, bounds, stats, diag = _shard_step(
            self.cfg, self.pcfg, self.backend, self.group, self.work, *sst)
        return ShardedState(x, v, ids, bounds), stats, diag

    def gather(self, stats: torch.Tensor, diag: torch.Tensor):
        """Every rank's rows, (D, 5) and (D, 3), in rank order."""
        if self.group is None:
            return stats[None], diag[None]
        return self.group.all_gather(stats), self.group.all_gather(diag)

    def __call__(self, sst: ShardedState):
        sst, stats, diag = self.step(sst)
        return (sst, *self.gather(stats, diag))


def _aggregate(acc: Sequence[torch.Tensor], stats: torch.Tensor,
               diag: torch.Tensor) -> None:
    """Fold one step into acc = (stats (5,), diag (3,)), zero at the start
    of a chunk, as the JAX rollout does (sharded.py:978-988): column 0 from
    the last step, the overflow columns summed, diag the running max."""
    total, dmax = acc
    total.add_(stats)
    total[0] = stats[0]
    torch.maximum(dmax, diag, out=dmax)


def step_into(stepper: ShardedStepper, sst: Sequence[torch.Tensor],
              acc: Sequence[torch.Tensor]) -> None:
    """One sharded step that writes the next state back into the tensors
    of `sst` (x, v, ids, bounds) and folds its stats and diag into `acc`:
    the body that a ShardedRollout captures."""
    out, stats, diag = stepper.step(ShardedState(*sst))
    for dst, src in zip(sst, out):
        dst.copy_(src)
    _aggregate(acc, stats, diag)


def captures(device: torch.device, group: Group | None) -> bool:
    """Whether a ShardedRollout on `device` runs as a CUDA graph: on a
    card, one rank (no group) or the ranks of an NCCL group, whose
    collectives the graph takes in, on either backend. gloo ranks, whose
    staging waits for the card, and the CPU run the Python loop. The choice
    follows the backend alone: a capture that fails raises, nothing falls
    back."""
    return device.type == "cuda" and (group is None
                                      or group.backend == "nccl")


class ShardedRollout:
    """`unroll_steps` sharded steps a call, or `steps` (a final partial
    chunk runs on the same buffers and graph), queued with no host read;
    returns (sst, stats (D, 5), diag (D, 3)) aggregated over the chunk
    (`_aggregate`). The caller's state is never written.

    Where `captures` says so, the step runs as a CUDA graph
    (core.step.CapturedStep with the body `step_into`, captured at the first
    call after one eager warm-up step); elsewhere as a Python loop."""

    def __init__(self, cfg: SimConfig, pcfg: ParallelConfig,
                 group: Group | None = None, backend: str = "window",
                 unroll_steps: int = 1,
                 device: torch.device | str = "cuda"):
        if unroll_steps < 1:
            raise ValueError(f"unroll_steps must be >= 1, got {unroll_steps}")
        self.stepper = ShardedStepper(cfg, pcfg, group, backend, device)
        self.unroll_steps = unroll_steps
        self.graphed = captures(self.stepper.device, group)
        self.captured: CapturedStep | None = None

    def release(self) -> None:
        """Free the graph (CapturedStep.release), the buffers and the
        scratch, before another tier's rollout allocates its own; the
        rollout cannot run afterwards."""
        if self.captured is not None:
            self.captured.release()
        self.captured = None
        self.stepper.work = None

    def __call__(self, sst: ShardedState, steps: int | None = None):
        steps = self.unroll_steps if steps is None else steps
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        self.stepper.check(sst)
        acc = (torch.zeros((5,), dtype=torch.int32, device=sst.x.device),
               torch.zeros((3,), dtype=torch.float32, device=sst.x.device))
        if self.graphed:
            if self.captured is None:
                self.captured = CapturedStep(
                    functools.partial(step_into, self.stepper), sst, acc)
            out, acc = self.captured(sst, steps)
            sst = ShardedState(*out)
        else:
            for _ in range(steps):
                sst, stats, diag = self.stepper.step(sst)
                _aggregate(acc, stats, diag)
        return (sst, *self.stepper.gather(*acc))


def _shard_diag(cfg: SimConfig, pcfg: ParallelConfig, backend: str,
                group: Group | None, x, v, ids, brow,
                scratch: cuda_pbf.PairScratch | None = None) -> torch.Tensor:
    """One rank's density diagnostics over its particles and their ghosts
    (the JAX `_shard_diag`, sharded.py:993-1069): (5,) float32
    [mean_density, max_density_err, max_speed, n_escaped, nan_detected].
    `cell` keeps JAX's table form, rho > 0 marking the measured particles;
    `window` takes rho from the density kernel's rho output (K1 rho), as
    core.step.diagnostics_fn does, measuring every finite particle. Ghosts
    add to rho but are measured on their home rank."""
    active = ids >= 0
    xm = torch.where(active[:, None], x, SENTINEL)
    gp = gok = None
    if pcfg.n_devices > 1:
        b = brow[1:]
        lo, hi = b[group.rank], b[group.rank + 1]
        left, right = _ghost_masks(cfg, pcfg, group, active,
                                   _zxkey(cfg, xm), lo, hi)
        gp, gok = _ghost_exchange(pcfg, group, left, right)[0](xm)
    combined, ok, cid = _local_set(cfg, xm, active, gp, gok)
    cap = pcfg.capacity
    if backend == "cell":
        sorted_cid, order = hashgrid.sort_by_cell(cfg, cid)
        grid = hashgrid.build_grid(cfg, sorted_cid, order,
                                   ignore_cell=cfg.num_nb_cells)
        cs = combined[order]
        rho_t = cell_list.density_tables(
            cfg, *cell_list.position_tables(cfg, grid, cs), grid)
        rho_s = hashgrid.gather_table(cfg, grid, rho_t,
                                      torch.zeros_like(cs[:, 0]))
        rho = rho_s[_inverse_permutation(order)][:cap]
        meas = active & (rho > 0.0)
    else:
        n_loc = combined.shape[0]
        sorted_cid, order = sort_cells(cfg, cid)
        plan = cuda_pbf.build_plan(cfg, sorted_cid)
        p4 = torch.zeros((sorted_cid.shape[0], 4), dtype=torch.float32,
                         device=x.device)
        p4[:n_loc, :3] = torch.where(ok[order][:, None], combined[order], 0.0)
        rho_s = cuda_pbf.density_rho(cfg, p4, plan, n_loc,
                                     scratch=scratch)[:n_loc, 3]
        rho = rho_s[_inverse_permutation(order)][:cap]
        meas = active & torch.isfinite(x).all(dim=1)
    n_meas = meas.sum().clamp_min(1).float()
    err = (rho * f32(cfg.inv_rho0) - 1.0).abs()
    zero = torch.zeros_like(rho)
    return torch.cat([
        torch.stack([torch.where(meas, rho, zero).sum() / n_meas,
                     torch.where(meas, err, zero).max()]),
        _diag(cfg, active, xm, v)])


class ShardedDiagnostics:
    """sst -> (D, 5) float32, every rank's row of [mean_density,
    max_density_err, max_speed, n_escaped, nan_detected]; on the window
    backend the pair kernel takes `scratch` (a ShardedStepper's) if given,
    else allocates its own."""

    def __init__(self, cfg: SimConfig, pcfg: ParallelConfig,
                 group: Group | None = None, backend: str = "window",
                 scratch: cuda_pbf.PairScratch | None = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown sharded backend {backend!r}")
        _validate_geometry(cfg, pcfg)
        _check_group(pcfg, group)
        self.cfg, self.pcfg, self.group = cfg, pcfg, group
        self.backend = backend
        self.scratch = scratch

    def __call__(self, sst: ShardedState) -> torch.Tensor:
        row = _shard_diag(self.cfg, self.pcfg, self.backend, self.group,
                          *sst, scratch=self.scratch)
        return row[None] if self.group is None \
            else self.group.all_gather(row)


def make_sharded_step(cfg: SimConfig, pcfg: ParallelConfig,
                      group: Group | None = None, backend: str = "window",
                      device: torch.device | str = "cuda") -> ShardedStepper:
    return ShardedStepper(cfg, pcfg, group, backend, device)


def make_sharded_rollout(cfg: SimConfig, pcfg: ParallelConfig,
                         group: Group | None = None, backend: str = "window",
                         unroll_steps: int = 1,
                         device: torch.device | str = "cuda"
                         ) -> ShardedRollout:
    return ShardedRollout(cfg, pcfg, group, backend, unroll_steps, device)


def make_sharded_diagnostics(cfg: SimConfig, pcfg: ParallelConfig,
                             group: Group | None = None,
                             backend: str = "window",
                             scratch: cuda_pbf.PairScratch | None = None
                             ) -> ShardedDiagnostics:
    return ShardedDiagnostics(cfg, pcfg, group, backend, scratch)


def tier_programs(cfg: SimConfig, pcfg: ParallelConfig, group: Group | None,
                  backend: str, unroll_steps: int,
                  device: torch.device | str
                  ) -> tuple[ShardedRollout, ShardedDiagnostics]:
    """One tier's programs on this rank: its rollout (the stepper, the
    pair-kernel scratch and, where `captures`, the graph) and the density
    diagnostics, which share the rollout's scratch. A run moves to another
    tier by `ShardedRollout.release`, collect, distribute and a new call
    (launch.rollout_ranks' `retier`, the runner's `--retier-at` and its
    fallback)."""
    roll = make_sharded_rollout(cfg, pcfg, group, backend, unroll_steps,
                                device)
    work = roll.stepper.work
    return roll, make_sharded_diagnostics(
        cfg, pcfg, group, backend, work.scratch if work else None)


def distribute(cfg: SimConfig, pcfg: ParallelConfig, state: SimState,
               group: Group | None = None,
               device: torch.device | str = "cuda") -> ShardedState:
    """This rank's ShardedState from the full state (every rank passes the
    same one): the particles of its slab of the initial split (the quantile
    split of the zx-key histogram when rebalancing), on `device`. Raises on
    every rank if any slab exceeds the capacity."""
    D, cap = pcfg.n_devices, pcfg.capacity
    x, v, ids = (_host(t) for t in (state.x, state.v, state.ids))
    b = initial_bounds(cfg, D, state=state, rebalance=pcfg.rebalance,
                       z_cells_hi=pcfg.z_cells_hi)
    dest = np.searchsorted(b[1:-1], _np_zxkey(cfg, x), side="right")
    counts = np.bincount(dest, minlength=D)
    if counts.max() > cap:
        d = int(counts.argmax())
        raise ValueError(f"shard {d} needs {int(counts[d])} slots > "
                         f"capacity {cap}; increase ParallelConfig.capacity")
    sel = np.nonzero(dest == (0 if group is None else group.rank))[0]
    gx = np.full((cap, 3), SENTINEL, np.float32)
    gv = np.zeros((cap, 3), np.float32)
    gids = np.full((cap,), -1, np.int32)
    gx[:len(sel)], gv[:len(sel)], gids[:len(sel)] = x[sel], v[sel], ids[sel]
    dev = resolve_device(device)
    brow = np.concatenate([[0], b]).astype(np.int32)
    return ShardedState(*(torch.from_numpy(a).to(dev)
                          for a in (gx, gv, gids, brow)))


def collect(sst: ShardedState, group: Group | None = None) -> SimState:
    """The full state in spawn-id order, on every rank (each rank's
    fixed-capacity buffers gathered), on the sharded state's device; step
    0, as in JAX."""
    parts = [sst.x, sst.v, sst.ids]
    if group is not None:
        parts = [group.all_gather(t).flatten(0, 1) for t in parts]
    x, v, ids = (_host(t) for t in parts)
    sel = ids >= 0
    order = np.argsort(ids[sel], kind="stable")
    dev = sst.x.device
    return SimState(
        x=torch.from_numpy(x[sel][order]).to(dev),
        v=torch.from_numpy(v[sel][order]).to(dev),
        ids=torch.from_numpy(ids[sel][order]).to(dev),
        step=torch.zeros((), dtype=torch.int32, device=dev))
