"""The windowed PBF constraint solve: plan, the two kernel passes, solve.

The port of `pdb_sph_tpu/ops/pallas_pbf.py`. Its design idea stays: each
own-chunk of `cfg.geom.own` consecutive cell-sorted particles takes as
candidates the 27-cell stencil of its cell span, which collapses to nine
contiguous ranges of the sorted array, one per (dy, dz), because cell ids
run x-fastest. What existed only for Mosaic's 128-lane DMA is gone: the
windows are exact `[start, end)` element ranges (no quantisation, no shifted
candidate copies, no segment table, no capacity), and padding rows are never
candidates, so no sentinel position is needed.

Positions travel as one (n_pad, 4) float32 tensor with columns
(x, y, z, lambda). `density_pass` reads one such buffer and writes
(x, y, z, lambda) into the other; `project_pass` reads that and writes the
projected positions back: the two buffers ping-pong, and the JAX solve's
lambda splice is the density pass's write.

`density_rho` is the density pass's other output: rho alone, for the
diagnostics (core/step.diagnostics_fn), through the same kernel body. It
stays FP32 whatever the geometry's switches say: JAX's diagnostic density
does not read the geometry either.

The geometry's tensor-core switches select the other forms of the passes,
as in the JAX kernels: `mxu_rd2` computes the density pass's rd2 as
(|p_i|^2 - (dot + dot)) + |p_j|^2 with the dot of a bf16 hi/lo split
(`bf16_split`, `dot3`); `mxu_proj` takes the project pass's rd2 the same
way and its delta-p as own3 * S - s @ cand3^T with s split too; `mxu_sum`
takes the row sums on the tensor cores at float32 precision, which is the
plain versions' `.sum(-1)` as a function.

Every pair kernel (`csrc/pair_items.cuh`, shared by `csrc/pbf_window.cu`
and `csrc/pbf_tc.cu`) splits the work into items of bounded size: the
plan also cuts each chunk's candidates, the virtual concatenation of its
nine ranges, into segments of `seg_len` candidates and gives the exclusive
prefix of segments per chunk (`seg_prefix`); one item is one (chunk,
segment). Each item's row sums go to a scratch slot (`PairScratch`, which
the caller may allocate once and pass on), and the chunk's last item adds
them in segment order. `split=True` on the plain versions takes the sums
the same way (`segment_sum`, and the split product of delta-p per
segment), so the CPU tests can hold the split against the unsplit sum.

Each pass is a wrapper that dispatches on the tensor's device: a CPU tensor
goes to the plain torch version beside it (`*_ref`), a CUDA tensor launches
the hand-written kernel, or raises: `csrc/pbf_window.cu` in the default
geometry, `csrc/pbf_tc.cu` when a switch of the pass is on. The plan
dispatches the same way: `build_plan` and `work_table` launch the two
kernels of `csrc/pbf_plan.cu` on a card and run `build_plan_ref` and
`work_table_ref` on the CPU, with the same fields bit for bit. `LAUNCHES`
counts the kernel launches of each wrapper and tensor-core form, so a run
can show that its main path went through the kernels; a launch captured
into a CUDA graph (`captured_launches`) counts once per replay
(`add_replays`).

The FP32 kernels cull each staged tile of candidates against the boxes of
groups of the chunk's own rows and run the pair body only on the
survivors (csrc/pbf_window.cu's header). The cull drops only pairs whose
terms the clamp already zeroes, so the plain versions, which take every
candidate, stay their plain versions. `cull_survivors` repeats the cull's
predicate bit for bit in plain torch; `cull_pair_evals` counts the (own
row, survivor) pairs that a launch evaluates, which a wrapper given
`evals` (an int64 on the card) has the kernel add there.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch

from ..config import SimConfig
from . import smoothing
from .smoothing import EPS, f32

NUM_WINDOWS = 9

# Kernel launches per wrapper since the last reset_launches(); the plain
# versions never count. The tensor-core forms count per instantiation of
# density_tc_kernel<rd2, sum> and project_tc_kernel<proj, sum>; "finalize"
# is ops/collide.finalize's kernel (csrc/pbf_finalize.cu); "plan" and
# "work_table" are build_plan's and work_table's (csrc/pbf_plan.cu).
LAUNCHES = {"density_lambda": 0, "density_rho": 0, "project": 0,
            "density_tc_rd2": 0, "density_tc_sum": 0, "density_tc_rd2_sum": 0,
            "project_tc_proj": 0, "project_tc_sum": 0,
            "project_tc_proj_sum": 0, "finalize": 0, "plan": 0,
            "work_table": 0}

# (own rows x candidates) pair elements per batch of the plain versions: a
# batch is a run of consecutive chunks padded to its longest one
_REF_PAIRS_PER_BATCH = 1 << 22
# work items the pair kernels' scratch holds, per own-chunk (a float4 per
# own row of each: 16 KiB a chunk at own 64): a plan whose candidates would
# need more items at the geometry's `seg` takes longer segments instead
# (work_table), so no candidate is dropped
ITEMS_PER_CHUNK = 16


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# The launches recorded by the CUDA graph capture under way, if any: a
# wrapper called while a stream captures launches nothing, its kernel runs
# at each replay of the graph (add_replays)
_captured: dict | None = None


@contextlib.contextmanager
def captured_launches():
    """Count the wrappers' launches inside this context into the yielded
    dict, not into LAUNCHES: for the body of a CUDA graph capture."""
    global _captured
    outer, _captured = _captured, dict.fromkeys(LAUNCHES, 0)
    try:
        yield _captured
    finally:
        _captured = outer


def count_launch(name: str, what: str) -> None:
    """Count one launch of the kernel `what` under LAUNCHES[name], or into
    the capture's dict while a stream captures (captured_launches)."""
    counts = LAUNCHES
    if torch.cuda.is_current_stream_capturing():
        if _captured is None:
            raise RuntimeError(f"{what} captured into a CUDA graph outside "
                               "captured_launches(): its replays would go "
                               "uncounted")
        counts = _captured
    counts[name] += 1


def add_replays(captured: dict, replays: int) -> None:
    """Add to LAUNCHES the launches of `replays` replays of a graph whose
    capture recorded `captured`."""
    for name, count in captured.items():
        LAUNCHES[name] += count * replays


class WindowPlan(NamedTuple):
    """Per-step candidate plan, built once from the step's sorted cell ids.

    ranges: (num_chunks, 9, 2) int32 — disjoint [start, end) ranges of the
        sorted array, ascending; empty ranges have start == end.
    n_overflow: () int32 — always 0, kept so the step's stats vector keeps
        the JAX layout [table_overflow, plan_overflow, nonfinite]: the plan
        has no capacity, since the kernels loop over each range whatever
        its length, so nothing can be truncated.
    seg_prefix: (num_chunks + 1,) int32 — the pair kernels' work table:
        chunk c owns items seg_prefix[c] .. seg_prefix[c + 1] - 1, one per
        segment of seg_len candidates (at least one, so an all-pad chunk's
        item writes its rows); seg_prefix[-1] is the item count.
    seg_len: () int32 — candidates per segment: the geometry's `seg`, or
        the least length that keeps the items within the scratch's
        ITEMS_PER_CHUNK * num_chunks.
    n_candidates: () int64 — the candidates of every chunk summed,
        sum(end - start) over the ranges; each is a candidate of each of
        the chunk's own rows (the step counts own x this, core/step.py).
    """

    ranges: torch.Tensor
    n_overflow: torch.Tensor
    seg_prefix: torch.Tensor | None = None
    seg_len: torch.Tensor | None = None
    n_candidates: torch.Tensor | None = None


class PairScratch(NamedTuple):
    """What the pair kernels write between their items: the kernel itself
    allocates nothing.

    partials: (ITEMS_PER_CHUNK * n_pad, 4) float32 — one float4 of row sums
        per own row of each item of a chunk with several items.
    counters: (num_chunks + 2,) int32 — per-chunk arrivals, then the next
        item to take and the blocks done; 0 before a launch, and each launch
        leaves them at 0.
    """

    partials: torch.Tensor
    counters: torch.Tensor


def alloc_scratch(cfg: SimConfig, n_pad: int,
                  device: torch.device | str) -> PairScratch:
    """The pair kernels' scratch for (n_pad, 4) inputs, counters zeroed."""
    num_chunks = n_pad // cfg.geom.own
    return PairScratch(
        partials=torch.empty((ITEMS_PER_CHUNK * n_pad, 4),
                             dtype=torch.float32, device=device),
        counters=torch.zeros((num_chunks + 2,), dtype=torch.int32,
                             device=device))


def pad_to_chunks(cfg: SimConfig, n: int) -> int:
    """n rounded up to a whole number of own-chunks."""
    own = cfg.geom.own
    return -(-n // own) * own


def disjoint_windows(start: torch.Tensor, end: torch.Tensor):
    """(chunks, 9) window bounds with ascending starts -> disjoint windows
    with the same union: each start is clipped to the reach of the windows
    before it, each end to at least its start. JAX's `dedup_q` carries that
    reach through a 9-step scan (pallas_pbf.py:175-188); it is the
    cumulative max of max(start, end), so one cummax replaces the scan."""
    reach = torch.maximum(start, end).cummax(dim=1).values
    carry = torch.cat([torch.zeros_like(reach[:, :1]), reach[:, :-1]], dim=1)
    start = torch.maximum(start, carry)
    return start, torch.maximum(end, start)


@functools.cache
def window_offsets(w: int, device: torch.device) -> torch.Tensor:
    """(9,) int32 cell-id offset of each window's (dy, dz) row on a grid of
    width w, made once per width and device: a tensor built from host
    values is a copy that, on a card, waits for the stream's queued work,
    so no plan may build one."""
    return torch.tensor(
        [dz * w * w + dy * w for dz in (-1, 0, 1) for dy in (-1, 0, 1)],
        dtype=torch.int32, device=device)


def build_plan_ref(cfg: SimConfig, sorted_cid: torch.Tensor,
                   counters: dict[str, torch.Tensor] | None = None
                   ) -> WindowPlan:
    """The plain torch plan. sorted_cid: (n_pad,) int32 sorted cell ids,
    padding = num_nb_cells; `counters` as work_table_ref's.

    Windows follow pdb_sph_tpu/ops/pallas_pbf.py:101-234 without its
    quantisation: the chunk's cell span [c_first, c_last] is taken from its
    real entries only (a mixed chunk's padding tail must not stretch the
    windows); window (dy, dz) spans cells c_first + off - 1 ..
    c_last + off + 1, capped at the last real cell so no padding entry is
    ever a candidate; the windows are made disjoint by clipping each start
    to the running maximum of the previous windows' reach (the carry of
    JAX's `dedup_q`, in closed form as a cumulative max); all-pad chunks get
    empty windows.
    """
    own = cfg.geom.own
    n_pad = sorted_cid.shape[0]
    num_chunks = n_pad // own
    ncells = cfg.num_nb_cells
    dev = sorted_cid.device

    chunk_cid = sorted_cid[: num_chunks * own].view(num_chunks, own)
    c_first = chunk_cid[:, 0]
    c_last = torch.where(chunk_cid < ncells, chunk_cid,
                         torch.full_like(chunk_cid, -1)).amax(dim=1)

    offsets = window_offsets(cfg.nb_grid_width, dev)
    lo_cell = (c_first[:, None] + offsets - 1).clamp(0, ncells)
    hi_cell = (c_last[:, None] + offsets + 1).clamp(-1, ncells - 1)

    cells = torch.arange(ncells + 1, dtype=torch.int32, device=dev)
    cell_starts = torch.searchsorted(sorted_cid, cells, out_int32=True)
    start, end = disjoint_windows(cell_starts[lo_cell.long()],
                                  cell_starts[(hi_cell + 1).long()])

    is_pad = (c_first >= ncells)[:, None]
    start = torch.where(is_pad, torch.zeros_like(start), start)
    end = torch.where(is_pad, torch.zeros_like(end), end)
    ranges = torch.stack([start, end], dim=-1).contiguous()
    seg_len, seg_prefix, total = work_table_ref(cfg, (end - start).sum(dim=1),
                                                counters)
    return WindowPlan(ranges=ranges,
                      n_overflow=torch.zeros((), dtype=torch.int32,
                                             device=dev),
                      seg_prefix=seg_prefix, seg_len=seg_len,
                      n_candidates=total)


def _plan_library(t: torch.Tensor):
    """The kernel library for a plan on `t`'s card; raise for a device
    with no kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"no plan kernel for device {t.device}")
    from ..utils.cuda_build import load_kernels
    return load_kernels()


def build_plan(cfg: SimConfig, sorted_cid: torch.Tensor,
               counters: dict[str, torch.Tensor] | None = None
               ) -> WindowPlan:
    """The step's window plan of sorted_cid, (n_pad,) int32 sorted cell ids
    with padding = num_nb_cells. CPU: build_plan_ref. CUDA: the two kernels
    of `csrc/pbf_plan.cu`, the same fields bit for bit, built on the device
    with no host read; each counts one launch, under LAUNCHES["plan"] and
    LAUNCHES["work_table"]. `counters` as work_table_ref's, added to inside
    the work table's kernel. Any other device raises."""
    if sorted_cid.device.type == "cpu":
        return build_plan_ref(cfg, sorted_cid, counters)
    kernels = _plan_library(sorted_cid)
    if sorted_cid.dtype != torch.int32 or sorted_cid.dim() != 1 \
            or not sorted_cid.is_contiguous():
        raise ValueError("sorted_cid must be contiguous (n_pad,) int32, got "
                         f"{tuple(sorted_cid.shape)} {sorted_cid.dtype}")
    own = cfg.geom.own
    n_pad = sorted_cid.shape[0]
    chunks = n_pad // own
    dev = sorted_cid.device
    ranges = torch.empty((chunks, NUM_WINDOWS, 2), dtype=torch.int32,
                         device=dev)
    cand = torch.empty((chunks,), dtype=torch.int64, device=dev)
    code = kernels.lib.launch_plan_windows(
        sorted_cid.data_ptr(), n_pad, chunks, own, cfg.num_nb_cells,
        cfg.nb_grid_width, ranges.data_ptr(), cand.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(code, "launch_plan_windows")
    count_launch("plan", "launch_plan_windows")
    n_overflow = torch.empty((), dtype=torch.int32, device=dev)
    seg_len, seg_prefix, total = _work_table_kernel(cfg, cand, n_overflow,
                                                    counters)
    return WindowPlan(ranges=ranges, n_overflow=n_overflow,
                      seg_prefix=seg_prefix, seg_len=seg_len,
                      n_candidates=total)


def restrict_plan(cfg: SimConfig, plan: WindowPlan,
                  keep: torch.Tensor) -> WindowPlan:
    """The plan with the nine ranges of every own-chunk c with keep[c]
    False emptied, and its work table rebuilt on the device, with no host
    read (`restrict_plan`, pdb_sph_tpu/ops/pallas_pbf.py:237-263).

    The sharded solve runs each pass only on the own-chunks whose outputs
    it reads. A masked chunk keeps its rows: its one empty work item still
    writes them, as JAX's rule has it, so the density pass gives lambda
    from zero sums (1 / relaxation_eps) and the project pass the own
    position unchanged. The plain versions honour the same plan."""
    if keep.shape != plan.ranges.shape[:1]:
        raise ValueError(f"keep must be ({plan.ranges.shape[0]},), got "
                         f"{tuple(keep.shape)}")
    ranges = torch.where(keep[:, None, None], plan.ranges,
                         torch.zeros_like(plan.ranges))
    seg_len, seg_prefix, total = work_table(
        cfg, (ranges[..., 1] - ranges[..., 0]).sum(dim=1))
    return WindowPlan(ranges=ranges, n_overflow=plan.n_overflow,
                      seg_prefix=seg_prefix, seg_len=seg_len,
                      n_candidates=total)


def work_table_ref(cfg: SimConfig, cand: torch.Tensor,
                   counters: dict[str, torch.Tensor] | None = None):
    """The plain torch work table: (seg_len () int32, seg_prefix (chunks +
    1,) int32, total () int64) for chunks of `cand` candidates each, on the
    device, with no host read; total is their sum.

    seg_len is the geometry's `seg` unless the candidates would need more
    than ITEMS_PER_CHUNK * chunks items; then it is the least length that
    fits: sum(max(1, ceil(cand / L))) <= chunks + total / L <= capacity.

    Where `counters` holds "pair_items" and "chunk_items_max" (0-dim int64,
    `core.step.Stepper.counters`), the table's items (seg_prefix[-1]) are
    added into the first and the most items of one chunk into the second."""
    chunks = cand.shape[0]
    spare = ITEMS_PER_CHUNK * chunks - chunks  # items beyond one a chunk
    total = cand.sum(dtype=torch.int64)
    seg_len = ((total + (spare - 1)) // spare).clamp_(min=cfg.geom.seg)
    seg_len = seg_len.to(torch.int32)
    # ceil(cand / seg_len), and one item for a chunk without candidates
    items = ((cand - 1) // seg_len + 1).clamp_(min=1)
    seg_prefix = torch.zeros((chunks + 1,), dtype=torch.int32,
                             device=cand.device)
    torch.cumsum(items, 0, dtype=torch.int32, out=seg_prefix[1:])
    counted = _item_counters(counters, cand.device)
    if counted is not None:
        counted[0].add_(seg_prefix[-1])
        counted[1].add_(items.max())
    return seg_len, seg_prefix, total


def _item_counters(counters: dict[str, torch.Tensor] | None,
                   device: torch.device):
    """(pair_items, chunk_items_max) of `counters`, or None where it lacks
    them; each must be a 0-dim int64 on `device`, which a kernel writes."""
    if counters is None or "pair_items" not in counters:
        return None
    got = counters["pair_items"], counters["chunk_items_max"]
    for t in got:
        if t.dtype != torch.int64 or t.dim() != 0 or t.device != device:
            raise ValueError(f"a work-item counter must be a 0-dim int64 on "
                             f"{device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    return got


def _work_table_kernel(cfg: SimConfig, cand: torch.Tensor,
                       n_overflow: torch.Tensor | None = None,
                       counters: dict[str, torch.Tensor] | None = None):
    """work_table's kernel on a card; also writes the 0 of `n_overflow`,
    a () int32, when given, and adds into `counters` as work_table_ref."""
    kernels = _plan_library(cand)
    if cand.dim() != 1 or not cand.is_contiguous() or cand.numel() < 1:
        raise ValueError(f"cand must be contiguous (chunks,), chunks >= 1, "
                         f"got {tuple(cand.shape)}")
    cand = cand.to(torch.int64)
    chunks = cand.shape[0]
    dev = cand.device
    seg_len = torch.empty((), dtype=torch.int32, device=dev)
    seg_prefix = torch.empty((chunks + 1,), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    counted = _item_counters(counters, dev)
    code = kernels.lib.launch_work_table(
        cand.data_ptr(), chunks, cfg.geom.seg,
        ITEMS_PER_CHUNK * chunks - chunks,
        seg_len.data_ptr(), seg_prefix.data_ptr(), total.data_ptr(),
        None if n_overflow is None else n_overflow.data_ptr(),
        *((None, None) if counted is None
          else (counted[0].data_ptr(), counted[1].data_ptr())),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(code, "launch_work_table")
    count_launch("work_table", "launch_work_table")
    return seg_len, seg_prefix, total


def work_table(cfg: SimConfig, cand: torch.Tensor,
               counters: dict[str, torch.Tensor] | None = None):
    """(seg_len () int32, seg_prefix (chunks + 1,) int32, total () int64)
    for chunks of `cand` candidates each (work_table_ref, with its
    `counters`), on the device, with no host read. CPU: work_table_ref.
    CUDA: `csrc/pbf_plan.cu`'s work_table_kernel, one launch under
    LAUNCHES["work_table"]. Any other device raises."""
    if cand.device.type == "cpu":
        return work_table_ref(cfg, cand, counters)
    return _work_table_kernel(cfg, cand, counters=counters)


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------

def _candidates(ranges: torch.Tensor):
    """(b, 9, 2) ranges -> (b, L) int64 candidate indices and (b, L) mask,
    L the longest chunk's candidate count; masked slots index row 0."""
    start = ranges[..., 0].long()
    lens = ranges[..., 1].long() - start
    cum = lens.cumsum(dim=1)
    cum0 = cum - lens
    total = cum[:, -1]
    length = int(total.max()) if total.numel() else 0
    k = torch.arange(length, device=ranges.device)[None, :]
    idx = torch.zeros((ranges.shape[0], length), dtype=torch.long,
                      device=ranges.device)
    for w in range(NUM_WINDOWS):
        sel = (k >= cum0[:, w:w + 1]) & (k < cum[:, w:w + 1])
        idx = torch.where(sel, start[:, w:w + 1] + (k - cum0[:, w:w + 1]),
                          idx)
    return idx, k < total[:, None]


def bf16_split(a: torch.Tensor):
    """float32 -> (hi, lo) bfloat16 pair with hi + lo ~= a to ~16 mantissa
    bits; the port of `_bf16_split` (pdb_sph_tpu/ops/pallas_pbf.py:301).
    A float64 `a` holding float32 values splits the same way."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.to(a.dtype)).to(torch.bfloat16)
    return hi, lo


def dot3(ah, al, bh, bl, dot, dtype=torch.float32) -> torch.Tensor:
    """The 3-pass bf16 product of `_dot3` (pallas_pbf.py:308):
    hi*hi + (hi*lo + lo*hi), the lo*lo term dropped. `dot(a, b)` contracts
    the pairs' values in `dtype`; a product of two bf16 values is exact in
    float32, so the forms differ only in the order of their sums (and a
    float64 `dtype` takes those sums without their float32 rounding)."""
    ah, al, bh, bl = (t.to(dtype) for t in (ah, al, bh, bl))
    return dot(ah, bh) + (dot(ah, bl) + dot(al, bh))


def _sq3(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 over the last axis's first three columns, left to right."""
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
            + p[..., 2] * p[..., 2])


def _xyz_dot(o: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(b, own, 3) . (b, L, 3) -> (b, own, L), x + y + z left to right."""
    o, c = o[:, :, None, :], c[:, None, :, :]
    return (o[..., 0] * c[..., 0] + o[..., 1] * c[..., 1]
            + o[..., 2] * c[..., 2])


def _cand_dot(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(b, own, L) @ (b, L, 3) -> (b, own, 3) over the candidates, as
    elementwise products and a sum (no matmul, so no TF32 on a card)."""
    return (s[..., None] * c[:, None, :, :]).sum(dim=2)


def _chunk_batches(lens: list[int], own: int) -> list[tuple[int, int]]:
    """[c0, c1) runs of consecutive chunks, each as long as its rows times
    its longest chunk's candidates stay within _REF_PAIRS_PER_BATCH (a
    chunk longer than that is a run of its own). Sized by each run's own
    longest chunk, not the plan's: at 1M particles one heavy chunk would
    otherwise cut every batch to a few chunks."""
    runs, c0, longest = [], 0, 1
    for c, length in enumerate(lens):
        wider = max(longest, length)
        if c > c0 and (c + 1 - c0) * own * wider > _REF_PAIRS_PER_BATCH:
            runs.append((c0, c))
            c0, wider = c, max(length, 1)
        longest = wider
    if lens:
        runs.append((c0, len(lens)))
    return runs


def _pair_blocks(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan, n: int,
                 split_rd2: bool = False):
    """Yield (row0, own (b, own, 4), (dx, dy, dz) or None, rd2 clamped,
    mask, cand (b, L, 4)) for batches of chunks: the plain version of the
    kernels' candidate streaming, with the same clamped pair distance.

    With `split_rd2`, rd2 is the tensor-core form of `_density_kernel`'s
    mxu_rd2 branch and `_project_kernel_mxu` (pallas_pbf.py:445-455,
    :563-568), (|o|^2 - (dot + dot)) + |c|^2 with `dot3` of the bf16 splits,
    and no deltas are yielded."""
    own = cfg.geom.own
    stop = min(plan.ranges.shape[0], -(-n // own))
    lens = (plan.ranges[:stop, :, 1] - plan.ranges[:stop, :, 0]).sum(dim=1)
    # fmin/fmax, not clamp: a NaN rd2 becomes h^2 and adds nothing, as the
    # kernels' fminf/fmaxf make it
    h2 = p4.new_full((), f32(cfg.h2))
    eps = p4.new_full((), f32(EPS))
    for c0, c1 in _chunk_batches(lens.tolist(), own):
        mine = p4[c0 * own:c1 * own].view(c1 - c0, own, 4)
        idx, mask = _candidates(plan.ranges[c0:c1])
        cand = p4[idx]
        if split_rd2:
            dot = dot3(*bf16_split(mine[..., :3]), *bf16_split(cand[..., :3]),
                       _xyz_dot, p4.dtype)
            rd2 = (_sq3(mine)[:, :, None] - (dot + dot)) + _sq3(cand)[:, None]
            d = None
        else:
            d = tuple(mine[:, :, None, a] - cand[:, None, :, a]
                      for a in range(3))
            rd2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        rd2 = torch.fmax(torch.fmin(rd2, h2), eps)
        yield c0 * own, mine, d, rd2, mask[:, None, :], cand


def segment_sum(terms: torch.Tensor, seg_len: int) -> torch.Tensor:
    """Sums over the last axis, a chunk's candidates in plan order, as the
    kernels split them: a partial sum per segment of seg_len candidates,
    the partials then added in segment order."""
    count = terms.shape[-1]
    if count <= seg_len:
        return terms.sum(dim=-1)
    nseg = -(-count // seg_len)
    parts = torch.nn.functional.pad(terms, (0, nseg * seg_len - count))
    parts = parts.unflatten(-1, (nseg, seg_len)).sum(dim=-1)
    acc = parts[..., 0]
    for k in range(1, nseg):
        acc = acc + parts[..., k]
    return acc


def _row_sum(plan: WindowPlan, split: bool):
    """The plain versions' row sum: `.sum(-1)`, or with `split` the
    kernels' `segment_sum` over the plan's segments."""
    if not split:
        return lambda t: t.sum(dim=-1)
    seg_len = int(plan.seg_len)
    return lambda t: segment_sum(t, seg_len)


def _segments(plan: WindowPlan, split: bool, length: int) -> list[slice]:
    """The pieces of a candidate axis of `length` that the kernels sum
    apart: the plan's segments with `split`, else the whole axis."""
    if not split:
        return [slice(None)]
    seg_len = int(plan.seg_len)
    # a batch of chunks without candidates still sums one empty piece
    return [slice(a, a + seg_len) for a in range(0, max(length, 1), seg_len)]


def _store(out: torch.Tensor, row0: int, rows: torch.Tensor, n: int) -> None:
    """Write a batch's (b, own, 4) results to out rows [row0, n)."""
    rows = rows.reshape(-1, 4)
    stop = min(row0 + rows.shape[0], n)
    out[row0:stop] = rows[: stop - row0]


def density_pass_ref(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan,
                     n: int, out: torch.Tensor | None = None,
                     split: bool = False) -> torch.Tensor:
    """Plain torch version of the density kernels: (n_pad, 4) positions ->
    (n_pad, 4) with column 3 = lambda for the first n rows. rd2 takes the
    split-dot form when `cfg.geom.mxu_rd2`; the row sums are `.sum(-1)`,
    also the plain version of `mxu_sum`, or with `split` the kernels'
    segment sums (`segment_sum`)."""
    if out is None:
        out = torch.zeros_like(p4)
    h, h2 = f32(cfg.h), f32(cfg.h2)
    l2 = f32(cfg.lambda_grad_coeff * cfg.lambda_grad_coeff)
    row_sum = _row_sum(plan, split)
    for row0, mine, _, rd2, mask, _ in _pair_blocks(
            cfg, p4, plan, n, split_rd2=cfg.geom.mxu_rd2):
        t = h2 - rd2
        u = h - rd2 * torch.rsqrt(rd2)
        t2 = t * t
        u2 = u * u
        zero = torch.zeros_like(rd2)
        s_rho = row_sum(torch.where(mask, t2 * t, zero))
        s_g2 = row_sum(torch.where(mask, (u2 * u2) * rd2, zero))
        lam = smoothing.lambda_from_sums(
            cfg, f32(cfg.poly6_coeff) * s_rho, l2 * s_g2)
        _store(out, row0, torch.cat([mine[..., :3], lam[..., None]], -1), n)
    return out


def density_rho_ref(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan,
                    n: int, out: torch.Tensor | None = None,
                    split: bool = False) -> torch.Tensor:
    """Plain torch version of the density kernel's rho output: (n_pad, 4)
    positions -> (n_pad, 4) with column 3 = rho for the first n rows; with
    `split`, the kernel's segment sums."""
    if out is None:
        out = torch.zeros_like(p4)
    h2 = f32(cfg.h2)
    row_sum = _row_sum(plan, split)
    for row0, mine, _, rd2, mask, _ in _pair_blocks(cfg, p4, plan, n):
        t = h2 - rd2
        s_rho = row_sum(torch.where(mask, (t * t) * t, torch.zeros_like(rd2)))
        rho = f32(cfg.poly6_coeff) * s_rho
        _store(out, row0, torch.cat([mine[..., :3], rho[..., None]], -1), n)
    return out


def project_pass_ref(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan,
                     n: int, out: torch.Tensor | None = None,
                     split: bool = False) -> torch.Tensor:
    """Plain torch version of the project kernels: (n_pad, 4) positions with
    lambda -> (n_pad, 4) projected positions, lambda carried through, for
    the first n rows. With `cfg.geom.mxu_proj` it follows
    `_project_kernel_mxu` (pallas_pbf.py:525-582): split-dot rd2, and
    own3 + k * (own3 * S - acc_p) with S the row sums of s and acc_p the
    split product of s and the candidates' positions. `split` takes the
    sums as the kernels do: the row sums per segment, and acc_p as one
    split product per segment, each added in segment order."""
    if out is None:
        out = torch.zeros_like(p4)
    row_sum = _row_sum(plan, split)
    h = f32(cfg.h)
    k_proj = f32(-cfg.spiky_grad_coeff * cfg.inv_rho0)
    s_corr = f32(cfg.s_corr)
    mxu = cfg.geom.mxu_proj
    for row0, mine, d, rd2, mask, cand in _pair_blocks(
            cfg, p4, plan, n, split_rd2=mxu):
        u = h - rd2 * torch.rsqrt(rd2)
        olam = mine[..., 3] + s_corr
        s = (u * u) * (olam[:, :, None] + cand[:, None, :, 3])
        s = torch.where(mask, s, torch.zeros_like(s))
        if mxu:
            own3 = mine[..., :3]
            sh, sl = bf16_split(s)
            ch, cl = bf16_split(cand[..., :3])
            acc_p = None
            for piece in _segments(plan, split, s.shape[-1]):
                part = dot3(sh[..., piece], sl[..., piece], ch[:, piece],
                            cl[:, piece], _cand_dot, p4.dtype)
                acc_p = part if acc_p is None else acc_p + part
            moved = own3 + k_proj * (own3 * row_sum(s)[..., None] - acc_p)
            moved = moved.unbind(-1)
        else:
            moved = [mine[..., a] + k_proj * row_sum(s * d[a])
                     for a in range(3)]
        _store(out, row0, torch.stack([*moved, mine[..., 3]], dim=-1), n)
    return out


# ---------------------------------------------------------------------------
# the FP32 kernels' cull, in plain torch
# ---------------------------------------------------------------------------

# a candidate survives a group's cull while its squared distance from the
# group's box rounds below h^2 times this (kCullMargin, csrc/pbf_window.cu)
CULL_MARGIN = 1.0 + 2.0 ** -16


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64: the float's bits as an unsigned integer in the
    float's order (`order_key` in csrc/pbf_window.cu)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | 1 << 31)


def _box(rows: torch.Tensor, ok: torch.Tensor):
    """(..., m, 3) rows and an (..., m) mask -> (lo, hi), each (..., 3),
    over the masked rows, NaN left out as fminf and fmaxf leave it; no row:
    (inf, -inf)."""
    ok = ok[..., None] & ~torch.isnan(rows)
    inf = rows.new_full((), float("inf"))
    return (torch.where(ok, rows, inf).amin(dim=-2),
            torch.where(ok, rows, -inf).amax(dim=-2))


def cull_groups(cfg: SimConfig, p4: torch.Tensor, n: int):
    """(group (chunks, own) int64, lo (chunks, G, 3), hi (chunks, G, 3)):
    the FP32 kernels' split of each own-chunk's rows into G =
    cfg.geom.cull_groups groups, and each group's box over its rows below
    n, as `begin` in csrc/pbf_window.cu makes them. With two groups the
    rows are ranked by their coordinate along the longest axis of the
    chunk's box (the first of equal extents), with keys of the float's
    order whose low bits are the row, and rows from n on last; the first
    own / 2 ranks are group 0."""
    own = cfg.geom.own
    chunks = p4.shape[0] // own
    rows = p4[: chunks * own, :3].reshape(chunks, own, 3)
    valid = torch.arange(chunks * own, device=p4.device).view(chunks, own) < n
    lo, hi = _box(rows, valid)
    if cfg.geom.cull_groups == 1:
        return (torch.zeros_like(valid, dtype=torch.long), lo[:, None],
                hi[:, None])
    ext = hi - lo
    axis = torch.where(ext[:, 1] > ext[:, 0], 1, 0)
    axis = torch.where(ext[:, 2] > ext.gather(1, axis[:, None])[:, 0], 2,
                       axis)
    coord = rows.gather(2, axis[:, None, None].expand(chunks, own, 1))[..., 0]
    key = torch.where(valid, _order_key(coord), 0xFFFFFFFF)
    key = key & ~(own - 1) | torch.arange(own, device=p4.device)
    rank = (key[:, None, :] < key[:, :, None]).sum(dim=-1)
    group = (rank >= own // 2).long()
    boxes = [_box(rows, valid & (group == g)) for g in (0, 1)]
    return (group, torch.stack([b[0] for b in boxes], 1),
            torch.stack([b[1] for b in boxes], 1))


def cull_survivors(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan,
                   n: int):
    """Yield (c0, group (b, own), keep (b, G, L) bool, idx (b, L), mask
    (b, L)) for runs of own-chunks from c0: keep[c, g, j] says that
    candidate j of chunk c (plan order; idx its row of p4, mask whether the
    chunk has a j-th candidate) survives the cull against group g's box
    (cull_groups), as `consume` in csrc/pbf_window.cu decides it, bit for
    bit: the squared distance from the box, each difference, product and
    sum rounded to float32 in turn, below h^2 * CULL_MARGIN."""
    own = cfg.geom.own
    group, lo, hi = cull_groups(cfg, p4, n)
    h2c = p4.new_full((), f32(cfg.h2)) * p4.new_full((), CULL_MARGIN)
    zero = p4.new_zeros(())
    lens = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1)
    for c0, c1 in _chunk_batches(lens.tolist(), own):
        idx, mask = _candidates(plan.ranges[c0:c1])
        cand = p4[idx][:, None, :, :3]
        e = torch.fmax(torch.fmax(lo[c0:c1, :, None] - cand,
                                  cand - hi[c0:c1, :, None]), zero)
        d = (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) \
            + e[..., 2] * e[..., 2]
        yield c0, group[c0:c1], (d < h2c) & mask[:, None], idx, mask


def cull_pair_evals(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan,
                    n: int) -> int:
    """The (own row, survivor) pairs that one launch of an FP32 pair kernel
    evaluates on these inputs, which it adds to its `evals` counter: each
    survivor meets the own / G rows of its group."""
    survivors = sum(int(keep.sum())
                    for _, _, keep, _, _ in cull_survivors(cfg, p4, plan, n))
    return survivors * (cfg.geom.own // cfg.geom.cull_groups)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan, n: int,
           out: torch.Tensor | None) -> None:
    own = cfg.geom.own
    n_pad = p4.shape[0]
    if p4.dtype != torch.float32 or p4.dim() != 2 or p4.shape[1] != 4:
        raise ValueError(f"p4 must be (n_pad, 4) float32, got "
                         f"{tuple(p4.shape)} {p4.dtype}")
    if n_pad % own or not 0 < n <= n_pad:
        raise ValueError(f"need 0 < n ({n}) <= n_pad ({n_pad}) and n_pad a "
                         f"multiple of own ({own})")
    r = plan.ranges
    if r.dtype != torch.int32 or tuple(r.shape) != (n_pad // own,
                                                    NUM_WINDOWS, 2):
        raise ValueError(f"plan.ranges must be ({n_pad // own}, 9, 2) int32, "
                         f"got {tuple(r.shape)} {r.dtype}")
    tensors = [p4, r] + ([] if out is None else [out])
    if out is not None and (out.shape != p4.shape or out.dtype != p4.dtype):
        raise ValueError("out must match p4's shape and dtype")
    if any(t.device != p4.device for t in tensors):
        raise ValueError("p4, plan and out must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("p4, plan.ranges and out must be contiguous")
    if out is not None and out.data_ptr() == p4.data_ptr():
        raise ValueError("out must not alias p4: other blocks still read it")


def _check_work(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan,
                scratch: PairScratch) -> None:
    """The pair kernels' extra inputs: the plan's work table and the
    scratch, shaped for p4 and on its device."""
    n_pad = p4.shape[0]
    num_chunks = n_pad // cfg.geom.own
    want = {
        "plan.seg_prefix": (plan.seg_prefix, (num_chunks + 1,), torch.int32),
        "plan.seg_len": (plan.seg_len, (), torch.int32),
        "scratch.partials": (scratch.partials, (ITEMS_PER_CHUNK * n_pad, 4),
                             torch.float32),
        "scratch.counters": (scratch.counters, (num_chunks + 2,),
                             torch.int32),
    }
    for name, (t, shape, dtype) in want.items():
        if t is None or tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != p4.device or not t.is_contiguous():
            got = None if t is None else (tuple(t.shape), t.dtype, t.device)
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} "
                             f"on {p4.device}, got {got}")


def _kernels_and_out(p4: torch.Tensor, out: torch.Tensor | None):
    from ..utils.cuda_build import load_kernels

    if p4.device.type != "cuda":
        raise ValueError(f"no kernel for device {p4.device}")
    kernels = load_kernels()
    if out is None:
        out = torch.zeros_like(p4)
    for t in (p4, out):
        if t.data_ptr() % 16:
            raise ValueError("the kernels read and write 16-byte float4 rows")
    return kernels, out, torch.cuda.current_stream(p4.device).cuda_stream


def _evals_ptr(evals: torch.Tensor | None, p4: torch.Tensor):
    """The FP32 kernels' `evals` argument: the counter's address, or None
    (a null pointer) for no counter."""
    if evals is None:
        return None
    if evals.dtype != torch.int64 or evals.dim() != 0 \
            or evals.device != p4.device:
        raise ValueError(f"evals must be a 0-dim int64 on {p4.device}, got "
                         f"{tuple(evals.shape)} {evals.dtype} "
                         f"{evals.device}")
    return evals.data_ptr()


def _launch(name: str, fn_name: str, cfg: SimConfig, p4: torch.Tensor,
            plan: WindowPlan, n: int, out: torch.Tensor | None,
            scratch: PairScratch | None, consts: tuple) -> torch.Tensor:
    """Launch the pair kernel `fn_name` (csrc/pbf_window.cu, whose `consts`
    end with the `evals` pointer, or csrc/pbf_tc.cu, whose `consts` lead
    with the pass's two switches) with (p4, out, ranges, seg_prefix,
    seg_len, partials, counters, n, chunks, own, *consts, stream), its
    scratch allocated here when None."""
    kernels, out, stream = _kernels_and_out(p4, out)
    if scratch is None:
        scratch = alloc_scratch(cfg, p4.shape[0], p4.device)
    _check_work(cfg, p4, plan, scratch)
    code = getattr(kernels.lib, fn_name)(
        p4.data_ptr(), out.data_ptr(), plan.ranges.data_ptr(),
        plan.seg_prefix.data_ptr(), plan.seg_len.data_ptr(),
        scratch.partials.data_ptr(), scratch.counters.data_ptr(), n,
        plan.ranges.shape[0], cfg.geom.own, *consts, stream)
    kernels.check(code, fn_name)
    count_launch(name, fn_name)
    return out


def density_consts(cfg: SimConfig) -> tuple:
    """The density kernels' float constants: (h, h^2, eps, poly6, l2,
    1 / rho0, relaxation eps)."""
    return (f32(cfg.h), f32(cfg.h2), f32(EPS), f32(cfg.poly6_coeff),
            f32(cfg.lambda_grad_coeff * cfg.lambda_grad_coeff),
            f32(cfg.inv_rho0), f32(cfg.relaxation_eps))


def rho_consts(cfg: SimConfig) -> tuple:
    """The rho output's float constants: (h^2, eps, poly6)."""
    return f32(cfg.h2), f32(EPS), f32(cfg.poly6_coeff)


def project_consts(cfg: SimConfig) -> tuple:
    """The project kernels' float constants: (h, h^2, eps, k, s_corr)."""
    return (f32(cfg.h), f32(cfg.h2), f32(EPS),
            f32(-cfg.spiky_grad_coeff * cfg.inv_rho0), f32(cfg.s_corr))


def density_pass(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan, n: int,
                 out: torch.Tensor | None = None,
                 scratch: PairScratch | None = None,
                 evals: torch.Tensor | None = None) -> torch.Tensor:
    """(n_pad, 4) positions -> (n_pad, 4) (x, y, z, lambda), first n rows.

    The port of K1, `_density_kernel` (pdb_sph_tpu/ops/pallas_pbf.py:424),
    with its `mxu_rd2` branch (:445) and `_ksum`'s `mxu_sum` (:318).
    CPU: density_pass_ref. CUDA: window_kernel<kLambda> in the default
    geometry, density_tc_kernel<mxu_rd2, mxu_sum> when either switch is
    on (the scratch of either allocated here when `scratch` is None); or
    raise. `window_kernel` adds the pairs it evaluated to `evals` when
    given; the plain version and the tensor-core forms count nothing."""
    _check(cfg, p4, plan, n, out)
    if p4.device.type == "cpu":
        return density_pass_ref(cfg, p4, plan, n, out)
    consts = density_consts(cfg)
    g = cfg.geom
    if g.mxu_rd2 or g.mxu_sum:
        name = "density_tc" + "_rd2" * g.mxu_rd2 + "_sum" * g.mxu_sum
        return _launch(name, "launch_density_tc", cfg, p4, plan, n, out,
                       scratch, (int(g.mxu_rd2), int(g.mxu_sum), *consts))
    return _launch("density_lambda", "launch_density_lambda", cfg, p4, plan,
                   n, out, scratch, (*consts, _evals_ptr(evals, p4)))


def density_rho(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan, n: int,
                out: torch.Tensor | None = None,
                scratch: PairScratch | None = None,
                evals: torch.Tensor | None = None) -> torch.Tensor:
    """(n_pad, 4) positions -> (n_pad, 4) (x, y, z, rho), first n rows.

    The diagnostic density through K1's kernel (its kRho instantiation), in
    float32 whatever the geometry's tensor-core switches say.
    CPU: density_rho_ref. CUDA: window_kernel<kRho>, or raise; the kernel
    adds the pairs it evaluated to `evals` when given."""
    _check(cfg, p4, plan, n, out)
    if p4.device.type == "cpu":
        return density_rho_ref(cfg, p4, plan, n, out)
    consts = rho_consts(cfg)
    return _launch("density_rho", "launch_density_rho", cfg, p4, plan, n,
                   out, scratch, (*consts, _evals_ptr(evals, p4)))


def project_pass(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan, n: int,
                 out: torch.Tensor | None = None,
                 scratch: PairScratch | None = None,
                 evals: torch.Tensor | None = None) -> torch.Tensor:
    """(n_pad, 4) positions with lambda -> projected (n_pad, 4), first n
    rows, lambda carried through.

    The port of K2, `_project_kernel` (pdb_sph_tpu/ops/pallas_pbf.py:477),
    with `_project_kernel_mxu` (:525) and `_ksum`'s `mxu_sum` (:318).
    CPU: project_pass_ref. CUDA: window_kernel<kProject> in the default
    geometry, project_tc_kernel<mxu_proj, mxu_sum> when either switch is
    on (the scratch of either allocated here when `scratch` is None); or
    raise. `window_kernel` adds the pairs it evaluated to `evals` when
    given."""
    _check(cfg, p4, plan, n, out)
    if p4.device.type == "cpu":
        return project_pass_ref(cfg, p4, plan, n, out)
    consts = project_consts(cfg)
    g = cfg.geom
    if g.mxu_proj or g.mxu_sum:
        name = "project_tc" + "_proj" * g.mxu_proj + "_sum" * g.mxu_sum
        return _launch(name, "launch_project_tc", cfg, p4, plan, n, out,
                       scratch, (int(g.mxu_proj), int(g.mxu_sum), *consts))
    return _launch("project", "launch_project", cfg, p4, plan, n, out,
                   scratch, (*consts, _evals_ptr(evals, p4)))


def solve(cfg: SimConfig, p_sorted: torch.Tensor, plan: WindowPlan,
          bufs: tuple[torch.Tensor, torch.Tensor] | None = None,
          mark=None, scratch: PairScratch | None = None,
          evals: torch.Tensor | None = None) -> torch.Tensor:
    """solver_iters Jacobi iterations of density -> project over the plan.

    p_sorted: (n, 3) cell-sorted predicted positions. `bufs`, two
    (n_pad, 4) float32 buffers the caller reuses across steps (allocated
    here when None), carry the ping-pong; their rows past n are never read.
    `scratch`, the pair kernels' scratch, is likewise the caller's to keep
    (allocated per pass on a card when None). Returns an (n, 3) view of the
    first buffer. `mark(name)`, if given, is called after each pass:
    "density", then "project" (stage timing, and the stage map of a
    capture, core/step.step_fn). `evals`, if given, gathers the pairs that
    the density passes' FP32 kernels evaluated (density_pass)."""
    n = p_sorted.shape[0]
    if bufs is None:
        n_pad = pad_to_chunks(cfg, n)
        bufs = tuple(torch.zeros((n_pad, 4), dtype=torch.float32,
                                 device=p_sorted.device) for _ in range(2))
    a, b = bufs
    a[:n, :3] = p_sorted
    for _ in range(cfg.solver_iters):
        density_pass(cfg, a, plan, n, out=b, scratch=scratch, evals=evals)
        if mark is not None:
            mark("density")
        project_pass(cfg, b, plan, n, out=a, scratch=scratch)
        if mark is not None:
            mark("project")
    return a[:n, :3]
