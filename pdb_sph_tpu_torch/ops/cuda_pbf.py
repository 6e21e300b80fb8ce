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
diagnostics (core/step.diagnostics_fn), through the same kernel body.

Each pass is a wrapper that dispatches on the tensor's device: a CPU tensor
goes to the plain torch version beside it (`*_ref`), a CUDA tensor launches
the hand-written kernel in `csrc/pbf_window.cu`, or raises. `LAUNCHES`
counts the kernel launches of each wrapper, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from . import smoothing
from .smoothing import EPS, f32

NUM_WINDOWS = 9

# Kernel launches per wrapper since the last reset_launches(); the plain
# versions never count.
LAUNCHES = {"density_lambda": 0, "density_rho": 0, "project": 0}

# (own rows x candidates) pair elements per batch of the plain versions
_REF_PAIRS_PER_BATCH = 1 << 22


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class WindowPlan(NamedTuple):
    """Per-step candidate plan, built once from the step's sorted cell ids.

    ranges: (num_chunks, 9, 2) int32 — disjoint [start, end) ranges of the
        sorted array, ascending; empty ranges have start == end.
    n_overflow: () int32 — always 0, kept so the step's stats vector keeps
        the JAX layout [table_overflow, plan_overflow, nonfinite]: the plan
        has no capacity, since the kernels loop over each range whatever
        its length, so nothing can be truncated.
    """

    ranges: torch.Tensor
    n_overflow: torch.Tensor


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


def build_plan(cfg: SimConfig, sorted_cid: torch.Tensor) -> WindowPlan:
    """sorted_cid: (n_pad,) int32 sorted cell ids, padding = num_nb_cells.

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
    w = cfg.nb_grid_width
    ncells = cfg.num_nb_cells
    dev = sorted_cid.device

    chunk_cid = sorted_cid[: num_chunks * own].view(num_chunks, own)
    c_first = chunk_cid[:, 0]
    c_last = torch.where(chunk_cid < ncells, chunk_cid,
                         torch.full_like(chunk_cid, -1)).amax(dim=1)

    offsets = torch.tensor(
        [dz * w * w + dy * w for dz in (-1, 0, 1) for dy in (-1, 0, 1)],
        dtype=torch.int32, device=dev)
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
    return WindowPlan(ranges=ranges,
                      n_overflow=torch.zeros((), dtype=torch.int32,
                                             device=dev))


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


def _pair_blocks(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan, n: int):
    """Yield (row0, own (b, own, 4), dx, dy, dz, rd2 clamped, mask,
    cand (b, L, 4)) for batches of chunks: the plain version of the
    kernels' candidate streaming, with the same clamped pair distance."""
    own = cfg.geom.own
    num_chunks = plan.ranges.shape[0]
    lens = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1)
    longest = max(int(lens.max()), 1)
    batch = max(1, _REF_PAIRS_PER_BATCH // (own * longest))
    # fmin/fmax, not clamp: a NaN rd2 becomes h^2 and adds nothing, as the
    # kernels' fminf/fmaxf make it
    h2 = torch.tensor(f32(cfg.h2), device=p4.device)
    eps = torch.tensor(f32(EPS), device=p4.device)
    for c0 in range(0, min(num_chunks, -(-n // own)), batch):
        c1 = min(c0 + batch, num_chunks)
        mine = p4[c0 * own:c1 * own].view(c1 - c0, own, 4)
        idx, mask = _candidates(plan.ranges[c0:c1])
        cand = p4[idx]
        dx = mine[:, :, None, 0] - cand[:, None, :, 0]
        dy = mine[:, :, None, 1] - cand[:, None, :, 1]
        dz = mine[:, :, None, 2] - cand[:, None, :, 2]
        rd2 = dx * dx + dy * dy + dz * dz
        rd2 = torch.fmax(torch.fmin(rd2, h2), eps)
        yield c0 * own, mine, dx, dy, dz, rd2, mask[:, None, :], cand


def _store(out: torch.Tensor, row0: int, rows: torch.Tensor, n: int) -> None:
    """Write a batch's (b, own, 4) results to out rows [row0, n)."""
    rows = rows.reshape(-1, 4)
    stop = min(row0 + rows.shape[0], n)
    out[row0:stop] = rows[: stop - row0]


def density_pass_ref(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan,
                     n: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the density kernel: (n_pad, 4) positions ->
    (n_pad, 4) with column 3 = lambda for the first n rows."""
    if out is None:
        out = torch.zeros_like(p4)
    h, h2 = f32(cfg.h), f32(cfg.h2)
    l2 = f32(cfg.lambda_grad_coeff * cfg.lambda_grad_coeff)
    for row0, mine, _, _, _, rd2, mask, _ in _pair_blocks(cfg, p4, plan, n):
        t = h2 - rd2
        u = h - rd2 * torch.rsqrt(rd2)
        t2 = t * t
        u2 = u * u
        zero = torch.zeros_like(rd2)
        s_rho = torch.where(mask, t2 * t, zero).sum(dim=-1)
        s_g2 = torch.where(mask, (u2 * u2) * rd2, zero).sum(dim=-1)
        lam = smoothing.lambda_from_sums(
            cfg, f32(cfg.poly6_coeff) * s_rho, l2 * s_g2)
        _store(out, row0, torch.cat([mine[..., :3], lam[..., None]], -1), n)
    return out


def density_rho_ref(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan,
                    n: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the density kernel's rho output: (n_pad, 4)
    positions -> (n_pad, 4) with column 3 = rho for the first n rows."""
    if out is None:
        out = torch.zeros_like(p4)
    h2 = f32(cfg.h2)
    for row0, mine, _, _, _, rd2, mask, _ in _pair_blocks(cfg, p4, plan, n):
        t = h2 - rd2
        s_rho = torch.where(mask, (t * t) * t, torch.zeros_like(rd2)).sum(-1)
        rho = f32(cfg.poly6_coeff) * s_rho
        _store(out, row0, torch.cat([mine[..., :3], rho[..., None]], -1), n)
    return out


def project_pass_ref(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan,
                     n: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of the project kernel: (n_pad, 4) positions with
    lambda -> (n_pad, 4) projected positions, lambda carried through, for
    the first n rows."""
    if out is None:
        out = torch.zeros_like(p4)
    h = f32(cfg.h)
    k_proj = f32(-cfg.spiky_grad_coeff * cfg.inv_rho0)
    s_corr = f32(cfg.s_corr)
    for row0, mine, dx, dy, dz, rd2, mask, cand in _pair_blocks(
            cfg, p4, plan, n):
        u = h - rd2 * torch.rsqrt(rd2)
        olam = mine[..., 3] + s_corr
        s = (u * u) * (olam[:, :, None] + cand[:, None, :, 3])
        s = torch.where(mask, s, torch.zeros_like(s))
        moved = [mine[..., a] + k_proj * (s * d).sum(dim=-1)
                 for a, d in enumerate((dx, dy, dz))]
        _store(out, row0, torch.stack([*moved, mine[..., 3]], dim=-1), n)
    return out


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


def _launch(name: str, fn_name: str, cfg: SimConfig, p4: torch.Tensor,
            plan: WindowPlan, n: int, out: torch.Tensor | None,
            consts: tuple) -> torch.Tensor:
    from ..utils.cuda_build import load_kernels

    if p4.device.type != "cuda":
        raise ValueError(f"no kernel for device {p4.device}")
    kernels = load_kernels()
    if out is None:
        out = torch.zeros_like(p4)
    for t in (p4, out):
        if t.data_ptr() % 16:
            raise ValueError("the kernels read and write 16-byte float4 rows")
    g = cfg.geom
    stream = torch.cuda.current_stream(p4.device).cuda_stream
    code = getattr(kernels.lib, fn_name)(
        p4.data_ptr(), out.data_ptr(), plan.ranges.data_ptr(), n,
        plan.ranges.shape[0], g.threads, g.tile, *consts, stream)
    kernels.check(code, fn_name)
    LAUNCHES[name] += 1
    return out


def density_pass(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan, n: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """(n_pad, 4) positions -> (n_pad, 4) (x, y, z, lambda), first n rows.

    The port of K1, `_density_kernel` (pdb_sph_tpu/ops/pallas_pbf.py:424).
    CPU: density_pass_ref. CUDA: density_lambda_kernel, or raise."""
    _check(cfg, p4, plan, n, out)
    if p4.device.type == "cpu":
        return density_pass_ref(cfg, p4, plan, n, out)
    consts = (f32(cfg.h), f32(cfg.h2), f32(EPS), f32(cfg.poly6_coeff),
              f32(cfg.lambda_grad_coeff * cfg.lambda_grad_coeff),
              f32(cfg.inv_rho0), f32(cfg.relaxation_eps))
    return _launch("density_lambda", "launch_density_lambda", cfg, p4, plan,
                   n, out, consts)


def density_rho(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan, n: int,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """(n_pad, 4) positions -> (n_pad, 4) (x, y, z, rho), first n rows.

    The diagnostic density through K1's body (its kRho instantiation).
    CPU: density_rho_ref. CUDA: density_lambda_kernel<kRho>, or raise."""
    _check(cfg, p4, plan, n, out)
    if p4.device.type == "cpu":
        return density_rho_ref(cfg, p4, plan, n, out)
    consts = (f32(cfg.h2), f32(EPS), f32(cfg.poly6_coeff))
    return _launch("density_rho", "launch_density_rho", cfg, p4, plan, n,
                   out, consts)


def project_pass(cfg: SimConfig, p4: torch.Tensor, plan: WindowPlan, n: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """(n_pad, 4) positions with lambda -> projected (n_pad, 4), first n
    rows, lambda carried through.

    The port of K2, `_project_kernel` (pdb_sph_tpu/ops/pallas_pbf.py:477).
    CPU: project_pass_ref. CUDA: project_kernel, or raise."""
    _check(cfg, p4, plan, n, out)
    if p4.device.type == "cpu":
        return project_pass_ref(cfg, p4, plan, n, out)
    consts = (f32(cfg.h), f32(cfg.h2), f32(EPS),
              f32(-cfg.spiky_grad_coeff * cfg.inv_rho0), f32(cfg.s_corr))
    return _launch("project", "launch_project", cfg, p4, plan, n, out, consts)


def solve(cfg: SimConfig, p_sorted: torch.Tensor, plan: WindowPlan,
          bufs: tuple[torch.Tensor, torch.Tensor] | None = None,
          mark=None) -> torch.Tensor:
    """solver_iters Jacobi iterations of density -> project over the plan.

    p_sorted: (n, 3) cell-sorted predicted positions. `bufs`, two
    (n_pad, 4) float32 buffers the caller reuses across steps (allocated
    here when None), carry the ping-pong; their rows past n are never read.
    Returns an (n, 3) view of the first buffer. `mark(name)`, if given, is
    called after each pass (stage timing)."""
    n = p_sorted.shape[0]
    if bufs is None:
        n_pad = pad_to_chunks(cfg, n)
        bufs = tuple(torch.zeros((n_pad, 4), dtype=torch.float32,
                                 device=p_sorted.device) for _ in range(2))
    a, b = bufs
    a[:n, :3] = p_sorted
    for _ in range(cfg.solver_iters):
        density_pass(cfg, a, plan, n, out=b)
        if mark is not None:
            mark("density")
        project_pass(cfg, b, plan, n, out=a)
        if mark is not None:
            mark("project")
    return a[:n, :3]
