"""The plain reference of a Position Based Fluids step over the chunk
windows' pair set, in plain torch.

`pbf.py`'s step with one change, the pair set. The CUDA solver of
github.com/jakymiws/pdb-sph (src/FluidSimulator.cu), which `pbf.py`
follows, sums over the pairs within h among the 27 cells around each
particle's predicted cell. The program under test, like the engine it was
ported from, takes a particle's candidates from the chunk of rows it
belongs to. This reference sums over the pairs (i, j) with

    |q_i - q_j|^2 < h^2                  at the solve's current iterate q
    cell(j) in [c_first + off - 1, c_last + off + 1]   for one of nine off

where cell(j) is j's predicted cell (the cell it was sorted by), the chunk
is i's block of `own` consecutive rows of the stable cell sort (`own`: the
configuration's `geometry`, the last chunk holding what is left),
c_first is the cell of the chunk's first row, c_last the largest cell of
its rows, off = dy W + dz W^2 for dy, dz in {-1, 0, 1} on the neighbour
grid of width W, and each range is clamped to the grid's cells [0, W^3 -
1] (which every cell id lies in, so the clamp changes no test).

Since c_first <= cell(i) <= c_last, each range holds the three cells of
i's own (dy, dz) row of the 27, and the set holds the 27 cells' pairs:
it departs from the CUDA source only by pairs whose partner was sorted
into a cell beyond the 27 around i's but within its chunk's span. In a
settled flow a pair that comes within h lies in the 27 cells, so the two
sets agree; in the first steps of an explosion, where the solve moves
particles by several h, they differ in most particles.

The pairs are found on a grid of cells of side h made from q itself
(every pair within h lies in the 27 cells around q_i's cell of that grid)
and kept where the partner's predicted cell passes the window test, a
bounded block of candidates at a time (`pairs`), so that memory stays
bounded at 1M particles at any density. Every other part (predict, the
cell sort, the pair terms in float32 with a particle's sums in float64,
finalize and its walls) is `pbf.py`'s.
"""

from __future__ import annotations

from typing import Iterator

import torch

from .. import neighbours
from .pbf import Constants, _walls, cell_of, predict

# candidates a block of rows enumerates at most: ~40 B each (two int64
# indices, the difference and its length, the window test), ~2.7 GB
BLOCK_CANDIDATES = 1 << 26


def windows(k: Constants, cell: torch.Tensor, own: int):
    """(lo, hi): (chunks, 9) int64 first and last cell of each chunk's nine
    cell ranges, clamped to the grid, for the rows' sorted predicted cells
    `cell`."""
    n, w = cell.shape[0], k.width
    chunks = -(-n // own)
    first = torch.arange(chunks, device=cell.device) * own
    last = torch.clamp(first + own, max=n) - 1
    c_first, c_last = cell[first], cell[last]
    off = torch.tensor([dz * w * w + dy * w for dz in (-1, 0, 1)
                        for dy in (-1, 0, 1)], device=cell.device)
    lo = (c_first[:, None] + off - 1).clamp(0, w ** 3 - 1)
    hi = (c_last[:, None] + off + 1).clamp(0, w ** 3 - 1)
    return lo, hi


def in_windows(lo: torch.Tensor, hi: torch.Tensor, own: int,
               i: torch.Tensor, cell_j: torch.Tensor) -> torch.Tensor:
    """Whether each partner's predicted cell `cell_j` lies in one of the
    nine ranges of row i's chunk."""
    c = i // own
    j = cell_j[:, None]
    return ((j >= lo[c]) & (j <= hi[c])).any(dim=1)


def pairs(k: Constants, cell: torch.Tensor, lo: torch.Tensor,
          hi: torch.Tensor, own: int, q: torch.Tensor
          ) -> Iterator[tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]]:
    """Yield (i, j, d, rd2) of the set's pairs at the iterate q (rows in
    the step's sorted order), a block at a time: d = q_i - q_j, rd2 its
    squared length."""
    qcell, perm = torch.sort(cell_of(k, q), stable=True)
    grid = neighbours.make_grid(qcell, k.width)
    fullest = int((grid.start[1:] - grid.start[:-1]).max())
    rows = max(1, BLOCK_CANDIDATES // (27 * max(1, fullest)))
    for a, b, d, rd2 in neighbours.near_pairs(grid, q[perm], k.h2, rows):
        i, j = perm[a], perm[b]
        keep = torch.nonzero(in_windows(lo, hi, own, i, cell[j])).squeeze(1)
        yield i[keep], j[keep], d[keep], rd2[keep]


def _lambda(k: Constants, near, q: torch.Tensor) -> torch.Tensor:
    n = q.shape[0]
    rho = torch.zeros(n, dtype=torch.float64, device=q.device)
    g2 = torch.zeros_like(rho)
    for i, _, _, rd2 in near():
        t = k.h2 - rd2
        u = k.h - torch.sqrt(rd2)
        rho.index_add_(0, i, (t * t * t).double())
        g2.index_add_(0, i, (u * u * u * u * rd2).double())
    rho = k.poly6 * rho.float()
    c = rho * k.inv_rho0 - 1.0
    return -c / (k.grad2 * g2.float() + k.eps_relax)


def _project(k: Constants, near, q: torch.Tensor,
             lam: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros((q.shape[0], 3), dtype=torch.float64, device=q.device)
    for i, j, d, rd2 in near():
        u = k.h - torch.sqrt(rd2)
        s = u * u * (lam[i] + lam[j] + k.s_corr)
        acc.index_add_(0, i, (s[:, None] * d).double())
    return q + k.k_proj * acc.float()


def step(config: dict, x: torch.Tensor, v: torch.Tensor,
         ids: torch.Tensor) -> dict:
    """One step from positions `x`, velocities `v` and particle ids `ids`
    (any order, float32, on any device), as `pbf.step` returns it: the
    next state in cell order, `x`, `v`, `ids`, `nonfinite` and
    `at_wall`."""
    k = Constants(config)
    own = int(config["geometry"]["own"])
    p = predict(k, x, v)
    cell, order = torch.sort(cell_of(k, p), stable=True)
    lo, hi = windows(k, cell, own)
    last = x[order]
    q = p[order]
    for _ in range(k.iters):
        def near(q=q):
            return pairs(k, cell, lo, hi, own, q)
        q = _project(k, near, q, _lambda(k, near, q))
    v_new = (q - last) / k.dt
    x_new, v_new, at_wall = _walls(k, q, v_new)
    finite = bool(torch.isfinite(x_new).all() and torch.isfinite(v_new).all())
    return {"x": x_new, "v": v_new, "ids": ids[order], "nonfinite": not finite,
            "at_wall": at_wall}
