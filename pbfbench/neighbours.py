"""Neighbour pairs on a uniform grid of cubic cells, in plain torch.

The benchmark's own neighbour search, shared by the plain reference step
(`reference/pbf.py`) and the census of pairs within h (`work.py`). It knows
nothing of the program under test: particles are sorted by the id of their
cell (x fastest), and a particle's candidates are the particles of the 27
cells around its own, which on this layout are nine runs of the sorted
array, one per (dy, dz) row of three cells. Pairs are enumerated a block of
rows at a time, so that memory stays bounded at any n.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

# rows of a block: a block enumerates ~27 x (particles a cell) candidates a
# row, ~2,200 at the dam break's density, ~2.4 GB of int64 indices at this
# size
BLOCK_ROWS = 1 << 16


class Grid(NamedTuple):
    """Particles sorted by cell: `cell` (n,) int64 sorted ids, `start`
    (width^3 + 1,) the first sorted index of each cell, `width` cells a
    side."""

    cell: torch.Tensor
    start: torch.Tensor
    width: int


def cell_coords(cell: torch.Tensor, width: int):
    return cell % width, (cell // width) % width, cell // (width * width)


def make_grid(cell_sorted: torch.Tensor, width: int) -> Grid:
    """The grid of particles whose sorted cell ids are `cell_sorted`."""
    cells = torch.arange(width ** 3 + 1, device=cell_sorted.device)
    return Grid(cell_sorted, torch.searchsorted(cell_sorted, cells), width)


def _runs(grid: Grid, rows: slice):
    """(start, length) (b, 9) of each row's nine candidate runs."""
    w = grid.width
    cx, cy, cz = cell_coords(grid.cell[rows], w)
    x_lo = (cx - 1).clamp(min=0)
    x_hi = (cx + 1).clamp(max=w - 1)
    starts, lens = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            y, z = cy + dy, cz + dz
            inside = (y >= 0) & (y < w) & (z >= 0) & (z < w)
            base = (z.clamp(0, w - 1) * w + y.clamp(0, w - 1)) * w
            lo = grid.start[base + x_lo]
            hi = grid.start[base + x_hi + 1]
            starts.append(lo)
            lens.append(torch.where(inside, hi - lo, torch.zeros_like(lo)))
    return torch.stack(starts, 1), torch.stack(lens, 1)


def candidates(grid: Grid, rows: slice):
    """(i, j) int64: every candidate pair of the sorted rows `rows`, i
    ascending, each row's candidates in cell order; the row itself is among
    its own candidates."""
    start, lens = _runs(grid, rows)
    lens = lens.reshape(-1)
    total = int(lens.sum())
    first = torch.cumsum(lens, 0) - lens
    j = torch.repeat_interleave(start.reshape(-1) - first, lens,
                                output_size=total)
    j += torch.arange(total, device=j.device)
    i = torch.repeat_interleave(
        torch.arange(rows.start, rows.stop, device=j.device),
        lens.view(-1, 9).sum(1), output_size=total)
    return i, j


def near_pairs(grid: Grid, q: torch.Tensor, h2: float,
               block_rows: int = BLOCK_ROWS
               ) -> Iterator[tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]]:
    """Yield (i, j, d, rd2) for the candidate pairs with |q_i - q_j|^2 <
    h2, a block of rows at a time: d = q_i - q_j (m, 3), rd2 its squared
    length. `q` is in the grid's sorted order; it may have moved since the
    grid was made, so that the candidates are those of the cells the grid
    was made from, and the distance is always the current one."""
    n = q.shape[0]
    for r0 in range(0, n, block_rows):
        i, j = candidates(grid, slice(r0, min(n, r0 + block_rows)))
        d = q[i] - q[j]
        rd2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        keep = torch.nonzero(rd2 < h2).squeeze(1)
        yield i[keep], j[keep], d[keep], rd2[keep]
