"""Cell ids, the sort by cell, and the cell table of the `cell` backend.

The torch counterpart of `pdb_sph_tpu/ops/hashgrid.py`: `cell_ids` and
`sort_by_cell` feed every backend; `build_grid`, `scatter_table`,
`gather_table` and `slot_masks` build and read the compact cell table of
the `cell` backend (`ops/cell_list.py`): a (max_occupied_cells + 1,
cell_capacity) layout, one row per occupied cell, the last row an
all-empty sentinel. Particles that do not fit (more occupied cells than
rows, more particles in a cell than slots) are dropped from the table and
counted in `CellGrid.n_overflow`.

JAX's scatters with `mode="drop"` become scatters into one spare slot past
the end, which is then sliced off; `jax.lax.cummax` is `torch.cummax`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from .smoothing import f32

# 27-stencil offsets, x fastest (pdb_sph_tpu/ops/hashgrid.py:36)
OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]


class CellGrid(NamedTuple):
    """Per-step neighbour structure over the sorted particle order; every
    index field is int64, ready for indexing (JAX keeps int32)."""

    order: torch.Tensor       # (n,) sorted index -> pre-sort index
    sorted_cid: torch.Tensor  # (n,) cell id per sorted particle
    row: torch.Tensor         # (n,) compact occupied-cell row (may be >= max_occ)
    col: torch.Tensor         # (n,) slot within the cell (may be >= capacity)
    counts: torch.Tensor      # (max_occ + 1,) particles per row; sentinel row 0
    nbr: torch.Tensor         # (max_occ, 27) row of each neighbour cell,
                              # max_occ (the sentinel) when empty or off-grid
    n_overflow: torch.Tensor  # () int32, particles dropped from the table


def cell_ids(cfg: SimConfig, p: torch.Tensor) -> torch.Tensor:
    """(n, 3) positions -> (n,) int32 linear cell id on the internal grid,
    x fastest, each axis clamped into [0, W).

    Clamping before the integer conversion gives JAX's floor, convert and
    clamp result without relying on how an out-of-range float converts to
    int32; once clamped into [0, W - 1], the conversion's truncation is the
    floor. A NaN coordinate goes to 0, as JAX converts it: the clamp keeps
    NaN, which the CPU would convert to INT_MIN and the card to 0, so
    nan_to_num takes the place of the floor."""
    w = cfg.nb_grid_width
    ijk = torch.nan_to_num(p * f32(1.0 / cfg.nb_cell), nan=0.0)
    ijk = ijk.clamp_(0, w - 1).to(torch.int32)
    return ijk[:, 0] + w * ijk[:, 1] + (w * w) * ijk[:, 2]


def sort_by_cell(cfg: SimConfig, cid: torch.Tensor):
    """(sorted_cid, order): a stable sort, so the port is deterministic
    (JAX's lax.sort is not stable; compare the two after un-sorting by id).
    `order` is int64, ready for indexing."""
    return torch.sort(cid, stable=True)


def build_grid(cfg: SimConfig, sorted_cid: torch.Tensor, order: torch.Tensor,
               ignore_cell: int | None = None) -> CellGrid:
    """The compact occupied-cell structure from sorted cell ids
    (pdb_sph_tpu/ops/hashgrid.py:76-149).

    `ignore_cell`: a cell id whose occupants stay out of the table and out
    of the overflow count (the sharded path parks inactive slots there)."""
    n = sorted_cid.shape[0]
    max_occ, cap = cfg.max_occupied_cells, cfg.cell_capacity
    dev = sorted_cid.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    cid = sorted_cid.long()

    is_start = torch.ones((n,), dtype=torch.bool, device=dev)
    is_start[1:] = cid[1:] != cid[:-1]
    row = torch.cumsum(is_start, 0) - 1
    seg_start = torch.where(is_start, iota, 0).cummax(0).values
    col = iota - seg_start

    in_table = (row < max_occ) & (col < cap)
    counted = torch.ones_like(in_table)
    if ignore_cell is not None:
        counted = cid != ignore_cell
        in_table = in_table & counted
    # rows past the table go to the spare row max_occ + 1, sliced off below
    scatter_row = torch.where(in_table, row, max_occ + 1)
    counts = torch.zeros((max_occ + 2,), dtype=torch.int32, device=dev)
    counts.index_add_(0, scatter_row,
                      torch.ones((n,), dtype=torch.int32, device=dev))
    counts = counts[:max_occ + 1]

    occ_cid = torch.full((max_occ + 2,), -1, dtype=torch.int64, device=dev)
    occ_cid = occ_cid.scatter_(0, scatter_row, cid)[:max_occ]

    num_cells = cfg.num_nb_cells
    cell_to_row = torch.full((num_cells + 2,), max_occ, dtype=torch.int64,
                             device=dev)
    cell_to_row.scatter_(
        0, torch.where(occ_cid >= 0, occ_cid, num_cells + 1),
        torch.arange(max_occ, dtype=torch.int64, device=dev))
    cell_to_row = cell_to_row[:num_cells]

    w = cfg.nb_grid_width
    cx, cy, cz = occ_cid % w, (occ_cid // w) % w, occ_cid // (w * w)
    cols = []
    for dx, dy, dz in OFFSETS:
        nx, ny, nz = cx + dx, cy + dy, cz + dz
        valid = ((occ_cid >= 0) & (nx >= 0) & (nx < w) & (ny >= 0) & (ny < w)
                 & (nz >= 0) & (nz < w))
        nrow = cell_to_row[torch.where(valid, nx + w * ny + (w * w) * nz, 0)]
        cols.append(torch.where(valid, nrow, max_occ))
    nbr = torch.stack(cols, dim=1)

    n_overflow = (~in_table & counted).sum().to(torch.int32)
    return CellGrid(order=order, sorted_cid=sorted_cid, row=row, col=col,
                    counts=counts, nbr=nbr, n_overflow=n_overflow)


def _table_slot(cfg: SimConfig, grid: CellGrid):
    """(flat slot of each sorted particle in the (max_occ + 1) x capacity
    table, or the spare slot past its end; whether the particle has a
    slot). JAX scatters by row < max_occ and col < capacity, not by
    `in_table`: an ignored cell's particles take slots of a row whose count
    is 0, which `slot_masks` never marks valid."""
    max_occ, cap = cfg.max_occupied_cells, cfg.cell_capacity
    ok = (grid.row < max_occ) & (grid.col < cap)
    spare = (max_occ + 1) * cap
    return torch.where(ok, grid.row * cap + grid.col, spare), ok


def scatter_table(cfg: SimConfig, grid: CellGrid,
                  vals_sorted: torch.Tensor) -> torch.Tensor:
    """(n,) sorted values -> (max_occ + 1, capacity) table; dropped
    particles leave no trace, the sentinel row stays zero."""
    max_occ, cap = cfg.max_occupied_cells, cfg.cell_capacity
    slot, _ = _table_slot(cfg, grid)
    flat = vals_sorted.new_zeros(((max_occ + 1) * cap + 1,))
    flat.scatter_(0, slot, vals_sorted)
    return flat[:-1].view(max_occ + 1, cap)


def gather_table(cfg: SimConfig, grid: CellGrid, table: torch.Tensor,
                 fallback: torch.Tensor) -> torch.Tensor:
    """Table layout back to (n,) sorted order; dropped particles take
    `fallback`."""
    slot, ok = _table_slot(cfg, grid)
    vals = table.reshape(-1)[torch.where(ok, slot, 0)]
    return torch.where(ok, vals, fallback)


def slot_masks(cfg: SimConfig, grid: CellGrid) -> torch.Tensor:
    """(max_occ + 1, capacity) bool: the table slots that hold particles."""
    lane = torch.arange(cfg.cell_capacity, device=grid.counts.device)
    counts = grid.counts.clamp(max=cfg.cell_capacity)
    return lane[None, :] < counts[:, None]
