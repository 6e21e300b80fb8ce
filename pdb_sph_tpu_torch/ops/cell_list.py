"""The `cell` backend: the two PBF passes over the cell table, plain torch.

The counterpart of `pdb_sph_tpu/ops/cell_list.py`. Positions and lambdas
live in cell-table layout, (max_occupied_cells + 1, cell_capacity), for the
whole Jacobi loop; each occupied row meets the rows of its 27 neighbour
cells as dense (capacity x capacity) pair blocks. No TPU kernel sits
behind it: the JAX package's portable backend and its parity reference.

JAX maps over 8 rows at a time to bound TPU memory; here a batch takes as
many rows as keep one (rows, capacity, capacity) float32 pair block within
PAIR_BLOCK_BYTES. Each row still adds its 27 offsets in order k = 0..26,
so every row's arithmetic is JAX's.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from . import smoothing
from .hashgrid import CellGrid, gather_table, scatter_table, slot_masks
from .smoothing import f32

# bytes of one (rows, capacity, capacity) float32 pair block per batch
PAIR_BLOCK_BYTES = 64 << 20


def _row_batches(cfg: SimConfig, device):
    """Consecutive row ranges of the table's max_occ occupied-cell rows."""
    max_occ, cap = cfg.max_occupied_cells, cfg.cell_capacity
    rows = max(1, PAIR_BLOCK_BYTES // (4 * cap * cap))
    for r0 in range(0, max_occ, rows):
        yield torch.arange(r0, min(r0 + rows, max_occ), device=device)


def _pair_terms(cfg: SimConfig, tables, valid, grid: CellGrid, rows):
    """Yield (dx, dy, dz, rd2, mask, k-th neighbour row indices) for the 27
    offsets of the batch `rows`, in order."""
    tx, ty, tz = tables
    ox, oy, oz = tx[rows], ty[rows], tz[rows]
    ovalid = valid[rows]
    nbr = grid.nbr[rows]
    h2 = f32(cfg.h2)
    for k in range(27):
        nb = nbr[:, k]
        dx = ox[:, :, None] - tx[nb][:, None, :]
        dy = oy[:, :, None] - ty[nb][:, None, :]
        dz = oz[:, :, None] - tz[nb][:, None, :]
        rd2 = dx * dx + dy * dy + dz * dz
        mask = ovalid[:, :, None] & valid[nb][:, None, :] & (rd2 < h2)
        yield dx, dy, dz, rd2, mask, nb


def _with_sentinel(cfg: SimConfig, t: torch.Tensor) -> torch.Tensor:
    """(max_occ, cap) -> (max_occ + 1, cap) with a zero sentinel row."""
    return torch.cat([t, t.new_zeros((1, cfg.cell_capacity))])


def density_lambda_tables(cfg: SimConfig, tx, ty, tz, grid: CellGrid):
    """lambda in table layout from position tables (computeDensity)."""
    valid = slot_masks(cfg, grid)
    lam = torch.empty((cfg.max_occupied_cells, cfg.cell_capacity),
                      dtype=tx.dtype, device=tx.device)
    for rows in _row_batches(cfg, tx.device):
        rho = torch.zeros_like(tx[rows])
        g2 = torch.zeros_like(rho)
        for _, _, _, rd2, mask, _ in _pair_terms(cfg, (tx, ty, tz), valid,
                                                 grid, rows):
            w, gg = smoothing.density_terms(cfg, rd2, mask)
            rho = rho + w.sum(dim=-1)
            g2 = g2 + gg.sum(dim=-1)
        lam[rows] = smoothing.lambda_from_sums(cfg, rho, g2)
    return _with_sentinel(cfg, lam)


def project_tables(cfg: SimConfig, tx, ty, tz, tlam, grid: CellGrid):
    """delta-p tables from position and lambda tables
    (projectDensityConstraint)."""
    valid = slot_masks(cfg, grid)
    out = [torch.empty((cfg.max_occupied_cells, cfg.cell_capacity),
                       dtype=tx.dtype, device=tx.device) for _ in range(3)]
    for rows in _row_batches(cfg, tx.device):
        olam = tlam[rows]
        acc = [torch.zeros_like(olam) for _ in range(3)]
        for dx, dy, dz, rd2, mask, nb in _pair_terms(cfg, (tx, ty, tz), valid,
                                                     grid, rows):
            s = smoothing.delta_p_scale(cfg, rd2, olam[:, :, None],
                                        tlam[nb][:, None, :], mask)
            acc = [a + (s * d).sum(dim=-1) for a, d in zip(acc, (dx, dy, dz))]
        for o, a in zip(out, acc):
            o[rows] = a
    return tuple(_with_sentinel(cfg, o) for o in out)


def density_tables(cfg: SimConfig, tx, ty, tz, grid: CellGrid):
    """rho alone, in table layout, for the diagnostics."""
    valid = slot_masks(cfg, grid)
    rho = torch.empty((cfg.max_occupied_cells, cfg.cell_capacity),
                      dtype=tx.dtype, device=tx.device)
    for rows in _row_batches(cfg, tx.device):
        acc = torch.zeros_like(tx[rows])
        for _, _, _, rd2, mask, _ in _pair_terms(cfg, (tx, ty, tz), valid,
                                                 grid, rows):
            acc = acc + smoothing.density_terms(cfg, rd2, mask)[0].sum(dim=-1)
        rho[rows] = acc
    return _with_sentinel(cfg, rho)


def position_tables(cfg: SimConfig, grid: CellGrid, p_sorted: torch.Tensor):
    """(tx, ty, tz): the sorted (n, 3) positions in table layout."""
    return tuple(scatter_table(cfg, grid, p_sorted[:, a]) for a in range(3))


def solve_cell_list(cfg: SimConfig, p_sorted: torch.Tensor,
                    grid: CellGrid) -> torch.Tensor:
    """solver_iters Jacobi iterations in table layout; (n, 3) positions in
    sorted order back. Particles the table dropped keep their predicted
    position (counted in grid.n_overflow)."""
    tx, ty, tz = position_tables(cfg, grid, p_sorted)
    for _ in range(cfg.solver_iters):
        tlam = density_lambda_tables(cfg, tx, ty, tz, grid)
        ddx, ddy, ddz = project_tables(cfg, tx, ty, tz, tlam, grid)
        tx, ty, tz = tx + ddx, ty + ddy, tz + ddz
    return torch.stack([gather_table(cfg, grid, t, p_sorted[:, a])
                        for a, t in enumerate((tx, ty, tz))], dim=1)
