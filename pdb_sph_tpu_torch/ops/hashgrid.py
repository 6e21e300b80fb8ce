"""Cell ids and the sort by cell: the neighbour structure of the main path.

The torch counterpart of `cell_ids` and `sort_by_cell` in
`pdb_sph_tpu/ops/hashgrid.py`. The cell-table functions of that module
belong to the JAX `cell` backend, which the port does not have.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from .smoothing import f32


def cell_ids(cfg: SimConfig, p: torch.Tensor) -> torch.Tensor:
    """(n, 3) positions -> (n,) int32 linear cell id on the internal grid,
    x fastest, each axis clamped into [0, W).

    Clamping before the integer conversion gives JAX's clamp-after-convert
    result for every finite input without relying on how an out-of-range
    float converts to int32."""
    w = cfg.nb_grid_width
    ijk = torch.floor(p * f32(1.0 / cfg.nb_cell)).clamp(0, w - 1)
    ijk = ijk.to(torch.int32)
    return ijk[:, 0] + w * ijk[:, 1] + (w * w) * ijk[:, 2]


def sort_by_cell(cfg: SimConfig, cid: torch.Tensor):
    """(sorted_cid, order): a stable sort, so the port is deterministic
    (JAX's lax.sort is not stable; compare the two after un-sorting by id).
    `order` is int64, ready for indexing."""
    return torch.sort(cid, stable=True)
