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
