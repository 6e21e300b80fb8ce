"""The work a step needs, counted by the benchmark, and the card's peaks.

The pair work of a PBF step is what the physics needs, whatever kernels
implement it: every ordered pair (i, j) of particles closer than h, each
particle's pair with itself included, goes through the lambda pass and the
position pass of each Jacobi iteration. A plan that streams candidates
beyond h, and the order or place in which a program sums, do not change it.
The pairs are counted by `pairs_within` (the census) on positions that the
benchmark holds, with its own neighbour search (`neighbours.py`).

Flops of one pair, by the reference's formulas (reference/pbf.py):
- lambda pass, 17: d = p_i - p_j 3, r^2 5, (h^2 - r^2)^3 3 and its sum 1,
  r 1, (h - r)^2 2, (h - r)^4 r^2 1 more and its sum 1.
- position pass, 19: d 3, r^2 5, r 1, (h - r)^2 2, lam_i + lam_j + s_corr
  2, their product 1, its product with d 3 and the sum 3.
Bytes of one particle and iteration, each input read once and each output
written once: the lambda pass reads p (12 B) and writes lambda (4 B), the
position pass reads p and lambda (16 B) and writes p (12 B): 44.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from . import neighbours

LAMBDA_FLOPS_PER_PAIR = 17
PROJECT_FLOPS_PER_PAIR = 19
BYTES_PER_PARTICLE_ITER = 44

PEAKS_FILE = Path(__file__).with_name("peaks.json")


def pairs_within(x: torch.Tensor, h: float) -> int:
    """Ordered pairs (i, j) with |x_i - x_j| < h, i == j included: a plain
    count on a grid of cells of side h over the positions' bounding box."""
    x = x.float()
    lo = x.min(0).values
    width = max(1, int(((x.max(0).values - lo).max() / h).floor()) + 1)
    ijk = ((x - lo) / h).floor().long().clamp(0, width - 1)
    cell = ijk[:, 0] + width * (ijk[:, 1] + width * ijk[:, 2])
    cell, order = torch.sort(cell)
    grid = neighbours.make_grid(cell, width)
    return sum(int(i.numel()) for i, _, _, _ in
               neighbours.near_pairs(grid, x[order], h * h))


def pair_flops(pairs: float, iters: int) -> float:
    return pairs * iters * (LAMBDA_FLOPS_PER_PAIR + PROJECT_FLOPS_PER_PAIR)


def pair_bytes(n: int, iters: int) -> float:
    return n * iters * BYTES_PER_PARTICLE_ITER


def peaks(card: str) -> dict | None:
    """The published peaks of `card` (peaks.json), or None for a card the
    table does not list."""
    return json.loads(PEAKS_FILE.read_text()).get(card)


def least_seconds(pairs: float, n: int, iters: int, peak: dict):
    """(seconds, "flops" or "bytes"): the least time one step's pair work
    can take on a card with these peaks, and which of the two bounds it."""
    flops = pair_flops(pairs, iters) / peak["fp32_flop_per_s"]
    mem = pair_bytes(n, iters) / peak["hbm_byte_per_s"]
    return (flops, "flops") if flops >= mem else (mem, "bytes")
