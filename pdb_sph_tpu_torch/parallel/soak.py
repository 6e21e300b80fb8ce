"""The invariants of a long sharded run: the JAX package's soak
(tests/test_sharded_soak.py:61-103) as one check over what
`launch.rollout_ranks` returns.

After every chunk:

  * the ranks' active counts sum to n;
  * every overflow counter (migration, merge, ghost, plan), summed over
    the chunk's steps, is 0, so nothing transient hides;
  * no rank saw a NaN;
  * every rank's bounds row is the same, its step counter the tier's
    steps so far;
  * every slab is at least `_min_slab_keys` (2 z-rows + 2 cells) wide, and
    the boundaries span the grid;

and over the run: the boundaries moved at least twice, max/mean of the
active counts stays within the caller's limit after chunk 0 (which holds
the spawn transient), and the final state is finite and within `margin`
of the box.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config import SimConfig
from ..state import SimState
from .sharded import _min_slab_keys, initial_bounds


def check(cfg: SimConfig, n_ranks: int, state0: SimState, got: Sequence,
          chunks: Sequence[int], retier: int | None, limit: float,
          margin: float = 0.25) -> tuple[list[dict], list[str]]:
    """The invariants over `got`, the `launch.Chunk`s of a run of `chunks`
    steps from `state0` that re-tiered before chunk `retier` (None: never),
    with the imbalance limit `limit`. Returns (each chunk's figures: step,
    tier, balance min/mean and imbalance max/mean of the active counts,
    max speed, boundary moves, narrowest slab, seconds; what failed, one
    line a fault)."""
    min_w, keys = _min_slab_keys(cfg), cfg.nb_grid_width ** 2
    b_prev = torch.from_numpy(initial_bounds(cfg, n_ranks, state=state0))
    step = tier_steps = moves = 0
    rows, bad = [], []
    for c, (ch, k) in enumerate(zip(got, chunks)):
        if c == retier:
            # the compact tier starts from the split of the collected state
            b_prev = torch.from_numpy(initial_bounds(
                cfg, n_ranks, state=got[c - 1].state))
            tier_steps = 0
        step += k
        tier_steps += k
        where = f"chunk {c} (step {step})"
        act = ch.stats[:, 0].double()
        if int(ch.stats[:, 0].sum()) != cfg.n:
            bad.append(f"{where}: particles lost or duplicated: "
                       f"{ch.stats[:, 0].tolist()}")
        if int(ch.stats[:, 1:].sum()):
            bad.append(f"{where}: overflow counters fired (migration, "
                       f"merge, ghost, plan summed over the chunk): "
                       f"{ch.stats.tolist()}")
        if float(ch.diag[:, 2].sum()):
            bad.append(f"{where}: NaN detected")
        brows = ch.bounds
        if not bool((brows == brows[0]).all()) \
                or int(brows[0, 0]) != tier_steps:
            bad.append(f"{where}: bounds rows {brows.tolist()}, the tier's "
                       f"step {tier_steps}")
        b = brows[0, 1:]
        if bool((b.diff() < min_w).any()) or int(b[0]) != 0 \
                or int(b[-1]) != keys:
            bad.append(f"{where}: slab bounds {b.tolist()} (minimum width "
                       f"{min_w}, {keys} keys)")
        moved = int((b != b_prev).sum())
        moves += moved
        b_prev = b
        rows.append({
            "step": step,
            "tier": "compact" if retier is not None and c >= retier
            else "spawn",
            "balance": float(act.min() / act.mean()),
            "imbalance": float(act.max() / act.mean()),
            "max_speed": float(ch.diag[:, 0].max()),
            "moves": moved, "min_slab": int(b.diff().min()),
            "secs": ch.secs})
    if moves < 2:
        bad.append(f"the boundaries moved {moves} times, not following the "
                   "fluid")
    worst = max((r["imbalance"] for r in rows[1:]), default=0.0)
    if worst > limit:
        bad.append(f"imbalance over {limit}: max/mean by chunk "
                   f"{[round(r['imbalance'], 4) for r in rows]}")
    x = got[-1].state.x
    if tuple(x.shape) != (cfg.n, 3) or not bool(torch.isfinite(x).all()) \
            or not bool(((x > -margin) & (x < cfg.wall + margin)).all()):
        bad.append(f"the final state is not finite or not within {margin} "
                   "of the box")
    return rows, bad
