"""rank_pair_roofline: the sharded step's pair kernels' share of their
roofline on the ranks' cards together, %.

The least time of a step's pair work (work.least_seconds: the pairs within
h that the census counts on the collected states of the traced segment, at
the flops and bytes per pair and particle of work.py) on as many cards as
the run has ranks, each at the published peaks (peaks.json), over the pair
kernels' device time a step on a rank, the mean over the ranks. Each pair
counts once: the ghost rows a rank also solves are overhead, not work."""

from pbfbench import trace, work
from pbfbench.metrics.pair_roofline import PATTERNS


def pair_seconds_per_step(ctx):
    """Each rank's pair-kernel device seconds a step, or None."""
    ranks = getattr(ctx, "ranks", None) or []
    if not ranks or any(t.window is None or not t.steps for t in ranks):
        return None
    per_rank = [sum(op.end - op.start for op in trace.matching(
        trace.kernels(t.window), PATTERNS)) / 1e6 / t.steps for t in ranks]
    return per_rank if all(s > 0 for s in per_rank) else None


def least_seconds(ctx):
    """The least time of a step's pair work on len(ctx.ranks) cards, or
    None."""
    ranks = getattr(ctx, "ranks", None) or []
    peak = work.peaks(ctx.card)
    if not ranks or peak is None or not ranks[0].pairs_per_step:
        return None
    cards = {k: v * len(ranks) for k, v in peak.items()
             if isinstance(v, (int, float))}
    return work.least_seconds(ranks[0].pairs_per_step, ctx.n, ctx.iters,
                              cards)[0]


def read(ctx):
    per_rank = pair_seconds_per_step(ctx)
    least = least_seconds(ctx)
    if per_rank is None or least is None:
        return None
    return 100.0 * least / (sum(per_rank) / len(per_rank))
