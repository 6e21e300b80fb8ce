"""rank_step_mfu: the whole sharded step's share of the ranks' cards' peak,
%: the least time of a step's pair work on as many cards as the run has
ranks (as rank_pair_roofline counts it) over the traced wall time a step,
the mean over the ranks; none from a trace with no device activity. It
reads the same work whatever kernels, or exchanges, implement it."""

from pbfbench.metrics.rank_pair_roofline import least_seconds


def read(ctx):
    ranks = getattr(ctx, "ranks", None) or []
    least = least_seconds(ctx)
    if least is None or any(t.window is None or not t.steps
                            or t.window_s <= 0 or t.busy_s <= 0
                            for t in ranks):
        return None
    wall = sum(t.window_s / t.steps for t in ranks) / len(ranks)
    return 100.0 * least / wall
