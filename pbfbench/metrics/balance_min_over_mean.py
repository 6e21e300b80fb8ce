"""balance_min_over_mean: the pair kernels' device time a step (the kernels
pair_roofline counts) on the least loaded rank over their mean over the
ranks, each rank's from its traced segment: 1 when the slabs hold equal
pair work, lower as one rank waits for the others at the exchanges."""

from pbfbench.metrics.rank_pair_roofline import pair_seconds_per_step


def read(ctx):
    per_rank = pair_seconds_per_step(ctx)
    if per_rank is None:
        return None
    return min(per_rank) / (sum(per_rank) / len(per_rank))
