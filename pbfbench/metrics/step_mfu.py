"""step_mfu: the whole step's share of the card's peak, %: the least time
of a step's pair work (as pair_roofline counts it) over the traced window's
wall time a step. It reads the same work whatever kernels implement it, so
it still bounds a gain when a pair kernel is fused or renamed."""

from pbfbench import work


def read(ctx):
    t = ctx.trace
    peak = work.peaks(ctx.card)
    if t is None or t.window is None or not t.pairs_per_step or peak is None \
            or t.window_s <= 0:
        return None
    least, _ = work.least_seconds(t.pairs_per_step, ctx.n, ctx.iters, peak)
    return 100.0 * least * t.steps / t.window_s
