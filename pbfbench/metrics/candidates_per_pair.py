"""candidates_per_pair: the (own row, candidate) pairs that the program's
window plans handed the pair kernels over the traced segment
(`Stepper.counters["plan_candidates"]` over the profiler session, read by
`timing.last_session()`) per ordered pair within h, self included, that the
benchmark's census counts (ctx.trace.pairs_per_step, work.py): how many
candidates the kernels stream for each pair that adds to a sum."""

from pbfbench import stages


def read(ctx):
    s = stages.session(ctx)
    t = ctx.trace
    if s is None or not t.pairs_per_step or "plan_candidates" not in s:
        return None
    return s["plan_candidates"] / s["steps"] / t.pairs_per_step
