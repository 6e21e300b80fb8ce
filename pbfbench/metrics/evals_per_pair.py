"""evals_per_pair: the (own row, candidate) pairs that the program's FP32
density kernels evaluated after their cull over the traced segment
(`Stepper.counters["pair_evals"]` over the profiler session, read by
`timing.last_session()`), per solver iteration, per ordered pair within h,
self included, that the benchmark's census counts (ctx.trace.pairs_per_step,
work.py): how many pair bodies the kernels run for each pair that adds to a
sum. A program without the counter, or one that counted nothing (the plain
versions on the CPU), gives no number."""

from pbfbench import stages


def read(ctx):
    s = stages.session(ctx)
    t = ctx.trace
    if s is None or not t.pairs_per_step or not s.get("pair_evals"):
        return None
    return s["pair_evals"] / s["steps"] / ctx.iters / t.pairs_per_step
