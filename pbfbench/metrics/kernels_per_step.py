"""kernels_per_step: kernel launches in the traced window over its steps,
an exact count (a graph's kernels count once per replay)."""

from pbfbench import trace


def read(ctx):
    t = ctx.trace
    if t is None or t.window is None or not t.steps:
        return None
    count = len(trace.kernels(t.window))
    return count / t.steps if count else None
