"""small_kernel_ms_per_step: device ms a step of every kernel in the traced
window that pair_roofline does not count (predict, cell ids, sort, gathers,
plan, finalize, and the rollout's fills and copies done as kernels)."""

from pbfbench import trace
from pbfbench.metrics.pair_roofline import PATTERNS


def read(ctx):
    t = ctx.trace
    if t is None or t.window is None or not t.steps:
        return None
    ks = trace.kernels(t.window)
    if not ks:
        return None
    pair = set(map(id, trace.matching(ks, PATTERNS)))
    return sum(op.end - op.start for op in ks
               if id(op) not in pair) / 1e3 / t.steps
