"""pair_roofline: the pair kernels' share of their roofline, %.

The least time of a step's pair work (work.least_seconds: the pairs within
h that the census counts over the traced segment, at the flops and bytes
per pair and particle of work.py, against the card's published FP32 peak
and memory rate, peaks.json) over the pair kernels' device time a step in
the trace. The pair kernels are the kernels whose names match PATTERNS:
every pair kernel of the port (csrc/pbf_window.cu window_kernel,
csrc/pbf_tc.cu density_tc_kernel and project_tc_kernel)."""

from pbfbench import trace, work

PATTERNS = (r"window_kernel", r"density_tc_kernel", r"project_tc_kernel")


def pair_seconds(t):
    return sum(op.end - op.start for op in
               trace.matching(trace.kernels(t.window), PATTERNS)) / 1e6


def read(ctx):
    t = ctx.trace
    peak = work.peaks(ctx.card)
    if t is None or t.window is None or not t.pairs_per_step or peak is None:
        return None
    busy = pair_seconds(t)
    if busy <= 0:
        return None
    least, _ = work.least_seconds(t.pairs_per_step, ctx.n, ctx.iters, peak)
    return 100.0 * least * t.steps / busy
