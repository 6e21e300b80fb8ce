"""nccl_ms_per_step: device ms a step of the NCCL kernels (the sharded
step's all_gather of the loads, the migration's and the ghosts' shifts, the
rollout's gather of the counters), each rank's over its traced segment, the
mean over the ranks. A rank's NCCL kernel runs until its peer has sent, so
this is the exchange's cost with the wait for the slowest rank in it."""

from pbfbench import trace

PATTERNS = (r"(?i)nccl",)


def nccl_seconds(t):
    return sum(op.end - op.start for op in
               trace.matching(trace.kernels(t.window), PATTERNS)) / 1e6


def read(ctx):
    ranks = getattr(ctx, "ranks", None) or []
    if not ranks or any(t.window is None or not t.steps for t in ranks):
        return None
    per_step = [nccl_seconds(t) / t.steps for t in ranks]
    if not any(per_step):
        return None
    return 1e3 * sum(per_step) / len(per_step)
