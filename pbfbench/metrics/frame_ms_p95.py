"""frame_ms_p95: the 95th percentile of every call's latency in the window,
ms, each from the issue of its step until its positions and counters are on
the host (Python's statistics.quantiles, inclusive method)."""

import statistics


def read(ctx):
    if len(ctx.calls_ms) < 20:
        return None
    return statistics.quantiles(ctx.calls_ms, n=20, method="inclusive")[18]
