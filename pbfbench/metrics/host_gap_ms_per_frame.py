"""host_gap_ms_per_frame: the ms a frame in which the card waits for the
host, on the host clock: a frame's wall time over the untraced window
(issue of its step to its read back on the host) less the device busy time
a frame (kernels, copies and memsets merged) of the traced segment that
follows the window, which the profiler does not change. The traced
segment's own idle time would not do: the profiler slows the host's launch
of each traced frame by ~0.6 ms, which device_idle_pct counts."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window is None or not t.calls or t.busy_s <= 0 \
            or not ctx.calls_ms:
        return None
    return 1e3 * (ctx.window_s / len(ctx.calls_ms) - t.busy_s / t.calls)
