"""frames_per_s: the calls (frames) completed in the window over the window's
wall time on the host clock, from the first frame's issue to the read back
of the last, which ends in a synchronize."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.calls_ms:
        return None
    return len(ctx.calls_ms) / ctx.window_s
