"""particle_steps_per_s: n times every step completed in the window, over
the window's wall time on the host clock (from the first call's issue to
the read back of the last call, which ends in a synchronize)."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.steps:
        return None
    return ctx.n * ctx.steps / ctx.window_s
