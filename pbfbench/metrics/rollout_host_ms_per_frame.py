"""rollout_host_ms_per_frame: the host ms of the program's `Rollout` call a
frame (the call's zeros, copy-in, graph launch, clones out and Python), as
the program times each call on its own host clock over the untraced window
(`timing.last_session()`: its untraced calls before the traced segment, the
set-up's capturing call left out). Under the profiler every op of the call
is recorded, which costs it several times its own time, so no traced span
is read."""

from pbfbench import stages


def read(ctx):
    return stages.rollout_host_ms(ctx)
