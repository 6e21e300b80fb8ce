"""chunk_items_max: the most work items of one chunk in a step's table,
the mean over the traced segment's steps (`Stepper.counters[
"chunk_items_max"]`, a sum of each step's maximum, over the profiler
session read by `timing.last_session()`, per step of the session). A
chunk's items are added in segment order by its last one, so this is the
longest such chain a step. A program without the counter gives no
number."""

from pbfbench import stages


def read(ctx):
    s = stages.session(ctx)
    if s is None or not s.get("chunk_items_max"):
        return None
    return s["chunk_items_max"] / s["steps"]
