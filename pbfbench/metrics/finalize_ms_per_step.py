"""finalize_ms_per_step: device ms a step of finalize (collide with the
walls), the stats, the copy-back into the graph's state and the accumulator
(the stages finalize and epilogue), from the program's stage map of its
captured step held against the traced replays (stages.py): the busy time of
the stage's own ops, their intervals merged, with no gap counted."""

from pbfbench import stages


def read(ctx):
    return stages.group_ms(ctx, "finalize")
