"""plan_ms_per_step: device ms a step of the window plan, its work table
and the candidate counter's add (the stage plan), from the program's stage
map of its captured step held against the traced replays (stages.py): the
busy time of the stage's own ops, their intervals merged, with no gap
counted."""

from pbfbench import stages


def read(ctx):
    return stages.group_ms(ctx, "plan")
