"""setup_s: seconds from the process's start (the first line of run.py) to
the first timed call: imports, the inputs, loading or building the kernels,
and one whole segment untimed, in which the graph is captured."""


def read(ctx):
    return ctx.setup_s
