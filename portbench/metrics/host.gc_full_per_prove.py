"""Full (generation-2) collections in the window's proves (the program's
counter, profiling.COLLECTOR, reset by the window's first prove) over the
completed proves."""

from portbench import program_trace


def read(ctx):
    c, n = program_trace.collector(), len(ctx["proves"])
    if c is None or not n:
        return None
    return c[0][2] / n
