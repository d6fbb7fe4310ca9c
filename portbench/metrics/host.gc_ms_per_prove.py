"""The collector's pauses a prove: the seconds of every collection in the
window's proves, all generations (the program's counter,
profiling.COLLECTOR, reset by the window's first prove), over the
completed proves."""

from portbench import program_trace


def read(ctx):
    c, n = program_trace.collector(), len(ctx["proves"])
    if c is None or not n:
        return None
    return 1e3 * sum(c[1]) / n
