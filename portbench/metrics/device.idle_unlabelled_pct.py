"""The share of the device's idle time in the window during which no
program range (``stark.*``) is open: what the tracing still cannot name.
The program's ranges (portbench/program_trace.py) are put on the trace's
clock by the harness's prove spans."""

from portbench import program_trace, tracing


def read(ctx):
    t = ctx["trace"]
    r = program_trace.on_trace_clock(t, program_trace.ranges())
    if r is None or not t.kernels:
        return None
    idle = t.window_s - t.busy_s()
    if idle <= 0:
        return None
    covered = tracing.union(t.busy_intervals() + [(a, b) for _, a, b in r], *t.window)
    return 100.0 * sum(b - a for a, b in tracing.gaps_of(covered, *t.window)) / idle
