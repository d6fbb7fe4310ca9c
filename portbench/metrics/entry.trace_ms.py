"""The model's trace or witness build a prove: the program's
``stark.entry.trace`` ranges (portbench/program_trace.py), each less the
collector's ``stark.gc.*`` ranges inside it, summed over the window, over
the completed proves."""

from portbench import program_trace


def read(ctx):
    r, n = program_trace.ranges(), len(ctx["proves"])
    if r is None or not n:
        return None
    spans = [(a, b) for name, a, b in r if name == "stark.entry.trace"]
    if not spans:
        return None
    pauses = [(a, b) for name, a, b in r if name.startswith("stark.gc.")]
    paused = sum(max(0.0, min(b, pb) - max(a, pa)) for a, b in spans for pa, pb in pauses)
    return 1e3 * (sum(b - a for a, b in spans) - paused) / n
