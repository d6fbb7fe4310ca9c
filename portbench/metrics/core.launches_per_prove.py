"""Hand-kernel launches a prove: the sum of the program's launch counters
(kernels.LAUNCHES, reset as the window opens) over the completed proves."""


def read(ctx):
    n = len(ctx["proves"])
    if not n:
        return None
    return sum(ctx["launches"].values()) / n
