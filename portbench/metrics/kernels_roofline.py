"""The hand kernels' share of their roofline: the sum of every counted
call's least time (portbench/roofline/) over the sum of those families'
kernel times in the trace."""


def read(ctx):
    s = ctx["roofline"]
    if not s:
        return None
    least = sum(f["least_s"] for f in s.values() if f["kernel_s"] > 0)
    time = sum(f["kernel_s"] for f in s.values())
    return 100.0 * least / time if time > 0 and least > 0 else None
