"""A kernel family's share of its roofline, for every metric
``<family>_roofline`` with no file of its own: the family's counted calls'
least time (``roofline/<family>.py``) over its kernels' time in the trace."""


def read(ctx, family):
    f = (ctx["roofline"] or {}).get(family)
    if not f or not f["kernel_s"] or not f["least_s"]:
        return None
    return 100.0 * f["least_s"] / f["kernel_s"]
