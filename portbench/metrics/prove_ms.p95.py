"""The 95th percentile (nearest rank) of the window's proves, each timed by
the host clock round the model's prove, over every completed prove."""


def p95(values):
    """Nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, -(-95 * len(v) // 100) - 1)]


def read(ctx):
    return 1e3 * p95(ctx["proves"]) if ctx["proves"] else None
