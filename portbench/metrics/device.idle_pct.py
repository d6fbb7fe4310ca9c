"""The share of the traced window in which no kernel, copy or fill ran on
the card: one less the union of their intervals over the window."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
