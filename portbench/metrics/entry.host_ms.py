"""The entry layer's own time a prove: the model's prove (the trace or
witness, the boundary, the claim) less the Stark.prove it calls, each by
the host clock; the mean over the window's proves."""


def read(ctx):
    n = len(ctx["proves"])
    if not n or len(ctx["stark"]) != n:
        return None
    return 1e3 * (sum(ctx["proves"]) - sum(w for w, _ in ctx["stark"])) / n
