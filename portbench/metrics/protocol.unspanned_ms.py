"""The host work of Stark.prove that no region of its last_profile covers:
its wall time less the sum of the top-level regions (the names without a
slash); the mean over the window's proves."""


def read(ctx):
    if not ctx["stark"]:
        return None
    rest = [w - sum(v for k, v in p.items() if "/" not in k) for w, p in ctx["stark"]]
    return 1e3 * sum(rest) / len(rest)
