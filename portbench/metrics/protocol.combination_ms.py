"""The prove's ``combination`` region of Stark.last_profile (the AIR
groups, the zeroifiers, the x^shift tables, the trace extension and K11);
the mean over the window's proves."""


def read(ctx):
    vals = [p.get("combination") for _, p in ctx["stark"]]
    if not vals or None in vals:
        return None
    return 1e3 * sum(vals) / len(vals)
