"""Seconds of the program's warm-up, model.precompile(), in set-up."""


def read(ctx):
    return ctx["setup"].get("precompile")
