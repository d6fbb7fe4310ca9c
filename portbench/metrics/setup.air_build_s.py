"""Seconds of the chain's AIR build (model.constraints) in set-up."""


def read(ctx):
    return ctx["setup"].get("air")
