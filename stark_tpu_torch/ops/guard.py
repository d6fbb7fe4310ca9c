"""Count the plain field arithmetic that runs on a device.

On the card every function of :mod:`stark_tpu_torch.ops.field_ops` is a
plain version (about 70 eager tensor operations a Montgomery product) of
work that a hand kernel does; the wrappers run it only for CPU tensors.
:func:`count_plain_calls` wraps each arithmetic function of that module
for the span of a ``with`` block and counts the calls that get a tensor on
the given device type, so a run can show that its path called none on the
card.  The comparison ``is_zero`` is not arithmetic and is not counted.
Calls through references taken before the block (none on a path of a
prove) are not seen.
"""

from __future__ import annotations

import contextlib
import functools
from collections import Counter

import torch

from . import field_ops as fo

#: the functions of field_ops the guard counts
ARITHMETIC = ("mont_mul", "mont_sqr", "add", "sub", "neg", "to_mont", "from_mont", "mont_pow_fixed", "mont_inv",
              "prefix_mul")


@contextlib.contextmanager
def count_plain_calls(device_type: str = "cuda"):
    """Within the block, a Counter of calls of each :data:`ARITHMETIC`
    function with a tensor argument on ``device_type``; a call made
    inside another counted call counts too."""
    counts: Counter = Counter()
    originals = {name: getattr(fo, name) for name in ARITHMETIC}

    def counted(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.device.type == device_type
                   for a in (*args, *kwargs.values())):
                counts[name] += 1
            return fn(*args, **kwargs)

        return call

    for name, fn in originals.items():
        setattr(fo, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(fo, name, fn)
