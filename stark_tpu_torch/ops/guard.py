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

:func:`count_device_ops` counts, for the span of a ``with`` block, every
PyTorch operation that puts a tensor on the given device type (an index,
a concatenation, a copy to the card, an allocation), so a run can show
that a step launched its hand kernel and nothing else.
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


#: the operations a kernel's wrapper itself runs: the allocation of its outputs
ALLOCATION = frozenset({"aten.empty.memory_format"})


@contextlib.contextmanager
def count_device_ops(device_type: str = "cuda"):
    """Within the block, a Counter of the ATen operations (by overload name,
    e.g. ``aten.index.Tensor``) whose result holds a tensor on
    ``device_type``.  A hand kernel launched through ``ctypes`` is not an
    ATen operation and is not counted; its wrapper's allocations are
    (:data:`ALLOCATION`)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts: Counter = Counter()

    def on_device(out) -> bool:
        if isinstance(out, torch.Tensor):
            return out.device.type == device_type
        return isinstance(out, (tuple, list)) and any(on_device(o) for o in out)

    class Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if on_device(out):
                counts[str(func)] += 1
            return out

    with Counting():
        yield counts
