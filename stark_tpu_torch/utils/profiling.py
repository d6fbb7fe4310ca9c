"""The program's tracer.

``Timer(layer)`` keeps wall-clock totals of named regions (the prover
keeps one a prove as ``Stark.last_profile``); :func:`span` marks a
stretch of code that keeps no totals.  While traced both also open
``torch.profiler`` ranges, ``stark.<layer>.<name>`` for a region and the
span's own name, which share the running profiler's clock with the CUDA
kernels and copies; and a ``gc.callbacks`` hook times the collector
(:data:`COLLECTOR`), its generation-1 and -2 runs as the ranges
``stark.gc.gen1`` / ``stark.gc.gen2`` nested in whatever range is open.
Every range is also kept in :data:`RANGES`, on the host's monotonic clock,
for a reader that sees the profiler's results but not the program's ranges
in them.

Tracing is on inside :func:`traced`, and for each model's prove
(:func:`prove_span`) that starts while a ``torch.profiler`` trace records:
an operator's profiler window is enough, and ``traced()`` round it also
times the collector between proves.  Off, a span costs one test of a
module flag, a region that test beside its wall clock, and a prove one
query of the profiler's state: no range is entered and no hook is
installed.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.autograd.profiler import record_function

_TRACED = False
_FOLLOWING = False  # the last prove found a profiler recording
_OFF = contextlib.nullcontext()
_GC_RANGES = (None, "stark.gc.gen1", "stark.gc.gen2")
_PROVES = itertools.count()

#: (name, start, end) of every range since tracing last began, in
#: ``time.perf_counter`` seconds
RANGES: List[Tuple[str, float, float]] = []


class _Range:
    """The profiler range ``name`` round a block, kept in :data:`RANGES`."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._rf.__exit__(*exc)
        RANGES.append((self.name, self._t0, t1))


def span(name: str):
    """The range ``name`` round the block while traced; else nothing."""
    return _Range(name) if _TRACED else _OFF


@contextlib.contextmanager
def _followed(name: str):
    _on()
    try:
        with _Range(name):
            yield
    finally:
        _off()


def prove_span():
    """``stark.entry.prove#<k>`` round a model's prove while traced, k the
    process's traced proves counted from 0, so that every span of one
    prove lies under one named range.  A prove that starts while a
    profiler records and nothing is traced traces itself; the first such
    prove after one that found no profiler resets :data:`COLLECTOR` and
    :data:`RANGES`, which then hold the profiler window's proves."""
    global _FOLLOWING
    if _TRACED:
        return _Range(f"stark.entry.prove#{next(_PROVES)}")
    if not torch.autograd._profiler_enabled():
        _FOLLOWING = False
        return _OFF
    if not _FOLLOWING:
        reset()
        _FOLLOWING = True
    return _followed(f"stark.entry.prove#{next(_PROVES)}")


class Timer:
    """Accumulates wall-clock seconds per named region of one layer."""

    def __init__(self, layer: str) -> None:
        self.layer = layer
        self.totals: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def region(self, name: str):
        """Wall clock of the block, added to ``totals[name]``; while
        traced, also the range ``stark.<layer>.<name>``, whose entry and
        exit the wall clock includes."""
        t0 = time.perf_counter()
        try:
            with _Range(f"stark.{self.layer}.{name}") if _TRACED else _OFF:
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0


class Collector:
    """The collector's runs while traced, by generation: how many and
    their seconds.  Installed as a ``gc.callbacks`` hook while traced."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.counts = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._range = None
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        gen = info["generation"]
        if phase == "start":
            if gen:
                self._range = _Range(_GC_RANGES[gen])
                self._range.__enter__()
            self._t0 = time.perf_counter()
            return
        self.seconds[gen] += time.perf_counter() - self._t0
        self.counts[gen] += 1
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


#: the collector's runs since tracing last began
COLLECTOR = Collector()


def reset() -> None:
    """Clear :data:`COLLECTOR` and :data:`RANGES`."""
    COLLECTOR.reset()
    RANGES.clear()


def _on() -> None:
    global _TRACED
    _TRACED = True
    gc.callbacks.append(COLLECTOR)


def _off() -> None:
    global _TRACED
    gc.callbacks.remove(COLLECTOR)
    _TRACED = False


@contextlib.contextmanager
def traced():
    """Spans and regions as profiler ranges, and the collector timed, for
    the block, from a reset :data:`COLLECTOR` and :data:`RANGES`; the hook
    is removed on exit, also on an exception."""
    reset()
    _on()
    try:
        yield COLLECTOR
    finally:
        _off()
