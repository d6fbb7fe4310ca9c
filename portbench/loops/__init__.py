"""The loops that drive a window, one a file, found by a traffic mix's
``loop`` key: ``loops/<loop>.py``.

A loop module has ``KEYS`` (the traffic keys it reads beyond those of
:mod:`portbench.statements`), may have ``check(traffic)`` (raises on values
it cannot drive) and ``stream_position(traffic, position, index,
warm_proves, draws)`` (where the program's randomness stream stands for a
proof, when it is not :func:`portbench.check.stream_position`), and has
``drive(w: Window) -> (records, window_s, failed)``: the records in the
order the program ran them, the window's seconds from its start to the
completion that ended it, and the proves that raised.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, NamedTuple, Optional

from .. import load_file
from ..statements import Statement, check_traffic

HERE = Path(__file__).resolve().parent


class Record(NamedTuple):
    statement: Statement
    seconds: float  # the prove's wall time by the host clock
    claim: Any  # None where the prove raised
    proof: Optional[bytes]


@dataclass
class Window:
    """What a loop drives: the statements, the program's prove of one, and
    the run's clock, spans and log.  The closed loop reads no more than that;
    the rest are for loops that later PRs add as files and that cannot
    edit this one (a batch of statements to the shared model, a service
    built round it)."""

    statement: Callable[[int], Statement]  # statement i, drawn from the seed
    prove: Callable[[Statement], tuple]  # (claim, proof bytes) by the model's own prove
    seconds: float
    span: Callable[[str], Any]  # a host span round a prove, in the traced run
    say: Callable[..., None]
    traffic: dict
    config: dict
    build: Optional[Callable[[int, int], Any]] = None  # (size, stream) -> a new model
    model: Any = None  # the shared model, built and warmed in set-up
    clock: Callable[[], float] = time.perf_counter


def load(name: str) -> ModuleType:
    return load_file(HERE / f"{name}.py", f"portbench.loops.{name}")


def for_traffic(traffic: dict) -> ModuleType:
    """The traffic's loop, with the traffic checked against it."""
    loop = load(traffic.get("loop", ""))
    check_traffic(traffic, getattr(loop, "KEYS", ()))
    if hasattr(loop, "check"):
        loop.check(traffic)
    return loop
