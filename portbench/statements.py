"""The one statement generator every traffic mix drives.

A traffic file (``traffic/<mix>.json``) says how a caller sends
statements; a configuration (``configs/<config>.json``) says which
statement family and at which size.  Everything random is drawn from the
run's seed by name, so one seed gives the same statements, the same sizes
and the same prover randomness in every run, and two seeds give the same
work in another order.

Traffic keys, besides those its loop reads (``loops/<loop>.py``):

* ``loop``: the loop that drives the window (``"closed"``: one caller
  that sends its next statement once the last proof is back);
* ``model``: ``"shared"`` (one model proves every statement, built and
  warmed in set-up) or ``"per_request"`` (each statement builds its own
  model inside its request, the last released first);
* ``sizes``: null (the configuration's size) or ``{"low", "high",
  "count"}``: ``count`` sizes evenly spaced over [low, high], in an order
  shuffled by the seed, statement i taking size i mod count;
* ``warm``: the set-up steps, of ``"precompile"`` (the program's own
  warm-up) and ``"prove"`` (one statement outside the draws, proved).

How many of the window's proofs the reference recomputes is the
configuration's ``check_sample``: what one costs depends on the statement.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass
from typing import List, Optional

from .reference.field import P

TRAFFIC_KEYS = {"loop", "model", "sizes", "warm", "why"}


@dataclass(frozen=True)
class Statement:
    index: int  # -1 for set-up's warm-up statement
    size: int
    inputs: tuple


def _draw(*parts) -> bytes:
    return hashlib.shake_256("/".join(str(p) for p in ("portbench",) + parts).encode()).digest(32)


def field_element(*parts) -> int:
    return int.from_bytes(_draw(*parts), "big") % P


def rng_seed(seed: int, stream: int) -> bytes:
    """The seed bytes of the prover's randomness stream ``stream``."""
    return hashlib.sha256(f"portbench/rng/{seed}/{stream}".encode()).digest()


def check_traffic(traffic: dict, loop_keys=()) -> None:
    extra = set(traffic) - TRAFFIC_KEYS - set(loop_keys)
    if extra:
        raise ValueError(f"unknown traffic keys {sorted(extra)}")
    if traffic.get("model") not in ("shared", "per_request"):
        raise ValueError("model is 'shared' or 'per_request'")
    if not set(traffic.get("warm", ())) <= {"precompile", "prove"}:
        raise ValueError("warm steps are 'precompile' and 'prove'")


class Generator:
    """Statement i of a run with ``seed``."""

    def __init__(self, config: dict, traffic: dict, seed: int) -> None:
        self.seed = seed
        self.arity = int(config["inputs"])
        self.sizes: Optional[List[int]] = None
        spec = traffic.get("sizes")
        if spec:
            lo, hi, count = int(spec["low"]), int(spec["high"]), int(spec["count"])
            sizes = [lo + round(k * (hi - lo) / (count - 1)) for k in range(count)] if count > 1 else [lo]
            random.Random(f"portbench/sizes/{seed}").shuffle(sizes)
            self.sizes = sizes
        self.size = int(config["size"])

    def statement(self, index: int) -> Statement:
        size = self.sizes[index % len(self.sizes)] if self.sizes and index >= 0 else self.size
        inputs = tuple(field_element("statement", self.seed, index, j) for j in range(self.arity))
        return Statement(index, size, inputs)

    def warm_statement(self) -> Statement:
        return self.statement(-1)


def check_indices(seed: int, completed: int, sample: int) -> List[int]:
    """Which of the window's proofs the reference recomputes."""
    return sorted(random.Random(f"portbench/check/{seed}").sample(range(completed), min(sample, completed)))
