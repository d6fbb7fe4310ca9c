"""Wall-clock regions: ``Timer`` collects named region timings (the
prover keeps one per prove as ``Stark.last_profile``)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class Timer:
    """Accumulates wall-clock per named region."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def region(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name]*1e3:.1f} ms ({self.counts[name]}x)"
            )
        return "; ".join(lines)
