"""Wall-clock regions: ``Timer`` collects named region timings (the
prover keeps one per prove as ``Stark.last_profile``); a region given a
CUDA device also records the device time of the work it queues."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class Timer:
    """Accumulates wall-clock per named region, and device time per region
    timed on a CUDA device."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = defaultdict(list)

    @contextlib.contextmanager
    def region(self, name: str, device=None):
        """Wall clock of the block.  With a CUDA ``device``, also two CUDA
        events on its current stream around the work the block queues
        (nothing waits for them here; :meth:`device_totals` reads them)."""
        events = None
        if device is not None and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            if events is not None:
                events[1].record(stream)
                self._events[name].append(events)

    def device_totals(self) -> Dict[str, float]:
        """Milliseconds on the device's clock from each device region's
        start event to its end event, summed per name: the region's work and
        any time the device waited for the host inside it.  Waits for the
        events, so read it after the prove."""
        out = {}
        for name, pairs in self._events.items():
            for _, end in pairs:
                end.synchronize()
            out[name] = sum(start.elapsed_time(end) for start, end in pairs)
        return out

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name]*1e3:.1f} ms ({self.counts[name]}x)"
            )
        return "; ".join(lines)
