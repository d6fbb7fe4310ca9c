"""The device trace of a traced window, read from ``torch.profiler``.

The window runs under the profiler with the harness's own host spans
(``record_function``): ``portbench.window`` round the whole window,
``portbench.prove#<k>`` round each prove and ``portbench.stark`` round
each call of ``Stark.prove`` inside it.  The trace is exported once to a
file in the run's temporary directory, read, and deleted.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"
PROVE = "portbench.prove#"
STARK = "portbench.stark"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_base(name: str) -> str:
    """The function's qualified name without return type, anonymous
    namespaces, template arguments or parameters: ``void (anonymous
    namespace)::ntt_pass_kernel<3>(int const*, ...)`` -> ``ntt_pass_kernel``."""
    s = re.sub(r"^void\s+", "", name.strip().replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in s:
        if ch in "<(":
            if depth == 0 and out:
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


@dataclass
class DeviceTrace:
    window: Tuple[float, float]  # seconds on the trace's clock
    kernels: List[Tuple[str, float, float]]  # (base name, start s, duration s)
    copies: List[Tuple[str, float, float]]  # memcpy and memset
    spans: List[Tuple[str, float, float]]  # the harness's host spans
    by_kernel: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's kernel and copy intervals, clipped to
        the window."""
        return union([(s, s + d) for _, s, d in self.kernels + self.copies], *self.window)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_s(self) -> float:
        return sum(d for _, _, d in self.kernels)

    def top_kernels(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for name, _, d in self.kernels:
            tot[name] += d
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The longest stretches of the window with nothing on the device,
        each named by the host span it falls in: ``prove#<k> in
        Stark.prove``, ``prove#<k> outside Stark.prove``, or ``between
        proves``."""
        gaps = gaps_of(self.busy_intervals(), *self.window)
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        return [[self.label((a + b) / 2), b - a] for a, b in gaps[:k]]

    def label(self, t: float) -> str:
        prove = next((n for n, s, d in self.spans if n.startswith(PROVE) and s <= t <= s + d), None)
        if prove is None:
            return "between proves"
        inside = any(n == STARK and s <= t <= s + d for n, s, d in self.spans)
        return f"{prove[len('portbench.'):]} {'in' if inside else 'outside'} Stark.prove"


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def gaps_of(busy: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def parse(events: List[dict]) -> Optional[DeviceTrace]:
    """A DeviceTrace from chrome-trace events (``ts``/``dur`` in
    microseconds), or None when the window span is missing."""
    kernels, copies, spans = [], [], []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)) * 1e-6, float(ev.get("dur", 0.0)) * 1e-6
        if cat == "kernel":
            kernels.append((kernel_base(name), ts, dur))
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copies.append((cat, ts, dur))
        elif cat == "user_annotation" and name.startswith("portbench."):
            if name == WINDOW:
                window = (ts, ts + dur)
            else:
                spans.append((name, ts, dur))
    if window is None:
        return None
    kernels = [k for k in kernels if window[0] <= k[1] < window[1]]
    copies = [c for c in copies if window[0] <= c[1] < window[1]]
    by_kernel: Dict[str, List[float]] = defaultdict(list)
    for n, _, d in kernels:
        by_kernel[n.split("::")[-1]].append(d)
    return DeviceTrace(window, kernels, copies, spans, dict(by_kernel))


def read(prof) -> Optional[DeviceTrace]:
    """Export the profiler's trace to a temporary file, parse, delete."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return parse(events)
