"""What the program keeps of itself while a profiler records
(``stark_tpu_torch.utils.profiling``): its ranges on the host's monotonic
clock (``RANGES``), the collector's counter (``COLLECTOR``) and the chain's
AIR build by region (``RescueChainStark.air_profile``).  The per-layer
readers of a traced window take them from the process; each is None where
the program keeps none, as a tree from before them does."""

from __future__ import annotations

import bisect
import sys

from portbench import tracing

ENTRY = "stark.entry.prove#"


def _profiling():
    return sys.modules.get("stark_tpu_torch.utils.profiling")


def ranges():
    """(name, start, end) of the program's ranges in the window, or None."""
    return list(getattr(_profiling(), "RANGES", None) or []) or None


def collector():
    """(runs, seconds) by generation in the window's traced proves, or None
    where the program traced nothing."""
    c = getattr(_profiling(), "COLLECTOR", None)
    if c is None or not ranges():
        return None
    return list(c.counts), list(c.seconds)


def air_profile():
    """The chain's AIR build's seconds by region, or None."""
    cls = getattr(sys.modules.get("stark_tpu_torch.models.rescue_chain"), "RescueChainStark", None)
    prof = getattr(cls, "air_profile", None)
    return dict(prof.totals) if prof is not None and prof.totals else None


def on_trace_clock(trace, rngs):
    """``rngs`` moved onto the trace's clock, or None.  The harness's span
    ``portbench.prove#<k>`` opens a few microseconds before the program's
    k-th ``stark.entry.prove``: each range takes the offset between the
    two of the last prove that opened at or before it."""
    if trace is None or not rngs:
        return None
    starts = sorted(s for n, s, _ in trace.spans if n.startswith(tracing.PROVE))
    entries = sorted(a for n, a, _ in rngs if n.startswith(ENTRY))
    if not starts or len(starts) != len(entries):
        return None
    shift = [s - e for s, e in zip(starts, entries)]
    out = []
    for n, a, b in rngs:
        d = shift[max(0, bisect.bisect_right(entries, a) - 1)]
        out.append((n, a + d, b + d))
    return out
