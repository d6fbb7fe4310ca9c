"""The algorithm's work of each hand kernel's call, and the least time the
card could take for it.

Each file of this folder but ``peaks.py`` is one kernel family: its
``KERNELS`` (the kernels' function names as the device trace shows them),
``LAUNCHES`` (the program's launch counter names) and ``count(key, args,
size)``, which gives (32-bit integer operations, bytes) for one call from
the call's shapes, as the algorithm needs them (never the kernel's
instructions).  A field element is 16 bytes; each input element is read
once and each output element written once.  ``FIELD_PRODUCT`` and the
other unit prices are the fewest 32-bit operations the unit needs.

The least time of a call is the larger of its operations over the card's
32-bit integer issue peak and its bytes over the card's memory bandwidth
(``peaks.py``); a family's share of its roofline is the sum of its calls'
least times over the sum of its kernels' times in the trace.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ELEMENT_BYTES = 16
#: 32-bit integer operations of one product in GF(p), p < 2^128: the 16
#: partial products of four 32-bit limbs by four (each at least one
#: multiply-add); its reduction and carries are not counted
FIELD_PRODUCT = 16
#: 32-bit operations of one Blake2b compression: 12 rounds of 8 G
#: functions, each 4 three-input 64-bit additions, 4 64-bit xors and 3
#: rotations by other than 32 bits, two 32-bit operations each (22)
BLAKE2B_COMPRESSION = 12 * 8 * 22
#: 32-bit operations of one Keccak-f[1600]: 24 rounds of 2 operations on
#: each half of each of the 25 lanes
KECCAK_PERMUTATION = 24 * 25 * 2 * 2


def families() -> Dict[str, ModuleType]:
    """Family name -> module, one a file of this folder."""
    out = {}
    for path in sorted(HERE.glob("*.py")):
        if path.stem in ("__init__", "peaks"):
            continue
        spec = importlib.util.spec_from_file_location(f"portbench.roofline.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def summarize(calls: List[tuple], kernel_times: Dict[str, List[float]], peak_ops: float, peak_bytes: float) -> dict:
    """Per family: calls, traced kernels, least seconds, kernel seconds and
    share (%), from the counted calls ``(family, ops, bytes)`` and the
    trace's kernel durations by function name."""
    out = {}
    for name, mod in families().items():
        least, n_calls = 0.0, 0
        for fam, ops, nbytes in calls:
            if fam == name:
                least += max(ops / peak_ops, nbytes / peak_bytes)
                n_calls += 1
        times = [d for k in mod.KERNELS for d in kernel_times.get(k, [])]
        if not n_calls and not times:
            continue
        kernel_s = sum(times)
        out[name] = {"calls": n_calls, "traced": len(times), "least_s": least, "kernel_s": kernel_s,
                     "share_pct": 100.0 * least / kernel_s if kernel_s > 0 else None}
    return out
