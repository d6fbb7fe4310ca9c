"""The card's peaks for the roofline.

* 32-bit integer operations a second: streaming multiprocessors x 64
  lanes x the maximum SM clock, both read from the card in the run.  64
  is the CUDA C++ Programming Guide's throughput a clock and SM, for
  compute capability 9.0, of 32-bit integer add, multiply-add, shift,
  compare and bitwise operations (its 128 a clock are floating-point
  lanes); no mix of integer instructions issues faster.
* Memory bandwidth: the data sheet's figure for the card's name.
"""

from __future__ import annotations

import subprocess
from typing import Optional

INT32_LANES = 64
#: bytes a second of device memory, by ``torch.cuda.get_device_name()``
BANDWIDTH = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM5 data sheet
}


def max_sm_clock_hz(index: int = 0) -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def peaks(device_index: int = 0):
    """(int32 operations a second, bytes a second), or None where the card
    or its name is unknown."""
    import torch

    props = torch.cuda.get_device_properties(device_index)
    clock = max_sm_clock_hz(device_index)
    bandwidth = BANDWIDTH.get(props.name)
    if clock is None or bandwidth is None:
        return None
    return props.multi_processor_count * INT32_LANES * clock, bandwidth
