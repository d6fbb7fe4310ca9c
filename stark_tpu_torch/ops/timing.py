"""CUDA-event times of a kernel call on the card.

* :func:`device_ms`: ``LAUNCHES_PER_REP`` calls queued behind a sleep on
  the card, so the events see the kernels back to back: the kernel's own
  time per launch, with the wrapper's host time off the clock;
* :func:`call_ms`: one call from an idle queue, what a caller waits,
  the wrapper's host time included;
* :func:`launch_floor_ms`: :func:`device_ms` of a kernel that does
  nothing (``csrc/probes.cu`` ``stark_launch_floor``), the least a launch
  takes on the card.

Each is the median of ``REPS`` repetitions (``call_ms``: of ``reps``).
"""

from __future__ import annotations

import statistics

import torch

REPS = 5
LAUNCHES_PER_REP = 20
# cycles of the card's sleep before a queued repetition: ~5 ms at the
# H100's clock, more than the host needs to enqueue LAUNCHES_PER_REP calls
SLEEP_CYCLES = 10_000_000


def device_ms(fn, launches: int = LAUNCHES_PER_REP) -> float:
    """Median device time of one fn() with ``launches`` calls queued back
    to back behind a sleep, so host overhead stays off the clock."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def call_ms(fn, reps: int = REPS) -> float:
    """Median time of one fn() started on an idle queue, host part
    included, over ``reps`` calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launch_floor_ms(device) -> float:
    """:func:`device_ms` of one launch of an empty kernel on ``device``'s
    current stream; measurement only, counted in no launch counter."""
    from . import kernels

    lib = kernels.library()

    def launch():
        err = lib.stark_launch_floor(torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"stark_launch_floor failed with CUDA error {err}")

    return device_ms(launch)
