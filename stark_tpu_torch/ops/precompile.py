"""Warm-up of the device prover before its first prove (cold-start latency).

Counterpart of :mod:`stark_tpu.ops.precompile`.  The JAX package's cold
prove waits on some fifteen XLA and Mosaic compiles, which its precompile
runs concurrently.  The port compiles nothing at run time but its kernel
library, yet the first prove of a statement pays for everything the prover
caches for that statement and for the first launch of each kernel:

* the kernel library (:func:`~stark_tpu_torch.ops.kernels.library`: one
  ``nvcc`` a source at first use, or the load of the last build);
* the prover core (``Stark._device_core``: on one device
  :func:`~stark_tpu_torch.ops.device_prover.get_core`, its NTT plan with
  the stage twiddles and the W table, the coset tables of its forward and
  inverse transforms);
* the transition zeroifiers, a host polynomial over the trace domain for
  each exemption list (``Stark._tz_poly``), and their inverted codewords
  (``Stark._device_tz_inv``);
* the AIR's group codewords (``Stark._device_air_groups``) and K11's
  program (``combination_fn``);
* the x^shift tables of every quotient's degree bound (``shift_table``);
* the fold inverse tables of every FRI round folded on the device;
* the first launch of each kernel at the prove's shapes (lazy module
  loading, the shared-memory opt-ins), the plans and tables of the trace
  interpolation's transforms, and the caching allocator's blocks for the
  prove's working set.

:func:`stark_precompile_jobs` lists these for one statement as phases of
named jobs, each through the Stark's and its core's own methods, so that
they fill whatever core the Stark has: the tables first, then the device
prove itself on a limb trace of zeros (``Stark._prove_device`` with
``dry_run``: zero randomness, no degree check), which builds the rest
(fold tables, K11's program, the interpolation's plans) and launches
every kernel the prove launches.  :func:`precompile_stark` runs the
phases in order, each on a thread pool (:func:`parallel_warm`): the jobs
of a phase are independent, and each reads what the phases before it
built.  Every cache two jobs can reach is filled under a lock, so each
entry is built once however many threads precompile.

One deviation from the JAX module: its ``parallel_warm`` logs a failed
job and records -1.0 for it.  Here the pool drains and then raises,
naming every failed job: a warm-up that swallowed a kernel's failure
would hide it until the prove.
"""

from __future__ import annotations

import functools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..params import NUM_LIMBS

Job = Tuple[str, Callable[[], object]]


def _wait(out) -> None:
    """Wait for the device work behind a job's result (JAX's
    ``block_until_ready``): synchronize each CUDA device it holds a
    tensor on, so that a kernel's failure surfaces in its job."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif hasattr(x, "shards"):  # a sharded array
            walk(x.shards)
        elif hasattr(x, "mont"):  # a device codeword
            walk(x.mont)

    walk(out)
    for dev in devices:
        torch.cuda.synchronize(dev)


def parallel_warm(jobs: Sequence[Job], threads: int = 6) -> Dict[str, float]:
    """Run warm-up thunks on a thread pool; returns name -> seconds (wall
    clock from the job's start to its device work's end).  Once every job
    has ended, raises ``RuntimeError`` naming each job that failed, the
    first failure chained."""
    timings: Dict[str, float] = {}
    failed: List[Tuple[str, BaseException]] = []

    def run(job: Job) -> None:
        name, fn = job
        t0 = time.perf_counter()
        try:
            _wait(fn())
        except Exception as e:  # noqa: BLE001 -- collected, and raised once the pool drains
            failed.append((name, e))
            return
        timings[name] = time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        for future in [pool.submit(run, job) for job in jobs]:
            future.result()
    if failed:
        names = ", ".join(f"{name} ({type(e).__name__}: {e})" for name, e in failed)
        raise RuntimeError(f"precompile jobs failed: {names}") from failed[0][1]
    return timings


def stark_precompile_jobs(stark, transition_constraints, trace_length: int, boundary=None) -> List[List[Job]]:
    """The phases of jobs that warm ``stark``'s device prove of a
    ``trace_length``-cycle trace (see the module docstring).  The jobs of
    a phase are independent; each phase reads what the ones before it
    built.  ``boundary``: the statement's boundary conditions, for the
    boundary quotients' x^shift tables (their cycles and registers are
    read, not their values); without it those tables are left to the
    prove."""
    from ..field import FieldElement
    from . import kernels

    tcs = list(transition_constraints)
    stark._check_constraint_count(len(tcs))
    core = stark._device_core  # built by the "core" job, cached on the Stark
    omega = stark.omega.value
    num_registers = stark.num_registers
    m_trace = trace_length + stark.num_randomizers
    exemption_lists = sorted({stark._exemption_list(i) for i in range(len(tcs))})
    bounds: Dict[str, object] = {}  # filled by the "degree_bounds" job

    def degree_bounds():
        bounds["max_degree"] = stark.combination_degree(tcs)
        bounds["shifts"] = [bounds["max_degree"] - b for b in stark.transition_quotient_degree_bounds(tcs)]
        if boundary is not None:
            bq = stark.boundary_quotient_degree_bounds(m_trace, boundary)
            bounds["shifts"] += [bounds["max_degree"] - b for b in bq]

    def shift_tables():
        return [core().shift_table(shift, omega) for shift in sorted(set(bounds["shifts"]))]

    def prove():
        # the device prove itself on a trace of zeros, zero randomness and
        # the statement's boundary (zeros at its cells): every stage, with
        # the prove's shapes and transcript lengths, and the allocations
        # of its working set, which the caching allocator then keeps
        zero = FieldElement(0)
        trace = np.zeros((num_registers, NUM_LIMBS, trace_length), np.uint32)
        cells = [(cycle, register, zero) for cycle, register, _ in boundary or ()]
        return stark._prove_device(trace, tcs, cells, dry_run=True)

    phases: List[List[Job]] = []
    if stark.backend.device.type == "cuda":
        phases.append([("library", kernels.library)])
    phases.append([("core", core), ("degree_bounds", degree_bounds)]
                  + [(f"tz_poly/{i}", functools.partial(stark._tz_poly, ex)) for i, ex in enumerate(exemption_lists)])
    phases.append([(f"tz_inv/{i}", lambda ex=ex: stark._device_tz_inv(core(), ex))
                   for i, ex in enumerate(exemption_lists)]
                  + [("air_groups", lambda: stark._device_air_groups(core(), tcs)),
                     ("shift_tables", shift_tables)])
    phases.append([("prove", prove)])
    return phases


def precompile_stark(stark, transition_constraints, trace_length: int, threads: int = 6,
                     boundary=None) -> Dict[str, float]:
    """Warm every table and kernel of ``stark``'s device prove (see the
    module docstring), each phase's jobs on a pool of ``threads``.
    Returns job name -> seconds; raises if a job failed.  A core whose
    mesh spans processes runs its jobs one at a time: its collectives
    must come in the same order on every rank."""
    from ..parallel.mesh import SpanningMesh

    phases = stark_precompile_jobs(stark, transition_constraints, trace_length, boundary)
    if isinstance(getattr(stark.backend, "mesh", None), SpanningMesh):
        threads = 1
    timings: Dict[str, float] = {}
    for jobs in phases:
        timings.update(parallel_warm(jobs, threads))
    return timings
