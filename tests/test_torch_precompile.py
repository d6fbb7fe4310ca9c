"""``precompile`` of the torch port (counterpart of tests/test_precompile.py).

The warm-up must build every table a device prove caches and launch every
kernel it launches, so that the prove after it fills no cache and misses
no ``lru_cache``; the proof must not change (it equals the JAX package's
host proof of the same statement on the same seed); a model without the
device pipeline gets None; a failing job raises once the pool drains; and
two threads precompiling one statement build each cache entry once.

Each test empties the process-wide caches it reads first (pytest-xdist
runs many test files in one worker process, which share them).

Tolerance: none (proof bytes are compared exactly).
"""

import collections
import gc
import importlib
import pkgutil
import threading

import pytest
import torch

import stark_tpu_torch
from stark_tpu.field import FieldElement as JaxFieldElement
from stark_tpu.models.fibonacci import FibonacciStark as JaxFibonacciStark
from stark_tpu.rng import DeterministicRandom as JaxRandom
from stark_tpu_torch import stark as port_stark
from stark_tpu_torch.field import FieldElement
from stark_tpu_torch.models.fibonacci import FibonacciStark
from stark_tpu_torch.models.rescue_chain import RescueChainStark
from stark_tpu_torch.ops import cuda_field, cuda_ntt, device_merkle, device_prover
from stark_tpu_torch.ops import ntt as plain_ntt
from stark_tpu_torch.ops.precompile import parallel_warm
from stark_tpu_torch.rng import DeterministicRandom

# more than one torch thread per xdist worker oversubscribes the cores
torch.set_num_threads(1)

A, B = FieldElement(3), FieldElement(7)


def _fresh_caches(mp) -> None:
    """Empty the process-wide caches a prove fills (monkeypatch restores
    the old ones afterwards)."""
    mp.setattr(port_stark, "_SHARED_TABLES", {})
    mp.setattr(device_prover, "_CORE_CACHE", {})
    mp.setattr(device_prover, "_B0_TABLES", {})
    mp.setattr(cuda_field, "_COLUMNS", {})


def _lru_functions() -> dict:
    """Every ``functools.lru_cache`` of the port's modules, by name."""
    found = {}
    for info in pkgutil.walk_packages(stark_tpu_torch.__path__, "stark_tpu_torch."):
        module = importlib.import_module(info.name)
        for name, value in vars(module).items():
            if hasattr(value, "cache_info") and getattr(value, "__module__", None) == info.name:
                found[f"{info.name}.{name}"] = value
    return found


def _plans() -> list:
    return [p for p in gc.get_objects() if type(p) in (cuda_ntt.CudaNTT, plain_ntt.NTTPlan)]


def _snapshot(core, lru: dict) -> dict:
    """The keys of every cache a prove may fill, and each lru_cache's misses."""
    return {
        "shared_tables": {shape: {name: set(t) for name, t in entry.items()}
                          for shape, entry in port_stark._SHARED_TABLES.items()},
        "cores": set(device_prover._CORE_CACHE),
        "b0_tables": set(device_prover._B0_TABLES),
        "columns": set(cuda_field._COLUMNS),
        "inv_tables": set(core._inv_tables),
        "shift_tables": set(core._shift_tables),
        "comb_cache": set(core._comb_cache),
        "plans": {(type(p).__name__, p.n, id(p)): set(getattr(p, "_row_col_cache", None)
                                                       or getattr(p, "_offset_cache", {})) for p in _plans()},
        "lru_misses": {name: f.cache_info().misses for name, f in lru.items()},
    }


def _fib(steps: int, floor: int = None):
    model = FibonacciStark(steps, device="cpu", rng=DeterministicRandom(11))
    if floor is not None:
        model.stark.backend.device_prover_min = floor
    return model


def _chain():
    model = RescueChainStark(4, device="cpu", rng=DeterministicRandom(21))
    model.stark.backend.device_prover_min = 512
    return model


# fib-1000: its 8192-point domain crosses device_prover_min; chain-4 (a
# 1024-point domain, the floor lowered to 512): two exemption lists, the
# AIR built by the model's precompile
MODELS = {"fib-1000": lambda: _fib(1000), "chain-4": _chain}


@pytest.fixture(scope="module", params=sorted(MODELS))
def warmed(request):
    """precompile(threads=2) on fresh caches, then one prove; the caches'
    keys just before and just after that prove."""
    lru = _lru_functions()
    with pytest.MonkeyPatch.context() as mp:
        _fresh_caches(mp)
        model = MODELS[request.param]()
        assert model.stark._use_device_pipeline()
        timings = model.precompile(threads=2)
        core = model.stark._device_core()
        before = _snapshot(core, lru)
        out = model.prove(A, B) if request.param == "fib-1000" else model.prove(FieldElement(77))
        after = _snapshot(core, lru)
    return request.param, model, timings, before, after, out


def test_precompile_returns_every_jobs_seconds(warmed):
    name, _, timings, *_ = warmed
    jobs = {"core", "degree_bounds", "tz_poly/0", "tz_inv/0", "air_groups", "shift_tables", "prove"}
    if name == "chain-4":
        jobs |= {"tz_poly/1", "tz_inv/1"}  # its round and chain-link constraints' exemption lists
    assert set(timings) == jobs
    assert all(v >= 0 for v in timings.values()), timings


def test_the_prove_after_precompile_fills_no_cache(warmed):
    name, *_, before, after, _ = warmed
    assert before["shift_tables"] and before["comb_cache"]
    assert bool(before["inv_tables"]) == (name == "fib-1000")  # chain-4's 1024 points fold on the host
    for key in before:
        assert after[key] == before[key], key


def test_precompile_does_not_change_the_proof(warmed):
    """fib-1000: the JAX package's host proof on the same seed; chain-4:
    the port's host prover's."""
    name, model, *_, out = warmed
    if name == "fib-1000":
        want = JaxFibonacciStark(1000, rng=JaxRandom(11)).prove(JaxFieldElement(3), JaxFieldElement(7))
        assert out[0].value == want[0].value and out[1] == want[1]
        assert model.verify(A, B, *out)
    else:
        assert out == RescueChainStark(4, device=None, rng=DeterministicRandom(21)).prove(FieldElement(77))


def test_precompile_without_the_device_pipeline_returns_none():
    assert FibonacciStark(16, device="cpu").precompile() is None  # a 128-point domain, below the floor
    assert FibonacciStark(1000, device=None).precompile() is None  # the host prover
    assert RescueChainStark(4, device=None).precompile() is None


def test_a_failing_job_raises_once_the_pool_drains():
    ran = []

    def fail(msg):
        def job():
            raise ValueError(msg)
        return job

    jobs = [("a", lambda: ran.append("a")), ("bad", fail("no")), ("b", lambda: ran.append("b")),
            ("worse", fail("never"))]
    with pytest.raises(RuntimeError, match=r"bad \(ValueError: no\), worse \(ValueError: never\)|"
                                           r"worse \(ValueError: never\), bad \(ValueError: no\)"):
        parallel_warm(jobs, threads=2)
    assert sorted(ran) == ["a", "b"]


def test_a_failing_kernel_in_precompile_raises(monkeypatch):
    _fresh_caches(monkeypatch)
    model = _fib(100, floor=512)
    assert model.stark._use_device_pipeline()

    def broken(*args, **kwargs):
        raise RuntimeError("stark_combination failed with CUDA error 1")

    monkeypatch.setattr(device_prover.cuda_combination, "combination", broken)
    with pytest.raises(RuntimeError, match="precompile jobs failed: prove"):
        model.precompile(threads=2)


def test_two_threads_precompiling_one_statement_build_each_entry_once(monkeypatch):
    """Two models of one statement precompile at once, sharing the
    process-wide tables and the core: each entry of the Stark's shared
    tables, of the core's tables and of the plans' coset tables is built
    once."""
    _fresh_caches(monkeypatch)
    builds = collections.Counter()
    shared_entry = port_stark._shared_entry

    def counted(shape_key, name, key, build):
        def counting_build():
            builds[("shared", name, key)] += 1
            return build()
        return shared_entry(shape_key, name, key, counting_build)

    monkeypatch.setattr(port_stark, "_shared_entry", counted)

    class CountingDict(dict):
        def __init__(self, name):
            super().__init__()
            self.name = name

        def __setitem__(self, key, value):
            builds[(self.name, key)] += 1
            super().__setitem__(key, value)

    # fib-200: a 2048-point domain; with device trees from 2048 leaves its
    # first FRI round folds on the device (a fold table)
    monkeypatch.setattr(device_merkle, "DEVICE_TREE_MIN", 2048)
    models = [_fib(200, floor=2048) for _ in range(2)]
    core = models[0].stark._device_core()
    assert models[1].stark._device_core() is core
    for name in ("_inv_tables", "_shift_tables", "_comb_cache"):
        setattr(core, name, CountingDict(name))
    core.plan._offset_cache = CountingDict("plan")
    results, errors = [], []
    barrier = threading.Barrier(2)

    def run(model):
        try:
            barrier.wait(timeout=30)
            results.append(model.precompile(threads=1))
        except Exception as e:  # noqa: BLE001 -- reported by the assertion below
            errors.append(e)

    workers = [threading.Thread(target=run, args=(m,)) for m in models]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers) and not errors, errors
    assert len(results) == 2
    assert {key for key in builds if key[0] == "shared"} and any(key[0] == "_inv_tables" for key in builds)
    assert all(count == 1 for count in builds.values()), {k: v for k, v in builds.items() if v != 1}


def test_precompile_over_a_mesh_fills_the_sharded_cores_tables(monkeypatch):
    """A sharded core: the jobs fill its tables through its own methods,
    the prove after them adds none, and the proof is the host prover's."""
    from stark_tpu_torch.parallel import ShardedBackend, cpu_mesh

    _fresh_caches(monkeypatch)
    model = FibonacciStark(100, backend=ShardedBackend(cpu_mesh(4), device_prover_min=1024),
                           rng=DeterministicRandom(11))
    assert model.stark._use_device_pipeline()
    timings = model.precompile(threads=2)
    assert timings and all(v >= 0 for v in timings.values())
    core = model.stark._device_core()
    tables = (set(core._shift_tables), set(core._comb_cache), set(core.sntt._tables),
              set(core.fold_sharded._tables))
    assert all(tables[:3])  # a 1024-point domain folds on the host: no sharded fold table
    got = model.prove(A, B)
    assert (set(core._shift_tables), set(core._comb_cache), set(core.sntt._tables),
            set(core.fold_sharded._tables)) == tables
    assert got == FibonacciStark(100, device=None, rng=DeterministicRandom(11)).prove(A, B)
