"""The torch port's prover end to end on the CPU.

* ``fold_mont`` against the JAX package's;
* the backend seam's NTT stages against the host NTT;
* ``FibonacciStark(1000)`` (8192-point FRI domain: the device pipeline's
  floor) proved through the port's device pipeline with its plain kernel
  versions, its trace interpolated by the device arm — byte-identical to
  the ``stark_tpu`` host proof on the same seed, accepted by the host
  verifier, a wrong claim rejected, none of its trace packed on the host;
* fib-300 through the device interpolation in each form of its trace
  (the model's limb trace from the host C library or from Python ints,
  and rows, the only form packed on the host and counted) byte-identical
  to the port's host prover;
* the limb trace's producers and conversions: the C recurrence and the
  Python one against ``pack`` of ``FibonacciAir.trace``, rows -> limbs ->
  rows, and the paths that prove a limb trace as rows (the host prover,
  a device prove of at most 256 rows) giving the rows' bytes;
* the port's host prover (no backend) byte-identical to ``stark_tpu``'s;
* the port's wiring (its own ``Fri``, its own prover core) and its CLI;
* that the port is self-contained: no module of it, and not
  ``chip_smoke.py``, imports JAX or the ``stark_tpu`` package, checked by
  importing every module and by scanning every import statement.

Tolerance: none (proof bytes and limbs are compared exactly).
"""

import ast
import gc
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.field import FieldElement
from stark_tpu.models.fibonacci import FibonacciStark as HostFibonacciStark
from stark_tpu.ntt import NTT
from stark_tpu.ops import field_ops as jfo
from stark_tpu.ops.fold import _fold_tables as jax_fold_tables
from stark_tpu.ops.fold import fold_mont as jax_fold_mont
from stark_tpu.ops.limbs import pack
from stark_tpu.params import GENERATOR, P, R_MOD_P
from stark_tpu.rng import DeterministicRandom
from stark_tpu_torch.field import FieldElement as PortFieldElement
from stark_tpu_torch.fri import Fri
from stark_tpu_torch.models import fibonacci
from stark_tpu_torch.models.fibonacci import FibonacciAir, FibonacciStark
from stark_tpu_torch.ops import backend as tbackend
from stark_tpu_torch.ops.device_prover import DeviceProverCore
from stark_tpu_torch.ops.fold import fold_mont
from stark_tpu_torch.ops.limbs import _fold_tables, from_numpy, pack_trace, to_numpy, unpack_trace
from stark_tpu_torch.rng import DeterministicRandom as PortRandom
from stark_tpu_torch.stark import Stark
from stark_tpu_torch.utils import profiling

# The suite runs several pytest-xdist workers side by side; more than one
# torch thread per worker oversubscribes the cores, and the threads'
# OpenMP spin-waits then slow the plain versions tens of times.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A, B = FieldElement(3), FieldElement(7)  # the JAX package's elements, for its host prover
PA, PB = PortFieldElement(3), PortFieldElement(7)  # the port's own, for the port


def _values(n: int, seed: int):
    rng = np.random.default_rng(seed)
    vals = [(int(v) << 64 | int(w)) % P for v, w in zip(rng.integers(0, 1 << 63, n), rng.integers(0, 1 << 63, n))]
    vals[:3] = [0, 1, P - 1]
    return vals


def test_fold_mont_matches_jax():
    n = 2048
    omega = FieldElement.primitive_nth_root(n).value
    cw = pack([v * R_MOD_P % P for v in _values(n, 5)])
    alpha = pack([98765 * R_MOD_P % P])
    table = _fold_tables(GENERATOR, omega, n // 2)
    assert np.array_equal(table, jax_fold_tables(GENERATOR, omega, n // 2))
    want = np.asarray(jax_fold_mont(jnp.asarray(cw), jnp.asarray(alpha), jnp.asarray(table)))
    got = fold_mont(from_numpy(cw, "cpu"), from_numpy(alpha, "cpu"), from_numpy(table, "cpu"))
    assert np.array_equal(to_numpy(got), want)


def test_backend_stages_match_host():
    backend = tbackend.TorchBackend("cpu")
    n = 8192
    coeffs = _values(n // 2, 6)
    host = NTT(n)
    ext = backend.rs_extend(coeffs, n, GENERATOR)
    assert ext == host.coset_evaluate(coeffs, GENERATOR)
    assert backend.rs_restrict(ext, GENERATOR) == coeffs + [0] * (n // 2)
    a, b = _values(3000, 7), _values(2500, 8)
    from stark_tpu.ntt import poly_multiply

    assert backend.poly_multiply(a, b) == poly_multiply(a, b)
    assert backend.poly_multiply([], b) == []
    from stark_tpu.rescue_prime import RescuePrime

    inputs = [1, 57322816861100832358702415967512842988]
    assert backend.rescue_hash(inputs) == [RescuePrime().hash(FieldElement(x)).value for x in inputs]


def test_backend_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbackend.TorchBackend("cuda")


def _refuse_host_interpolation(*args, **kwargs):
    raise AssertionError("the device prove called the host trace interpolation")


@pytest.fixture(scope="module")
def proofs():
    """fib-1000 from the JAX host prover and from the port's device
    pipeline, with the count of row traces that prove packed; the port's
    host trace interpolation raises, so its prove must take the device
    interpolation arm (more than 256 trace rows)."""
    seed = 11
    host = HostFibonacciStark(1000, rng=DeterministicRandom(seed))
    assert host.stark.fri_domain_length == 8192
    assert not host.stark._use_device_pipeline()
    host_result, host_proof = host.prove(A, B)
    port = FibonacciStark(1000, device="cpu", rng=PortRandom(seed))
    packed = profiling.PACKED_ROW_TRACES
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Stark, "_interpolate_trace", _refuse_host_interpolation)
        result, proof = port.prove(PA, PB)
    return host_result, host_proof, port, result, proof, profiling.PACKED_ROW_TRACES - packed


def test_fibonacci_proof_bytes_equal_host(proofs):
    host_result, host_proof, port, result, proof, packed = proofs
    assert port.stark._use_device_pipeline()
    assert result.value == host_result.value
    assert proof == host_proof
    assert packed == 0  # the model's limb trace, uploaded as it came
    prof = port.stark.last_profile
    for stage in ("combination", "fri", "bq_merkle", "openings", "trace_interpolation"):
        assert stage in prof.totals


@pytest.fixture(scope="module")
def host_300():
    """fib-300's proof from the port's host prover (held to the JAX
    package's by test_port_host_prover_equals_the_jax_package_host_prover)."""
    return FibonacciStark(300, device=None, rng=PortRandom(5)).prove(PA, PB)[1]


@pytest.mark.parametrize("form", ["limbs", "limbs-python", "rows"])
def test_each_trace_form_gives_the_host_proof(host_300, form, monkeypatch):
    """fib-300 (309 rows: the device interpolates the trace) from the
    model's limb trace (the host C library's, or Python ints with the
    library taken away) and from rows handed to ``Stark.prove``: the host
    prover's bytes.  Only the rows are packed on the host, counted once in
    ``profiling.PACKED_ROW_TRACES``, which off the profiler enters no
    range and installs no hook."""
    def refused(*args, **kwargs):
        raise AssertionError("entered while off")

    port = FibonacciStark(300, device="cpu", rng=PortRandom(5))
    port.stark.backend.device_prover_min = 4096
    assert port.stark._use_device_pipeline()
    monkeypatch.setattr(Stark, "_interpolate_trace", _refuse_host_interpolation)
    monkeypatch.setattr(profiling, "record_function", refused)
    monkeypatch.setattr(profiling, "_on", refused)
    callbacks = list(gc.callbacks)
    packed = profiling.PACKED_ROW_TRACES
    if form == "rows":
        rows = port.air.trace(PA, PB)
        proof = port.stark.prove(rows, port._constraints, port.air.boundary_constraints(PA, PB, rows[-1][0]))
    else:
        if form == "limbs-python":
            monkeypatch.setattr(fibonacci, "_native_fieldvec", lambda: None)
        proof = port.prove(PA, PB)[1]
    assert proof == host_300
    assert profiling.PACKED_ROW_TRACES - packed == (form == "rows")
    assert gc.callbacks == callbacks


@pytest.mark.parametrize("seeds", [(0, 1), (1, 0), (P - 1, P - 2), (P - 1, P - 1), tuple(_values(5, 9)[3:])],
                         ids=["0-1", "1-0", "p-1-p-2", "p-1-p-1", "random"])
def test_the_fibonacci_limb_trace_is_the_packed_rows(seeds, monkeypatch):
    """The C recurrence and the Python one both write ``pack`` of each
    column of ``FibonacciAir.trace``; near p the sum wraps past 2^128."""
    from stark_tpu_torch.native import fieldvec

    air = FibonacciAir(300)
    a, b = (PortFieldElement(v) for v in seeds)
    want = pack_trace(air.trace(a, b), 2)
    native = fieldvec.fib_trace_limbs(a.value, b.value, 300)
    monkeypatch.setattr(fibonacci, "_native_fieldvec", lambda: None)
    python = air.trace_limbs(a, b)
    assert native.dtype == python.dtype == np.uint32 and native.shape == python.shape == (2, 8, 301)
    assert np.array_equal(native, want) and np.array_equal(python, want)


def test_rows_to_limbs_to_rows_is_the_identity():
    rows = FibonacciAir(300).trace(PortFieldElement(P - 1), PortFieldElement(5))
    limbs = pack_trace(rows, 2)
    assert [[v.value for v in row] for row in unpack_trace(limbs)] == [[v.value for v in row] for row in rows]
    assert np.array_equal(pack_trace(unpack_trace(limbs), 2), limbs)


@pytest.mark.parametrize("path", ["host", "short"])
def test_the_row_paths_prove_a_limb_trace_as_its_rows(path):
    """The host prover, and a device prove of at most 256 rows (host
    interpolation), turn a limb trace into rows: the rows' bytes."""
    steps = 300 if path == "host" else 100

    def proof(form):
        port = FibonacciStark(steps, device=None if path == "host" else "cpu", rng=PortRandom(4))
        if path == "short":
            port.stark.backend.device_prover_min = 1024
        assert port.stark._use_device_pipeline() == (path == "short")
        rows = port.air.trace(PA, PB)
        trace = rows if form == "rows" else port.air.trace_limbs(PA, PB)
        return port.stark.prove(trace, port._constraints, port.air.boundary_constraints(PA, PB, rows[-1][0]))

    assert proof("limbs") == proof("rows")


def test_a_limb_trace_of_another_shape_is_refused():
    port = FibonacciStark(10, device=None)
    boundary = port.air.boundary_constraints(PA, PB, PA)
    for bad in (np.zeros((3, 8, 11), np.uint32), np.zeros((2, 8, 11), np.int64), np.zeros((2, 8), np.uint32)):
        with pytest.raises(ValueError, match="limb trace"):
            port.stark.prove(bad, port._constraints, boundary)


def test_fibonacci_proof_verifies_and_wrong_claim_fails(proofs):
    _, _, port, result, proof, _ = proofs
    host_verifier = HostFibonacciStark(1000)
    assert host_verifier.verify(A, B, FieldElement(result.value), proof)
    assert port.verify(PA, PB, result, proof)
    assert not port.verify(PA, PB, result + PortFieldElement(1), proof)
    assert not host_verifier.verify(A, B, FieldElement(result.value + 1), proof)


def test_port_wiring(proofs):
    port = proofs[2]
    assert type(port.stark.fri) is Fri
    core = port.stark._device_core()
    assert isinstance(core, DeviceProverCore)
    assert core.device == torch.device("cpu") and core.n == 8192
    assert port.stark.fri.last_fused_rounds == 0  # 8192 points: below two device-tree rounds


def test_device_air_group_values_match_host(proofs):
    """The verifier's fast path reads the same group values as the host's
    multi-point evaluation."""
    stark = proofs[2].stark
    constraints = proofs[2]._constraints
    indices = [0, 3, 4097, 8191]
    got = stark._device_air_group_values(constraints, [True, False], indices)
    assert got[1] is None
    assert got[0] == stark._air_group_point_values(constraints[0], indices)


def test_tampered_trace_trips_the_device_degree_check():
    port = FibonacciStark(1000, device="cpu", rng=PortRandom(6))
    trace = port.air.trace(PA, PB)
    trace[500][0] = trace[500][0] + PortFieldElement(1)
    boundary = port.air.boundary_constraints(PA, PB, trace[-1][0])
    with pytest.raises(ValueError, match="degree"):
        port.stark.prove(trace, port._constraints, boundary)


def test_cli_round_trip_on_cpu(tmp_path, proofs):
    out = tmp_path / "fib.bin"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # one torch thread, as in this process
    run = lambda *args: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "stark_tpu_torch.cli", *args], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=600,
    )
    common = ["--model", "fibonacci", "--steps", "1000", "--seed-a", "3", "--seed-b", "7", "--device", "cpu"]
    p = run("prove", *common, "--seed", "11", "--out", str(out))
    assert p.returncode == 0, p.stderr
    info = json.loads(p.stdout)
    assert out.read_bytes() == proofs[1]  # the host prover's bytes
    assert info["output"] == str(proofs[0].value)
    p = run("verify", *common, "--output", info["output"], "--proof", str(out))
    assert p.returncode == 0 and json.loads(p.stdout)["valid"], p.stderr
    p = run("verify", *common, "--output", str(proofs[0].value + 1), "--proof", str(out))
    assert p.returncode == 1 and not json.loads(p.stdout)["valid"]


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stark_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(stark_tpu_torch.__path__, 'stark_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "assert len(names) >= 30, names\n"
        "assert {'stark_tpu_torch.serve', 'stark_tpu_torch.parallel.stark_sharded'} <= set(names), names\n"
        "bad = [m for m in sys.modules if m in ('jax', 'stark_tpu') or m.startswith(('jax.', 'stark_tpu.'))]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


def _imported_modules(path: Path):
    """(line, module) of every import statement in a file, at any depth
    (lazy imports inside functions included); relative imports are
    reported as written, with their leading dots."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, "." * node.level + (node.module or "")


def test_no_import_of_jax_or_the_jax_package_anywhere_in_the_port():
    files = sorted(Path(REPO, "stark_tpu_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]
    assert len(files) >= 30
    rescue_modules = {"rescue_prime.py", "rescue_native.py", "rescue.py", "cuda_rescue.py", "rescue_stark.py",
                      "mimc.py", "rescue_chain.py", "cli.py"}
    probe_modules = {"cuda_probes.py", "lazy_limb_experiment.py", "quick_timing.py", "mont_mul_experiments.py",
                     "merkle_roofline.py"}
    service_and_mesh_modules = {"serve.py", "mesh.py", "ntt_sharded.py", "fold_sharded.py", "merkle_sharded.py",
                                "stark_sharded.py"}
    assert rescue_modules | probe_modules | service_and_mesh_modules <= {path.name for path in files}
    bad = [
        f"{path.relative_to(REPO)}:{line}: {module}"
        for path in files
        for line, module in _imported_modules(path)
        if module.split(".")[0] in ("jax", "jaxlib", "stark_tpu")
    ]
    assert not bad, bad


def test_port_host_prover_equals_the_jax_package_host_prover(proofs):
    """``Stark`` with no backend is the host prover: fib-1000 proofs are
    byte-identical to ``stark_tpu``'s, and it verifies the device proof."""
    host_result, host_proof = proofs[0], proofs[1]
    port_host = FibonacciStark(1000, device=None, rng=PortRandom(11))
    assert port_host.stark.backend is None and not port_host.stark._use_device_pipeline()
    result, proof = port_host.prove(PA, PB)
    assert result.value == host_result.value
    assert proof == host_proof
    assert port_host.verify(PA, PB, result, proofs[4])
