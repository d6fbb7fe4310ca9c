"""The torch port's prover end to end on the CPU.

* ``fold_mont`` against the JAX package's;
* the backend seam's NTT stages against the host NTT;
* ``FibonacciStark(1000)`` (8192-point FRI domain: the device pipeline's
  floor) proved through the port's device pipeline with its plain kernel
  versions — byte-identical to the ``stark_tpu`` host proof on the same
  seed, accepted by the host verifier, a wrong claim rejected;
* the port's wiring (``TorchFri``, its own prover core) and its CLI;
* that no module of the port imports JAX.

Tolerance: none (proof bytes and limbs are compared exactly).
"""

import json
import os
import subprocess
import sys

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
from stark_tpu_torch.fri import TorchFri
from stark_tpu_torch.models.fibonacci import FibonacciStark
from stark_tpu_torch.ops import backend as tbackend
from stark_tpu_torch.ops.device_prover import DeviceProverCore
from stark_tpu_torch.ops.fold import fold_mont
from stark_tpu_torch.ops.limbs import _fold_tables, from_numpy, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A, B = FieldElement(3), FieldElement(7)


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
    with pytest.raises(NotImplementedError):
        backend.rescue_hash([1])


def test_backend_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbackend.TorchBackend("cuda")


@pytest.fixture(scope="module")
def proofs():
    seed = 11
    host = HostFibonacciStark(1000, rng=DeterministicRandom(seed))
    assert host.stark.fri_domain_length == 8192
    assert not host.stark._use_device_pipeline()
    host_result, host_proof = host.prove(A, B)
    port = FibonacciStark(1000, device="cpu", rng=DeterministicRandom(seed))
    result, proof = port.prove(A, B)
    return host_result, host_proof, port, result, proof


def test_fibonacci_proof_bytes_equal_host(proofs):
    host_result, host_proof, port, result, proof = proofs
    assert port.stark._use_device_pipeline()
    assert result == host_result
    assert proof == host_proof
    prof = port.stark.last_profile
    for stage in ("combination", "fri", "bq_merkle", "openings", "trace_interpolation"):
        assert stage in prof.totals


def test_fibonacci_proof_verifies_and_wrong_claim_fails(proofs):
    _, _, port, result, proof = proofs
    host_verifier = HostFibonacciStark(1000)
    assert host_verifier.verify(A, B, result, proof)
    assert port.verify(A, B, result, proof)
    assert not port.verify(A, B, result + FieldElement(1), proof)
    assert not host_verifier.verify(A, B, result + FieldElement(1), proof)


def test_port_wiring(proofs):
    port = proofs[2]
    assert isinstance(port.stark.fri, TorchFri)
    core = port.stark._device_core()
    assert isinstance(core, DeviceProverCore)
    assert core.device == torch.device("cpu") and core.n == 8192
    assert port.precompile() is None
    assert port.stark.precompile(port._constraints) is None


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
    port = FibonacciStark(1000, device="cpu", rng=DeterministicRandom(6))
    trace = port.air.trace(A, B)
    trace[500][0] = trace[500][0] + FieldElement(1)
    boundary = port.air.boundary_constraints(A, B, trace[-1][0])
    with pytest.raises(ValueError, match="degree"):
        port.stark.prove(trace, port._constraints, boundary)


def test_cli_round_trip_on_cpu(tmp_path, proofs):
    out = tmp_path / "fib.bin"
    env = dict(os.environ, PYTHONPATH=REPO)
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
        "assert len(names) >= 14, names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
