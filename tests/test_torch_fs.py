"""The port's fused FRI commit cascade against the JAX package, on the CPU.

* the plain Shake256 against hashlib and the JAX ``device_keccak``, and
  against hashlib at the 8 message lengths a fib-2^16 prove's cascade
  hashes;
* ``hex_words`` and ``alpha_mont_from_fs`` against the JAX ``device_fs``;
* the plain fold against the Pallas fold kernel (interpret mode) and the
  JAX XLA fold;
* the randomizer's reduction on the device (``device_prover.be17_mont``,
  Montgomery limbs) against the JAX package's ``pack_be17``;
* the kernel wrappers' input checks and CPU dispatch;
* a 2^14 FRI prove through the port's cascade against ``stark_tpu``'s
  host FRI (transcript objects and indices), at least 2 rounds fused;
* fib-1000 with the cascade engaged (the port's device-tree floor lowered
  to 2048, as tests/test_device_fs.py lowers the JAX package's), from the
  port's device pipeline and from its host prover, byte-identical to
  ``stark_tpu``'s host proof.

Tolerance: none (bytes and limbs are compared exactly).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.field import FieldElement as JaxFieldElement
from stark_tpu.fri import Fri as HostFri
from stark_tpu.models.fibonacci import FibonacciStark as HostFibonacciStark
from stark_tpu.ops import field_ops as jax_field_ops
from stark_tpu.ops.limbs import pack, pack_be17
from stark_tpu.params import GENERATOR, P, R_MOD_P
from stark_tpu.poly import Polynomial as HostPolynomial
from stark_tpu.proof_stream import ProofStream as HostProofStream
from stark_tpu.rng import DeterministicRandom as HostRandom
from stark_tpu_torch.field import FieldElement
from stark_tpu_torch.fri import Fri
from stark_tpu_torch.models.fibonacci import FibonacciStark
from stark_tpu_torch.ops import cuda_fold, cuda_fs, device_merkle
from stark_tpu_torch.ops.device_fs import alpha_mont_from_fs, fs_round_plain, hex_words
from stark_tpu_torch.ops.device_keccak import shake256_words
from stark_tpu_torch.ops.device_prover import DeviceProverCore, be17_mont
from stark_tpu_torch.ops.fold import fold_mont
from stark_tpu_torch.ops.limbs import _fold_tables, from_numpy, to_numpy
from stark_tpu_torch.proof_stream import ProofStream
from stark_tpu_torch.rng import DeterministicRandom

# The suite runs several pytest-xdist workers side by side; more than one
# torch thread per worker oversubscribes the cores, and the threads'
# OpenMP spin-waits then slow the plain versions tens of times.
torch.set_num_threads(1)


def _msg(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("n", [0, 135, 136, 137, 300])
def test_shake256_matches_hashlib_and_jax(n):
    from stark_tpu.ops.device_keccak import shake256_words as jax_shake256_words

    msg = _msg(n, n)
    got = to_numpy(shake256_words(torch.from_numpy(msg)))
    assert got.astype("<u4").tobytes() == hashlib.shake_256(msg.tobytes()).digest(32)
    assert np.array_equal(got, np.asarray(jax.device_get(jax_shake256_words(jnp.asarray(msg)))))


@pytest.mark.parametrize("r", range(8))
def test_shake256_matches_hashlib_at_the_cascade_lengths(r):
    """Round r of the fib-2^16 cascade hashes le64(count) || a 216 + 72r
    byte body || the 72 appended bytes: 3 to 6 permutations."""
    msg = _msg(8 + 216 + 72 * (r + 1), 100 + r)
    got = to_numpy(shake256_words(torch.from_numpy(msg)))
    assert got.astype("<u4").tobytes() == hashlib.shake_256(msg.tobytes()).digest(32)


def test_hex_words_and_alpha_match_jax():
    from stark_tpu.ops.device_fs import alpha_mont_from_fs as jax_alpha
    from stark_tpu.ops.device_fs import hex_words as jax_hex

    rng = np.random.default_rng(1)
    words = [rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype(np.uint32) for _ in range(3)]
    words.append(np.full(8, 0xFFFFFFFF, dtype=np.uint32))  # hi and lo halves both >= p
    words.append(np.zeros(8, dtype=np.uint32))
    for w in words:
        t = from_numpy(w, "cpu")
        j = jnp.asarray(w)
        assert bytes(hex_words(t).numpy()) == bytes(np.asarray(jax.device_get(jax_hex(j))))
        assert bytes(hex_words(t).numpy()).decode() == w.astype("<u4").tobytes().hex()
        got = to_numpy(alpha_mont_from_fs(t))
        assert np.array_equal(got, np.asarray(jax.device_get(jax_alpha(j))))
        want = JaxFieldElement.sample(w.astype("<u4").tobytes()).value
        assert got[:, 0].tolist() == pack([want * R_MOD_P % P])[:, 0].tolist()


def test_fold_matches_pallas_interpret_and_xla():
    from stark_tpu.ops.fold import fold_mont as jax_fold_mont
    from stark_tpu.ops.pallas_fold import fold_mont_pallas

    n = 512
    rng = np.random.default_rng(3)
    vals = [(int(a) << 64 | int(b)) % P for a, b in zip(rng.integers(0, 1 << 63, n), rng.integers(0, 1 << 63, n))]
    vals[:2] = [0, P - 1]
    cw = pack([v * R_MOD_P % P for v in vals])
    alpha = pack([12345 * R_MOD_P % P])
    table = _fold_tables(GENERATOR, JaxFieldElement.primitive_nth_root(n).value, n // 2)
    got = to_numpy(fold_mont(from_numpy(cw, "cpu"), from_numpy(alpha, "cpu"), from_numpy(table, "cpu")))
    pallas = fold_mont_pallas(jnp.asarray(cw), jnp.asarray(alpha), jnp.asarray(table), block=128, interpret=True)
    assert np.array_equal(got, np.asarray(pallas))
    assert np.array_equal(got, np.asarray(jax_fold_mont(jnp.asarray(cw), jnp.asarray(alpha), jnp.asarray(table))))


def test_be17_device_limbs_match_pack_be17():
    rng = np.random.default_rng(4)
    raw = bytearray(rng.integers(0, 256, 17 * 300, dtype=np.uint8).tobytes())
    raw[:17] = b"\xff" * 17  # the largest chunk: v0 >= p and b0 = 255
    raw[17:34] = bytes(17)
    raw[34:51] = b"\x00" + b"\xff" * 16
    raw = bytes(raw)
    got = to_numpy(be17_mont(raw, "cpu"))
    assert np.array_equal(got, np.asarray(jax_field_ops.to_mont(jnp.asarray(pack_be17(raw)))))
    from stark_tpu_torch.ops.limbs import pack_be17 as port_pack_be17

    assert np.array_equal(port_pack_be17(raw), pack_be17(raw))


def test_kernel_wrappers_take_the_plain_versions_on_the_cpu():
    n = 64
    cw = from_numpy(pack([i * R_MOD_P % P for i in range(n)]), "cpu")
    alpha = from_numpy(pack([5 * R_MOD_P % P]), "cpu")
    table = from_numpy(_fold_tables(GENERATOR, JaxFieldElement.primitive_nth_root(n).value, n // 2), "cpu")
    assert torch.equal(cuda_fold.fri_fold(cw, alpha, table), fold_mont(cw, alpha, table))
    body = torch.from_numpy(_msg(40 + 72, 5))
    body2 = body.clone()
    root = from_numpy(np.arange(8, dtype=np.uint32), "cpu")
    assert torch.equal(cuda_fs.fs_round(body, 40, 9, root), fs_round_plain(body2, 40, 9, root))
    assert torch.equal(body, body2)


def test_kernel_wrappers_validate_inputs():
    cw = torch.zeros((8, 64), dtype=torch.int32)
    alpha = torch.zeros((8, 1), dtype=torch.int32)
    table = torch.zeros((8, 32), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_fold.fri_fold(cw.to(torch.int64), alpha, table)
    with pytest.raises(ValueError):
        cuda_fold.fri_fold(cw, alpha, table[:, :16].contiguous())
    with pytest.raises(ValueError):
        cuda_fold.fri_fold(cw[:, :63], alpha, table)
    body = torch.zeros(100, dtype=torch.uint8)
    root = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_fs.fs_round(body, 29, 1, root)  # no room for the 72 appended bytes
    with pytest.raises(ValueError):
        cuda_fs.fs_round(body.to(torch.int32), 0, 1, root)
    with pytest.raises(ValueError):
        cuda_fs.fs_round(body, 0, 1, root[:4])


def test_cascade_fri_transcript_matches_host_fri():
    n = 1 << 14
    host = HostFri(JaxFieldElement.generator(), JaxFieldElement.primitive_nth_root(n), n, 4, 2)
    poly = HostPolynomial([i * 7919 % P for i in range(1, n // 4)])
    ps_host = HostProofStream()
    idx_host = host.prove([fe.value for fe in poly.eval_domain(host.eval_domain())], ps_host)

    fri = Fri(FieldElement.generator(), FieldElement.primitive_nth_root(n), n, 4, 2)
    core = DeviceProverCore(n, fri.offset.value, "cpu")
    ps = ProofStream()
    idx = fri.prove(core.extend_codeword(poly.coeffs), ps)
    assert fri.last_fused_rounds >= 2
    assert idx == idx_host
    assert ps.objects == ps_host.objects
    assert fri.verify(ProofStream(ps.objects), [])


@pytest.fixture(scope="module")
def host_fib1000():
    return HostFibonacciStark(1000, rng=HostRandom(11)).prove(JaxFieldElement(3), JaxFieldElement(7))


@pytest.mark.parametrize("device", ["cpu", None], ids=["device_pipeline", "host_prover"])
def test_fib1000_with_the_cascade_equals_host_proof(monkeypatch, host_fib1000, device):
    monkeypatch.setattr(device_merkle, "DEVICE_TREE_MIN", 2048)
    model = FibonacciStark(1000, device=device, rng=DeterministicRandom(11))
    result, proof = model.prove(FieldElement(3), FieldElement(7))
    assert result.value == host_fib1000[0].value
    assert proof == host_fib1000[1]
    if device is not None:
        assert model.stark._use_device_pipeline()
        assert model.stark.fri.last_fused_rounds == 3
