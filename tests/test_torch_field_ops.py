"""The torch port's field arithmetic against the JAX package's, limb for limb.

Inputs come from a numpy seed and include 0, 1, p - 1 and p - 2; both
packages get the same uint32 limb arrays (the port through
``stark_tpu_torch.ops.limbs.from_numpy``) and must return identical
limbs.  Tolerance: none — integer field arithmetic is exact.
"""

import jax
import numpy as np
import pytest
import torch

from stark_tpu.ops import field_ops as jfo
from stark_tpu.ops.limbs import pack, unpack
from stark_tpu.params import P, R_MOD_P
from stark_tpu_torch.ops import field_ops as tfo
from stark_tpu_torch.ops.limbs import from_numpy, to_numpy

N = 64


def _values(seed: int):
    rng = np.random.default_rng(seed)
    vals = [int(v) * (1 << 64) + int(w) for v, w in zip(rng.integers(0, 1 << 63, N - 4), rng.integers(0, 1 << 63, N - 4))]
    return [v % P for v in vals] + [0, 1, P - 1, P - 2]


@pytest.fixture(scope="module")
def operands():
    a = pack(_values(1))
    b = pack(_values(2)[::-1])
    mont_a = pack([v * R_MOD_P % P for v in _values(1)])
    mont_b = pack([v * R_MOD_P % P for v in _values(2)[::-1]])
    return a, b, mont_a, mont_b


def _jax(fn, *arrs):
    return np.asarray(jax.device_get(fn(*[jax.numpy.asarray(a) for a in arrs])), dtype=np.uint32)


def _torch(fn, *arrs):
    out = fn(*[from_numpy(a, "cpu") for a in arrs])
    assert out.dtype == torch.int32
    return to_numpy(out)


@pytest.mark.parametrize(
    "name, arity, mont",
    [
        ("add", 2, False),
        ("sub", 2, False),
        ("neg", 1, False),
        ("mont_mul", 2, True),
        ("mont_sqr", 1, True),
        ("to_mont", 1, False),
        ("from_mont", 1, True),
        ("mont_inv", 1, True),
    ],
)
def test_op_matches_jax(operands, name, arity, mont):
    a, b, mont_a, mont_b = operands
    args = (mont_a, mont_b) if mont else (a, b)
    args = args[:arity]
    want = _jax(getattr(jfo, name), *args)
    got = _torch(getattr(tfo, name), *args)
    assert np.array_equal(got, want)
    assert all(v < P for v in unpack(got))  # canonical


def test_is_zero_matches_jax(operands):
    a = operands[0]
    want = np.asarray(jfo.is_zero(jax.numpy.asarray(a)))
    got = tfo.is_zero(from_numpy(a, "cpu")).numpy()
    assert np.array_equal(got, want)
    assert got[-4] and not got[-3]  # the 0 and 1 entries


def test_broadcast_constant_operand(operands):
    """A (8, 1) operand broadcasts against an (8, n) one, as in the JAX ops."""
    a, _, mont_a, _ = operands
    c = pack([12345 * R_MOD_P % P])
    want = _jax(jfo.mont_mul, mont_a, c)
    assert np.array_equal(_torch(tfo.mont_mul, mont_a, c), want)
    assert np.array_equal(_torch(tfo.add, a, pack([P - 1])), _jax(jfo.add, a, pack([P - 1])))


def test_limb_conversions_round_trip(operands):
    a = operands[0]
    t = from_numpy(a, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == a.shape
    assert np.array_equal(to_numpy(t), a)
    with pytest.raises(TypeError):
        to_numpy(t.to(torch.int64))
