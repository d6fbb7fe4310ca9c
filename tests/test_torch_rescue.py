"""The torch port's Rescue-Prime against the JAX package's host code.

* ``RescuePrime``: hashes, traces, boundary and transition constraints
  equal ``stark_tpu.rescue_prime.RescuePrime``'s;
* the host library's hash chain (``csrc/host/rescue.c``) equals the
  port's Python golden model chained by hand;
* the plain batched permutation (``ops/rescue.py``, through the wrapper of
  the R1 kernel on CPU tensors) equals the JAX host ``RescuePrime.hash`` /
  ``trace`` at B = 1, 5 and 33;
* the plain ``mont_pow_fixed`` of the inverse S-box, cubed, gives its
  input back, and equals Python's ``pow``;
* the wrapper's refusals;
* ``chip_smoke.py``'s product count of a permutation, R1's bound, is no
  more than a known addition chain for the inverse S-box needs.

Inputs come from a numpy seed.  The JAX package's XLA ``permutation_mont``
is not compiled here: tests/test_device_ntt.py already pins it to the
same host model.  Tolerance: none (field values are compared exactly).
"""

import numpy as np
import pytest
import torch

from stark_tpu.field import FieldElement as JaxFieldElement
from stark_tpu.rescue_prime import RescuePrime as JaxRescuePrime
from stark_tpu_torch import RescuePrime
from stark_tpu_torch.field import FieldElement
from stark_tpu_torch.ops import field_ops as fo
from stark_tpu_torch.ops import rescue
from stark_tpu_torch.ops.cuda_rescue import rescue_permutation
from stark_tpu_torch.ops.limbs import from_numpy, pack, to_numpy, unpack
from stark_tpu_torch.params import P, R_MOD_P, RESCUE_ALPHA, RESCUE_ALPHA_INV, RESCUE_M, RESCUE_N

# The suite runs several pytest-xdist workers side by side; more than one
# torch thread per worker oversubscribes the cores, and the threads'
# OpenMP spin-waits then slow the plain versions tens of times.
torch.set_num_threads(1)


def _inputs(b: int, seed: int):
    rng = np.random.default_rng(seed)
    vals = [(int(v) << 64 | int(w)) % P for v, w in zip(rng.integers(0, 1 << 63, b), rng.integers(0, 1 << 63, b))]
    return ([0, 1, P - 1] + vals)[:b]


def _jax_trace(x: int):
    return [[v.value for v in row] for row in JaxRescuePrime().trace(JaxFieldElement(x))]


def test_rescue_prime_matches_the_jax_host_model():
    port, ref = RescuePrime(), JaxRescuePrime()
    for x in _inputs(6, 1) + [57322816861100832358702415967512842988]:
        assert port.hash(FieldElement(x)).value == ref.hash(JaxFieldElement(x)).value
        assert [[v.value for v in row] for row in port.trace(FieldElement(x))] == _jax_trace(x)
    assert port.hash(FieldElement(1)).value == 244180265933090377212304188905974087294
    out = 89633745865384635541695204788332415101
    assert [(c, r, v.value) for c, r, v in port.boundary_constraints(FieldElement(out))] == [
        (c, r, v.value) for c, r, v in ref.boundary_constraints(JaxFieldElement(out))
    ]
    omicron = 42 ** 3 % P  # any element: the constraints are its polynomials
    got = port.transition_constraints(FieldElement(omicron))
    want = ref.transition_constraints(JaxFieldElement(omicron))
    assert [{k: int(v) for k, v in c.dict.items()} for c in got] == [
        {k: int(v) for k, v in c.dict.items()} for c in want
    ]


def test_native_chain_matches_the_python_golden_model():
    from stark_tpu_torch.native import rescue_native

    rp = RescuePrime()
    x = _inputs(4, 2)[3]
    rows, h = [], FieldElement(x)
    for _ in range(3):
        seg = rp.trace(h)
        rows.extend([[v.value for v in row] for row in seg])
        h = seg[-1][0]
    got = rescue_native.chain_trace(x, 3)
    assert got.shape == (3 * (RESCUE_N + 1), RESCUE_M)
    assert got.tolist() == rows


@pytest.mark.parametrize("b", [1, 5, 33])
def test_plain_hash_batch_matches_the_jax_host_hash(b):
    inputs = _inputs(b, 10 + b)
    assert rescue.hash_batch(inputs, "cpu") == [JaxRescuePrime().hash(JaxFieldElement(x)).value for x in inputs]


@pytest.mark.parametrize("b", [1, 5, 33])
def test_plain_trace_batch_matches_the_jax_host_trace(b):
    inputs = _inputs(b, 20 + b)
    got = rescue.trace_batch(inputs, "cpu")
    assert got.shape == (b, RESCUE_N + 1, RESCUE_M) and got.dtype == object
    assert [got[i].tolist() for i in range(b)] == [_jax_trace(x) for x in inputs]


def test_plain_mont_pow_fixed_inverts_the_cube():
    values = _inputs(40, 3)
    x = from_numpy(pack([v * R_MOD_P % P for v in values]), "cpu")
    y = fo.mont_pow_fixed(x, RESCUE_ALPHA_INV)
    assert torch.equal(fo.mont_mul(fo.mont_sqr(y), y), x)
    plain = unpack(to_numpy(fo.from_mont(y)))
    assert plain == [pow(v, RESCUE_ALPHA_INV, P) for v in values]
    assert unpack(to_numpy(fo.from_mont(fo.mont_pow_fixed(x, RESCUE_ALPHA)))) == [pow(v, 3, P) for v in values]
    assert torch.equal(fo.mont_pow_fixed(x, 1), x)
    assert torch.equal(fo.mont_pow_fixed(x, 0), fo.mont_one(x))


def test_rescue_permutation_wrapper_checks_its_state():
    state = torch.zeros((8, 2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        rescue_permutation(state.to(torch.int64))
    with pytest.raises(ValueError):
        rescue_permutation(torch.zeros((8, 3, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        rescue_permutation(torch.zeros((8, 2, 0), dtype=torch.int32))
    with pytest.raises(ValueError):
        rescue_permutation(torch.zeros((8, 3, 2), dtype=torch.int32).transpose(1, 2))
    with pytest.raises(ValueError):
        rescue_permutation(state.to("meta"))
    with pytest.raises(ValueError):
        rescue.hash_batch([], "cpu")
    consts = rescue.constants(torch.device("cpu"))
    assert consts.shape == (8, 4 + 4 * RESCUE_N)  # csrc/rescue.cu kConstants


def test_r1_bound_prices_no_more_products_than_a_byte_window_chain():
    """chip_smoke prices a permutation at no more products than a known
    chain for x^RESCUE_ALPHA_INV (0x87, fourteen 0xAA bytes, 0xAB) takes:
    x^2 .. x^128, x^5, x^21, x^85, x^170, x^7, x^135, then a byte window
    each (8 squarings and x^170; the last also x)."""
    import chip_smoke
    from stark_tpu_torch import params

    have, products = {1}, 0

    def mul(x, y):
        nonlocal products
        assert x in have and y in have
        have.add(x + y)
        products += 1
        return x + y

    power = 1
    for _ in range(7):
        power = mul(power, power)
    x5 = mul(4, 1)
    x85 = mul(64, mul(16, x5))
    x170 = mul(x85, x85)
    acc = mul(128, mul(x5, 2))
    tail = RESCUE_ALPHA_INV.to_bytes(16, "big")[1:]
    assert tail == bytes([0xAA] * 14 + [0xAB])
    for byte in tail:
        for _ in range(8):
            acc = mul(acc, acc)
        acc = mul(acc, x170)
        if byte == 0xAB:
            acc = mul(acc, 1)
    assert acc == RESCUE_ALPHA_INV and products == 149
    assert chip_smoke.rescue_products(params) <= RESCUE_N * (2 * products + 4 + 8)
