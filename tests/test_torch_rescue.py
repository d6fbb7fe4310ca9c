"""The torch port's Rescue-Prime against the JAX package's host code.

* ``RescuePrime``: hashes, traces, boundary and transition constraints
  equal ``stark_tpu.rescue_prime.RescuePrime``'s;
* the host library's hash chain (``csrc/host/rescue.c``) equals the
  port's Python golden model chained by hand, and its words reshaped
  into the limb trace equal ``pack`` of its Python ints;
* the plain batched permutation (``ops/rescue.py``, through the wrapper of
  the R1 kernel on CPU tensors) equals the JAX host ``RescuePrime.hash`` /
  ``trace`` at B = 1, 5 and 33;
* the plain ``mont_pow_fixed`` of the inverse S-box, cubed, gives its
  input back, and equals Python's ``pow``;
* the wrapper's refusals;
* ``chip_smoke.py``'s product count of a permutation, R1's bound, is no
  more than a known addition chain for the inverse S-box needs;
* R1's own chain, read from the tables of ``csrc/rescue.cu``, replayed on
  exponents: it reaches ``RESCUE_ALPHA_INV`` in at most 149 products, each
  operand made before it is used, and its squarings are those
  ``chip_smoke.py`` prices;
* a word-level model of ``csrc/field.cuh``'s ``fe_sqr``, ``fe_mul_scan``
  and ``fe_redc`` (the same 32-bit words, carry chains and one-step
  reduction) against ``a * b * 2^-128 mod p`` on random canonical inputs
  and on 0, 1, p - 1, R mod p and (p - 1)^2 mod p, products whose value
  before the last correction is negative among them, and
  ``chip_smoke.rescue_edge_values`` against the model.

Inputs come from a numpy seed.  The JAX package's XLA ``permutation_mont``
is not compiled here: tests/test_device_ntt.py already pins it to the
same host model.  Tolerance: none (field values are compared exactly).
"""

import re
from pathlib import Path

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


@pytest.mark.parametrize("x", _inputs(4, 3), ids=["0", "1", "p-1", "random"])
def test_the_chain_limb_trace_is_the_packed_chain_ints(x):
    from stark_tpu_torch.models.rescue_chain import RescueChainAir
    from stark_tpu_torch.native import rescue_native

    ints = rescue_native.chain_trace(x, 3)
    want = np.stack([pack(list(ints[:, s])) for s in range(RESCUE_M)])
    got = rescue_native.trace_limbs(rescue_native.chain_limb_pairs(x, 3))
    assert got.dtype == np.uint32 and got.shape == (RESCUE_M, 8, 3 * (RESCUE_N + 1))
    assert np.array_equal(got, want)
    assert np.array_equal(RescueChainAir(3).trace_limbs(FieldElement(x)), want)


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


def test_r1_sbox_chain_replays_to_the_inverse_exponent():
    """Each kSetup step's exponent is the one its comment names; the whole
    chain (kSetup, then the kWindows runs) makes every operand before it
    uses it and ends at RESCUE_ALPHA_INV in at most 149 products; its
    squarings (steps that double an exponent) are the ones chip_smoke.py
    prices as R1's, and the bound it prices is below what R1 runs."""
    import chip_smoke
    from stark_tpu_torch import params

    torch.set_num_threads(1)
    source = (Path(__file__).resolve().parents[1] / "stark_tpu_torch" / "csrc" / "rescue.cu").read_text()
    block = re.search(r"kSetup\[kSetupSteps\] = \{(.*?)\n    \};", source, re.S).group(1)
    setup = [(int(d), int(a), int(b), int(e)) for d, a, b, e in
             re.findall(r"\{(\d+), (\d+), (\d+)\},\s*// x\^(\d+)", block)]
    chain = chip_smoke.sbox_chain()
    assert [step[:3] for step in setup] == chain["steps"][: len(setup)]
    exponent = {0: 1}
    for dst, a, b, named in setup:
        exponent[dst] = exponent[a] + exponent[b]
        assert exponent[dst] == named
    exponent, squarings = {0: 1}, 0
    for dst, a, b in chain["steps"]:
        assert a in exponent and b in exponent  # made before it is used
        squarings += exponent[a] == exponent[b]
        exponent[dst] = exponent[a] + exponent[b]
    assert exponent[chain["acc"]] == RESCUE_ALPHA_INV
    counts = chip_smoke.chain_counts(chain)
    assert counts == {"products": len(chain["steps"]), "squarings": squarings, "dependent": 144}
    assert len(chain["steps"]) <= 149 and squarings == 128
    runs = chip_smoke.rescue_kernel_split(params, chain)
    assert runs["squarings"] == RESCUE_N * (2 * squarings + 2)
    assert runs["general"] == RESCUE_N * (2 * (len(chain["steps"]) - squarings) + 10)
    bound_sqr, bound_mul = chip_smoke.rescue_bound_split(params)
    assert bound_sqr + bound_mul == chip_smoke.rescue_products(params)
    assert bound_sqr + bound_mul <= runs["squarings"] + runs["general"] and bound_mul <= runs["general"]


# A word-level model of csrc/field.cuh's R1 products: 32-bit words, the PTX
# carry flag as a variable, the same chains in the same order.
_M32 = (1 << 32) - 1
_KPTOP = 0xCB800000


class _Flag:
    def __init__(self):
        self.cf = 0

    def add_cc(self, a, b):
        self.cf = 0
        return self.addc_cc(a, b)

    def addc_cc(self, a, b):
        s = a + b + self.cf
        self.cf = s >> 32
        return s & _M32

    def addc(self, a, b):
        return (a + b + self.cf) & _M32

    def sub_cc(self, a, b):
        self.cf = 0
        return self.subc_cc(a, b)

    def subc_cc(self, a, b):
        need = b + self.cf
        self.cf = int(a < need)
        return (a - need) & _M32

    def subc(self, a, b):
        return (a - b - self.cf) & _M32


def _words(x):
    return [(x >> (32 * k)) & _M32 for k in range(4)]


def _lohi(x):
    return x & _M32, x >> 32


def _redc(t):
    """fe_redc: (canonical words, whether the last step added p)."""
    f = _Flag()
    m3 = f.sub_cc(t[3], t[0] * _KPTOP & _M32)
    h0 = t[0] * _KPTOP >> 32
    q1, q2, q3 = (_lohi(w * _KPTOP) for w in (t[1], t[2], m3))
    r0 = f.subc_cc(t[4], h0)
    r1 = f.subc_cc(t[5], q1[1])
    r2 = f.subc_cc(t[6], q2[1])
    r3 = f.subc_cc(t[7], q3[1])
    r4 = f.subc(0, 0)
    r0 = f.sub_cc(r0, q1[0])
    r1 = f.subc_cc(r1, q2[0])
    r2 = f.subc_cc(r2, q3[0])
    r3 = f.subc_cc(r3, 0)
    r4 = f.subc(r4, 0)
    assert r4 in (0, _M32)
    out = [f.add_cc(r0, r4 & 1), f.addc_cc(r1, 0), f.addc_cc(r2, 0), f.addc(r3, r4 & _KPTOP)]
    return out, r4 != 0


def _mul_scan(a, b):
    a, b = _words(a), _words(b)
    p = [[_lohi(a[i] * b[j]) for j in range(4)] for i in range(4)]
    f = _Flag()
    t = [p[0][0][0]]
    t.append(f.add_cc(p[0][0][1], p[0][1][0]))
    t.append(f.addc_cc(p[1][1][0], p[0][1][1]))
    t.append(f.addc_cc(p[1][1][1], p[1][2][0]))
    t.append(f.addc_cc(p[2][2][0], p[1][2][1]))
    t.append(f.addc_cc(p[2][2][1], p[2][3][0]))
    t.append(f.addc_cc(p[3][3][0], p[2][3][1]))
    t.append(f.addc(p[3][3][1], 0))
    t[1] = f.add_cc(t[1], p[1][0][0])
    t[2] = f.addc_cc(t[2], p[1][0][1])
    t[3] = f.addc_cc(t[3], p[2][1][0])
    t[4] = f.addc_cc(t[4], p[2][1][1])
    t[5] = f.addc_cc(t[5], p[3][2][0])
    t[6] = f.addc_cc(t[6], p[3][2][1])
    t[7] = f.addc(t[7], 0)
    for u, v in ((p[0][2], p[1][3]), (p[2][0], p[3][1])):
        t[2] = f.add_cc(t[2], u[0])
        t[3] = f.addc_cc(t[3], u[1])
        t[4] = f.addc_cc(t[4], v[0])
        t[5] = f.addc_cc(t[5], v[1])
        t[6] = f.addc_cc(t[6], 0)
        t[7] = f.addc(t[7], 0)
    for u in (p[0][3], p[3][0]):
        t[3] = f.add_cc(t[3], u[0])
        t[4] = f.addc_cc(t[4], u[1])
        t[5] = f.addc_cc(t[5], 0)
        t[6] = f.addc_cc(t[6], 0)
        t[7] = f.addc(t[7], 0)
    return t


def _sqr(a):
    a = _words(a)
    p = {(i, j): _lohi(a[i] * a[j]) for i in range(4) for j in range(i, 4)}
    f = _Flag()
    x1 = p[0, 1][0]
    x2 = f.add_cc(p[0, 1][1], p[0, 2][0])
    x3 = f.addc_cc(p[0, 3][0], p[0, 2][1])
    x4 = f.addc_cc(p[0, 3][1], p[1, 3][0])
    x5 = f.addc_cc(p[2, 3][0], p[1, 3][1])
    x6 = f.addc(p[2, 3][1], 0)
    x3 = f.add_cc(x3, p[1, 2][0])
    x4 = f.addc_cc(x4, p[1, 2][1])
    x5 = f.addc_cc(x5, 0)
    x6 = f.addc(x6, 0)

    def dbl(x, below):
        return (x << 1 | below >> 31) & _M32

    t = [p[0, 0][0], f.add_cc(p[0, 0][1], x1 << 1 & _M32), f.addc_cc(p[1, 1][0], dbl(x2, x1)),
         f.addc_cc(p[1, 1][1], dbl(x3, x2)), f.addc_cc(p[2, 2][0], dbl(x4, x3)), f.addc_cc(p[2, 2][1], dbl(x5, x4)),
         f.addc_cc(p[3, 3][0], dbl(x6, x5))]
    t.append(f.addc(p[3, 3][1], x6 >> 31))
    return t


def _value(words):
    return sum(w << (32 * k) for k, w in enumerate(words))


R_INV = pow(1 << 128, -1, P)


def test_r1_word_model_of_the_squaring_and_product():
    torch.set_num_threads(1)
    rng = np.random.default_rng(12)
    edges = [0, 1, P - 1, R_MOD_P, (P - 1) ** 2 % P, 2, P - 2]
    randoms = [(int(v) << 64 | int(w)) % P for v, w in zip(rng.integers(0, 1 << 63, 600, dtype=np.uint64),
                                                          rng.integers(0, 1 << 63, 600, dtype=np.uint64))]
    corrected = {"sqr": 0, "mul": 0}
    pairs = [(a, b) for a in edges for b in edges] + list(zip(randoms[:300], randoms[300:]))
    for a, b in pairs:
        t = _mul_scan(a, b)
        assert _value(t) == a * b  # the 256-bit product, before its reduction
        got, fixed = _redc(t)
        assert _value(got) == a * b * R_INV % P
        corrected["mul"] += fixed
    for a in edges + randoms:
        t = _sqr(a)
        assert _value(t) == a * a
        got, fixed = _redc(t)
        assert _value(got) == a * a * R_INV % P
        corrected["sqr"] += fixed
    # the last step's correction both taken and not: a fair share of each
    assert all(50 < n < 600 for n in corrected.values()), corrected


def test_rescue_edge_values_are_canonical_and_hit_the_correction():
    import chip_smoke
    from stark_tpu_torch import params
    from stark_tpu_torch.ops import limbs

    torch.set_num_threads(1)
    vals = chip_smoke.rescue_edge_values(params)
    assert vals[:4] == [0, 1, P - 1, R_MOD_P] and len(vals) == 8 and all(0 <= v < P for v in vals)
    assert [_redc(_sqr(v))[1] for v in vals[4:]] == [True] * 4
    state = chip_smoke.rescue_edge_state(limbs, params, "cpu")
    assert state.shape == (8, 2, 64)
    assert unpack(to_numpy(state[:, 0].contiguous()))[:9] == [0] * 8 + [1]


def test_rescue_kernel_registers_survive_a_reused_kernel_build(tmp_path, monkeypatch):
    """chip_smoke.py reads R1's registers from ptxas's lines of the kernel
    build; a process that reuses the built library reads the same."""
    import chip_smoke
    from stark_tpu_torch.ops import kernels

    torch.set_num_threads(1)
    nvcc = tmp_path / "nvcc"  # writes the file after -o and prints ptxas's lines
    nvcc.write_text("#!/bin/sh\n"
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n'
                    "echo \"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113rescue_kernelEPKiPiS1_li'\" >&2\n"
                    'echo "ptxas info    : Used 66 registers, used 0 barriers" >&2\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "build_info", {})
    kernels.build()
    assert kernels.build_info["cached"] is False
    assert chip_smoke.ptxas_registers(kernels.build_info["ptxas"], "rescue_kernel") == 66
    kernels.build_info.clear()
    kernels.build()
    assert kernels.build_info["cached"] is True
    assert chip_smoke.ptxas_registers(kernels.build_info["ptxas"], "rescue_kernel") == 66
