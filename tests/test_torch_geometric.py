"""The port's device trace interpolation against the JAX package, on the CPU.

* ``prefix_mont_mul``, ``chirp_table`` and ``horner_eval`` against the
  JAX package's device functions, ``geometric_table`` against Python ints;
* ``device_poly_product``, ``device_chirp_eval`` and
  ``device_geometric_interpolate`` against the JAX package's host golden
  models (``stark_tpu.ntt.poly_multiply``, ``stark_tpu.geometric``), which
  tests/test_geometric_device.py pins bit-identical to its device
  functions; the JAX device versions of these cost 12-71 s of XLA:CPU
  compile each, so they are not called here;
* the plain versions of the field vector kernels (``cuda_field``) against
  Python ints, and their wrappers' input checks;
* ``DeviceProverCore.extend_mont`` against ``extend``.

fib-1000's device prove, whose proof bytes tests/test_torch_prover.py
holds against the JAX host prover's, runs this arm with the host
interpolation disabled there.

Tolerance: none (limbs and bytes are compared exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.field import FieldElement as JaxFieldElement
from stark_tpu.geometric import geometric_evaluate, geometric_interpolate
from stark_tpu.ntt import poly_multiply
from stark_tpu.ops import field_ops as jfo
from stark_tpu.ops import geometric_device as jgd
from stark_tpu_torch.ops import cuda_field as cf
from stark_tpu_torch.ops import field_ops as fo
from stark_tpu_torch.ops import geometric_device as tgd
from stark_tpu_torch.ops.device_prover import DeviceProverCore, geometric_table
from stark_tpu_torch.ops.limbs import mont_tensor, pack, to_numpy, unpack
from stark_tpu_torch.params import GENERATOR, P, R_MOD_P

torch.set_num_threads(1)

R_INV = pow(R_MOD_P, -1, P)


def _values(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [int(v) % P for v in rng.integers(0, 1 << 62, n)]


def _dev(vals):
    """Plain residues -> (8, n) Montgomery limbs on the CPU."""
    return mont_tensor([v % P for v in vals], "cpu")


def _host(t: torch.Tensor):
    """(8, n) Montgomery limbs -> plain residues."""
    return [v * R_INV % P for v in unpack(to_numpy(t))]


def _jax(vals):
    return jfo.to_mont(jnp.asarray(pack([v % P for v in vals])))


def _jax_limbs(arr) -> np.ndarray:
    return np.asarray(arr, dtype=np.uint32)


def test_prefix_mont_mul_matches_jax():
    vals = _values(37, 0)
    got = tgd.prefix_mont_mul(_dev(vals))
    assert np.array_equal(to_numpy(got), _jax_limbs(jgd.prefix_mont_mul(_jax(vals))))
    acc, want = 1, []
    for v in vals:
        acc = acc * v % P
        want.append(acc)
    assert _host(got) == want


def test_chirp_table_matches_jax():
    q = JaxFieldElement.primitive_nth_root(128).value
    got = tgd.chirp_table(q, 20, "cpu")
    assert np.array_equal(to_numpy(got), _jax_limbs(jgd.chirp_table(q, 20)))
    assert _host(got) == [pow(q, k * (k - 1) // 2, P) for k in range(20)]


def test_horner_eval_matches_jax():
    base, start = JaxFieldElement.primitive_nth_root(64).value, GENERATOR
    x_tab = geometric_table(base, start, 64, "cpu")
    coeffs = [5, P - 3, 123456789]
    got = tgd.horner_eval(coeffs, x_tab)
    assert np.array_equal(to_numpy(got), _jax_limbs(jgd.horner_eval(coeffs, jnp.asarray(to_numpy(x_tab)))))
    xs = [start * pow(base, i, P) % P for i in range(64)]
    assert _host(got) == [(coeffs[0] + coeffs[1] * x + coeffs[2] * x * x) % P for x in xs]
    assert _host(tgd.horner_eval([], x_tab)) == [0] * 64
    assert _host(tgd.horner_eval([P - 1], x_tab)) == [P - 1] * 64


@pytest.mark.parametrize("n", [1, 2, 100, 1025])
def test_geometric_table_matches_pow(n):
    base, start = 3 ** 101 % P, 7
    got = geometric_table(base, start, n, "cpu")
    assert got.shape == (8, n)
    assert _host(got) == [start * pow(base, i, P) % P for i in range(n)]


def test_device_poly_product_matches_host():
    a, b = _values(33, 1), _values(47, 11)
    got = _host(tgd.device_poly_product(_dev(a), _dev(b), 79))
    want = poly_multiply(a, b)
    assert got == (want + [0] * (79 - len(want)))[:79]


def test_device_chirp_eval_matches_host():
    q = JaxFieldElement.primitive_nth_root(256).value
    coeffs = _values(41, 2)
    assert _host(tgd.device_chirp_eval(_dev(coeffs), q, 60)) == geometric_evaluate(coeffs, 1, q, 60)


@pytest.mark.parametrize("n", [1, 2, 257])
def test_plain_mont_inv_matches_pow(n):
    vals = _values(n, n)
    vals[0] = 0
    if n > 2:
        vals[1], vals[-1] = 1, P - 1
    a = _dev(vals)
    want = [pow(v, P - 2, P) for v in vals]  # 0 -> 0
    assert _host(cf.mont_inv(a)) == want
    assert torch.equal(fo.mont_inv(a), cf.mont_inv(a))


@pytest.mark.parametrize("pattern", ["first_and_last", "run", "all"])
def test_plain_mont_inv_zero_patterns(pattern):
    """Zeros first and last, a run of zeros, and zeros only: each maps to
    zero and every other element to its inverse (Python's pow)."""
    vals = _values(257, 8)
    if pattern == "first_and_last":
        vals[0] = vals[-1] = 0
    elif pattern == "run":
        vals[100:164] = [0] * 64
    else:
        vals = [0] * 257
    got = _host(cf.mont_inv(_dev(vals)))
    assert got == [pow(v, -1, P) if v else 0 for v in vals]


def test_plain_prefix_and_binary_ops():
    a, b = _values(300, 3), _values(300, 4)
    ta, tb, col = _dev(a), _dev(b), _dev([99])
    prefix, acc = [], 1
    for x in a:
        acc = acc * x % P
        prefix.append(acc)
    assert _host(cf.prefix_mul(ta)) == prefix
    assert _host(cf.mont_mul(ta, tb)) == [x * y % P for x, y in zip(a, b)]
    assert _host(cf.add(col, tb)) == [(99 + y) % P for y in b]
    assert _host(cf.sub(ta, col)) == [(x - 99) % P for x in a]
    assert _host(cf.sub(col, ta)) == [(99 - x) % P for x in a]
    assert _host(cf.mont_mul(col, ta)) == [99 * x % P for x in a]
    assert _host(cf.neg(ta)) == [(-x) % P for x in a]


@pytest.mark.parametrize("pattern", ["none", "tile_edges", "all"])
def test_plain_prefix_mul_through_tile_edges(pattern):
    """Three K8 tiles (2 * PREFIX_TILE + 1 elements), no zero, zeros at the
    tiles' first and last elements, and zeros only: the plain version the
    kernel is held to against Python ints (a prefix through a zero is zero)."""
    tile = cf.PREFIX_TILE
    vals = _values(2 * tile + 1, 12)
    vals = [v or 1 for v in vals]
    if pattern == "tile_edges":
        for i in (tile - 1, tile, 2 * tile):
            vals[i] = 0
    elif pattern == "all":
        vals = [0] * len(vals)
    want, acc = [], 1
    for v in vals:
        acc = acc * v % P
        want.append(acc)
    assert _host(cf.prefix_mul(_dev(vals))) == want


def test_scan_status_epochs_and_tickets(monkeypatch):
    """K8's status buffer: a power of two of tiles, zeroed; each call a new
    epoch and the ticket count at its start; past the last epoch the
    ticket and the flags are zeroed again, and a buffer too small for a
    call is refused (the wrapper grows it first)."""
    status = cf.ScanStatus(3, "cpu")
    assert status.capacity == 4
    assert not status.flags.any() and not status.ticket.any() and status.values.shape == (2, 4, 4)
    assert [status.claim(t) for t in (1, 4, 2)] == [(1, 0), (2, 1), (3, 5)]
    with pytest.raises(ValueError, match="exceed"):
        status.claim(5)
    monkeypatch.setattr(cf, "EPOCHS", 5)
    status.ticket.fill_(7)
    status.flags.fill_(3 << 2 | 2)
    assert status.claim(1) == (4, 7)
    assert status.claim(2) == (1, 0)  # epoch 5 would not fit: zeroed, counted from 0
    assert not status.flags.any() and not status.ticket.any()
    assert cf.ScanStatus(1, "cpu").capacity == 1 and cf.ScanStatus(1025, "cpu").capacity == 2048


def test_scan_status_is_kept_a_device_and_grown():
    dev = torch.device("meta")
    try:
        small = cf.scan_status(3, dev)
        assert cf.scan_status(4, dev) is small
        grown = cf.scan_status(5, dev)
        assert grown is not small and grown.capacity == 8 and grown.epoch == 0
        assert cf.scan_status(2, dev) is grown
    finally:
        cf._STATUS.pop(dev, None)


def test_field_wrappers_refuse_bad_inputs():
    a = _dev(_values(16, 5))
    with pytest.raises(ValueError, match="contiguous"):
        cf.mont_inv(a[:, ::2])
    with pytest.raises(TypeError):
        cf.prefix_mul(a.to(torch.int64))
    with pytest.raises(ValueError, match="broadcast"):
        cf.add(a, a[:, :4].contiguous())
    with pytest.raises(ValueError, match="empty"):
        cf.mont_inv(a[:, :0])
    with pytest.raises(ValueError, match="bit bases"):
        cf.geometric_table(a[:, :1].contiguous(), a[:, :2].contiguous(), 16)
    with pytest.raises(ValueError, match="unknown op"):
        cf.mont_binary(7, a, a)
    meta = torch.empty((8, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cf.mont_mul(meta, meta)


@pytest.mark.parametrize("n, start", [(36, 1), (44, 7), (129, 85), (256, 1), (4105, 1)])
def test_device_geometric_interpolate_matches_host(n, start):
    q = JaxFieldElement.primitive_nth_root(512 if n <= 256 else 8192).value
    ys = _values(n, n)
    ys[0] = 0  # zero-value edge
    xs = [start * pow(q, i, P) % P for i in range(n)]
    got = tgd.device_geometric_interpolate(_dev(ys), start, q)
    assert _host(got) == geometric_interpolate(xs, ys, q)


def test_extend_mont_matches_extend():
    core = DeviceProverCore(8192, GENERATOR, "cpu")
    coeffs = _values(1009, 6)
    want = core.extend(coeffs)
    assert torch.equal(core.extend_mont(_dev(coeffs)), want)
    with pytest.raises(ValueError, match="longer"):
        core.extend_mont(_dev(_values(8193, 7)))
