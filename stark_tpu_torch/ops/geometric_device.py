"""Device-resident interpolation and evaluation on geometric progressions.

Counterpart of :mod:`stark_tpu.ops.geometric_device`: the Bostan-Schost
chirp interpolation of :func:`stark_tpu_torch.geometric.geometric_interpolate`
run on the device, with the same algebra line for line, so each
intermediate can be held against the JAX package's:

* every power table is a structured recurrence, not a loop of modpows:
  q^{T(k)} (T(k) = k(k-1)/2) is the exclusive prefix product of the
  geometric series q^k;
* q-factorials are prefix products of (q^m - 1); Lagrange denominators
  use q^{e_i} = q^{-T(i)} * (q^{n-2})^i (e_i = T(i) + i(n-1-i) mod p-1);
* batch inversion is Fermat's; the three polynomial products are device
  NTT products through ``best_plan(n, device)``.

The field arithmetic goes through :mod:`stark_tpu_torch.ops.cuda_field`:
prefix products (K8), power tables (K9), inversions (K7) and elementwise
products, sums and differences (K10) are the hand-written kernels on the
card and their plain versions on the CPU; the products' transforms are
K2/K3 from 2^13 points.  Reversals are ``torch.flip`` and every slice
handed to a kernel is made contiguous first.

The JAX module's ``_interp_jit``, ``_fuse_interp`` and ``product_tabs``
exist only to build and feed one XLA executable for the whole
interpolation; PyTorch runs eagerly, so they have no counterpart here and
:func:`device_poly_product` takes no table argument.

Bit-identical to :func:`stark_tpu_torch.geometric.geometric_interpolate`
(tests/test_torch_geometric.py).
"""

from __future__ import annotations

import torch

from ..params import NUM_LIMBS, P
from . import cuda_field as cf
from .backend import best_plan
from .device_prover import geometric_table
from .limbs import mont_tensor


def _mont_col(value: int, device) -> torch.Tensor:
    """(8, 1) Montgomery column of one residue."""
    return mont_tensor([value % P], device)


def prefix_mont_mul(arr: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along axis 1 of an (8, n) Montgomery
    tensor (K8)."""
    return cf.prefix_mul(arr.contiguous())


def exclusive_prefix_mont_mul(arr: torch.Tensor) -> torch.Tensor:
    """[1, a0, a0*a1, ...]: prefix products shifted right by one."""
    n = arr.shape[1]
    shifted = torch.cat([_mont_col(1, arr.device), arr[:, : n - 1]], dim=1)
    return prefix_mont_mul(shifted)


def chirp_table(q: int, length: int, device) -> torch.Tensor:
    """(8, length) Montgomery table of q^{T(k)}, T(k) = k(k-1)/2: the
    exclusive prefix product of the geometric series q^k."""
    return exclusive_prefix_mont_mul(geometric_table(q % P, 1, length, device))


def _zero_pad(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([t, torch.zeros((NUM_LIMBS, n - t.shape[1]), dtype=torch.int32, device=t.device)], dim=1)


def device_poly_product(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """NTT product of two (8, la) / (8, lb) Montgomery coefficient tensors,
    truncated to ``out_len`` coefficients, with no host round trip."""
    la, lb = a.shape[1], b.shape[1]
    n = 1 << (la + lb - 2).bit_length()
    plan = best_plan(n, a.device)
    fa = plan.forward(_zero_pad(a, n))
    fb = plan.forward(_zero_pad(b, n))
    return plan.inverse(cf.mont_mul(fa, fb))[:, :out_len].contiguous()


def device_chirp_eval(coeffs: torch.Tensor, q: int, m: int) -> torch.Tensor:
    """[p(q^t) for t < m] of an (8, n) Montgomery coefficient tensor (the
    correlation of :func:`stark_tpu_torch.geometric._chirp_eval`)."""
    n = coeffs.shape[1]
    q_inv = pow(q, -1, P)
    f = cf.mont_mul(coeffs.contiguous(), chirp_table(q_inv, n, coeffs.device))
    g = chirp_table(q, n + m - 1, coeffs.device)
    conv = device_poly_product(torch.flip(f, dims=[1]), g, n - 1 + m)
    return cf.mont_mul(conv[:, n - 1 : n - 1 + m].contiguous(), chirp_table(q_inv, m, coeffs.device))


def horner_eval(coeff_values, x_tab: torch.Tensor) -> torch.Tensor:
    """Evaluate a LOW-degree polynomial (plain-int coefficients, lowest
    first) pointwise over an (8, n) Montgomery x table: the boundary
    interpolant and zeroifier codewords (degree ~ #boundary points)."""
    n = x_tab.shape[1]
    if not coeff_values:
        return torch.zeros((NUM_LIMBS, n), dtype=torch.int32, device=x_tab.device)
    consts = [_mont_col(c, x_tab.device) for c in coeff_values]
    acc = consts[-1]  # an (8, 1) column until the first step broadcasts it
    for c in reversed(consts[:-1]):
        acc = cf.add(cf.mont_mul(acc, x_tab), c)
    return acc.expand(NUM_LIMBS, n).contiguous()


def _signed(arr: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Negate (mod p) the columns where ``flip`` is True."""
    return torch.where(flip[None, :], cf.neg(arr), arr)


def device_geometric_interpolate(ys: torch.Tensor, start: int, q: int) -> torch.Tensor:
    """Montgomery coefficient tensor (8, n) of the unique interpolant
    through (start * q^i, ys[i]): the Bostan-Schost chirp interpolation
    of :func:`stark_tpu_torch.geometric.geometric_interpolate`, on the
    device of ``ys``."""
    if int(ys.shape[1]) == 1:
        return ys
    return _interpolate_body(ys.contiguous(), start % P, q % P)


def _interpolate_body(ys: torch.Tensor, start: int, q: int) -> torch.Tensor:
    n = ys.shape[1]
    dev = ys.device
    q_inv = pow(q, -1, P)
    one = _mont_col(1, dev)

    # q-factorials: fact[k] = prod_{m=1..k} (q^m - 1), k = 0..n
    qpow = geometric_table(q, q, n, dev)  # q^(m+1), m = 0..n-1
    terms = cf.sub(qpow, one)  # q^m - 1 for m = 1..n
    fact_ext = torch.cat([one, prefix_mont_mul(terms)], dim=1)  # (8, n+1): fact[0..n]
    fact = fact_ext[:, :n].contiguous()

    # Lagrange denominators:
    # d[i] = (-1)^(n-1-i) q^{e_i} fact[i] fact[n-1-i],
    # e_i = T(i) + i(n-1-i) = -T(i) + i(n-2)  (mod p-1)
    qe = cf.mont_mul(chirp_table(q_inv, n, dev), geometric_table(pow(q, n - 2, P), 1, n, dev))
    d = cf.mont_mul(qe, cf.mont_mul(fact, torch.flip(fact, dims=[1])))
    idx = torch.arange(n, device=dev)
    d = _signed(d, ((n - 1 - idx) & 1) == 1)
    u = cf.mont_mul(ys, cf.mont_inv(d))

    # h_t = sum_i u_i q^{it}
    h = device_chirp_eval(u, q, n)

    # vanishing polynomial Z via q-binomials:
    # z[k] = (-1)^(n-k) q^{T(n-k)} fact[n] / (fact[k] fact[n-k])
    inv_fact = cf.mont_inv(fact_ext)
    cq = cf.mont_mul(fact_ext[:, n : n + 1].contiguous(), cf.mont_mul(inv_fact, torch.flip(inv_fact, dims=[1])))
    z = cf.mont_mul(torch.flip(chirp_table(q, n + 1, dev), dims=[1]), cq)
    kidx = torch.arange(n + 1, device=dev)
    z = _signed(z, ((n - kidx) & 1) == 1)

    # numerator combine: N_d = sum_t Z_{d+1+t} h_t
    conv = device_poly_product(z, torch.flip(h, dims=[1]), 2 * n)
    g_coeffs = conv[:, n : 2 * n].contiguous()

    if start != 1:
        g_coeffs = cf.mont_mul(g_coeffs, geometric_table(pow(start, -1, P), 1, n, dev))
    return g_coeffs
