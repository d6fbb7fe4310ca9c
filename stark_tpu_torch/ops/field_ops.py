"""Batched Montgomery arithmetic over GF(p) in plain PyTorch.

Counterpart of :mod:`stark_tpu.ops.field_ops`.  Inputs and outputs are
``(8, *batch)`` ``int32`` tensors of canonical (< p) 16-bit limbs
(:mod:`stark_tpu_torch.ops.limbs`); Montgomery form uses R = 2^128, so
every output equals the JAX package's limb for limb.

Inside, limbs widen to ``int64``.  The CIOS product exploits
p = 0xCB80 * 2^112 + 1 exactly as the JAX code does: the per-step
quotient is m = -t0 mod 2^16 and m * p touches only limbs 0, 7 and 8.
The 64 partial products of one multiply are formed as one broadcast
``(8, 8, *batch)`` product, so a multiply is a few dozen tensor ops
rather than hundreds.  Carries and borrows share one sweep
(:func:`_sweep`): ``>>`` on a signed ``int64`` is an arithmetic shift, so
``s >> 16`` and ``s & 0xFFFF`` are floor-division and modulo for negative
limbs too.

These run eagerly on whatever device the tensors live on; the card's
hand-written kernels (:mod:`stark_tpu_torch.ops.cuda_ntt`,
``csrc/field.cuh``) compute the same functions.  The XLA:CPU workarounds
of the JAX module (fusion barriers, one-multiply scan bodies) have no
counterpart here.
"""

from __future__ import annotations

import torch

from stark_tpu.ops.limbs import limbs_of
from stark_tpu.params import LIMB_BITS, LIMB_MASK, NUM_LIMBS, P, P_TOP, R2_MOD_P, R_MOD_P

_P9 = limbs_of(P) + [0]


def _const(value: int, like: torch.Tensor) -> torch.Tensor:
    """(8, 1, ..., 1) int64 limbs of a constant, broadcastable to ``like``."""
    shape = (NUM_LIMBS,) + (1,) * (like.dim() - 1)
    return torch.tensor(limbs_of(value), dtype=torch.int64, device=like.device).reshape(shape)


def _sweep(t: torch.Tensor):
    """Propagate carries/borrows through the limb rows of ``t`` (int64).
    Returns (rows with every limb in [0, 2^16), final carry)."""
    rows = []
    carry = None
    for k in range(t.shape[0]):
        s = t[k] if carry is None else t[k] + carry
        rows.append(s & LIMB_MASK)
        carry = s >> LIMB_BITS
    return torch.stack(rows), carry


def _canonicalize(v: torch.Tensor) -> torch.Tensor:
    """9 normalized limbs of a value < 2p -> canonical 8 limbs (int32)."""
    p9 = torch.tensor(_P9, dtype=torch.int64, device=v.device).reshape(
        (NUM_LIMBS + 1,) + (1,) * (v.dim() - 1)
    )
    d, borrow = _sweep(v - p9)
    keep = (borrow == 0).unsqueeze(0)  # v >= p
    return torch.where(keep, d[:NUM_LIMBS], v[:NUM_LIMBS]).to(torch.int32)


def _wide(a: torch.Tensor, b: torch.Tensor):
    a, b = torch.broadcast_tensors(a, b)
    return a.to(torch.int64), b.to(torch.int64)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p."""
    a, b = _wide(a, b)
    s, carry = _sweep(a + b)
    return _canonicalize(torch.cat([s, carry.unsqueeze(0)]))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p."""
    a, b = _wide(a, b)
    d, borrow = _sweep(a - b)
    plus_p, _ = _sweep(d + _const(P, d))
    return torch.where((borrow < 0).unsqueeze(0), plus_p, d).to(torch.int32)


def neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p."""
    return sub(torch.zeros_like(a), a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Boolean batch: element == 0 (canonical form assumed)."""
    return (a == 0).all(dim=0)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CIOS Montgomery product a * b * 2^-128 mod p."""
    a, b = _wide(a, b)
    prods = a.unsqueeze(1) * b.unsqueeze(0)  # [j, i] = a_j * b_i < 2^32
    lo = prods & LIMB_MASK
    hi = prods >> LIMB_BITS
    zero = torch.zeros_like(a[:1])
    t = torch.zeros((NUM_LIMBS + 1,) + a.shape[1:], dtype=torch.int64, device=a.device)
    for i in range(NUM_LIMBS):
        # t += a * b_i, product halves accumulated without carries
        t[:NUM_LIMBS] += lo[:, i]
        t[1:] += hi[:, i]
        # p == 1 (mod 2^16): quotient m = -t0 mod 2^16; m * p = m + m*P_TOP*2^112
        m = (-t[0]) & LIMB_MASK
        mp = m * P_TOP
        carry = (t[0] + m) >> LIMB_BITS
        t[NUM_LIMBS - 1] += mp & LIMB_MASK
        t[NUM_LIMBS] += mp >> LIMB_BITS
        # shift one limb right, folding the carry of the dead low limb
        t = torch.cat([t[1:], zero])
        t[0] += carry
    v, _ = _sweep(t)
    return _canonicalize(v)


def mont_sqr(a: torch.Tensor) -> torch.Tensor:
    return mont_mul(a, a)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Plain residue -> Montgomery form: REDC(a * R^2)."""
    return mont_mul(a, _const(R2_MOD_P, a))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> plain residue: REDC(a * 1)."""
    return mont_mul(a, _const(1, a))


def mont_one(like: torch.Tensor) -> torch.Tensor:
    """Montgomery form of 1 (= R mod p), broadcast against ``like``."""
    return _const(R_MOD_P, like).to(torch.int32).expand(like.shape).contiguous()


def mont_pow_fixed(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a~ ^ exponent in Montgomery form: 4-bit windowed exponentiation
    (a 15-entry power table, then 4 squarings and at most one multiply
    per hex digit)."""
    if exponent == 0:
        return mont_one(a)
    powers = [a]
    for _ in range(min(exponent, 15) - 1):
        powers.append(mont_mul(powers[-1], a))
    digits = []
    e = exponent
    while e:
        digits.append(e & 0xF)
        e >>= 4
    digits.reverse()
    acc = powers[digits[0] - 1]
    for d in digits[1:]:
        for _ in range(4):
            acc = mont_mul(acc, acc)
        if d:
            acc = mont_mul(acc, powers[d - 1])
    return acc


def mont_inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inversion via Fermat: a~^(p-2) = (a^-1)~; zero maps to zero."""
    return mont_pow_fixed(a, P - 2)
