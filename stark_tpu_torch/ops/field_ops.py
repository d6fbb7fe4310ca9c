"""Batched Montgomery arithmetic over GF(p) in plain PyTorch.

Counterpart of :mod:`stark_tpu.ops.field_ops`.  Inputs and outputs are
``(8, *batch)`` ``int32`` tensors of canonical (< p) 16-bit limbs
(:mod:`stark_tpu_torch.ops.limbs`); Montgomery form uses R = 2^128, so
every output equals the JAX package's limb for limb.

Inside, limbs widen to ``int64``.  The Montgomery product exploits
p = 0xCB80 * 2^112 + 1: p == 1 (mod 2^32), so a reduction step's
quotient is m = -t0 mod 2^32 and m * p touches only three 32-bit words.
The 64 partial products of one multiply are formed as one broadcast
product into a padded buffer whose reshape sums them along their
anti-diagonals; the reduction then runs over four 32-bit words, so a
multiply is ~70 tensor ops, where a 16-bit CIOS loop takes ~180.
Elsewhere carries and borrows share one sweep
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

from ..params import LIMB_BITS, LIMB_MASK, NUM_LIMBS, P, P_TOP, R2_MOD_P, R_MOD_P
from .limbs import from_numpy, limbs_of, pack, to_numpy, unpack

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


_WORD_MASK = (1 << 32) - 1
#: word 3 of p in 32-bit words: p = 1 + P_WORD3 * 2^96
_P_WORD3 = P_TOP << LIMB_BITS


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * 2^-128 mod p.

    The 64 limb products, summed along their anti-diagonals into the 16
    columns of a * b (each < 2^35) by one padded reshape, are paired into
    eight 32-bit words (< 2^52).  The reduction runs over 32-bit words:
    p == 1 (mod 2^32), so word i's quotient is m_i = -t_i mod 2^32, and
    m_i * p = m_i + m_i * P_TOP * 2^(112 + 32 i) touches words i, i+3 and
    i+4 only; of those additions only m_0's into word 3 is read by a later
    step, the rest are made at once after the four steps.  Then one carry
    sweep over the four high words and one subtraction of p where the
    value is >= p.  About 70 tensor ops, each on a whole row of the
    batch."""
    a, b = _wide(a, b)
    shape = a.shape
    n = a[0].numel()
    # [j, i] = a_j * b_i in rows 17 long: (j, i) lands in column 16 j + (i + j) of the flat buffer
    prods = torch.zeros((NUM_LIMBS, 17, n), dtype=torch.int64, device=a.device)
    torch.mul(a.reshape(NUM_LIMBS, 1, n), b.reshape(1, NUM_LIMBS, n), out=prods[:, :NUM_LIMBS])
    cols = prods.reshape(17 * NUM_LIMBS, n)[: 16 * NUM_LIMBS].reshape(NUM_LIMBS, 8, 2, n).sum(0)
    words = list((cols[:, 0] + (cols[:, 1] << LIMB_BITS)).unbind(0))
    ms = []
    carry = None
    for i in range(4):
        v = words[i] if carry is None else words[i].add_(carry)
        ms.append(v.neg().bitwise_and_(_WORD_MASK))
        carry = v.add_(ms[-1]).bitwise_right_shift_(32)  # the low word is now 0
        if i == 0:  # m_0 * P_TOP * 2^112 lands 16 bits into word 3
            words[3].add_((ms[0] * P_TOP & LIMB_MASK) << LIMB_BITS)
    words[4].add_(carry)
    q = torch.stack(ms) * P_TOP  # (4, n)
    high = torch.stack(words[4:])
    high += q >> LIMB_BITS
    high[:3] += (q[1:] & LIMB_MASK) << LIMB_BITS
    # value < 2p: sweep the four high words, the top one keeps its carry
    out, carry = [], None
    for k in range(3):
        s = high[k] if carry is None else high[k] + carry
        out.append(s & _WORD_MASK)
        carry = s >> 32
    out.append(high[3] + carry)
    # minus p; keep the difference where no borrow leaves the top word
    diff, borrow = [], None
    for k, pk in enumerate((1, 0, 0)):
        s = out[k] - pk if borrow is None else out[k] - pk + borrow
        diff.append(s & _WORD_MASK)
        borrow = s >> 32
    diff.append(out[3] - _P_WORD3 + borrow)
    diff = torch.stack(diff)
    v = torch.where(diff[3] >= 0, diff, torch.stack(out))
    return torch.stack([v & LIMB_MASK, v >> LIMB_BITS], dim=1).reshape(shape).to(torch.int32)


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
    """a^exponent (Montgomery in and out) for a fixed Python-int exponent,
    elementwise: fixed 4-bit windows, most significant first (4 squarings
    and a product by the digit's power a window), the powers a^d of the
    digits that occur built on demand (a^(2k) = (a^k)^2, a^(2k+1) =
    a^(2k) * a).  The counterpart of the JAX package's
    ``field_ops.mont_pow_fixed``, with the same values; ``csrc/rescue.cu``
    runs the same chain for the Rescue inverse S-box."""
    if exponent == 0:
        return mont_one(a)
    powers = {1: a}

    def power(d: int) -> torch.Tensor:
        if d not in powers:
            powers[d] = mont_sqr(power(d // 2)) if d % 2 == 0 else mont_mul(power(d - 1), a)
        return powers[d]

    digits = [int(c, 16) for c in format(exponent, "x")]  # most significant first
    acc = power(digits[0])
    for d in digits[1:]:
        for _ in range(4):
            acc = mont_sqr(acc)
        if d:
            acc = mont_mul(acc, power(d))
    return acc


def prefix_mul(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along the last axis of an (8, n)
    Montgomery tensor: log2(n) Hillis-Steele rounds of full-width products
    (the JAX package's ``geometric_device.prefix_mont_mul``)."""
    n = int(a.shape[-1])
    one = mont_one(a[:, :1])
    shift = 1
    while shift < n:
        a = mont_mul(a, torch.cat([one.expand(NUM_LIMBS, shift), a[:, : n - shift]], dim=1))
        shift *= 2
    return a


def mont_inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inversion of an (8, n) Montgomery tensor; zero maps to zero.

    Montgomery's batch inversion: with the zeros set to one, an element's
    inverse is the product of the elements before it and of those after it
    (two prefix scans) times the inverse of the total, which the host
    inverts as one Python int (the Montgomery form of x^-1 is
    (xR)^-1 * R^2).  About 2 log2(n) + 2 full-width products instead of
    Fermat's ~160.  The card's kernel (``csrc/fieldvec.cu`` K7) is a batch
    inversion too, but one a block of 2048 elements, each warp's total
    inverted by a Fermat chain on the card; the inverse is unique, so the
    limbs agree."""
    zero = is_zero(a)[None, :]
    one = mont_one(a[:, :1])
    x = torch.where(zero, one, a)
    before = prefix_mul(x)
    after = torch.flip(prefix_mul(torch.flip(x, dims=[1])), dims=[1])
    others = mont_mul(torch.cat([one, before[:, :-1]], dim=1), torch.cat([after[:, 1:], one], dim=1))
    total = unpack(to_numpy(before[:, -1:]))[0]
    total_inv = from_numpy(pack([pow(total, -1, P) * R2_MOD_P % P]), a.device)
    return torch.where(zero, a, mont_mul(others, total_inv))
