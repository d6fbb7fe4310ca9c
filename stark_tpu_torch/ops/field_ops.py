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

import numpy as np
import torch

from ..params import LIMB_BITS, LIMB_MASK, NUM_LIMBS, P, P_TOP, R2_MOD_P, R_MOD_P
from .limbs import _b0_table, from_numpy, limbs_of, pack, to_numpy, unpack

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


def _digit_limbs(d: torch.Tensor) -> torch.Tensor:
    """(4, *batch) int64 base-2^32 digits -> (8, *batch) 16-bit limbs."""
    return torch.stack([d[k // 2] >> (LIMB_BITS * (k % 2)) & LIMB_MASK for k in range(NUM_LIMBS)])


def be17_device_limbs(raw: bytes, device) -> torch.Tensor:
    """Concatenated 17-byte big-endian chunks -> (8, N) canonical plain
    limbs of ``int.from_bytes(chunk, "big") % p`` on ``device``.  The host
    only splits bytes into 32-bit digits (2.5 MB uploaded instead of 16 MB
    of limbs at 2^19 chunks); the reduction runs on the device: v = b0 *
    2^128 + v0 with b0 the leading byte, v0 < 2^128 < 2p takes one
    conditional subtraction, b0 * 2^128 mod p comes from the 256-entry
    table of :func:`stark_tpu_torch.ops.limbs.pack_be17`, whose values this
    returns."""
    a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 17)
    b0 = torch.from_numpy(a[:, 0].astype(np.int64)).to(device)
    le = np.ascontiguousarray(a[:, 1:][:, ::-1])
    digits = from_numpy(np.ascontiguousarray(le.view("<u4").T), device).to(torch.int64) & 0xFFFFFFFF
    v0 = _digit_limbs(digits)
    v0 = _canonicalize(torch.cat([v0, torch.zeros_like(v0[:1])]))
    table = _digit_limbs(torch.from_numpy(_b0_table().T.astype(np.int64)).to(device))  # (8, 256)
    return add(v0, table[:, b0])
