"""Vectorized host-side field arithmetic (numpy, no JAX).

For large-domain proving the evaluation-space prover does O(n) pointwise
column algebra (AIR terms, quotients, the weighted combination).  Python
int lists cost ~0.5us per multiply; this module does the same arithmetic
vectorized in numpy at ~10ns/element for big arrays — no device
dispatch, so it also accelerates CPU-only environments and CI.

Representation: four 32-bit limbs in uint64 lanes, shape (4, N).  The
same structural luck as the device kernels applies in base 2^32:

    p = 0xCB800000 << 96 | 1   (limbs [1, 0, 0, 0xCB800000])
    p == 1 (mod 2^32)  =>  Montgomery quotient m = -t0 mod 2^32
    m * p touches limbs 0, 3, 4 only (m * 0xCB800000 < 2^64 fits u64)

Products of 32-bit limbs are exact in u64; partial products split into
32-bit halves accumulate without overflow (column sums < 2^37).

Differential-tested against the scalar golden model.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .params import P

_MASK32 = np.uint64(0xFFFFFFFF)
_P_TOP32 = np.uint64((P >> 96) & 0xFFFFFFFF)  # 0xCB800000
_R32 = (1 << 128) % P
_R2_32 = pow(1 << 128, 2, P)


def pack32(values: Sequence[int]) -> np.ndarray:
    """Residues -> (4, N) uint64 array of 32-bit limbs (plain form)."""
    n = len(values)
    buf = bytearray(16 * n)
    for i, v in enumerate(values):
        buf[16 * i : 16 * i + 16] = int(v % P).to_bytes(16, "little")
    u32 = np.frombuffer(bytes(buf), dtype="<u4").reshape(n, 4)
    return np.ascontiguousarray(u32.T).astype(np.uint64)


def unpack32(a: np.ndarray) -> List[int]:
    """(4, N) limb array -> list of Python ints."""
    u32 = np.ascontiguousarray((a & _MASK32).T.astype("<u4"))
    buf = u32.tobytes()
    n = a.shape[1]
    return [
        int.from_bytes(buf[16 * i : 16 * i + 16], "little") for i in range(n)
    ]


def _canonicalize(t: np.ndarray) -> np.ndarray:
    """Reduce 5 propagated 32-bit limbs (< 2p) to canonical 4 limbs."""
    p_limbs = np.array(
        [(P >> (32 * i)) & 0xFFFFFFFF for i in range(5)], dtype=np.uint64
    )
    diff = np.empty_like(t)
    borrow = np.zeros(t.shape[1], dtype=np.uint64)
    for i in range(5):
        need = p_limbs[i] + borrow
        b = (t[i] < need).astype(np.uint64)
        diff[i] = (t[i] - need) & _MASK32
        borrow = b
    keep_diff = borrow == 0
    return np.where(keep_diff[None, :], diff[:4], t[:4])


def _carry(t: np.ndarray) -> np.ndarray:
    """Propagate carries over the leading limbs (values < 2^64 per lane)."""
    out = np.empty_like(t)
    carry = np.zeros(t.shape[1], dtype=np.uint64)
    for i in range(t.shape[0]):
        s = t[i] + carry
        out[i] = s & _MASK32
        carry = s >> np.uint64(32)
    return out


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Montgomery product of (4, N) Montgomery-form limb arrays."""
    if a.shape != b.shape:
        a, b = np.broadcast_arrays(a, b)
    n = a.shape[1]
    t = np.zeros((5, n), dtype=np.uint64)
    for i in range(4):
        bi = b[i]
        for j in range(4):
            prod = a[j] * bi
            t[j] += prod & _MASK32
            t[j + 1] += prod >> np.uint64(32)
        m = (np.uint64(0) - t[0]) & _MASK32
        t0 = t[0] + m
        mp = m * _P_TOP32
        t[3] += mp & _MASK32
        t[4] += mp >> np.uint64(32)
        carry = t0 >> np.uint64(32)
        t[:-1] = t[1:]
        t[-1] = 0
        t[0] += carry
    return _canonicalize(_carry(t))


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.shape != b.shape:
        a, b = np.broadcast_arrays(a, b)
    t = np.zeros((5, a.shape[1]), dtype=np.uint64)
    t[:4] = a + b
    return _canonicalize(_carry(t))


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.shape != b.shape:
        a, b = np.broadcast_arrays(a, b)
    n = a.shape[1]
    diff = np.empty((4, n), dtype=np.uint64)
    borrow = np.zeros(n, dtype=np.uint64)
    for i in range(4):
        need = b[i] + borrow
        nb = (a[i] < need).astype(np.uint64)
        diff[i] = (a[i] - need) & _MASK32
        borrow = nb
    p_limbs = [np.uint64((P >> (32 * i)) & 0xFFFFFFFF) for i in range(4)]
    added = np.empty_like(diff)
    carry = np.zeros(n, dtype=np.uint64)
    for i in range(4):
        s = diff[i] + p_limbs[i] + carry
        added[i] = s & _MASK32
        carry = s >> np.uint64(32)
    return np.where((borrow == 1)[None, :], added, diff)


def to_mont(values: Sequence[int]) -> np.ndarray:
    """Residues -> Montgomery-form (4, N) limb array."""
    return pack32([v * _R32 % P for v in values])


def from_mont(a: np.ndarray) -> List[int]:
    """Montgomery-form limb array -> plain residues."""
    one = pack32([1] * a.shape[1])
    return unpack32(mul(a, one))


class HostColumns:
    """Column algebra over Montgomery numpy arrays with a list API."""

    @staticmethod
    def from_ints(values: Sequence[int]) -> np.ndarray:
        return to_mont(list(values))

    @staticmethod
    def to_ints(a: np.ndarray) -> List[int]:
        return from_mont(a)
