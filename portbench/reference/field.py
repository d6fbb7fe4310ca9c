"""GF(p), p = 1 + 407 * 2^119, as plain tensor operations.

An element is eight 16-bit limbs, little-endian, held in int64 along the
first axis of a tensor: shape ``(8, ...)``.  Values are kept canonical
(below p) and, inside this package, in Montgomery form (``x * 2^128 mod
p``).  Every product is the schoolbook product of the limbs followed by
eight 16-bit Montgomery steps (p is 1 mod 2^16, so each step's quotient is
the negated low limb); no step relies on anything but int64 arithmetic,
so the same code runs on the CPU and on the card.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

P = 407 * 2**119 + 1
GENERATOR = 85408008396924667383611388730472331217
TWO_ADICITY = 119
MASK = 0xFFFF
P_LIMBS = [(P >> (16 * i)) & MASK for i in range(8)]
P_TOP = P_LIMBS[7]
R = 1 << 128
R_MOD_P = R % P
R2_MOD_P = R * R % P
assert P_LIMBS[0] == 1 and all(v == 0 for v in P_LIMBS[1:7])


def primitive_root(n: int) -> int:
    """A primitive n-th root of unity (n a power of two up to 2^119): the
    generator squared down to order n."""
    if n <= 0 or n & (n - 1) or n > 1 << TWO_ADICITY:
        raise ValueError(f"no primitive {n}-th root of unity")
    return pow(GENERATOR, (1 << TWO_ADICITY) // n, P)


def limbs(values: Sequence[int], device) -> torch.Tensor:
    """(8, n) plain limbs of the given residues."""
    buf = b"".join((int(v) % P).to_bytes(16, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").reshape(-1, 8).T.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def ints(x: torch.Tensor) -> List[int]:
    """The residues of (8, n) plain limbs."""
    raw = x.reshape(8, -1).T.to("cpu").numpy().astype("<u2").tobytes()
    return [int.from_bytes(raw[16 * i : 16 * i + 16], "little") for i in range(len(raw) // 16)]


def constant(value: int, device) -> torch.Tensor:
    """(8, 1) Montgomery limbs of one residue, to broadcast."""
    return limbs([value * R % P], device)


def _carry(t: torch.Tensor) -> torch.Tensor:
    """Normalise limbs of any sign into 16 bits, the carry into the last."""
    t = t.clone()
    for j in range(t.shape[0] - 1):
        t[j + 1] += t[j] >> 16
        t[j] &= MASK
    return t


def _reduce_once(r: torch.Tensor) -> torch.Tensor:
    """(9, ...) normalised limbs of a value below 2p -> (8, ...) below p."""
    d = torch.empty_like(r)
    borrow = torch.zeros_like(r[0])
    for j in range(9):
        pj = P_LIMBS[j] if j < 8 else 0
        v = r[j] - pj - borrow
        borrow = (v < 0).to(r.dtype)
        d[j] = v + (borrow << 16)
    keep = (borrow != 0)  # r < p
    return torch.where(keep, r[:8], d[:8])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b / 2^128 mod p (shapes broadcast)."""
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    t = torch.zeros((17,) + shape, dtype=torch.int64, device=a.device)
    for i in range(8):
        t[i : i + 8] += a[i] * b
    for i in range(8):
        m = (-t[i]) & MASK
        t[i] += m
        t[i + 7] += m * P_TOP
        t[i + 1] += t[i] >> 16
    return _reduce_once(_carry(t[8:17]))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    pad = torch.zeros((1,) + s.shape[1:], dtype=s.dtype, device=s.device)
    return _reduce_once(_carry(torch.cat([s, pad])))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = torch.tensor(P_LIMBS, dtype=torch.int64, device=a.device).reshape((8,) + (1,) * (a.dim() - 1))
    s = a - b + p
    pad = torch.zeros((1,) + s.shape[1:], dtype=s.dtype, device=s.device)
    return _reduce_once(_carry(torch.cat([s, pad])))


def to_mont(x: torch.Tensor) -> torch.Tensor:
    return mul(x, constant_plain(R2_MOD_P, x.device))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    return mul(x, constant_plain(1, x.device))


def constant_plain(value: int, device) -> torch.Tensor:
    return limbs([value], device)


def mont_ints(x: torch.Tensor) -> List[int]:
    """The residues of (8, n) Montgomery limbs."""
    return ints(from_mont(x.reshape(8, -1)))


def from_ints(values: Sequence[int], device) -> torch.Tensor:
    """(8, n) Montgomery limbs of the given residues."""
    return to_mont(limbs(values, device))


def powers(base: int, n: int, device, start: int = 1) -> torch.Tensor:
    """(8, n) Montgomery limbs of start * base^i, i < n, by doubling."""
    tab = constant(start, device)
    k = 1
    while k < n:
        step = constant(pow(base, k, P), device)
        tab = torch.cat([tab, mul(tab, step)], dim=1)
        k *= 2
    return tab[:, :n].contiguous()


def inverse(x: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of (8, n) nonzero Montgomery limbs: a product
    tree up, one inverse of the root, and the tree down."""
    n = x.shape[1]
    one = constant(1, x.device)
    levels = [x]
    cur = x
    while cur.shape[1] > 1:
        if cur.shape[1] % 2:
            cur = torch.cat([cur, one], dim=1)
            levels[-1] = cur
        cur = mul(cur[:, 0::2], cur[:, 1::2])
        levels.append(cur)
    root = mont_ints(cur)[0]
    if root == 0:
        raise ZeroDivisionError("inverse of zero")
    inv = constant(pow(root, -1, P), x.device)
    for level in reversed(levels[:-1]):
        left, right = level[:, 0::2], level[:, 1::2]
        inv = inv[:, : left.shape[1]]
        out = torch.empty_like(level)
        out[:, 0::2] = mul(inv, right)
        out[:, 1::2] = mul(inv, left)
        inv = out
    return inv[:, :n].contiguous()
