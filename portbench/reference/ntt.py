"""Radix-2 number-theoretic transforms over (8, n) Montgomery limbs."""

from __future__ import annotations

import torch

from . import field as F

_BITREV = {}


def _bitrev(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _BITREV:
        bits = n.bit_length() - 1
        idx = torch.arange(n, dtype=torch.int64)
        rev = torch.zeros_like(idx)
        for b in range(bits):
            rev |= ((idx >> b) & 1) << (bits - 1 - b)
        _BITREV[key] = rev.to(device)
    return _BITREV[key]


def ntt(x: torch.Tensor, omega: int) -> torch.Tensor:
    """[sum_j x_j omega^(ij) for i < n]: omega of order n = x.shape[1]."""
    n = x.shape[1]
    if n & (n - 1):
        raise ValueError("transform length must be a power of two")
    if n == 1:
        return x.clone()
    x = x[:, _bitrev(n, x.device)]
    table = F.powers(omega, n // 2, x.device)  # omega^j, j < n/2
    m = 1
    while m < n:
        tw = table[:, :: n // (2 * m)]  # (8, m): roots of order 2m
        y = x.reshape(8, n // (2 * m), 2, m)
        u = y[:, :, 0, :]
        v = F.mul(y[:, :, 1, :], tw.reshape(8, 1, m))
        x = torch.stack([F.add(u, v), F.sub(u, v)], dim=2).reshape(8, n)
        m *= 2
    return x


def intt(x: torch.Tensor, omega: int) -> torch.Tensor:
    n = x.shape[1]
    y = ntt(x, pow(omega, -1, F.P))
    return F.mul(y, F.constant(pow(n, -1, F.P), x.device))


def coset_evaluate(coeffs: torch.Tensor, offset: int, n: int) -> torch.Tensor:
    """[f(offset * w^i) for i < n], w of order n, f given by its (8, k)
    Montgomery coefficients (low first, k <= n)."""
    k = coeffs.shape[1]
    if k > n:
        raise ValueError("more coefficients than points")
    scaled = F.mul(coeffs, F.powers(offset, k, coeffs.device))
    padded = torch.zeros((8, n), dtype=torch.int64, device=coeffs.device)
    padded[:, :k] = scaled
    return ntt(padded, F.primitive_root(n))


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Coefficients of the product of two polynomials ((8, ka), (8, kb))."""
    k = a.shape[1] + b.shape[1] - 1
    n = 1 << max(k - 1, 1).bit_length()
    w = F.primitive_root(n)
    pa = torch.zeros((8, n), dtype=torch.int64, device=a.device)
    pb = torch.zeros_like(pa)
    pa[:, : a.shape[1]] = a
    pb[:, : b.shape[1]] = b
    return intt(F.mul(ntt(pa, w), ntt(pb, w)), w)[:, :k]
