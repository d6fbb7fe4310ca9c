"""Interpolation on the geometric progression {q^i : i < n} (the trace
domain, the first n powers of the trace generator), after Bostan and
Schost: with T(k) = k(k-1)/2 and ij = T(i+j) - T(i) - T(j), evaluation
at the q^t is one convolution, the Lagrange denominators have a closed
form in q-factorials, and the vanishing polynomial is a q-binomial sum.
The O(n) tables are Python integers, made once for each (q, n); the two
convolutions a column are tensor transforms."""

from __future__ import annotations

from typing import Dict, List

import torch

from . import field as F, ntt as N
from .field import P


def _batch_inverse(values: List[int]) -> List[int]:
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % P
    inv = pow(prefix[n], -1, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % P
        inv = inv * values[i] % P
    return out


def _tri_powers(q: int, count: int) -> List[int]:
    """q^T(k) for k < count (T(k+1) = T(k) + k)."""
    out = [1] * count
    qk = 1
    for k in range(1, count):
        out[k] = out[k - 1] * qk % P
        qk = qk * q % P
    return out


def zeroifier(start: int, q: int, n: int) -> List[int]:
    """Coefficients (low first) of prod_{i<n} (x - start q^i):
    sum_k (-1)^(n-k) q^T(n-k) [n choose k]_q start^(n-k) x^k."""
    fact = [1] * (n + 1)
    qm = 1
    for k in range(1, n + 1):
        qm = qm * q % P
        fact[k] = fact[k - 1] * (qm - 1) % P
    inv_fact = _batch_inverse(fact)
    qt = _tri_powers(q, n + 1)
    spow = [1] * (n + 1)
    for j in range(1, n + 1):
        spow[j] = spow[j - 1] * start % P
    z = [0] * (n + 1)
    for k in range(n + 1):
        c = qt[n - k] * fact[n] % P * inv_fact[k] % P * inv_fact[n - k] % P * spow[n - k] % P
        z[k] = (-c) % P if (n - k) & 1 else c
    return z


class Interpolator:
    """Interpolation over {q^i : i < n}; the tables are made at the first
    call and kept."""

    def __init__(self, q: int, n: int, device) -> None:
        self.q, self.n, self.device = q, n, device
        self._tables: Dict[str, torch.Tensor] = {}

    def _build(self) -> None:
        q, n = self.q, self.n
        qinv = pow(q, -1, P)
        fact = [1] * n
        qm = 1
        for k in range(1, n):
            qm = qm * q % P
            fact[k] = fact[k - 1] * (qm - 1) % P
        # Lagrange denominators prod_{j != i} (q^i - q^j)
        #   = (-1)^(n-1-i) q^(T(i) + i(n-1-i)) fact[i] fact[n-1-i]
        d = [0] * n
        e = 1  # q^(T(i) + i(n-1-i)); the exponent steps by n-2-i
        step = pow(q, n - 2, P)
        for i in range(n):
            v = e * fact[i] % P * fact[n - 1 - i] % P
            d[i] = (-v) % P if (n - 1 - i) & 1 else v
            e = e * step % P
            step = step * qinv % P
        dev = self.device
        self._tables["d_inv"] = F.from_ints(_batch_inverse(d), dev)
        qt = _tri_powers(q, 2 * n - 1)
        qt_inv = _tri_powers(qinv, n)
        self._tables["chirp"] = F.from_ints(qt, dev)
        self._tables["chirp_inv"] = F.from_ints(qt_inv, dev)
        self._tables["z"] = F.from_ints(zeroifier(1, q, n), dev)

    def interpolate(self, values: torch.Tensor) -> torch.Tensor:
        """(8, n) Montgomery values at q^i -> (8, n) Montgomery coefficients
        of the interpolant of degree below n."""
        if not self._tables:
            self._build()
        t = self._tables
        n = self.n
        u = F.mul(values, t["d_inv"])
        # h_t = sum_i u_i q^(it) = q^-T(t) sum_i [u_i q^-T(i)] q^T(i+t)
        f = F.mul(u, t["chirp_inv"])
        conv = N.multiply(f.flip(1), t["chirp"])
        h = F.mul(conv[:, n - 1 : 2 * n - 1], t["chirp_inv"])
        # coefficient d = sum_t z_(d+1+t) h_t
        conv = N.multiply(t["z"], h.flip(1))
        return conv[:, n : 2 * n].contiguous()
