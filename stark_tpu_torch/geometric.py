"""O(n log n) interpolation/evaluation on geometric progressions.

The STARK trace domain is {omicron^i, i < trace_length} — a geometric
progression that is NOT a full power-of-two subgroup (trace_length is
36, 44, 60... while omicron has order 128), so plain NTTs don't apply and
the reference falls back to O(n^2) Lagrange (reference:
univariate_poly.rs:147-164) — its interpolation bottleneck for long
traces.

Geometric progressions admit chirp-style O(M(n)) algorithms
(Bostan-Schost, "Polynomial evaluation and interpolation on special sets
of points", 2005).  With T(k) = k(k-1)/2 and the identity
ij = T(i+j) - T(i) - T(j):

* evaluation at q^t is a correlation:
      p(q^t) = q^{-T(t)} * sum_j [c_j q^{-T(j)}] q^{T(t+j)}
* Lagrange denominators have the closed q-factorial form
      prod_{j != i} (q^i - q^j)
        = (-1)^{n-1-i} q^{T(i) + i(n-1-i)} fact[i] fact[n-1-i],
      fact[k] = prod_{m<=k} (q^m - 1)
* the vanishing polynomial is the q-binomial expansion
      prod_i (x - q^i) = sum_k (-1)^{n-k} q^{T(n-k)} C_q(n,k) x^k
* the numerator combine  sum_i u_i Z(x)/(x - q^i)  is one more
  correlation against Z's coefficients.

Everything reduces to three NTT multiplications plus O(n) tables and one
batch inversion.  Progressions starting at s != 1 are handled by the
substitution p(s*y).

Differential-tested against Newton interpolation; transparently hooked
into :meth:`stark_tpu_torch.poly.Polynomial.lagrange` for large geometric
domains.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .params import P


def _tri(k: int) -> int:
    """Triangular number T(k) = k(k-1)/2 (exponents taken mod p-1)."""
    return (k * (k - 1) // 2) % (P - 1)


def _batch_inverse(values: Sequence[int]) -> List[int]:
    n = len(values)
    prefix = [1] * (n + 1)
    for i in range(n):
        prefix[i + 1] = prefix[i] * values[i] % P
    inv_all = pow(prefix[n], -1, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % P
        inv_all = inv_all * values[i] % P
    return out


def detect_ratio(xs: Sequence[int]) -> Optional[int]:
    """If xs is a geometric progression x_i = xs[0] * q^i (with xs[0] and
    q nonzero), return q; else None."""
    n = len(xs)
    if n < 3 or xs[0] == 0 or xs[1] == 0:
        return None
    q = xs[1] * pow(xs[0], -1, P) % P
    if q == 0:
        return None
    cur = xs[1]
    for i in range(2, n):
        cur = cur * q % P
        if xs[i] != cur:
            return None
    return q


def _chirp_eval(
    coeffs: Sequence[int], q: int, m: int, multiply=None
) -> List[int]:
    """[p(q^t) for t < m] where p has the given coefficients (low-first)."""
    from .ntt import poly_multiply

    if multiply is None:
        multiply = poly_multiply
    n = len(coeffs)
    if n == 0:
        return [0] * m
    q_inv = pow(q, -1, P)
    f = [coeffs[j] * pow(q_inv, _tri(j), P) % P for j in range(n)]
    g = [pow(q, _tri(k), P) for k in range(n + m - 1)]
    fr = f[::-1]
    conv = multiply(fr, g)
    return [
        pow(q_inv, _tri(t), P) * conv[n - 1 + t] % P for t in range(m)
    ]


def geometric_evaluate(
    coeffs: Sequence[int], start: int, q: int, m: int
) -> List[int]:
    """[p(start * q^t) for t < m]."""
    if start == 1:
        return _chirp_eval(coeffs, q, m)
    scaled = []
    s = 1
    for j, c in enumerate(coeffs):
        if j:
            s = s * start % P
        scaled.append(c * s % P)
    return _chirp_eval(scaled, q, m)


def geometric_zeroifier(start: int, q: int, n: int) -> List[int]:
    """Coefficients (low-first) of prod_{i<n} (x - start * q^i) via the
    q-binomial theorem — O(n) instead of the O(n^2) incremental product
    (the STARK transition zeroifier over {omicron^i} is exactly this).

    prod (x - q^i) = sum_k (-1)^{n-k} q^{T(n-k)} C_q(n,k) x^k, and a
    start factor rescales coefficient k by start^{n-k}."""
    if n == 0:
        return [1]
    q %= P
    start %= P
    fact = [1] * (n + 1)
    power = q
    for k in range(1, n + 1):
        fact[k] = fact[k - 1] * ((power - 1) % P) % P
        power = power * q % P
    inv_fact = _batch_inverse(fact)
    z = [0] * (n + 1)
    spow = [1] * (n + 1)  # start^j
    for j in range(1, n + 1):
        spow[j] = spow[j - 1] * start % P
    # q^{T(m)} built incrementally (T(m) = m(m-1)/2, so T(m) - T(m-1)
    # = m-1): two multiplies per entry instead of one ~log(n^2)-squaring
    # pow per entry
    qtri = [1] * (n + 1)
    qp = 1  # q^{m-1}
    for m in range(1, n + 1):
        qtri[m] = qtri[m - 1] * qp % P
        qp = qp * q % P
    for k in range(n + 1):
        cq = fact[n] * inv_fact[k] % P * inv_fact[n - k] % P
        coeff = qtri[n - k] * cq % P
        if (n - k) & 1:
            coeff = (-coeff) % P
        z[k] = coeff * spow[n - k] % P
    return z


def geometric_interpolate(
    xs: Sequence[int],
    ys: Sequence[int],
    q: Optional[int] = None,
    multiply=None,
) -> List[int]:
    """Coefficients (low-first) of the unique interpolant through
    (xs[i], ys[i]) where xs is a geometric progression.

    ``multiply`` overrides the polynomial-product primitive (e.g. a
    device-NTT multiplier from the backend); results are identical."""
    from .ntt import poly_multiply

    if multiply is None:
        multiply = poly_multiply

    n = len(xs)
    if n == 0:
        return [0]
    if n == 1:
        return [ys[0] % P]
    if q is None:
        q = detect_ratio(xs)
        if q is None:
            raise ValueError("domain is not a geometric progression")
    start = xs[0] % P

    # reduce to x_i = q^i by interpolating g(y) = p(start * y)
    # (then p's coefficients are g's scaled by start^-k)

    # q-factorials fact[k] = prod_{m=1..k} (q^m - 1), and the closed-form
    # Lagrange denominators
    fact = [1] * n
    power = q % P
    for k in range(1, n):
        fact[k] = fact[k - 1] * ((power - 1) % P) % P
        power = power * q % P

    d = [0] * n
    for i in range(n):
        e = (_tri(i) + i * (n - 1 - i)) % (P - 1)
        val = pow(q, e, P) * fact[i] % P * fact[n - 1 - i] % P
        if (n - 1 - i) & 1:
            val = (-val) % P
        d[i] = val
    d_inv = _batch_inverse(d)
    u = [ys[i] % P * d_inv[i] % P for i in range(n)]

    # h_t = sum_i u_i q^{it}  (chirp evaluation of u at q^t)
    h = _chirp_eval(u, q, n, multiply)

    # vanishing polynomial Z(x) = prod (x - q^i) via q-binomials
    # C_q(n, k) = factN / (fact[k] * fact[n-k]) with fact extended to n
    fact_n = fact[n - 1] * ((pow(q, n, P) - 1) % P) % P  # fact[n]
    fact_ext = fact + [fact_n]
    inv_fact = _batch_inverse(fact_ext)
    z = [0] * (n + 1)
    for k in range(n + 1):
        cq = fact_ext[n] * inv_fact[k] % P * inv_fact[n - k] % P
        coeff = pow(q, _tri(n - k), P) * cq % P
        if (n - k) & 1:
            coeff = (-coeff) % P
        z[k] = coeff

    # N_d = sum_t Z_{d+1+t} h_t  — correlation of Z against h
    conv = multiply(z, h[::-1])
    g_coeffs = [conv[d_ + n] for d_ in range(n)]

    if start != 1:
        inv_s = pow(start, -1, P)
        s = 1
        for k in range(n):
            if k:
                s = s * inv_s % P
            g_coeffs[k] = g_coeffs[k] * s % P
    return g_coeffs
