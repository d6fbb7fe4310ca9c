"""Univariate polynomials over GF(p) (host golden model).

Coefficients are stored **lowest-degree first** as canonical residues
(Python ints) — the natural order for NTTs and for the batched device
representation.  The reference stores highest-degree first
(reference: univariate_poly.rs:27); only the in-memory order differs, every
mathematical behavior is reproduced, including the reference's quirks that
shape the STARK transcript:

* ``degree()`` of the zero polynomial is 0 (reference: univariate_poly.rs:69-85);
* division returns the quotient only, silently discarding any remainder
  (reference: univariate_poly.rs:437-484) — all protocol divisions are exact;
* ``lagrange`` dispatches to the NTT when the domain is exactly the
  consecutive powers of the canonical primitive n-th root (n a power of two,
  n > 8), otherwise uses O(n^2) interpolation
  (reference: univariate_poly.rs:127-144).
"""

from __future__ import annotations

import json
from typing import Iterable, List, Sequence, Tuple, Union

from .field import FieldElement
from .ntt import NTT, _root_of_unity, poly_multiply
from .params import P

CoeffLike = Union[int, FieldElement]


def _to_int(x: CoeffLike) -> int:
    return x.value if isinstance(x, FieldElement) else x % P


def _trim(coeffs: List[int]) -> List[int]:
    """Drop trailing (highest-degree) zeros, keeping at least one entry."""
    n = len(coeffs)
    while n > 1 and coeffs[n - 1] == 0:
        n -= 1
    return coeffs[:n]


class Polynomial:
    """Dense univariate polynomial, coefficients lowest-degree first."""

    __slots__ = ("coeffs",)

    def __init__(self, coeffs: Iterable[CoeffLike] = ()) -> None:
        c = [_to_int(x) for x in coeffs]
        self.coeffs = c if c else [0]

    # -- constructors -----------------------------------------------------

    @staticmethod
    def zero() -> "Polynomial":
        return Polynomial([0])

    @staticmethod
    def one() -> "Polynomial":
        return Polynomial([1])

    @staticmethod
    def x() -> "Polynomial":
        return Polynomial([0, 1])

    @staticmethod
    def constant(c: CoeffLike) -> "Polynomial":
        return Polynomial([_to_int(c)])

    @staticmethod
    def monomial(degree: int, coefficient: CoeffLike) -> "Polynomial":
        c = [0] * (degree + 1)
        c[degree] = _to_int(coefficient)
        return Polynomial(c)

    # -- predicates / metadata -------------------------------------------

    def is_zero(self) -> bool:
        return all(c == 0 for c in self.coeffs)

    def degree(self) -> int:
        """Degree; 0 for the zero polynomial (reference quirk, see module doc)."""
        for i in range(len(self.coeffs) - 1, -1, -1):
            if self.coeffs[i] != 0:
                return i
        return 0

    # -- evaluation -------------------------------------------------------

    def eval(self, x: CoeffLike) -> FieldElement:
        """Horner evaluation (reference: univariate_poly.rs:33-41)."""
        xv = _to_int(x)
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * xv + c) % P
        return FieldElement(acc)

    def eval_domain(self, domain: Sequence[CoeffLike]) -> List[FieldElement]:
        """Evaluate over a domain, with NTT fast paths.

        Unlike the reference (which only fast-paths plain root-of-unity
        domains, reference: univariate_poly.rs:44-54), coset domains
        {offset * omega^i} are also NTT-evaluated.
        """
        n = len(domain)
        vals = [_to_int(d) for d in domain]
        trimmed = _trim(list(self.coeffs))
        if n >= 8 and (n & (n - 1)) == 0 and len(trimmed) <= n:
            kind = _classify_domain(vals)
            if kind is not None:
                offset = kind
                ntt = NTT(n)
                if offset == 1:
                    out = ntt.evaluate(trimmed)
                else:
                    out = ntt.coset_evaluate(trimmed, offset)
                return [FieldElement(v) for v in out]
        return [self.eval(v) for v in vals]

    # -- interpolation ----------------------------------------------------

    @staticmethod
    def lagrange(
        domain: Sequence[CoeffLike], values: Sequence[CoeffLike]
    ) -> "Polynomial":
        """Unique interpolant through (domain[i], values[i]).

        Dispatch mirrors the reference (univariate_poly.rs:127-144): NTT for
        power-of-two consecutive-root domains with n > 8, otherwise O(n^2).
        The resulting polynomial is identical either way (interpolants are
        unique), so the dispatch is purely a performance detail.
        """
        xs = [_to_int(d) for d in domain]
        ys = [_to_int(v) for v in values]
        if len(xs) != len(ys):
            raise ValueError("domain and values must have the same length")
        n = len(xs)
        if n > 8 and (n & (n - 1)) == 0:
            kind = _classify_domain(xs)
            if kind == 1:
                return Polynomial(NTT(n).interpolate(ys))
            if kind is not None:
                return Polynomial(NTT(n).coset_interpolate(ys, kind))
        if n > 24:
            # geometric progressions (e.g. the STARK trace domain
            # {omicron^i, i < trace_length}) interpolate in O(n log n)
            # via the chirp/q-binomial method — the reference is O(n^2)
            # here (univariate_poly.rs:147-164); the chirp wins from a few
            # dozen points up (measured ~4x at the 36-point trace domain)
            from .geometric import detect_ratio, geometric_interpolate

            q = detect_ratio(xs)
            if q is not None:
                return Polynomial(geometric_interpolate(xs, ys, q))
        return Polynomial(_lagrange_newton(xs, ys))

    @staticmethod
    def zeroifier_domain(domain: Sequence[CoeffLike]) -> "Polynomial":
        """Vanishing polynomial prod (x - d_i)
        (reference: univariate_poly.rs:254-264).

        Geometric-progression domains (e.g. the STARK transition
        zeroifier over {omicron^i}) use the O(n) q-binomial closed form
        instead of the O(n^2) incremental product."""
        vals = [_to_int(d) for d in domain]
        if len(vals) > 64:
            from .geometric import detect_ratio, geometric_zeroifier

            q = detect_ratio(vals)
            if q is not None:
                return Polynomial(geometric_zeroifier(vals[0], q, len(vals)))
        if len(vals) > 1024:
            # non-geometric large domain (e.g. a transition zeroifier with
            # per-constraint exemptions): pairwise product tree with NTT
            # multiplies — O(n log^2 n) and bit-identical to the incremental
            # product below (polynomial products over GF(p) are exact, so
            # the association order cannot change a coefficient); the
            # incremental O(n^2) Python loop took ~20 minutes at n ~ 2^17
            layer: List[List[int]] = [[(-v) % P, 1] for v in vals]
            while len(layer) > 1:
                nxt = [
                    poly_multiply(layer[i], layer[i + 1])
                    for i in range(0, len(layer) - 1, 2)
                ]
                if len(layer) & 1:
                    nxt.append(layer[-1])
                layer = nxt
            return Polynomial(layer[0])
        acc = [1]
        for dv in vals:
            # multiply acc by (x - d): shift up + subtract d*acc
            nxt = [0] + acc
            for i in range(len(acc)):
                nxt[i] = (nxt[i] - dv * acc[i]) % P
            acc = nxt
        return Polynomial(acc)

    zeroifier = zeroifier_domain

    @staticmethod
    def test_colinearity(points: Sequence[Tuple[CoeffLike, CoeffLike]]) -> bool:
        """True iff the interpolant through the points has degree exactly 1
        (reference: univariate_poly.rs:267-282)."""
        xs = [_to_int(x) for x, _ in points]
        ys = [_to_int(y) for _, y in points]
        poly = Polynomial(_lagrange_newton(xs, ys))
        return poly.degree() == 1

    # -- algebra ----------------------------------------------------------

    def scale(self, factor: CoeffLike) -> "Polynomial":
        f = _to_int(factor)
        return Polynomial([c * f % P for c in self.coeffs])

    def compose(self, other: "Polynomial") -> "Polynomial":
        """self(other(x)) by Horner on polynomial values
        (reference: univariate_poly.rs:203-221)."""
        if self.is_zero():
            return Polynomial.zero()
        result = Polynomial.zero()
        for c in reversed(self.coeffs):
            result = result * other + Polynomial.constant(c)
        return result

    def scale_argument(self, factor: CoeffLike) -> "Polynomial":
        """self(factor * x) — coefficient i scaled by factor^i.

        Fast replacement for ``compose`` with a linear polynomial; used for
        the trace-shift p(omicron * x) (reference: stark.rs:319-325 composes
        explicitly).
        """
        f = _to_int(factor)
        out = []
        s = 1
        for i, c in enumerate(self.coeffs):
            if i:
                s = s * f % P
            out.append(c * s % P)
        return Polynomial(out)

    def pow(self, exponent: int) -> "Polynomial":
        """Exponentiation by squaring (reference: univariate_poly.rs:285-303;
        that loop reads ``exponent.leading_zeros()`` as the bit budget, which
        silently mis-computes for exponents >= 2^64 — never reached by the
        protocol.  This implementation is correct for all exponents)."""
        if self.is_zero():
            return Polynomial.zero()
        if exponent == 0:
            return Polynomial.one()
        acc = Polynomial.one()
        for bit in bin(exponent)[2:]:
            acc = acc * acc
            if bit == "1":
                acc = acc * self
        return acc

    def __add__(self, other: "Polynomial") -> "Polynomial":
        a, b = self.coeffs, other.coeffs
        if len(a) < len(b):
            a, b = b, a
        out = list(a)
        for i, c in enumerate(b):
            out[i] = (out[i] + c) % P
        return Polynomial(out)

    def __sub__(self, other: "Polynomial") -> "Polynomial":
        n = max(len(self.coeffs), len(other.coeffs))
        out = [0] * n
        for i in range(n):
            a = self.coeffs[i] if i < len(self.coeffs) else 0
            b = other.coeffs[i] if i < len(other.coeffs) else 0
            out[i] = (a - b) % P
        return Polynomial(out)

    def __neg__(self) -> "Polynomial":
        return Polynomial([(-c) % P for c in self.coeffs])

    def __mul__(self, other: "Polynomial") -> "Polynomial":
        return Polynomial(poly_multiply(self.coeffs, other.coeffs))

    def __truediv__(self, other: "Polynomial") -> "Polynomial":
        """Quotient of long division; any remainder is discarded
        (reference: univariate_poly.rs:437-484).  Protocol divisions
        (boundary/transition quotients) are exact on honest inputs."""
        if other.is_zero():
            raise ZeroDivisionError("division by zero polynomial")
        num_deg = self.degree()
        den_deg = other.degree()
        if den_deg > num_deg:
            return Polynomial.zero()
        dividend = list(self.coeffs[: num_deg + 1])
        divisor = other.coeffs[: den_deg + 1]
        lead_inv = pow(divisor[den_deg], -1, P)
        qdeg = num_deg - den_deg
        quotient = [0] * (qdeg + 1)
        for i in range(qdeg, -1, -1):
            c = dividend[den_deg + i] * lead_inv % P
            if c:
                quotient[i] = c
                for j in range(den_deg + 1):
                    dividend[i + j] = (dividend[i + j] - c * divisor[j]) % P
        return Polynomial(quotient)

    def divmod(self, other: "Polynomial") -> Tuple["Polynomial", "Polynomial"]:
        """Quotient and remainder (extension; the reference drops remainders)."""
        q = self / other
        r = self - q * other
        return q, Polynomial(_trim(r.coeffs))

    # -- persistence (reference: univariate_poly.rs:224-238) --------------

    def save(self, filename: str) -> None:
        """Write serde_json-compatible {"coeffs":[FieldElement...]} with
        coefficients highest-degree first, matching the reference's on-disk
        format exactly (Polynomial derives Serialize; coefficient order is
        part of the format)."""
        from .serialization import json_field_element

        body = ",".join(json_field_element(c) for c in reversed(self.coeffs))
        with open(filename, "w") as f:
            f.write('{"coeffs":[%s]}' % body)

    @staticmethod
    def load(filename: str) -> "Polynomial":
        from .serialization import _field_element_from_obj

        with open(filename) as f:
            data = json.load(f)
        return Polynomial(
            [_field_element_from_obj(o) for o in reversed(data["coeffs"])]
        )

    # -- dunder plumbing --------------------------------------------------

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Polynomial):
            return NotImplemented
        return _trim(list(self.coeffs)) == _trim(list(other.coeffs))

    def __hash__(self) -> int:
        return hash(tuple(_trim(list(self.coeffs))))

    def __repr__(self) -> str:
        return f"Polynomial({self.coeffs})"


def _classify_domain(xs: Sequence[int]) -> Union[int, None]:
    """If xs == {offset * omega^i} for the canonical primitive n-th root,
    return offset (1 for the plain domain); else None."""
    n = len(xs)
    if n <= 1 or n & (n - 1):
        return None
    try:
        omega = _root_of_unity(n)
    except ValueError:
        return None
    offset = xs[0]
    if offset == 0:
        return None
    cur = offset
    for i in range(1, n):
        cur = cur * omega % P
        if xs[i] != cur:
            return None
    return offset


def _lagrange_newton(xs: Sequence[int], ys: Sequence[int]) -> List[int]:
    """O(n^2) interpolation via Newton's divided differences.

    Produces the unique interpolant (same polynomial as the reference's
    Lagrange-basis accumulation, reference: univariate_poly.rs:147-164).
    """
    n = len(xs)
    if n == 0:
        return [0]
    if len(set(xs)) != n:
        raise ValueError("interpolation domain has repeated points")
    # divided difference coefficients
    dd = [y % P for y in ys]
    for level in range(1, n):
        for i in range(n - 1, level - 1, -1):
            denom = (xs[i] - xs[i - level]) % P
            dd[i] = (dd[i] - dd[i - 1]) * pow(denom, -1, P) % P
    # expand Newton form to monomial basis
    coeffs = [0] * n
    coeffs[0] = dd[n - 1]
    deg = 0
    for i in range(n - 2, -1, -1):
        # coeffs <- coeffs * (x - xs[i]) + dd[i]
        xi = xs[i]
        nxt = [0] * (deg + 2)
        for j in range(deg + 1):
            nxt[j + 1] = coeffs[j]
            nxt[j] = (nxt[j] - coeffs[j] * xi) % P
        nxt[0] = (nxt[0] + dd[i]) % P
        coeffs[: deg + 2] = nxt
        deg += 1
    return _trim(coeffs)
