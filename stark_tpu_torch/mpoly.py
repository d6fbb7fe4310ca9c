"""Multivariate polynomials over GF(p) (host-side; AIR description language).

Sparse dict representation: {exponent-vector (tuple of ints): coefficient
(canonical residue int)} — same model as the reference
(reference: multivariate_poly.rs:23-26).  AIRs are tiny (the Rescue-Prime AIR
has 2 polynomials in 5 variables of total degree 3 with <= ~60 terms), so
this stays on the host; the heavy lifting happens after symbolic evaluation
produces univariate polynomials / codewords.

Exponent vectors of differing lengths may coexist (the reference's Add/Mul
pad implicitly); ``eval`` ignores exponent entries beyond the point length,
matching the reference (multivariate_poly.rs:48-51).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

from .field import FieldElement
from .poly import Polynomial
from .params import P

CoeffLike = Union[int, FieldElement]
Exponents = Tuple[int, ...]


def _to_int(x: CoeffLike) -> int:
    return x.value if isinstance(x, FieldElement) else x % P


class _FrozenTerms(dict):
    """Term dict of a fingerprinted MPolynomial.  Once a polynomial's
    content key has been served to the process-wide statement caches,
    mutating it in place would silently poison those caches for every
    Stark instance (a term-count guard alone misses same-count
    rewrites), so mutation fails loudly instead — build a new
    MPolynomial for a different constraint."""

    def _frozen(self, *a, **k):
        raise TypeError(
            "MPolynomial is frozen: its content fingerprint has been "
            "handed to statement-level caches; build a new MPolynomial "
            "instead of mutating this one in place"
        )

    __setitem__ = __delitem__ = _frozen
    update = pop = popitem = clear = setdefault = _frozen


class MPolynomial:
    """Sparse multivariate polynomial."""

    __slots__ = ("dict", "_content_key", "_degree_bound_cache")

    def __init__(self, terms: Dict[Sequence[int], CoeffLike] = None) -> None:
        self.dict: Dict[Exponents, int] = {}
        if terms:
            for k, v in terms.items():
                self.dict[tuple(k)] = _to_int(v)

    # -- constructors -----------------------------------------------------

    @staticmethod
    def zero() -> "MPolynomial":
        return MPolynomial()

    @staticmethod
    def constant(c: CoeffLike) -> "MPolynomial":
        return MPolynomial({(0,): _to_int(c)})

    @staticmethod
    def variables(num_variables: int) -> List["MPolynomial"]:
        """[x_0, ..., x_{n-1}] as n-variable polynomials
        (reference: multivariate_poly.rs:113-130)."""
        out = []
        for i in range(num_variables):
            exps = [0] * num_variables
            exps[i] = 1
            out.append(MPolynomial({tuple(exps): 1}))
        return out

    @staticmethod
    def lift(poly: Polynomial, variable_index: int) -> "MPolynomial":
        """Lift a univariate polynomial into variable `variable_index`
        (reference: multivariate_poly.rs:133-146)."""
        if poly.is_zero():
            return MPolynomial.zero()
        # direct dict construction: every term's key is unique (the
        # exponent in `variable_index` differs), so this equals the
        # reference's term-by-term accumulation — which kept a (0,)
        # constant key for degree-0 terms via MPolynomial::constant —
        # without the O(degree^2) dict copying (a chained-permutation
        # AIR lifts degree-10^5 interpolants; the accumulation was ~48 s
        # per 8 lifts at L=512 and quadratically worse beyond)
        n = variable_index + 1
        d = {}
        for i, c in enumerate(poly.coeffs):
            if c == 0 and i != 0:
                continue
            if i == 0:
                key = (0,)
            else:
                exps = [0] * n
                exps[variable_index] = i
                key = tuple(exps)
            d[key] = c % P
        out = MPolynomial()
        out.dict = d
        return out

    # -- predicates -------------------------------------------------------

    def content_key(self) -> tuple:
        """Compact content fingerprint ``(num_terms, sha256)``, cached on
        the instance.  Statement-level caches key AIR polynomials by
        content (object identity can alias after GC); for chained-
        permutation AIRs the dict holds millions of monomials, and
        re-sorting plus re-hashing a megatuple per cache LOOKUP
        dominated repeat verifies.  Serving the fingerprint FREEZES the
        polynomial (see :class:`_FrozenTerms`): an in-place mutation
        afterwards would silently corrupt every cache keyed by the stale
        fingerprint, so it raises instead."""
        cached = getattr(self, "_content_key", None)
        if cached is not None:
            return cached
        import hashlib

        h = hashlib.sha256()
        for exps, coeff in sorted(self.dict.items()):
            h.update(repr(exps).encode())
            h.update(coeff.to_bytes(16, "little"))
        key = (len(self.dict), h.digest())
        self.dict = _FrozenTerms(self.dict)
        self._content_key = key
        return key

    def is_zero(self) -> bool:
        return all(v == 0 for v in self.dict.values())

    def num_variables(self) -> int:
        return max((len(k) for k in self.dict), default=0)

    # -- evaluation -------------------------------------------------------

    def eval(self, point: Sequence[CoeffLike]) -> FieldElement:
        """Evaluate at a point of field elements
        (reference: multivariate_poly.rs:42-72)."""
        pt = [_to_int(x) for x in point]
        acc = 0
        for exps, coeff in self.dict.items():
            prod = coeff
            for i, e in enumerate(exps):
                if i >= len(pt):
                    continue
                if e:
                    prod = prod * pow(pt[i], e, P) % P
            acc = (acc + prod) % P
        return FieldElement(acc)

    def eval_batch(self, columns: Sequence[Sequence[int]]) -> List[int]:
        """Evaluate at many points at once: ``columns[i][k]`` is the value
        of variable i at point k.  Returns the value column.

        This is the evaluation-space path the device prover uses instead of
        symbolic polynomial composition — the AIR is evaluated pointwise
        over the whole FRI domain as batched column arithmetic (power
        columns are cached per (variable, exponent))."""
        if not columns:
            return []
        n = len(columns[0])
        acc = [0] * n
        pow_cache = {}

        def pow_col(i: int, e: int) -> Sequence[int]:
            if e == 1:
                return columns[i]
            key = (i, e)
            if key not in pow_cache:
                half = pow_col(i, e // 2)
                sq = [v * v % P for v in half]
                if e & 1:
                    base = columns[i]
                    sq = [a * b % P for a, b in zip(sq, base)]
                pow_cache[key] = sq
            return pow_cache[key]

        for exps, coeff in self.dict.items():
            if coeff == 0:
                continue
            term = None
            for i, e in enumerate(exps):
                if e == 0 or i >= len(columns):
                    continue
                pc = pow_col(i, e)
                if term is None:
                    term = [coeff * v % P for v in pc]
                else:
                    term = [t * v % P for t, v in zip(term, pc)]
            if term is None:
                term = [coeff] * n
            acc = [(a + t) % P for a, t in zip(acc, term)]
        return acc

    def eval_symbolic(self, point: Sequence[Polynomial]) -> Polynomial:
        """Substitute univariate polynomials for the variables
        (reference: multivariate_poly.rs:75-88)."""
        acc = Polynomial.zero()
        for exps, coeff in self.dict.items():
            prod = Polynomial.constant(coeff)
            for i, e in enumerate(exps):
                prod = prod * point[i].pow(e)
            acc = acc + prod
        return acc

    # -- algebra ----------------------------------------------------------

    def pow(self, exponent: int) -> "MPolynomial":
        """Exponentiation by squaring (reference: multivariate_poly.rs:91-108)."""
        if self.is_zero():
            return MPolynomial.zero()
        if exponent == 0:
            return MPolynomial.constant(1)
        nvars = len(next(iter(self.dict)))
        acc = MPolynomial({tuple([0] * nvars): 1})
        for bit in bin(exponent)[2:]:
            acc = acc * acc
            if bit == "1":
                acc = acc * self
        return acc

    def __add__(self, other: "MPolynomial") -> "MPolynomial":
        out = MPolynomial()
        out.dict = dict(self.dict)
        for k, v in other.dict.items():
            out.dict[k] = (out.dict.get(k, 0) + v) % P
        return out

    def __sub__(self, other: "MPolynomial") -> "MPolynomial":
        return self + (-other)

    def __neg__(self) -> "MPolynomial":
        out = MPolynomial()
        out.dict = {k: (-v) % P for k, v in self.dict.items()}
        return out

    def __mul__(self, other: "MPolynomial") -> "MPolynomial":
        out: Dict[Exponents, int] = {}
        for ka, va in self.dict.items():
            if va == 0:
                continue
            for kb, vb in other.dict.items():
                if vb == 0:
                    continue
                # pad the shorter exponent vector (reference:
                # multivariate_poly.rs:211-221)
                if len(ka) >= len(kb):
                    key = list(ka)
                    for i, e in enumerate(kb):
                        key[i] += e
                else:
                    key = list(kb)
                    for i, e in enumerate(ka):
                        key[i] += e
                key = tuple(key)
                out[key] = (out.get(key, 0) + va * vb) % P
        res = MPolynomial()
        res.dict = out
        return res

    # -- dunder plumbing --------------------------------------------------

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, MPolynomial):
            return NotImplemented

        def norm(d: Dict[Exponents, int]) -> Dict[Exponents, int]:
            out = {}
            for k, v in d.items():
                if v == 0:
                    continue
                kk = list(k)
                while kk and kk[-1] == 0:
                    kk.pop()
                out[tuple(kk)] = v
            return out

        return norm(self.dict) == norm(other.dict)

    def __hash__(self) -> int:  # pragma: no cover - not used as dict key
        return hash(frozenset(self.dict.items()))

    def __repr__(self) -> str:
        return f"MPolynomial({self.dict})"
