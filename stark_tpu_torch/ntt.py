"""Host-side radix-2 NTT over GF(p) (golden model).

Computes the same transform as the reference (reference: ntt.rs:25-107):
``forward`` maps coefficients (lowest-first) to evaluations at consecutive
powers of omega, i.e. the DFT X[k] = sum_j a[j] * omega^{j*k};
``inverse`` is the inverse DFT with the 1/n scaling.

Beyond the reference, this module adds *coset* evaluate/interpolate —
evaluation over {offset * omega^i} — which is the fast path the device prover
uses for all Reed-Solomon extensions (the reference falls back to per-point
Horner evaluation on coset domains, its hottest loop; see
reference: univariate_poly.rs:44-54 and fri.rs:90-97).

The device NTT lives in :mod:`stark_tpu_torch.ops.ntt`; this implementation
defines the semantics it is tested against.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

from .field import FieldElement
from .params import P


@lru_cache(maxsize=64)
def _root_of_unity(n: int) -> int:
    return FieldElement.primitive_nth_root(n).value


@lru_cache(maxsize=64)
def _twiddles(n: int, inverse: bool) -> tuple:
    """Per-stage twiddle tables for an iterative DIT NTT of size n."""
    omega = _root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, P)
    stages = []
    length = 2
    while length <= n:
        w = pow(omega, n // length, P)
        row = [1] * (length // 2)
        for j in range(1, length // 2):
            row[j] = row[j - 1] * w % P
        stages.append(tuple(row))
        length *= 2
    return tuple(stages)


def _bit_reverse_permute(a: List[int]) -> None:
    n = len(a)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j ^= bit
        if i < j:
            a[i], a[j] = a[j], a[i]


def _ntt_in_place(a: List[int], inverse: bool) -> None:
    n = len(a)
    if n <= 1:
        return
    _bit_reverse_permute(a)
    stages = _twiddles(n, inverse)
    length = 2
    s = 0
    while length <= n:
        half = length // 2
        row = stages[s]
        for i in range(0, n, length):
            for j in range(half):
                u = a[i + j]
                v = a[i + j + half] * row[j] % P
                a[i + j] = (u + v) % P
                a[i + j + half] = (u - v) % P
        length *= 2
        s += 1


#: sizes at/above this run the vectorized numpy host transform
_NUMPY_NTT_MIN = 4096


def _fv():
    """The native two-limb Montgomery kernels (~5-10x over the Python
    loops; the host library is built at first use), or None where it
    cannot be built."""
    try:
        from .native import fieldvec
    except ImportError:
        return None
    return fieldvec


#: sizes at/above this run the native C transform when available
_NATIVE_NTT_MIN = 64


@lru_cache(maxsize=16)
def _np_tables(n: int, inverse: bool):
    """Montgomery numpy twiddles + bit-reversal permutation for size n."""
    import numpy as np

    from . import hostops as ho

    stages = [ho.to_mont(list(row)) for row in _twiddles(n, inverse)]
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return stages, rev


def _ntt_numpy(a: List[int], inverse: bool) -> List[int]:
    """Vectorized host NTT over hostops' uint64/32-bit-limb Montgomery
    arrays — bit-identical to the scalar path, ~4x faster from a few
    thousand points."""
    import numpy as np

    from . import hostops as ho

    n = len(a)
    stages, rev = _np_tables(n, inverse)
    x = ho.to_mont(a)[:, rev]
    length = 2
    s = 0
    while length <= n:
        half = length // 2
        g = n // length
        xv = x.reshape(4, g, length)
        u = np.ascontiguousarray(xv[:, :, :half]).reshape(4, -1)
        v = np.ascontiguousarray(xv[:, :, half:]).reshape(4, -1)
        tw = np.broadcast_to(
            stages[s][:, None, :], (4, g, half)
        ).reshape(4, -1)
        v = ho.mul(v, tw)
        x = np.concatenate(
            [
                ho.add(u, v).reshape(4, g, half),
                ho.sub(u, v).reshape(4, g, half),
            ],
            axis=2,
        ).reshape(4, n)
        length *= 2
        s += 1
    return ho.from_mont(x)


class NTT:
    """Number-theoretic transform of a fixed power-of-two size n <= 2^30.

    Mirrors the reference API (reference: ntt.rs:12-135) but operates on
    lists of canonical residues (Python ints), lowest-degree-first.
    """

    def __init__(self, n: int) -> None:
        if n & (n - 1) != 0 or n <= 0:
            raise ValueError("NTT size must be a power of 2")
        if n > (1 << 30):
            raise ValueError("NTT size too large")
        self.n = n
        self.omega = FieldElement(_root_of_unity(n))
        self.omega_inv = self.omega.inverse()

    def forward(self, coeffs: Sequence[int]) -> List[int]:
        """Coefficients -> evaluations at {omega^i}."""
        if len(coeffs) != self.n:
            raise ValueError("input size must match NTT size")
        fv = _fv() if self.n >= _NATIVE_NTT_MIN else None
        if fv is not None:
            return fv.ntt_rows([list(coeffs)], False, self.omega.value)[0]
        a = [c % P for c in coeffs]
        if self.n >= _NUMPY_NTT_MIN:
            return _ntt_numpy(a, inverse=False)
        _ntt_in_place(a, inverse=False)
        return a

    def inverse(self, evals: Sequence[int]) -> List[int]:
        """Evaluations at {omega^i} -> coefficients (with 1/n scaling)."""
        if len(evals) != self.n:
            raise ValueError("input size must match NTT size")
        fv = _fv() if self.n >= _NATIVE_NTT_MIN else None
        if fv is not None:
            return fv.ntt_rows([list(evals)], True, self.omega.value)[0]
        a = [e % P for e in evals]
        if self.n >= _NUMPY_NTT_MIN:
            a = _ntt_numpy(a, inverse=True)
        else:
            _ntt_in_place(a, inverse=True)
        n_inv = pow(self.n, -1, P)
        return [x * n_inv % P for x in a]

    def evaluate(self, coefficients: Sequence[int]) -> List[int]:
        """Zero-pad to n and transform (reference: ntt.rs:101-107)."""
        a = list(coefficients) + [0] * (self.n - len(coefficients))
        return self.forward(a)

    def interpolate(self, evaluations: Sequence[int]) -> List[int]:
        return self.inverse(evaluations)

    # -- coset extensions (device fast path; not in the reference) -----------

    def coset_evaluate(self, coefficients: Sequence[int], offset: int) -> List[int]:
        """Evaluate at {offset * omega^i}: scale coeff j by offset^j, then NTT."""
        return self.coset_evaluate_batch([coefficients], offset)[0]

    def coset_evaluate_batch(
        self, rows: Sequence[Sequence[int]], offset: int
    ) -> List[List[int]]:
        """Coset-evaluate many coefficient lists at once (native C path
        amortizes twiddle/offset tables across the batch)."""
        for row in rows:
            if len(row) > self.n:
                raise ValueError("input size must match NTT size")
        padded = [
            list(row) + [0] * (self.n - len(row)) for row in rows
        ]
        fv = _fv() if self.n >= _NATIVE_NTT_MIN else None
        if fv is not None:
            return fv.ntt_rows(padded, False, self.omega.value, offset % P)
        out = []
        for a in padded:
            scale = 1
            for j in range(self.n):
                if j:
                    scale = scale * offset % P
                    a[j] = a[j] * scale % P
            out.append(self.forward(a))
        return out

    def coset_interpolate(self, evaluations: Sequence[int], offset: int) -> List[int]:
        """Inverse of :meth:`coset_evaluate`."""
        if len(evaluations) != self.n:
            raise ValueError("input size must match NTT size")
        fv = _fv() if self.n >= _NATIVE_NTT_MIN else None
        if fv is not None:
            return fv.ntt_rows(
                [list(evaluations)], True, self.omega.value, offset % P
            )[0]
        a = self.inverse(evaluations)
        inv = pow(offset, -1, P)
        scale = 1
        for j in range(self.n):
            if j:
                scale = scale * inv % P
                a[j] = a[j] * scale % P
        return a

    def multiply(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        """Polynomial product via pointwise multiplication
        (reference: ntt.rs:110-135)."""
        result_size = len(a) + len(b) - 1
        ntt_size = 1 << (result_size - 1).bit_length()
        sub = NTT(ntt_size)
        fa = sub.evaluate(a)
        fb = sub.evaluate(b)
        prod = [x * y % P for x, y in zip(fa, fb)]
        out = sub.inverse(prod)
        return out[:result_size]


def poly_square_and_cube(a: Sequence[int]) -> tuple:
    """(a^2, a^3) as coefficient lists, with ONE forward transform.

    Chained ``poly_multiply`` calls (a*a, then (a*a)*a) evaluate ``a``
    three times and round-trip limb packing per product; for the
    degree-10^5 periodic interpolants of chained-permutation AIRs that
    dominated constraint assembly.  Evaluating once on a domain sized
    for degree 3*deg(a) and inverting the pointwise square and cube is
    exact, hence bit-identical to the chained products."""
    if not a:
        return [], []
    if len(a) <= 32:
        sq = poly_multiply(a, a)
        return sq, poly_multiply(sq, a)
    sq_size = 2 * len(a) - 1
    cu_size = 3 * len(a) - 2
    sub = NTT(1 << (cu_size - 1).bit_length())
    fa = sub.evaluate(a)
    sq_evals = [x * x % P for x in fa]
    cu_evals = [s * x % P for s, x in zip(sq_evals, fa)]
    return sub.inverse(sq_evals)[:sq_size], sub.inverse(cu_evals)[:cu_size]


def poly_multiply(a: Sequence[int], b: Sequence[int]) -> List[int]:
    """Product of two coefficient lists (lowest-first), NTT for large sizes."""
    if not a or not b:
        return []
    if min(len(a), len(b)) <= 32:
        res = [0] * (len(a) + len(b) - 1)
        for i, ca in enumerate(a):
            if ca == 0:
                continue
            for j, cb in enumerate(b):
                res[i + j] = (res[i + j] + ca * cb) % P
        return res
    result_size = len(a) + len(b) - 1
    return NTT(1 << (result_size - 1).bit_length()).multiply(a, b)
