"""ctypes bindings for the native vectorized field kernels
(``csrc/host/fieldvec.c`` in the host library, see
:mod:`stark_tpu_torch.native`).

The host prover path runs its NTTs and pointwise codeword algebra as
CPython big-int loops; these bindings route the same arithmetic through
two-limb ``__int128`` Montgomery C (~50x).  Pure performance seam:
outputs are canonical plain residues, bit-identical to the Python
golden model in :mod:`stark_tpu_torch.ntt` / :mod:`stark_tpu_torch.hostops`
(reference semantics: ntt.rs:25-107, fri.rs:133-139), which stays the
source of truth; tests pin equality.

Array convention: ``np.uint64`` arrays of shape ``(n, 2)`` (or any
contiguous buffer of 2n u64) holding little-endian (lo, hi) limb pairs
of plain residues.  Conversion helpers ``pack_pairs``/``unpack_pairs``
map Python-int lists to/from this layout.

Importing raises ImportError if the library cannot be built; callers
treat that as "fall back to the Python golden model".
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from ..params import P
from .hashing_native import _lib

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u64 = ctypes.c_uint64
_int = ctypes.c_int

_lib.fv_coset_ntt_batch.argtypes = [
    _u64p, _u64, _u64, _u64, _u64, _u64, _u64, _int,
]
_lib.fv_coset_ntt_batch.restype = _int
_lib.fv_fri_fold.argtypes = [
    _u64p, _u64, _u64, _u64, _u64, _u64, _u64, _u64, _u64p,
]
_lib.fv_fri_fold.restype = _int
_lib.fv_batch_inverse.argtypes = [_u64p, _u64p, _u64]
_lib.fv_batch_inverse.restype = _int
_lib.fv_poly_eval_many.argtypes = [_u64p, _u64, _u64p, _u64, _u64p]
_lib.fv_poly_eval_many.restype = _int
_lib.fv_to_mont.argtypes = [_u64p, _u64]
_lib.fv_from_mont.argtypes = [_u64p, _u64]
_lib.fv_mul_mont.argtypes = [_u64p, _u64p, _u64p, _u64]
_lib.fv_add.argtypes = [_u64p, _u64p, _u64p, _u64]
_lib.fv_sub.argtypes = [_u64p, _u64p, _u64p, _u64]
_lib.fv_scale_mont.argtypes = [_u64p, _u64, _u64, _u64p, _u64]
_lib.fv_comb_term_mont.argtypes = [
    _u64p, _u64p, _u64p, _u64, _u64, _u64, _u64, _u64,
]
_lib.fv_geom.argtypes = [_u64, _u64, _u64, _u64, _u64p, _u64]
_lib.fv_fib_trace_limbs.argtypes = [_u64, _u64, _u64, _u64, _u64, ctypes.POINTER(ctypes.c_uint32)]

_MASK = (1 << 64) - 1


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u64p)


def pack_pairs(values: Sequence[int]) -> np.ndarray:
    """Python-int residues -> contiguous (n, 2) u64 (lo, hi) array."""
    buf = b"".join((v % P).to_bytes(16, "little") for v in values)
    return np.frombuffer(buf, dtype="<u8").reshape(-1, 2).copy()


def unpack_pairs(a: np.ndarray) -> List[int]:
    """(n, 2) u64 (lo, hi) array -> list of Python-int residues."""
    pairs = a.reshape(-1, 2)
    return list(
        pairs[:, 0].astype(object) + (pairs[:, 1].astype(object) << 64)
    )


def _split(v: int) -> tuple:
    v %= P
    return v & _MASK, v >> 64


def coset_ntt_batch(
    rows: np.ndarray, n: int, omega: int, offset: int, inverse: bool
) -> None:
    """In-place batched coset NTT over ``rows`` (shape (B, n, 2) or
    (n, 2)); ``omega`` is the FORWARD primitive n-th root in both
    directions (matches :class:`stark_tpu_torch.ntt.NTT` semantics)."""
    rows = np.ascontiguousarray(rows)
    batch = rows.size // (2 * n)
    ol, oh = _split(omega)
    fl, fh = _split(offset)
    rc = _lib.fv_coset_ntt_batch(
        _ptr(rows), batch, n, ol, oh, fl, fh, 1 if inverse else 0
    )
    if rc != 0:
        raise ValueError(f"fv_coset_ntt_batch failed (rc={rc}, n={n})")


def ntt_rows(rows: List[List[int]], inverse: bool, omega: int,
             offset: int = 1) -> List[List[int]]:
    """Batched (coset) NTT of equal-length residue lists."""
    n = len(rows[0])
    buf = pack_pairs([v for row in rows for v in row])
    coset_ntt_batch(buf, n, omega, offset, inverse)
    flat = unpack_pairs(buf)
    return [flat[i * n:(i + 1) * n] for i in range(len(rows))]


def fri_fold(codeword: Sequence[int], alpha: int, offset: int,
             omega: int) -> List[int]:
    """Native FRI fold; semantics of the host golden model
    (:meth:`stark_tpu_torch.fri.Fri._fold_host`, reference fri.rs:133-139)."""
    n = len(codeword)
    cw = pack_pairs(codeword)
    out = np.empty((n // 2, 2), dtype=np.uint64)
    al, ah = _split(alpha)
    fl, fh = _split(offset)
    ol, oh = _split(omega)
    rc = _lib.fv_fri_fold(_ptr(cw), n, al, ah, fl, fh, ol, oh, _ptr(out))
    if rc != 0:
        raise ValueError(f"fv_fri_fold failed (rc={rc}, n={n})")
    return unpack_pairs(out)


def poly_eval_many(coeffs: Sequence[int], xs: Sequence[int]) -> List[int]:
    """[p(x) for x in xs] for a lowest-first coefficient list (native
    multi-point Horner; bit-identical to the Python model)."""
    c = pack_pairs(coeffs)
    x = pack_pairs(xs)
    out = np.empty((len(xs), 2), dtype=np.uint64)
    rc = _lib.fv_poly_eval_many(_ptr(c), len(coeffs), _ptr(x), len(xs),
                                _ptr(out))
    if rc != 0:
        raise ValueError(f"fv_poly_eval_many failed (rc={rc})")
    return unpack_pairs(out)


def batch_inverse(values: Sequence[int]) -> List[int]:
    """Batched modular inversion (Montgomery trick + one Fermat pow);
    raises ZeroDivisionError on a zero input (matching the host model)."""
    a = pack_pairs(values)
    out = np.empty_like(a)
    rc = _lib.fv_batch_inverse(_ptr(a), _ptr(out), len(values))
    if rc == -1:
        raise ZeroDivisionError("batch inversion of zero")
    if rc != 0:
        raise ValueError(f"fv_batch_inverse failed (rc={rc})")
    return unpack_pairs(out)


def geom_series(base: int, start: int, n: int) -> np.ndarray:
    """(n, 2) u64 array of plain residues start * base^i."""
    out = np.empty((n, 2), dtype=np.uint64)
    bl, bh = _split(base)
    sl, sh = _split(start)
    _lib.fv_geom(bl, bh, sl, sh, _ptr(out), n)
    return out


def fib_trace_limbs(a: int, b: int, steps: int) -> np.ndarray:
    """The Fibonacci trace (a, b) -> (a + b, a) from the seeds (a, b)
    over ``steps`` steps, as the prover's limb trace: a (2, 8, steps + 1)
    uint32 array, one :func:`stark_tpu_torch.ops.limbs.pack` layout a
    register."""
    out = np.empty((2, 8, steps + 1), dtype=np.uint32)
    _lib.fv_fib_trace_limbs(*_split(a), *_split(b), steps, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


# ---------------------------------------------------------------------
# Montgomery-domain column algebra over (n, 2) u64 arrays — the native
# equivalent of stark_tpu_torch.hostops.HostColumns, for composite pointwise
# pipelines (AIR products, the weighted combination).
# ---------------------------------------------------------------------

def to_mont_arr(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    _lib.fv_to_mont(_ptr(a), a.size // 2)
    return a


def from_mont_arr(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    _lib.fv_from_mont(_ptr(a), a.size // 2)
    return a


def col_from_ints(values: Sequence[int]) -> np.ndarray:
    """Residue list -> Montgomery-domain (n, 2) column."""
    return to_mont_arr(pack_pairs(values))


def col_to_ints(a: np.ndarray) -> List[int]:
    """Montgomery-domain column -> residue list (input preserved)."""
    return unpack_pairs(from_mont_arr(a.copy()))


def col_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.empty_like(a)
    _lib.fv_mul_mont(_ptr(a), _ptr(b), _ptr(out), a.size // 2)
    return out


def col_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.empty_like(a)
    _lib.fv_add(_ptr(a), _ptr(b), _ptr(out), a.size // 2)
    return out


def col_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.empty_like(a)
    _lib.fv_sub(_ptr(a), _ptr(b), _ptr(out), a.size // 2)
    return out


def col_scale(a: np.ndarray, scalar_mont_pair: tuple) -> np.ndarray:
    out = np.empty_like(a)
    lo, hi = scalar_mont_pair
    _lib.fv_scale_mont(_ptr(a), int(lo), int(hi), _ptr(out), a.size // 2)
    return out


def mont_scalar(v: int) -> tuple:
    """Plain residue -> Montgomery (lo, hi) scalar pair."""
    m = col_from_ints([v])
    return int(m[0, 0]), int(m[0, 1])


def comb_term(acc: np.ndarray, cw: np.ndarray, xs: np.ndarray,
              w1_mont: tuple, w2_mont: tuple) -> None:
    """acc += w1*cw + w2*xs*cw in place (Montgomery domain)."""
    _lib.fv_comb_term_mont(
        _ptr(acc), _ptr(cw), _ptr(xs),
        int(w1_mont[0]), int(w1_mont[1]),
        int(w2_mont[0]), int(w2_mont[1]),
        acc.size // 2,
    )
