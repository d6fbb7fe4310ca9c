"""ctypes bindings for the Rescue-Prime chain kernel of the host library
(``csrc/host/rescue.c``, built by :func:`stark_tpu_torch.native.library`
at first import of this module).

The hash chain is sequential — no batch parallelism applies — so witness
generation runs in two-limb Montgomery C instead of CPython big-int pow.
Pure performance seam: outputs are bit-identical to
:meth:`stark_tpu_torch.rescue_prime.RescuePrime.trace` chained by hand
(reference semantics rescue_prime.rs:180-293); tests pin equality.

Importing raises ImportError if the library cannot be built or loaded;
callers treat that as "fall back to the Python golden model".
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..params import (
    P,
    RESCUE_ALPHA_INV,
    RESCUE_MDS,
    RESCUE_N,
    RESCUE_ROUND_CONSTANTS,
)
from . import library

_lib = library()

_u64p = ctypes.POINTER(ctypes.c_uint64)

_lib.rescue_chain_trace.argtypes = [
    ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,  # in_lo/hi, L
    _u64p, _u64p,                                        # mds, consts
    ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,   # N, ainv hi/lo
    _u64p,                                               # out
]

_MASK = (1 << 64) - 1


def _limb_pairs(values) -> np.ndarray:
    arr = np.empty(2 * len(values), dtype=np.uint64)
    for i, v in enumerate(values):
        v %= P
        arr[2 * i] = v & _MASK
        arr[2 * i + 1] = v >> 64
    return arr


_MDS_LIMBS = _limb_pairs([c for row in RESCUE_MDS for c in row])
_RC_LIMBS = _limb_pairs(RESCUE_ROUND_CONSTANTS)


def chain_limb_pairs(input_value: int, num_hashes: int) -> np.ndarray:
    """All (N+1)*num_hashes permutation states of the Rescue hash chain
    starting from ``input_value``, as the C library writes them: a uint64
    array of shape (num_hashes*(N+1), 2, 2), [row, register] the
    plain residue's (low, high) 64-bit words."""
    if num_hashes < 1:
        raise ValueError("need at least one hash in the chain")
    v = input_value % P
    rows = num_hashes * (RESCUE_N + 1)
    out = np.empty((rows, 2, 2), dtype=np.uint64)
    _lib.rescue_chain_trace(
        v & _MASK, v >> 64, num_hashes,
        _MDS_LIMBS.ctypes.data_as(_u64p), _RC_LIMBS.ctypes.data_as(_u64p),
        RESCUE_N, RESCUE_ALPHA_INV >> 64, RESCUE_ALPHA_INV & _MASK,
        out.ctypes.data_as(_u64p),
    )
    return out


def trace_limbs(pairs: np.ndarray) -> np.ndarray:
    """:func:`chain_limb_pairs`'s states as the prover's limb trace, a
    (2, 8, rows) uint32 array (:func:`stark_tpu_torch.ops.limbs.pack_trace`):
    each 64-bit word's two 32-bit halves, then each half's two 16-bit limbs,
    by shifts and masks."""
    rows, registers, words = pairs.shape
    by_register = pairs.transpose(1, 2, 0)  # (register, word, row)
    halves = np.empty((registers, 2 * words, rows), dtype=np.uint32)
    halves[:, 0::2] = by_register & np.uint64(0xFFFFFFFF)
    halves[:, 1::2] = by_register >> np.uint64(32)
    out = np.empty((registers, 4 * words, rows), dtype=np.uint32)
    np.bitwise_and(halves, np.uint32(0xFFFF), out=out[:, 0::2])
    np.right_shift(halves, np.uint32(16), out=out[:, 1::2])
    return out


def chain_trace(input_value: int, num_hashes: int) -> np.ndarray:
    """All (N+1)*num_hashes permutation states of the Rescue hash chain
    starting from ``input_value``, as an object ndarray of plain-residue
    Python ints, shape (num_hashes*(N+1), 2)."""
    pairs = chain_limb_pairs(input_value, num_hashes)
    return pairs[:, :, 0].astype(object) + (
        pairs[:, :, 1].astype(object) << 64
    )
