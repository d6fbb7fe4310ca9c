"""ctypes bindings for the batched hashing kernels of the host library
(``csrc/host/hashing.c`` and ``keccak.c``, built by
:func:`stark_tpu_torch.native.library` at first import of this module).

Importing this module raises ImportError if the library cannot be built;
callers (:mod:`stark_tpu_torch.hashing`) treat that as "fall back to
hashlib".
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from . import library

_lib = library()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)

_lib.batch_blake2b_256.argtypes = [_u8p, _u64p, ctypes.c_uint64, _u8p]
_lib.merkle_level.argtypes = [_u8p, ctypes.c_uint64, _u8p]
_lib.merkle_leaves_u128.argtypes = [_u32p, ctypes.c_uint64, _u8p]
_lib.merkle_tree_from_leaves.argtypes = [_u8p, ctypes.c_uint64, _u8p]
_lib.batch_shake256_ctr.argtypes = [
    _u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
    ctypes.c_uint64, _u8p,
]


def _as_u8p(buf: np.ndarray):
    return buf.ctypes.data_as(_u8p)


def batch_blake2b_256(items: Sequence[bytes]) -> List[bytes]:
    n = len(items)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    total = 0
    for i, it in enumerate(items):
        total += len(it)
        offsets[i + 1] = total
    data = np.frombuffer(b"".join(items), dtype=np.uint8) if total else np.zeros(
        1, dtype=np.uint8
    )
    out = np.empty(32 * n, dtype=np.uint8)
    _lib.batch_blake2b_256(
        _as_u8p(data), offsets.ctypes.data_as(_u64p), n, _as_u8p(out)
    )
    raw = out.tobytes()
    return [raw[32 * i : 32 * i + 32] for i in range(n)]


def merkle_level(nodes: bytes) -> bytes:
    n_parents = len(nodes) // 64
    src = np.frombuffer(nodes, dtype=np.uint8)
    out = np.empty(32 * n_parents, dtype=np.uint8)
    _lib.merkle_level(_as_u8p(src), n_parents, _as_u8p(out))
    return out.tobytes()


def merkle_leaves_u128(digits: np.ndarray) -> bytes:
    """digits: (n, 4) uint32 little-endian base-2^32 digit rows ->
    concatenated 32-byte leaf digests of bincode(FieldElement)."""
    digits = np.ascontiguousarray(digits, dtype=np.uint32)
    n = digits.shape[0]
    out = np.empty(32 * n, dtype=np.uint8)
    _lib.merkle_leaves_u128(digits.ctypes.data_as(_u32p), n, _as_u8p(out))
    return out.tobytes()


def batch_shake256_ctr(
    seed: bytes, counter_start: int, count: int, size: int
) -> bytes:
    """Concatenated SHAKE256(seed || le64(counter_start + i)) digests of
    ``size`` bytes each, i < count — the byte stream of ``count``
    sequential :class:`stark_tpu_torch.rng.DeterministicRandom` draws.
    Raises ValueError for shapes outside the C kernel's single-block
    case (the caller falls back to hashlib)."""
    if len(seed) + 8 > 135 or size > 136:
        raise ValueError("seed/output too long for the single-block kernel")
    s = (
        np.frombuffer(seed, dtype=np.uint8)
        if seed
        else np.zeros(1, dtype=np.uint8)
    )
    out = np.empty(count * size, dtype=np.uint8)
    _lib.batch_shake256_ctr(
        _as_u8p(s), len(seed), counter_start, count, size, _as_u8p(out)
    )
    return out.tobytes()


def merkle_tree_from_leaves(leaf_digests: bytes) -> List[bytes]:
    """All levels (leaf level first) from concatenated leaf digests."""
    n = len(leaf_digests) // 32
    src = np.frombuffer(leaf_digests, dtype=np.uint8)
    out = np.empty(32 * (2 * n - 1), dtype=np.uint8)
    _lib.merkle_tree_from_leaves(_as_u8p(src), n, _as_u8p(out))
    raw = out.tobytes()
    levels = []
    pos = 0
    width = n
    while width >= 1:
        levels.append(raw[pos : pos + 32 * width])
        pos += 32 * width
        if width == 1:
            break
        width //= 2
    return levels
