"""Hash primitives: Blake2b-256/512, Shake256 XOF, batched leaf hashing.

The protocol's hash usage (reference):

* Merkle leaves/nodes: Blake2b with 32-byte digest (merkle.rs:4-10,29)
* FRI index sampling: Blake2b with 64-byte digest (fri.rs:60-65)
* Fiat-Shamir transcript: Shake256 XOF (proof_stream.rs:50-69)
* STARK combination weights: Blake2b-256 (stark.rs:205-220)

Python's hashlib blake2b/shake_256 are exactly these functions (blake2b's
``digest_size`` parameterizes the BLAKE2 parameter block the same way the
Rust `blake2` crate's ``Blake2b<OutputSize>`` does).

For throughput, batched hashing of many equal-role inputs (Merkle leaves and
interior levels) is delegated to the native C library of
:mod:`stark_tpu_torch.native` (OpenMP-parallel Blake2b, built at first use),
with a hashlib fallback so the framework is fully functional without it.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence



def _native():
    """The native hashing bindings (the host library is built at first
    use), or None where it cannot be built."""
    try:
        from .native import hashing_native
    except ImportError:
        return None
    return hashing_native


def blake2b_256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def blake2b_512(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=64).digest()


def shake256(data: bytes, num_bytes: int) -> bytes:
    return hashlib.shake_256(data).digest(num_bytes)


def blake2b_256_pair(left: bytes, right: bytes) -> bytes:
    h = hashlib.blake2b(digest_size=32)
    h.update(left)
    h.update(right)
    return h.digest()


#: below this many items, ctypes marshalling beats any parallel speedup
_NATIVE_MIN_BATCH = 128


def batch_blake2b_256(items: Sequence[bytes]) -> List[bytes]:
    """Hash many byte strings (Merkle leaf hashing hot loop)."""
    native = _native() if len(items) >= _NATIVE_MIN_BATCH else None
    if native is not None:
        return native.batch_blake2b_256(items)
    return [hashlib.blake2b(d, digest_size=32).digest() for d in items]


def merkle_level(nodes: bytes) -> bytes:
    """One interior Merkle level: input is concatenated 32-byte child
    digests (even count); output is the concatenated parent digests."""
    native = _native() if len(nodes) >= 64 * _NATIVE_MIN_BATCH else None
    if native is not None:
        return native.merkle_level(nodes)
    out = bytearray()
    for i in range(0, len(nodes), 64):
        out += hashlib.blake2b(nodes[i : i + 64], digest_size=32).digest()
    return bytes(out)


def merkle_levels_from_codeword_digits(digits) -> "list[bytes] | None":
    """Fused native path: (n, 4) uint32 digit rows -> all Merkle levels
    (bincode-serialize + leaf hash + tree build entirely in C).  Returns
    None when the native library is unavailable."""
    native = _native()
    if native is None:
        return None
    leaf = native.merkle_leaves_u128(digits)
    return native.merkle_tree_from_leaves(leaf)
