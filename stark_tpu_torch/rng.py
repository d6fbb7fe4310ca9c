"""Injectable randomness — the determinism seam.

The reference draws proof randomness (trace randomizers, the randomizer
polynomial) from ``thread_rng`` (reference: stark.rs:244-250, :345-352),
making every proof byte-unique.  This framework routes all such draws
through a ``random_bytes(n)`` callable so that:

* production uses OS entropy (default),
* tests use a seeded deterministic stream, enabling byte-exact transcript
  fixtures and reproducible failures,
* recorded randomness from another prover can be replayed for cross-
  verification.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, List

RandomBytes = Callable[[int], bytes]


def os_random_bytes(n: int) -> bytes:
    return os.urandom(n)


def _os_read_many(count: int, size: int) -> List[bytes]:
    """One bulk ``os.urandom`` read sliced into ``count`` chunks.  For OS
    entropy this is distributionally identical to ``count`` separate
    reads (no stream/counter semantics to preserve), and it removes ~1M
    syscall round-trips from a large proof's randomizer sampling."""
    raw = os.urandom(count * size)
    return [raw[i * size : (i + 1) * size] for i in range(count)]


os_random_bytes.read_many = _os_read_many
os_random_bytes.read_concat = lambda count, size: os.urandom(count * size)


def draw_concat(rng: RandomBytes, count: int, size: int) -> bytes:
    """The concatenation of ``count`` draws of ``size`` bytes — what the
    randomizer-polynomial samplers actually consume.  Skips materializing
    ``count`` small bytes objects when the rng produces a contiguous
    buffer natively (DeterministicRandom's keccak batch, bulk urandom)."""
    concat = getattr(rng, "read_concat", None)
    if concat is not None:
        return concat(count, size)
    return b"".join(draw_many(rng, count, size))


def draw_many(rng: RandomBytes, count: int, size: int) -> List[bytes]:
    """``count`` sequential draws of ``size`` bytes from ``rng`` — exactly
    ``[rng(size) for _ in range(count)]``, but routed through the rng's
    batched ``read_many`` when it has one (the randomizer polynomial of a
    large proof draws ~2^17 chunks; per-call hashlib overhead dominates
    otherwise)."""
    many = getattr(rng, "read_many", None)
    if many is not None:
        return many(count, size)
    return [rng(size) for _ in range(count)]


class DeterministicRandom:
    """A Shake256-based deterministic byte stream with a seed."""

    def __init__(self, seed: bytes | str | int = 0) -> None:
        if isinstance(seed, int):
            seed = seed.to_bytes(8, "little")
        elif isinstance(seed, str):
            seed = seed.encode()
        self._seed = seed
        self._counter = 0

    def __call__(self, n: int) -> bytes:
        h = hashlib.shake_256()
        h.update(self._seed)
        h.update(self._counter.to_bytes(8, "little"))
        self._counter += 1
        return h.digest(n)

    def read_many(self, count: int, size: int) -> List[bytes]:
        """Byte-identical to ``count`` sequential calls; batched through
        the native keccak kernel when available (native/keccak.c)."""
        raw = self.read_concat(count, size)
        return [raw[i * size : (i + 1) * size] for i in range(count)]

    def read_concat(self, count: int, size: int) -> bytes:
        """Concatenation of ``count`` sequential ``size``-byte calls,
        without slicing into per-draw objects (native keccak batch)."""
        try:
            from .native.hashing_native import batch_shake256_ctr

            raw = batch_shake256_ctr(self._seed, self._counter, count, size)
        except (ImportError, ValueError):
            return b"".join(self(size) for _ in range(count))
        self._counter += count
        return raw


class RecordedRandom:
    """Replays a recorded list of byte strings (cross-prover verification)."""

    def __init__(self, chunks) -> None:
        self._chunks = list(chunks)
        self._idx = 0

    def __call__(self, n: int) -> bytes:
        chunk = self._chunks[self._idx]
        self._idx += 1
        if len(chunk) != n:
            raise ValueError(f"recorded chunk has {len(chunk)} bytes, need {n}")
        return chunk
