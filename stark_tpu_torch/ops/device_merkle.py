"""Device-resident Blake2b-256 Merkle commitment.

Counterpart of :mod:`stark_tpu.ops.device_merkle`.  A commitment hashes
the codeword's ``bincode(FieldElement)`` leaves and every interior level
on the device; only the TAIL_WIDTH-wide level (32 KB), the root and the
opened siblings cross to the host.  Roots and auth paths are byte-identical
to :class:`stark_tpu_torch.merkle.MerkleTree` over the same codeword.

This module holds the plain PyTorch Blake2b (:func:`blake2b256_single_block`
and the leaf/level functions built on it), which is what the CUDA kernels
of :mod:`stark_tpu_torch.ops.cuda_merkle` compute and what they run as on
the CPU.  Words are ``int64`` tensors holding u64 bits: additions wrap
modulo 2^64, and since ``>>`` on a signed ``int64`` is arithmetic, the
rotates mask after shifting.  Digest levels are ``(8, w)`` ``int32``
tensors of u32 words (lo/hi of each u64, little-endian).

The JAX module's ``_bucket_pad`` and ``_sibling_gather_fn`` kept jit
shapes stable; PyTorch runs eagerly, so plain indexing takes their place.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..hashing import merkle_level
from . import field_ops as fo
from .limbs import to_numpy

_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)
# unkeyed 32-byte digest: h[0] = IV[0] ^ 0x01010020
_H0 = _IV[0] ^ 0x01010020

_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

#: tree levels at or below this width are fetched and finished on the host
TAIL_WIDTH = 1024

#: smallest codeword the device tree is used for (below it the host's
#: native-C tree over the fetched digits is used); read at call time, so
#: tests may lower it
DEVICE_TREE_MIN = 8192

_U32 = 0xFFFFFFFF


def _s64(x: int) -> int:
    """u64 constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) & ((1 << (64 - n)) - 1)) | (x << (64 - n))


def _g(v, a, b, c, d, x, y) -> None:
    v[a] = v[a] + v[b] + x
    v[d] = _rotr(v[d] ^ v[a], 32)
    v[c] = v[c] + v[d]
    v[b] = _rotr(v[b] ^ v[c], 24)
    v[a] = v[a] + v[b] + y
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = v[c] + v[d]
    v[b] = _rotr(v[b] ^ v[c], 63)


def blake2b256_single_block(m: Sequence, t, rounds: int = 12) -> torch.Tensor:
    """Batched final-block Blake2b-256.

    ``m``: 16 message words, each an ``int64`` tensor of u64 bits or the
    int 0; ``t``: the byte count, an ``int64`` tensor or an int.  Returns
    the (8, w) ``int32`` digest words (lo/hi of h[0..3]).  ``rounds`` < 12
    cuts the compress short, as the JAX function's argument does: not a
    valid hash, only the Merkle roofline probe's
    (:mod:`stark_tpu_torch.benches.merkle_roofline`)."""
    if not 1 <= rounds <= 12:
        raise ValueError(f"rounds must be in [1, 12], got {rounds}")
    like = next(w for w in m if isinstance(w, torch.Tensor))
    m = [w if isinstance(w, torch.Tensor) else torch.zeros_like(like) for w in m]
    h = [_s64(_H0)] + [_s64(w) for w in _IV[1:]]
    v = [torch.full_like(like, x) for x in h + [_s64(w) for w in _IV]]
    v[12] = v[12] ^ t
    v[14] = ~v[14]
    for r in range(rounds):
        s = _SIGMA[r % 10]
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    rows = []
    for i in range(4):
        word = v[i] ^ v[i + 8] ^ h[i]
        rows += [word & _U32, (word >> 32) & _U32]
    return torch.stack(rows).to(torch.int32)


def _u64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two u32-bit int32 rows -> one int64 row of u64 bits."""
    return (lo.to(torch.int64) & _U32) | (hi.to(torch.int64) << 32)


def leaf_digests_from_digits(d: torch.Tensor) -> torch.Tensor:
    """(4, w) plain base-2^32 digit rows -> (8, w) digests of the
    ``bincode(FieldElement)`` leaves (sign u32 | count u64 | k digits,
    k = index + 1 of the highest nonzero digit)."""
    d = d.to(torch.int64) & _U32
    k = torch.where(d[3] != 0, 4, torch.where(d[2] != 0, 3, torch.where(d[1] != 0, 2, torch.where(d[0] != 0, 1, 0))))
    sign = torch.where(k > 0, 2, 1)  # Plus = 2 / NoSign = 1
    m = [sign | (k << 32), d[0] << 32, d[1] | (d[2] << 32), d[3]] + [0] * 12
    return blake2b256_single_block(m, 12 + 4 * k)


def level_hash(level: torch.Tensor, rounds: int = 12) -> torch.Tensor:
    """One interior level: (8, w) child digests -> (8, w/2) parents
    H(left || right), one 64-byte block each (a compress of ``rounds``
    rounds: see :func:`blake2b256_single_block`)."""
    left, right = level[:, 0::2], level[:, 1::2]
    m = [_u64(left[2 * j], left[2 * j + 1]) for j in range(4)]
    m += [_u64(right[2 * j], right[2 * j + 1]) for j in range(4)]
    return blake2b256_single_block(m + [0] * 8, 64, rounds)


def merkle_subtrees_plain(level: torch.Tensor, depth: int) -> torch.Tensor:
    """The ``depth`` levels above an (8, w) level, w a power of two >= 2^depth,
    as one flat int32 buffer of 8 * (w - w / 2^depth) words: level k is the
    contiguous (8, w / 2^k) slab after those of the levels below it (see
    :func:`top_slabs`)."""
    slabs = []
    for _ in range(depth):
        level = level_hash(level)
        slabs.append(level.reshape(-1))
    return torch.cat(slabs)


def merkle_top_plain(level: torch.Tensor) -> torch.Tensor:
    """Every level above an (8, w) level, w a power of two >= 2, down to the
    root, as one flat int32 buffer of 8 * (w - 1) words, the root last:
    :func:`merkle_subtrees_plain` of depth log2 w."""
    return merkle_subtrees_plain(level, int(level.shape[1]).bit_length() - 1)


def top_slabs(flat: torch.Tensor, w: int) -> List[torch.Tensor]:
    """The (8, w / 2^k) views, k = 1, 2, ..., of a flat buffer laid out
    as :func:`merkle_subtrees_plain`'s, as many as it holds."""
    views, off = [], 0
    while off < flat.numel():
        w //= 2
        views.append(flat[off : off + 8 * w].view(8, w))
        off += 8 * w
    return views


def plain_digits(mont: torch.Tensor) -> torch.Tensor:
    """(8, n) Montgomery limbs -> (4, n) ``int32`` plain base-2^32 digits:
    the plain version of :func:`stark_tpu_torch.ops.cuda_merkle.mont_digits`,
    which the prover calls."""
    plain = fo.from_mont(mont).to(torch.int64)
    return (plain[0::2] | (plain[1::2] << 16)).to(torch.int32)


def tree_arrays_with_root(mont: torch.Tensor, n: int):
    """Whole-tree build including the root: ``(levels, root_words)`` with
    ``levels`` the (8, w) digest levels from the leaves down to TAIL_WIDTH
    and ``root_words`` the (8,) root.  Hashing runs through the leaf and
    level kernels on the card (their plain versions on the CPU), the leaf
    kernel reading the Montgomery codeword itself."""
    from .cuda_merkle import tree_levels

    if int(mont.shape[1]) != n:
        raise ValueError(f"codeword has {int(mont.shape[1])} leaves, expected {n}")
    return tree_levels(mont, TAIL_WIDTH, mont=True)


def _digest_bytes(words: np.ndarray) -> bytes:
    """(8,) uint32 words -> 32 digest bytes."""
    return np.ascontiguousarray(words.astype("<u4")).tobytes()


def _level_bytes(arr: np.ndarray) -> bytes:
    """(8, w) uint32 level -> concatenated 32-byte digests."""
    return np.ascontiguousarray(arr.T.astype("<u4")).tobytes()


def roots_batch(trees) -> List[bytes]:
    """Roots of many trees with at most ONE device fetch."""
    jobs = [(t, t.root_words_async() if hasattr(t, "root_words_async") else None) for t in trees]
    arrs = [w for _, w in jobs if w is not None]
    if arrs:
        flat = to_numpy(torch.stack(arrs))
        i = 0
        for t, w in jobs:
            if w is not None:
                t.set_root(_digest_bytes(flat[i]))
                i += 1
    return [t.root for t, _ in jobs]


class DeviceMerkleTree:
    """Merkle tree whose levels down to TAIL_WIDTH live on the device.

    Same surface as :class:`stark_tpu_torch.merkle.MerkleTree` (``root``,
    ``open``, ``num_leaves``) plus the batched-fetch hooks the prover
    uses: ``gather_siblings_async`` / ``absorb_siblings``, ``tail_async``
    / ``absorb_tail``, ``root_words_async`` / ``set_root`` and
    ``prefetch``."""

    def __init__(self, mont: torch.Tensor) -> None:
        n = int(mont.shape[1])
        if n < 2 * TAIL_WIDTH or n & (n - 1):
            raise ValueError(f"device tree needs a power-of-two codeword >= {2 * TAIL_WIDTH}")
        levels, root_words = tree_arrays_with_root(mont, n)
        self._init_from_arrays(n, levels, None)
        self._root_words = root_words

    @classmethod
    def from_cascade(cls, n: int, levels, root: bytes) -> "DeviceMerkleTree":
        """Wrap the level arrays built inside the fused FRI cascade; the
        root was hashed on the device and fetched with the round-roots
        batch, so ``.root`` never blocks on the tail level."""
        tree = cls.__new__(cls)
        tree._init_from_arrays(n, levels, root)
        tree._root_words = None
        return tree

    def _init_from_arrays(self, n: int, levels, root) -> None:
        self.num_leaves = n
        # widths n .. 2*TAIL stay on the device; the TAIL-wide level is
        # fetched lazily (32 KB) and the top finishes on the host
        self._device_levels = list(levels[:-1])
        self._tail_arr = levels[-1]
        self._host_levels = None
        self._log_n = n.bit_length() - 1
        self._log_tail_gap = self._log_n - TAIL_WIDTH.bit_length() + 1
        self._sib_cache: Dict[tuple, bytes] = {}
        self._root_bytes = root

    @property
    def tail_pending(self) -> bool:
        """Whether the host top levels still wait for the tail level."""
        return self._host_levels is None

    def tail_async(self):
        """The (8, TAIL_WIDTH) tail level if it still needs fetching."""
        return self._tail_arr if self.tail_pending else None

    def absorb_tail(self, arr: np.ndarray) -> None:
        """Finish the host top levels from an externally fetched tail."""
        if self._host_levels is not None:
            return
        self._tail_arr = None
        host_levels = [_level_bytes(arr)]
        while len(host_levels[-1]) > 32:
            host_levels.append(merkle_level(host_levels[-1]))
        self._host_levels = host_levels

    def _finish_top(self) -> List[bytes]:
        if self._host_levels is None:
            self.absorb_tail(to_numpy(self._tail_arr))
        return self._host_levels

    def root_words_async(self):
        """The device (8,) root words, or None if the root is already known."""
        if self._root_bytes is not None or self._host_levels is not None:
            return None
        return self._root_words

    def set_root(self, root: bytes) -> None:
        self._root_bytes = root

    @property
    def root(self) -> bytes:
        if self._root_bytes is None:
            if self._host_levels is not None:
                self._root_bytes = self._host_levels[-1]
            else:
                self._root_bytes = _digest_bytes(to_numpy(self._root_words))
        return self._root_bytes

    def missing_siblings(self, indices: Sequence[int]) -> List[tuple]:
        """The (level, index) keys of the device-level auth-path siblings of
        ``indices`` that are not cached yet, level by level, in order."""
        keys: List[tuple] = []
        for lvl in range(len(self._device_levels)):
            cached = {s for (l, s) in self._sib_cache if l == lvl}
            keys.extend((lvl, s) for s in sorted({(int(i) >> lvl) ^ 1 for i in indices} - cached))
        return keys

    def gather_siblings(self, keys: Sequence[tuple]) -> torch.Tensor:
        """The (8, len(keys)) device digests of ``keys`` (as
        :meth:`missing_siblings` orders them): one index a level."""
        by_level: Dict[int, List[int]] = {}
        for lvl, sib in keys:
            by_level.setdefault(lvl, []).append(sib)
        return torch.cat([self._device_levels[lvl][:, torch.tensor(sibs, device=self._device_levels[lvl].device)]
                          for lvl, sibs in by_level.items()], dim=1)

    def gather_siblings_async(self, indices: Sequence[int]):
        """Gather (without fetching) every device-level auth-path sibling of
        ``indices`` that is not cached yet: (keys, (8, len(keys)) tensor),
        or ([], None) when nothing is missing."""
        keys = self.missing_siblings(indices)
        if not keys:
            return [], None
        return keys, self.gather_siblings(keys)

    def absorb_siblings(self, keys, flat: np.ndarray) -> None:
        """Fill the sibling cache from a fetched gather (columns match keys)."""
        for col, key in enumerate(keys):
            self._sib_cache[key] = _digest_bytes(flat[:, col])

    def prefetch(self, indices: Sequence[int]) -> None:
        """One host fetch for every sibling (and the tail) ``indices`` need."""
        from .device_prover import fetch_absorb

        keys, arr = self.gather_siblings_async(indices)
        jobs = []
        if keys:
            jobs.append((arr, lambda s: self.absorb_siblings(keys, s)))
        tail = self.tail_async()
        if tail is not None:
            jobs.append((tail, self.absorb_tail))
        fetch_absorb(jobs)

    def open(self, index: int) -> List[bytes]:
        """Auth path: sibling digests, leaf level first."""
        if not 0 <= index < self.num_leaves:
            raise IndexError("leaf index out of range")
        path: List[bytes] = []
        for lvl in range(self._log_n):
            sib = (index >> lvl) ^ 1
            if lvl < len(self._device_levels):
                key = (lvl, sib)
                if key not in self._sib_cache:
                    self.absorb_siblings([key], to_numpy(self.gather_siblings([key])))
                path.append(self._sib_cache[key])
            else:
                host = self._finish_top()[lvl - self._log_tail_gap]
                path.append(host[32 * sib : 32 * sib + 32])
        return path
