"""Merkle commitments over sharded codewords.

Counterpart of :mod:`stark_tpu.parallel.merkle_sharded`.  The chunk
exchange (:func:`~stark_tpu_torch.parallel.mesh.exchange`) turns a
four-step codeword's ``(8, C, R/D)`` shards into ``(8, C/D, R)`` shards,
and a contiguous k2 range over every k1 is a contiguous range of natural
indices k = k1 + R*k2: shard b then holds natural-order block b of n/D
leaves.  Each block is hashed into its own subtree; only the D subtree
roots are combined, on the host, into the top log2(D) levels.  The tree
is byte-identical to :class:`stark_tpu_torch.merkle.MerkleTree` over the
whole codeword, and so are its auth paths.

* :func:`subtree_levels`, :func:`tree_from_block_levels` and
  :func:`tree_from_blocks` are the JAX module's host functions: blocks
  given as digit matrices, hashed by the host's native C.
* :class:`ShardedMerkleTree` is the device form: a
  :class:`~stark_tpu_torch.ops.device_merkle.DeviceMerkleTree` a block on
  its shard's device (K4 from the Montgomery limbs, the subtrees kernel,
  the top kernel), the top levels hashed on the host from the D block
  roots, openings gathered from the blocks' device levels.  On a mesh
  that spans ranks a rank holds device trees for its own blocks and a
  :class:`RemoteBlock` for each other one; only the D roots, the opened
  paths' siblings and the tail levels cross ranks, each in one all-gather
  (:func:`~stark_tpu_torch.parallel.mesh.allgather_shards`), so every
  rank opens the same paths.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..hashing import merkle_level
from ..merkle import MerkleTree
from ..ops.device_merkle import TAIL_WIDTH, DeviceMerkleTree, _digest_bytes
from ..ops.limbs import from_numpy, to_numpy
from .mesh import Mesh, allgather_shards, owned


def subtree_levels(block_digits: np.ndarray) -> List[bytes]:
    """All Merkle levels (leaf level first, 32-byte subroot last) of one
    natural-order block given as (m, 4) uint32 digit rows."""
    return MerkleTree.from_digits(block_digits).levels


def _top_levels(roots: bytes) -> List[bytes]:
    """The levels above D concatenated subtree roots, those roots first."""
    levels = [roots]
    while len(levels[-1]) > 32:
        levels.append(merkle_level(levels[-1]))
    return levels


def tree_from_block_levels(block_levels: Sequence[List[bytes]]) -> MerkleTree:
    """The whole tree from per-block subtree levels: below the subtree
    roots each level is the blocks' levels joined in block order; above,
    the top levels hashed from the D subtree roots."""
    d = len(block_levels)
    if d & (d - 1):
        raise ValueError("block count must be a power of two")
    depth = len(block_levels[0])
    if any(len(bl) != depth for bl in block_levels):
        raise ValueError("blocks must have equal size")
    levels = [b"".join(bl[level] for bl in block_levels) for level in range(depth)]
    levels += _top_levels(levels.pop())
    tree = MerkleTree.__new__(MerkleTree)
    tree.num_leaves = len(levels[0]) // 32
    tree.levels = levels
    return tree


def tree_from_blocks(blocks: Sequence[np.ndarray]) -> MerkleTree:
    """The commitment of natural-order digit blocks: a subtree a block,
    the top levels from the subtree roots."""
    return tree_from_block_levels([subtree_levels(b) for b in blocks])


class RemoteBlock(DeviceMerkleTree):
    """A block whose device tree lives on another rank: the host side of a
    :class:`DeviceMerkleTree` (the siblings, tail level and root that
    crossed, with the same bookkeeping of what is missing) and no device
    level.  Its owner's rank supplies what it lacks."""

    def __init__(self, n: int) -> None:
        if n < 2 * TAIL_WIDTH or n & (n - 1):
            raise ValueError(f"device tree needs a power-of-two block >= {2 * TAIL_WIDTH}")
        depth = n.bit_length() - TAIL_WIDTH.bit_length()  # the levels n .. 2 * TAIL_WIDTH
        self._init_from_arrays(n, [None] * (depth + 1), None)
        self._root_words = None

    def gather_siblings(self, keys):
        raise RuntimeError("a remote block's levels live on another rank: gather through its ShardedMerkleTree")

    def _finish_top(self) -> List[bytes]:
        if self._host_levels is None:
            raise RuntimeError("a remote block's tail level has not crossed: fetch it through its ShardedMerkleTree")
        return self._host_levels


class ShardedMerkleTree:
    """A Merkle tree over D natural-order blocks, each a
    :class:`DeviceMerkleTree` on its shard's device (a :class:`RemoteBlock`
    where another rank owns it), the top log2(D) levels on the host.  Same
    surface as ``DeviceMerkleTree`` (``root``, ``open``, ``num_leaves``,
    ``prefetch`` and the batched-fetch hooks); gathers from the blocks are
    joined on ``device``.  On a spanning ``mesh`` the root, the hooks and
    ``open`` are collectives: every rank calls them in the same order with
    the same indices, and gets the same bytes."""

    def __init__(self, blocks: Sequence[DeviceMerkleTree], device, mesh: Mesh) -> None:
        d = len(blocks)
        if d & (d - 1):
            raise ValueError("block count must be a power of two")
        self.blocks = list(blocks)
        self.device = torch.device(device)
        self.mesh = mesh
        self._own = [s for s, _ in owned(self.mesh)]
        self.block_leaves = blocks[0].num_leaves
        self.num_leaves = d * self.block_leaves
        self._log_d = d.bit_length() - 1
        self._top = None
        self._tail_blocks: List[int] = []

    def _join(self, parts, cols: Sequence[int]) -> torch.Tensor:
        """Own blocks' (8, k) columns joined on ``device``, then every
        block's on every rank (``cols[b]``: block b's columns)."""
        local = (torch.cat([p.to(self.device) for p in parts], dim=1) if parts
                 else torch.zeros((8, 0), dtype=torch.int32, device=self.device))
        return allgather_shards(self.mesh, local, cols)

    def _finish_top(self) -> List[bytes]:
        if self._top is None:
            words = []
            for b in self._own:
                w = self.blocks[b].root_words_async()
                if w is None:  # the root is known: its words as they hash
                    w = from_numpy(np.frombuffer(self.blocks[b].root, dtype="<u4"), self.device)
                words.append(w.reshape(8, 1))
            flat = to_numpy(self._join(words, [1] * len(self.blocks)))
            for b, t in enumerate(self.blocks):
                t.set_root(_digest_bytes(flat[:, b]))
            self._top = _top_levels(b"".join(t.root for t in self.blocks))
        return self._top

    @property
    def root(self) -> bytes:
        return self._finish_top()[-1]

    def _by_block(self, indices):
        per = {}
        for i in sorted({int(i) for i in indices}):
            b, local = divmod(i, self.block_leaves)
            per.setdefault(b, []).append(local)
        return per

    def gather_siblings_async(self, indices: Sequence[int]):
        """Every block's missing device-level siblings of ``indices``:
        (keys, (8, len(keys)) tensor on ``device``) or ([], None)."""
        keys, parts, cols = [], [], [0] * len(self.blocks)
        for b, local in self._by_block(indices).items():
            got = self.blocks[b].missing_siblings(local)
            keys += [(b, key) for key in got]
            cols[b] = len(got)
            if got and b in self._own:
                parts.append(self.blocks[b].gather_siblings(got))
        if not keys:
            return [], None
        return keys, self._join(parts, cols)

    def absorb_siblings(self, keys, flat: np.ndarray) -> None:
        per = {}
        for col, (b, key) in enumerate(keys):
            per.setdefault(b, ([], []))
            per[b][0].append(key)
            per[b][1].append(col)
        for b, (got, cols) in per.items():
            self.blocks[b].absorb_siblings(got, flat[:, cols])

    def tail_async(self):
        """The blocks' tail levels still to fetch, joined on ``device``."""
        need = [b for b, t in enumerate(self.blocks) if t.tail_pending]
        if not need:
            return None
        self._tail_blocks = need
        return self._join([self.blocks[b].tail_async() for b in need if b in self._own],
                          [TAIL_WIDTH if b in need else 0 for b in range(len(self.blocks))])

    def absorb_tail(self, arr: np.ndarray) -> None:
        w = arr.shape[1] // len(self._tail_blocks)
        for j, b in enumerate(self._tail_blocks):
            self.blocks[b].absorb_tail(arr[:, j * w:(j + 1) * w])
        self._tail_blocks = []

    def prefetch(self, indices: Sequence[int]) -> None:
        """One host fetch for every sibling (and tail) ``indices`` need."""
        from ..ops.device_prover import fetch_absorb

        keys, arr = self.gather_siblings_async(indices)
        jobs = []
        if keys:
            jobs.append((arr, lambda s: self.absorb_siblings(keys, s)))
        tail = self.tail_async()
        if tail is not None:
            jobs.append((tail, self.absorb_tail))
        fetch_absorb(jobs)

    def open(self, index: int) -> List[bytes]:
        """Auth path: the block's path, then the top levels' siblings."""
        if not 0 <= index < self.num_leaves:
            raise IndexError("leaf index out of range")
        b, local = divmod(index, self.block_leaves)
        top = self._finish_top()
        self.prefetch([index])  # nothing moves once the batched fetches have run
        path = self.blocks[b].open(local)
        for lvl in range(self._log_d):
            sib = (b >> lvl) ^ 1
            path.append(top[lvl][32 * sib:32 * sib + 32])
        return path
