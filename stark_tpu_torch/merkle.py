"""Blake2b-256 binary Merkle trees.

Computes the same roots/paths as the reference's recursive split-combine
(reference: merkle.rs:17-132): leaves are Blake2b-256 digests of the raw
data elements; interior nodes are Blake2b-256(left || right); auth paths
list the sibling digest at each level from leaf to root.

Unlike the reference — which recomputes subtree roots from scratch for every
``open`` (O(n) hashing per opening) — :class:`MerkleTree` builds all levels
once (O(n) total) and answers openings by lookup.  The stateless
``commit``/``open``/``verify`` functions mirror the reference API for
drop-in use and for the adversarial test suite.
"""

from __future__ import annotations

from typing import List, Sequence

from .hashing import (
    batch_blake2b_256,
    blake2b_256_pair,
    merkle_level,
    merkle_levels_from_codeword_digits,
)


class MerkleTree:
    """A fully materialized tree over a power-of-two list of data elements."""

    __slots__ = ("levels", "num_leaves")

    def __init__(self, data_array: Sequence[bytes]) -> None:
        n = len(data_array)
        if n == 0 or n & (n - 1):
            raise ValueError("length must be a power of two")
        self.num_leaves = n
        leaf_digests = batch_blake2b_256(data_array)
        # levels[0] = leaf digests, levels[-1] = [root]; each as concatenated
        # 32-byte digests for compact storage and native-level hashing.
        levels = [b"".join(leaf_digests)]
        while len(levels[-1]) > 32:
            levels.append(merkle_level(levels[-1]))
        self.levels = levels

    @classmethod
    def from_codeword(cls, values: Sequence[int]) -> "MerkleTree":
        """Tree over bincode(FieldElement) leaves of a codeword of residues.

        Uses the fused native serialize+hash+tree path when built (one C
        call for the whole tree); bit-identical to the generic constructor.
        """
        n = len(values)
        if n and not n & (n - 1):
            import numpy as np

            digits = np.zeros((n, 4), dtype=np.uint32)
            for i, v in enumerate(values):
                digits[i, 0] = v & 0xFFFFFFFF
                digits[i, 1] = (v >> 32) & 0xFFFFFFFF
                digits[i, 2] = (v >> 64) & 0xFFFFFFFF
                digits[i, 3] = (v >> 96) & 0xFFFFFFFF
            levels = merkle_levels_from_codeword_digits(digits)
            if levels is not None:
                tree = cls.__new__(cls)
                tree.num_leaves = n
                tree.levels = levels
                return tree
        from .serialization import bincode_field_element

        return cls([bincode_field_element(v) for v in values])

    @classmethod
    def from_digits(cls, digits) -> "MerkleTree":
        """Tree over bincode(FieldElement) leaves given as an (n, 4) uint32
        base-2^32 digit matrix — the device pipeline's native handoff
        (:func:`stark_tpu_torch.ops.device_prover.mont_to_digits`); skips all
        Python-int materialization.  Bit-identical to ``from_codeword``."""
        n = digits.shape[0]
        if n == 0 or n & (n - 1):
            raise ValueError("length must be a power of two")
        levels = merkle_levels_from_codeword_digits(digits)
        if levels is not None:
            tree = cls.__new__(cls)
            tree.num_leaves = n
            tree.levels = levels
            return tree
        # no native library: fall back through Python ints
        from .serialization import bincode_field_element

        values = [
            int(d[0]) | int(d[1]) << 32 | int(d[2]) << 64 | int(d[3]) << 96
            for d in digits
        ]
        return cls([bincode_field_element(v) for v in values])

    @property
    def root(self) -> bytes:
        return self.levels[-1]

    def open(self, index: int) -> List[bytes]:
        """Auth path: sibling digests, leaf level first (reference:
        merkle.rs:54-93)."""
        if not 0 <= index < self.num_leaves:
            raise IndexError("cannot open invalid index")
        path = []
        idx = index
        for level in self.levels[:-1]:
            sib = idx ^ 1
            path.append(level[32 * sib : 32 * sib + 32])
            idx >>= 1
        return path


def commit(data_array: Sequence[bytes]) -> bytes:
    """Root of the tree over ``data_array`` (reference: merkle.rs:38-51)."""
    return MerkleTree(data_array).root


def open(index: int, data_array: Sequence[bytes]) -> List[bytes]:  # noqa: A001
    """Auth path for one leaf (reference: merkle.rs:79-93)."""
    return MerkleTree(data_array).open(index)


def verify(root: bytes, index: int, path: Sequence[bytes], data_element: bytes) -> bool:
    """Recompute the root from a leaf + auth path (reference:
    merkle.rs:96-132)."""
    if not 0 <= index < (1 << len(path)):
        return False
    from .hashing import blake2b_256

    node = blake2b_256(data_element)
    idx = index
    for sibling in path:
        if len(sibling) != 32:
            return False
        if idx & 1:
            node = blake2b_256_pair(sibling, node)
        else:
            node = blake2b_256_pair(node, sibling)
        idx >>= 1
    return node == root
