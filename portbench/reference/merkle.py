"""Binary Blake2b-256 Merkle trees over codewords of field elements."""

from __future__ import annotations

import hashlib

import torch

from . import blake2b

#: levels at most this wide are hashed with hashlib on the host
HOST_WIDTH = 4096


class Tree:
    """All levels of the tree over (8, n) plain limbs; ``levels[0]`` the
    leaves' digests, the last the root."""

    def __init__(self, plain: torch.Tensor) -> None:
        n = plain.shape[1]
        if n & (n - 1):
            raise ValueError("a tree needs a power-of-two width")
        words, length = blake2b.leaf_words(plain)
        level = blake2b.blake2b_256(words, length)
        self.levels = []
        while level.shape[1] > HOST_WIDTH:
            self.levels.append(level)
            level = blake2b.blake2b_256(blake2b.node_words(level[:, 0::2], level[:, 1::2]), 64)
        host = b"".join(blake2b.digest_bytes(level))
        self.levels.append(host)
        while len(host) > 32:
            host = b"".join(hashlib.blake2b(host[i : i + 64], digest_size=32).digest()
                            for i in range(0, len(host), 64))
            self.levels.append(host)

    @property
    def root(self) -> bytes:
        return self.levels[-1]

    def open(self, index: int) -> list:
        """Sibling digests from the leaf level up."""
        path = []
        for level in self.levels[:-1]:
            sib = index ^ 1
            if isinstance(level, bytes):
                path.append(level[32 * sib : 32 * sib + 32])
            else:
                path.append(blake2b.digest_bytes(level[:, sib : sib + 1])[0])
            index >>= 1
        return path
