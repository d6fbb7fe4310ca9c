"""Fiat-Shamir proof stream (transcript).

An ordered list of string objects with a read cursor.  Serialization is
bincode(Vec<String>) and the Fiat-Shamir challenge is Shake256 over the
serialized prefix — byte-identical to the reference
(reference: proof_stream.rs:13-69).
"""

from __future__ import annotations

from typing import List

from .hashing import shake256
from .serialization import bincode_parse_string_vec, bincode_string_vec


class ProofStream:
    __slots__ = ("objects", "read_idx")

    def __init__(self, objects: List[str] = None) -> None:
        self.objects: List[str] = list(objects) if objects else []
        self.read_idx = 0

    def push(self, obj: str) -> None:
        self.objects.append(obj)

    def pull(self) -> str:
        if self.read_idx >= len(self.objects):
            raise IndexError("ProofStream: cannot pull object; queue empty")
        obj = self.objects[self.read_idx]
        self.read_idx += 1
        return obj

    def serialize(self) -> bytes:
        return bincode_string_vec(self.objects)

    @staticmethod
    def deserialize(data: bytes) -> "ProofStream":
        return ProofStream(bincode_parse_string_vec(data))

    def prover_fiat_shamir(self, num_bytes: int = 32) -> bytes:
        """Shake256 over the full serialized transcript
        (reference: proof_stream.rs:50-58)."""
        return shake256(self.serialize(), num_bytes)

    def verifier_fiat_shamir(self, num_bytes: int = 32) -> bytes:
        """Shake256 over the read prefix only
        (reference: proof_stream.rs:61-69)."""
        return shake256(bincode_string_vec(self.objects[: self.read_idx]), num_bytes)

    def __len__(self) -> int:
        return len(self.objects)
