"""The proof's wire format and its Fiat-Shamir transcript, from the
protocol (the Rust reference's bincode 1.3 and serde_json encodings)."""

from __future__ import annotations

import hashlib
from typing import List

from .field import P


def u32_digits(v: int) -> List[int]:
    out = []
    while v:
        out.append(v & 0xFFFFFFFF)
        v >>= 32
    return out


def json_field_element(v: int) -> str:
    return '{"value":["%s",[%s]]}' % ("NoSign" if v == 0 else "Plus", ",".join(str(d) for d in u32_digits(v)))


def json_field_element_vec(vs) -> str:
    return "[%s]" % ",".join(json_field_element(v) for v in vs)


def json_triple(a: int, b: int, c: int) -> str:
    return '["%d","%d","%d"]' % (a, b, c)


def json_path(path) -> str:
    return "[%s]" % ",".join("[%s]" % ",".join(str(x) for x in d) for d in path)


def serialize(objects: List[str]) -> bytes:
    out = bytearray(len(objects).to_bytes(8, "little"))
    for s in objects:
        b = s.encode()
        out += len(b).to_bytes(8, "little")
        out += b
    return bytes(out)


def sample(data: bytes) -> int:
    return int.from_bytes(data, "big") % P


class Transcript:
    """The proof stream: a list of strings; a challenge is Shake256 of the
    serialisation of everything pushed so far."""

    def __init__(self) -> None:
        self.objects: List[str] = []

    def push(self, s: str) -> None:
        self.objects.append(s)

    def challenge(self, n: int = 32) -> bytes:
        return hashlib.shake_256(serialize(self.objects)).digest(n)

    def bytes(self) -> bytes:
        return serialize(self.objects)


def sample_weights(number: int, randomness: bytes) -> List[int]:
    return [sample(hashlib.blake2b(randomness + i.to_bytes(8, "little"), digest_size=32).digest())
            for i in range(number)]


def sample_indices(seed: bytes, size: int, reduced_size: int, number: int) -> List[int]:
    """Blake2b-512(seed || counter) folded big-endian into 64 bits, mod
    size; distinct by the index mod reduced_size."""
    indices, reduced = [], set()
    counter = 0
    while len(indices) < number:
        acc = 0
        for b in hashlib.blake2b(seed + counter.to_bytes(8, "little"), digest_size=64).digest():
            acc = ((acc << 8) ^ b) & ((1 << 64) - 1)
        index = acc % size
        counter += 1
        if index % reduced_size not in reduced:
            indices.append(index)
            reduced.add(index % reduced_size)
    return indices


class SeededStream:
    """The prover's seeded randomness stream: draw k is
    Shake256(seed || k as 8 little-endian bytes), cut to the size asked."""

    def __init__(self, seed: bytes, counter: int = 0) -> None:
        self.seed = seed
        self.counter = counter

    def draw(self, n: int) -> bytes:
        out = hashlib.shake_256(self.seed + self.counter.to_bytes(8, "little")).digest(n)
        self.counter += 1
        return out
