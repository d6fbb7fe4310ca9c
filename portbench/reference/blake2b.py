"""Blake2b-256 of single-block messages, batched over int64 tensors.

Each message is at most 128 bytes (one compression): a Merkle leaf (the
bincode of one field element, 12 to 28 bytes) or an interior node (two
32-byte digests).  Words are int64 holding the 64-bit patterns; additions
wrap mod 2^64 and right shifts are masked to be logical.  The four G
functions of a column (or diagonal) step run as one tensor operation.
"""

from __future__ import annotations

import torch

_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)
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


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) & ((1 << (64 - r)) - 1)) | (x << (64 - r))


def _g(a, b, c, d, x, y):
    a = a + b + x
    d = _rotr(d ^ a, 32)
    c = c + d
    b = _rotr(b ^ c, 24)
    a = a + b + y
    d = _rotr(d ^ a, 16)
    c = c + d
    b = _rotr(b ^ c, 63)
    return a, b, c, d


def blake2b_256(words: torch.Tensor, length) -> torch.Tensor:
    """Digests (4, n) of n messages given as (16, n) little-endian words of
    their zero-padded block, ``length`` bytes each (int or (n,) tensor)."""
    n = words.shape[1]
    dev = words.device
    iv = torch.tensor([_signed(v) for v in _IV], dtype=torch.int64, device=dev).reshape(8, 1)
    h = iv.clone()
    h[0] ^= 0x01010020  # digest length 32, no key, fanout 1, depth 1
    v = torch.cat([h.expand(8, n), iv.expand(8, n)]).clone()
    v[12] ^= length if isinstance(length, torch.Tensor) else torch.full((n,), length, dtype=torch.int64, device=dev)
    v[14] = ~v[14]  # last block
    a, b, c, d = v[0:4], v[4:8], v[8:12], v[12:16]
    for r in range(12):
        s = _SIGMA[r % 10]
        a, b, c, d = _g(a, b, c, d, words[list(s[0:8:2])], words[list(s[1:8:2])])
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b, c, d = _g(a, b, c, d, words[list(s[8:16:2])], words[list(s[9:16:2])])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    out = h.expand(8, n) ^ torch.cat([a, b]) ^ torch.cat([c, d])
    return out[:4]


def leaf_words(plain: torch.Tensor):
    """The bincode of each field element of (8, n) plain limbs (sign u32,
    digit count u64, base-2^32 digits without trailing zeros) as (16, n)
    block words, and its byte length."""
    n = plain.shape[1]
    digits = plain[0::2] | (plain[1::2] << 16)  # (4, n) u32 digits
    nonzero = digits != 0
    count = torch.zeros(n, dtype=torch.int64, device=plain.device)
    for j in range(4):
        count = torch.where(nonzero[j], torch.full_like(count, j + 1), count)
    sign = torch.where(count == 0, 1, 2).to(torch.int64)
    words = torch.zeros((16, n), dtype=torch.int64, device=plain.device)
    words[0] = sign | (count << 32)
    words[1] = digits[0] << 32
    words[2] = digits[1] | (digits[2] << 32)
    words[3] = digits[3]
    return words, 12 + 4 * count


def node_words(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    n = left.shape[1]
    return torch.cat([left, right, torch.zeros((8, n), dtype=torch.int64, device=left.device)])


def digest_bytes(d: torch.Tensor) -> list:
    """(4, n) digests -> n 32-byte strings."""
    raw = d.T.contiguous().to("cpu").numpy().astype("<i8").tobytes()
    return [raw[32 * i : 32 * i + 32] for i in range(d.shape[1])]
