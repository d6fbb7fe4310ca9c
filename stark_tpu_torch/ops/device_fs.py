"""On-device Fiat-Shamir transcript pieces for the fused FRI cascade.

Counterpart of :mod:`stark_tpu.ops.device_fs`.  Bridges the device Merkle
roots (:mod:`stark_tpu_torch.ops.device_merkle`), the device Shake256
(:mod:`stark_tpu_torch.ops.device_keccak`) and the limb field arithmetic
(:mod:`stark_tpu_torch.ops.field_ops`):

* ``hex_words`` — 32-byte digest (as 8 LE u32 words) -> the 64
  lowercase-hex ASCII bytes the transcript stores (reference pushes
  ``hex::encode(root)`` strings, fri.rs:119-120);
* ``alpha_mont_from_fs`` — 32 Fiat-Shamir bytes -> the fold challenge as
  a Montgomery limb column.  Sampling is the reference's big-endian byte
  fold mod p (field.rs:110-116): with R = 2^128 the fold of 32 bytes
  splits as v = hi*2^128 + lo, and hi*2^128 mod p is exactly
  ``to_mont(hi)`` read as a plain residue;
* ``fs_round_plain`` — one cascade round's transcript step (append
  bincode(hex(root)), Shake256 over count || body, alpha): the plain
  version of the card's ``stark_fs_round`` kernel
  (:mod:`stark_tpu_torch.ops.cuda_fs`).

Digest words are ``int32`` tensors holding u32 bits; bytes are ``uint8``.
"""

from __future__ import annotations

import torch

from . import field_ops as fo
from .device_keccak import shake256_words

_HEX = b"0123456789abcdef"

#: bytes a cascade round appends to the transcript body: the bincode
#: string length (u64 64, little-endian) and the 64 hex digits of the root
APPENDED_BYTES = 72


def digest_bytes(words: torch.Tensor) -> torch.Tensor:
    """(8,) int32 LE digest words -> (32,) uint8 digest bytes."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=words.device)
    return ((w[:, None] >> shifts[None, :]) & 0xFF).reshape(32).to(torch.uint8)


def hex_words(words: torch.Tensor) -> torch.Tensor:
    """(8,) int32 LE digest words -> (64,) uint8 lowercase hex ASCII."""
    b = digest_bytes(words).to(torch.int64)
    table = torch.tensor(list(_HEX), dtype=torch.uint8, device=words.device)
    return torch.stack([table[b >> 4], table[b & 0xF]], dim=1).reshape(64)


def _limbs_from_be_bytes(b: torch.Tensor) -> torch.Tensor:
    """(16,) uint8 big-endian bytes -> (8, 1) int32 16-bit limb column
    (limb k = bits 16k..16k+15 of the big-endian value)."""
    v = b.to(torch.int32)
    lo = v[[15 - 2 * k for k in range(8)]]
    hi = v[[14 - 2 * k for k in range(8)]]
    return (lo | (hi << 8)).reshape(8, 1)


def alpha_mont_from_fs(words: torch.Tensor) -> torch.Tensor:
    """32 Fiat-Shamir digest bytes (as 8 LE int32 words) -> the sampled
    field element (big-endian fold mod p) as an (8, 1) Montgomery limb
    column: ``FieldElement.sample(fs_bytes)`` in Montgomery form."""
    b = digest_bytes(words)
    hi = _limbs_from_be_bytes(b[:16])
    lo = _limbs_from_be_bytes(b[16:])
    # to_mont(hi) = hi * 2^128 mod p read as plain; from_mont(to_mont(lo))
    # = lo mod p (lo < 2^128 may exceed p)
    plain = fo.add(fo.to_mont(hi), fo.from_mont(fo.to_mont(lo)))
    return fo.to_mont(plain)


def _le64(value: int, device) -> torch.Tensor:
    return torch.tensor(list(value.to_bytes(8, "little")), dtype=torch.uint8, device=device)


def fs_round_plain(body: torch.Tensor, body_len: int, count: int, root: torch.Tensor) -> torch.Tensor:
    """One Fiat-Shamir step of the cascade.  ``body`` is a uint8 buffer
    holding the transcript body (the serialized proof stream without its
    u64 count) in ``[0, body_len)``; ``le64(64) || hex(root)`` is written
    in place at ``body_len``.  Returns alpha, the Shake256 draw over
    ``le64(count) || body[:body_len + 72]`` sampled into an (8, 1)
    Montgomery column."""
    end = body_len + APPENDED_BYTES
    body[body_len:end] = torch.cat([_le64(64, body.device), hex_words(root)])
    msg = torch.cat([_le64(count, body.device), body[:end]])
    return alpha_mont_from_fs(shake256_words(msg))
