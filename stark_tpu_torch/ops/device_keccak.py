"""Shake256 (FIPS 202) in plain PyTorch, for on-device Fiat-Shamir.

Counterpart of :mod:`stark_tpu.ops.device_keccak`.  The JAX module holds
each 64-bit lane as a (lo, hi) pair of uint32 lanes because the TPU has no
64-bit integer path; here a lane is one ``int64`` holding the u64 bits
(additions are never needed, and ``>>`` on a signed ``int64`` is
arithmetic, so the rotate masks after shifting).  One permutation is 24
rounds of vectorized theta / rho / pi / chi / iota over the 25-lane state.

Only what the transcript needs is implemented: absorb a byte message
(multi-block, pad10*1 with the 0x1f SHAKE domain byte) and squeeze the
first 32 bytes.  This is the plain version of the Shake256 inside the
card's ``stark_fs_round`` kernel (``csrc/fs.cu``); bit-identical to
``hashlib.shake_256``.
"""

from __future__ import annotations

import torch

_RATE = 136  # SHAKE256 rate in bytes (17 lanes)

_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# rho rotation amounts, lane index x + 5y
_RHO = (0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
        25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14)

# pi: dst[_PI[i]] = src[i]
_PI = (0, 10, 20, 5, 15, 16, 1, 11, 21, 6, 7, 17, 2,
       12, 22, 23, 8, 18, 3, 13, 14, 24, 9, 19, 4)


def _s64(x: int) -> int:
    """u64 constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _rotl(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """64-bit rotate-left of int64 lanes by per-lane amounts 0 <= n < 64."""
    mask = torch.bitwise_left_shift(torch.ones_like(n), n) - 1  # low n bits
    right = torch.bitwise_right_shift(x, (64 - n) % 64) & mask
    return torch.bitwise_left_shift(x, n) | right


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """One Keccak-f[1600] permutation of a (25,) ``int64`` state (lane
    x + 5y holds the u64 bits)."""
    dev = state.device
    rho = torch.tensor(_RHO, dtype=torch.int64, device=dev)
    pi_inv = torch.argsort(torch.tensor(_PI, device=dev))
    one = torch.ones(5, dtype=torch.int64, device=dev)
    a = state.reshape(5, 5)  # [y, x]
    for rc in _RC:
        # theta
        c = a[0] ^ a[1] ^ a[2] ^ a[3] ^ a[4]
        d = torch.roll(c, 1) ^ _rotl(torch.roll(c, -1), one)
        a = a ^ d[None, :]
        # rho + pi
        b = _rotl(a.reshape(25), rho)[pi_inv].reshape(5, 5)
        # chi
        a = b ^ (~torch.roll(b, -1, dims=1) & torch.roll(b, -2, dims=1))
        # iota
        a = a.reshape(25).clone()
        a[0] ^= _s64(rc)
        a = a.reshape(5, 5)
    return a.reshape(25)


def shake256_words(msg: torch.Tensor) -> torch.Tensor:
    """Shake256 of a (n,) ``uint8`` message -> the first 32 output bytes
    as (8,) ``int32`` little-endian words (u32 bits)."""
    n = int(msg.shape[0])
    nblocks = n // _RATE + 1  # pad10*1 always adds at least one bit
    padded = torch.zeros(nblocks * _RATE, dtype=torch.int64, device=msg.device)
    padded[:n] = msg.to(torch.int64)
    padded[n] ^= 0x1F
    padded[-1] ^= 0x80
    shifts = torch.arange(0, 64, 8, dtype=torch.int64, device=msg.device)
    lanes = torch.bitwise_left_shift(padded.reshape(-1, 17, 8), shifts)
    lanes = lanes[..., 0] | lanes[..., 1] | lanes[..., 2] | lanes[..., 3] | lanes[..., 4] | lanes[..., 5] \
        | lanes[..., 6] | lanes[..., 7]  # (nblocks, 17)
    state = torch.zeros(25, dtype=torch.int64, device=msg.device)
    for b in range(nblocks):
        state = torch.cat([state[:17] ^ lanes[b], state[17:]])
        state = keccak_f1600(state)
    out = state[:4]
    words = torch.stack([out & 0xFFFFFFFF, (out >> 32) & 0xFFFFFFFF], dim=1).reshape(8)
    return words.to(torch.int32)
