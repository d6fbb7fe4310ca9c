"""The Fiat-Shamir round: Shake256 over the count, the transcript body and
the appended root (8 + body + 72 bytes), one Keccak-f[1600] a 136-byte
block, padding included."""

from . import KECCAK_PERMUTATION

KERNELS = ("fs_round_kernel",)
LAUNCHES = ("fs_round",)


def count(key, args, size):
    absorbed = 8 + int(args[1]) + 72
    blocks = absorbed // 136 + 1
    return blocks * KECCAK_PERMUTATION, absorbed + 32 + 16
