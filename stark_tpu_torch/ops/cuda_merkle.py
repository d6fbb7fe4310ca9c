"""Blake2b-256 Merkle tree through the hand-written CUDA kernels (K4, K5).

Counterpart of :mod:`stark_tpu.ops.pallas_merkle`
(``leaf_digests_pallas``, ``level_hash_pallas``, ``tree_levels``).
:func:`merkle_leaves` and :func:`merkle_level` wrap the two kernels of
``csrc/merkle.cu``; their plain PyTorch versions are
:func:`stark_tpu_torch.ops.device_merkle.leaf_digests_from_digits` and
:func:`stark_tpu_torch.ops.device_merkle.level_hash`, and run only for
tensors on the CPU.  For a CUDA tensor a wrapper launches its kernel or
raises.

On the card every level down to the root goes through the level kernel:
the 256-wide minimum of the TPU version was a tiling rule of that chip.
"""

from __future__ import annotations

import torch

from . import kernels
from .device_merkle import leaf_digests_from_digits, level_hash


def _check(name: str, t: torch.Tensor, rows: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name}: expected shape ({rows}, w), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def merkle_leaves(digits: torch.Tensor) -> torch.Tensor:
    """K4: (4, n) plain base-2^32 digits -> (8, n) leaf digest words
    (Blake2b-256 of each ``bincode(FieldElement)``).

    Replaces ``leaf_digests_pallas`` / ``_leaf_kernel``
    (stark_tpu/ops/pallas_merkle.py).  One thread per leaf with the state
    in registers; bound by 64-bit integer throughput (one 12-round
    compress per 16 bytes read), see csrc/merkle.cu."""
    _check("digits", digits, 4)
    n = int(digits.shape[1])
    if n == 0:
        raise ValueError("no leaves")
    if digits.device.type == "cpu":
        return leaf_digests_from_digits(digits)
    out = torch.empty((8, n), dtype=torch.int32, device=digits.device)
    kernels.launch("merkle_leaves", "stark_merkle_leaves", kernels.ptr(digits), kernels.ptr(out), n,
                   device=digits.device)
    return out


def merkle_level(level: torch.Tensor) -> torch.Tensor:
    """K5: (8, w) child digests -> (8, w/2) parents H(left || right).

    Replaces ``level_hash_pallas`` / ``_level_kernel``
    (stark_tpu/ops/pallas_merkle.py).  One thread per parent, reading its
    children 2i and 2i + 1 itself; compute-bound like
    :func:`merkle_leaves`."""
    _check("level", level, 8)
    w = int(level.shape[1])
    if w < 2 or w % 2:
        raise ValueError(f"level width must be even and >= 2, got {w}")
    if level.device.type == "cpu":
        return level_hash(level)
    out = torch.empty((8, w // 2), dtype=torch.int32, device=level.device)
    kernels.launch("merkle_level", "stark_merkle_level", kernels.ptr(level), kernels.ptr(out), w,
                   device=level.device)
    return out


def tree_levels(digits: torch.Tensor, tail_width: int):
    """All levels from the (4, n) digits, n a power of two: the (8, w)
    levels for w = n .. tail_width (kept on the device for openings) and
    the (8,) root words."""
    cur = merkle_leaves(digits.contiguous())
    levels = [cur]
    while cur.shape[1] > 1:
        cur = merkle_level(cur)
        levels.append(cur)
    kept = tuple(lv for lv in levels if lv.shape[1] >= tail_width)
    return kept, levels[-1][:, 0]
