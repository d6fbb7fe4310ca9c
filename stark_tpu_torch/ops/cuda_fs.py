"""One Fiat-Shamir round of the fused FRI cascade through a CUDA kernel.

:func:`fs_round` wraps ``stark_fs_round`` of ``csrc/fs.cu``, which in one
launch appends ``bincode(hex(root))`` to the device transcript body, runs
Shake256 over ``le64(count) || body`` and writes the sampled fold
challenge as an (8, 1) Montgomery column.  It stands in for the JAX
package's XLA-fused ``device_keccak.shake256_words`` and
``device_fs.hex_words`` / ``alpha_mont_from_fs`` (no Pallas kernel there).
Its plain PyTorch version is
:func:`stark_tpu_torch.ops.device_fs.fs_round_plain`, which runs only for
tensors on the CPU.  For a CUDA tensor the wrapper launches its kernel or
raises.
"""

from __future__ import annotations

import torch

from . import kernels
from .device_fs import APPENDED_BYTES, fs_round_plain


def fs_round(body: torch.Tensor, body_len: int, count: int, root: torch.Tensor) -> torch.Tensor:
    """Append ``le64(64) || hex(root)`` to ``body`` at ``body_len`` (in
    place) and return alpha = sample(Shake256(le64(count) || body[:body_len
    + 72])) as an (8, 1) int32 Montgomery column.  ``body`` is a 1-D uint8
    buffer of at least ``body_len + 72`` bytes; ``root`` the (8,) int32
    root words."""
    if body.dtype != torch.uint8 or body.dim() != 1 or not body.is_contiguous():
        raise ValueError(f"body: expected a contiguous 1-D uint8 buffer, got {body.dtype} {tuple(body.shape)}")
    if not 0 <= body_len <= int(body.shape[0]) - APPENDED_BYTES:
        raise ValueError(f"body_len {body_len} leaves no room for {APPENDED_BYTES} bytes in {int(body.shape[0])}")
    if not 0 <= count < 1 << 64:
        raise ValueError(f"count {count} is not a u64")
    if root.dtype != torch.int32 or tuple(root.shape) != (8,) or not root.is_contiguous():
        raise ValueError(f"root: expected contiguous (8,) int32 words, got {root.dtype} {tuple(root.shape)}")
    if root.device != body.device:
        raise ValueError(f"fs_round: body on {body.device}, root on {root.device}")
    if body.device.type == "cpu":
        return fs_round_plain(body, body_len, count, root)
    if body.device.type != "cuda":
        raise ValueError(f"fs_round: unsupported device {body.device}")
    alpha = torch.empty((8, 1), dtype=torch.int32, device=body.device)
    kernels.launch("fs_round", "stark_fs_round", kernels.ptr(body), body_len, count, kernels.ptr(root),
                   kernels.ptr(alpha), device=body.device, size=body_len)
    return alpha
