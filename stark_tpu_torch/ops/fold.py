"""FRI fold in plain PyTorch.

Counterpart of :mod:`stark_tpu.ops.fold` (reference fold semantics
fri.rs:133-139):

    c'_i = 1/2 * [ (1 + alpha * inv_i) * c_i + (1 - alpha * inv_i) * c_{i+N/2} ]

with inv_i = (offset * omega^i)^{-1} from a precomputed table.  This is
the plain version of the card's fold kernel (K6,
:func:`stark_tpu_torch.ops.cuda_fold.fri_fold`), and what that wrapper
runs for CPU tensors.
"""

from __future__ import annotations

import torch

from ..params import P
from . import field_ops as fo
from .limbs import mont_tensor


def fold_mont(codeword: torch.Tensor, alpha: torch.Tensor, inv_table: torch.Tensor) -> torch.Tensor:
    """Fold a Montgomery (8, N) codeword to (8, N/2); ``alpha`` is (8, 1)."""
    half = codeword.shape[1] // 2
    u = codeword[:, :half]
    v = codeword[:, half:]
    one = mont_tensor([1], codeword.device)
    two_inv = mont_tensor([pow(2, -1, P)], codeword.device)
    ai = fo.mont_mul(alpha, inv_table)
    left = fo.mont_mul(fo.add(one, ai), u)
    right = fo.mont_mul(fo.sub(one, ai), v)
    return fo.mont_mul(two_inv, fo.add(left, right))
