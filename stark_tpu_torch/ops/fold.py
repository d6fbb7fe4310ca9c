"""FRI fold in plain PyTorch.

Counterpart of :mod:`stark_tpu.ops.fold` (reference fold semantics
fri.rs:133-139):

    c'_i = 1/2 * [ (1 + alpha * inv_i) * c_i + (1 - alpha * inv_i) * c_{i+N/2} ]

with inv_i = (offset * omega^i)^{-1} from a precomputed table.  The JAX
package's production fold is this XLA-fused elementwise form too; its
Pallas fold kernel is not on the path and is still to be ported.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from stark_tpu.ops.limbs import pack, unpack
from stark_tpu.params import P

from . import field_ops as fo
from .limbs import _fold_tables, from_numpy, mont_tensor, to_numpy


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


def fri_fold(codeword: Sequence[int], alpha: int, offset: int, omega: int, device) -> List[int]:
    """Host-facing fold on ``device``: plain residues in and out."""
    half = len(codeword) // 2
    cw = fo.to_mont(from_numpy(pack(list(codeword)), device))
    a = mont_tensor([alpha % P], device)
    inv_table = from_numpy(_fold_tables(offset % P, omega % P, half), device)
    return unpack(to_numpy(fo.from_mont(fold_mont(cw, a, inv_table))))
