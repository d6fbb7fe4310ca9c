"""FRI fold through the hand-written CUDA kernel (K6).

:func:`fri_fold` wraps ``stark_fri_fold`` of ``csrc/fold.cu``, which
replaces the Pallas kernel ``fold_mont_pallas`` / ``_fold_kernel``
(stark_tpu/ops/pallas_fold.py).  Its plain PyTorch version is
:func:`stark_tpu_torch.ops.fold.fold_mont`, which runs only for tensors on
the CPU.  For a CUDA tensor the wrapper launches its kernel or raises.
"""

from __future__ import annotations

import torch

from . import kernels
from .fold import fold_mont


def _check(name: str, t: torch.Tensor, cols: int = None) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != 8 or (cols is not None and t.shape[1] != cols):
        want = f"(8, {cols})" if cols is not None else "(8, n)"
        raise ValueError(f"{name}: expected shape {want}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def fri_fold(codeword: torch.Tensor, alpha: torch.Tensor, inv_table: torch.Tensor) -> torch.Tensor:
    """K6: fold an (8, N) Montgomery codeword to (8, N/2),

        out[i] = 1/2 [(1 + alpha * inv_i) u_i + (1 - alpha * inv_i) v_i],

    u = codeword[:, :N/2], v = codeword[:, N/2:]; ``alpha`` is an (8, 1)
    Montgomery column and ``inv_table`` the (8, N/2) table of
    (offset * omega^i)^-1.  One thread per output element on the card."""
    _check("codeword", codeword)
    n = int(codeword.shape[1])
    if n < 2 or n % 2:
        raise ValueError(f"codeword length must be even and >= 2, got {n}")
    _check("alpha", alpha, 1)
    _check("inv_table", inv_table, n // 2)
    devices = {codeword.device, alpha.device, inv_table.device}
    if len(devices) != 1:
        raise ValueError(f"fri_fold: operands on different devices {sorted(map(str, devices))}")
    if codeword.device.type == "cpu":
        return fold_mont(codeword, alpha, inv_table)
    if codeword.device.type != "cuda":
        raise ValueError(f"fri_fold: unsupported device {codeword.device}")
    out = torch.empty((8, n // 2), dtype=torch.int32, device=codeword.device)
    kernels.launch("fri_fold", "stark_fri_fold", kernels.ptr(codeword), kernels.ptr(inv_table),
                   kernels.ptr(alpha), kernels.ptr(out), n // 2, device=codeword.device, size=n)
    return out
