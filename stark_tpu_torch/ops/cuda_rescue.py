"""Batched Rescue-Prime permutation through the hand-written CUDA kernel (R1).

:func:`rescue_permutation` wraps ``stark_rescue_permutation`` of
``csrc/rescue.cu``, which computes what the JAX package's XLA-fused
``permutation_mont`` / ``trace_mont`` (stark_tpu/ops/rescue.py:92, :104)
compute; there is no Pallas form.  Its plain PyTorch versions are
:func:`stark_tpu_torch.ops.rescue.permutation_mont` and
:func:`~stark_tpu_torch.ops.rescue.trace_mont`, which run only for tensors
on the CPU.  For a CUDA tensor the wrapper launches its kernel or raises.
"""

from __future__ import annotations

import torch

from ..params import RESCUE_N
from . import kernels
from .rescue import _check_state, constants, permutation_mont, trace_mont


def rescue_permutation(state: torch.Tensor, trace: bool = False) -> torch.Tensor:
    """R1: the 27-round Rescue-Prime permutation of an (8, 2, B) Montgomery
    state, one instance a thread on the card.  Returns the final (8, 2, B)
    state, or with ``trace`` all N+1 states, (N+1, 8, 2, B).  The MDS
    matrix and round constants are :func:`~stark_tpu_torch.ops.rescue.constants`
    on the state's device."""
    b = _check_state(state)
    dev = state.device
    if dev.type == "cpu":
        return trace_mont(state) if trace else permutation_mont(state)
    if dev.type != "cuda":
        raise ValueError(f"rescue_permutation: unsupported device {dev}")
    shape = ((RESCUE_N + 1,) if trace else ()) + tuple(state.shape)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    kernels.launch("rescue_permutation", "stark_rescue_permutation", kernels.ptr(state), kernels.ptr(out),
                   kernels.ptr(constants(dev)), b, int(trace), device=dev, size=b)
    return out
