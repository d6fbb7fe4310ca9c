"""Batched Rescue-Prime permutation on a torch device.

Counterpart of :mod:`stark_tpu.ops.rescue`: the scalar permutation
(:mod:`stark_tpu_torch.rescue_prime`, reference: rescue_prime.rs:172-293)
vectorised over a batch of inputs, the state a Montgomery tensor of shape
(8, m, B) (m = 2).  One round:

* forward S-box x^3: 2 products on the whole state;
* MDS mix: 4 products + 2 sums, round-constant sum;
* inverse S-box x^(1/3): :func:`field_ops.mont_pow_fixed` of
  ``RESCUE_ALPHA_INV``;
* MDS mix + round-constant sum again.

:func:`permutation_mont` and :func:`trace_mont` are the plain PyTorch
versions of the Rescue permutation kernel (``csrc/rescue.cu``, wrapper
:func:`stark_tpu_torch.ops.cuda_rescue.rescue_permutation`), round for
round as the JAX module's ``_round`` / ``permutation_mont`` /
``trace_mont``.  :func:`hash_batch` and :func:`trace_batch` are the host
wrappers: they go through the wrapper, so a CUDA device runs the kernel
and the CPU the plain version.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch

from ..params import P, R2_MOD_P, RESCUE_ALPHA_INV, RESCUE_M, RESCUE_MDS, RESCUE_N, RESCUE_ROUND_CONSTANTS
from . import field_ops as fo
from .limbs import from_numpy, mont_tensor, pack, to_numpy, unpack

#: the first columns of :func:`constants`: the MDS matrix row major; each
#: round's four constants follow (first half-round's two, second half-round's two)
MDS_COLUMNS = RESCUE_M * RESCUE_M


@lru_cache(maxsize=None)
def constants(device: torch.device) -> torch.Tensor:
    """(8, 112) Montgomery limbs on ``device``: the MDS matrix row major,
    then for round r the constants ``RESCUE_ROUND_CONSTANTS[4r .. 4r+3]``
    (c1_0, c1_1, c2_0, c2_1).  Built once a device; the kernel reads it by
    pointer and the plain version slices it."""
    values = [c % P for row in RESCUE_MDS for c in row]
    values += [c % P for c in RESCUE_ROUND_CONSTANTS[: 2 * RESCUE_M * RESCUE_N]]
    return mont_tensor(values, device)


def _mds_mix(state: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    s0, s1 = state[:, 0], state[:, 1]
    t0 = fo.add(fo.mont_mul(table[:, 0:1], s0), fo.mont_mul(table[:, 1:2], s1))
    t1 = fo.add(fo.mont_mul(table[:, 2:3], s0), fo.mont_mul(table[:, 3:4], s1))
    return torch.stack([t0, t1], dim=1)


def _round(state: torch.Tensor, r: int, table: torch.Tensor) -> torch.Tensor:
    """Round r of the permutation on an (8, 2, B) Montgomery state."""
    base = MDS_COLUMNS + 2 * RESCUE_M * r
    rc1 = table[:, base : base + RESCUE_M, None]
    rc2 = table[:, base + RESCUE_M : base + 2 * RESCUE_M, None]
    state = fo.mont_mul(fo.mont_sqr(state), state)
    state = fo.add(_mds_mix(state, table), rc1)
    state = fo.mont_pow_fixed(state, RESCUE_ALPHA_INV)
    return fo.add(_mds_mix(state, table), rc2)


def _check_state(state: torch.Tensor) -> int:
    if state.dtype != torch.int32:
        raise TypeError(f"state: expected int32, got {state.dtype}")
    if state.dim() != 3 or state.shape[0] != 8 or state.shape[1] != RESCUE_M or state.shape[2] == 0:
        raise ValueError(f"state: expected shape (8, {RESCUE_M}, B) with B > 0, got {tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("state: must be contiguous")
    return int(state.shape[2])


def permutation_mont(state: torch.Tensor) -> torch.Tensor:
    """Plain version: the full 27-round permutation of an (8, 2, B)
    Montgomery state."""
    _check_state(state)
    table = constants(state.device)
    for r in range(RESCUE_N):
        state = _round(state, r, table)
    return state


def trace_mont(state: torch.Tensor) -> torch.Tensor:
    """Plain version: all N+1 states, (N+1, 8, 2, B) Montgomery."""
    _check_state(state)
    table = constants(state.device)
    states = [state]
    for r in range(RESCUE_N):
        states.append(_round(states[-1], r, table))
    return torch.stack(states)


# ---------------------------------------------------------------------------
# host-facing wrappers
# ---------------------------------------------------------------------------


def _absorb(inputs: Sequence[int], device) -> torch.Tensor:
    """(8, 2, B) Montgomery state: register 0 the input, register 1 zero."""
    from .cuda_field import mont_mul

    b = len(inputs)
    if b == 0:
        raise ValueError("empty batch")
    flat = [v % P for v in inputs] + [0] * b
    r2 = from_numpy(pack([R2_MOD_P]), device)  # a * R^2 / R = a R, a's Montgomery form
    return mont_mul(from_numpy(pack(flat), device), r2).view(8, RESCUE_M, b)


def _plain_values(limbs: torch.Tensor) -> List[int]:
    """(8, n) Montgomery limbs -> n plain residues on the host."""
    from .cuda_field import mont_mul

    one = from_numpy(pack([1]), limbs.device)
    return unpack(to_numpy(mont_mul(limbs, one)))


def hash_batch(inputs: Sequence[int], device) -> List[int]:
    """Batched Rescue-Prime hash of many field elements on ``device``."""
    from .cuda_rescue import rescue_permutation

    state = rescue_permutation(_absorb(inputs, device))
    return _plain_values(state[:, 0].contiguous())


def trace_batch(inputs: Sequence[int], device) -> np.ndarray:
    """Batched traces on ``device``: object array (B, N+1, m) of ints."""
    from .cuda_rescue import rescue_permutation

    b = len(inputs)
    states = rescue_permutation(_absorb(inputs, device), trace=True)  # (N+1, 8, 2, B)
    vals = _plain_values(states.permute(1, 0, 2, 3).reshape(8, -1))
    # index = ((cycle * m) + reg) * b + batch
    return np.array(vals, dtype=object).reshape(RESCUE_N + 1, RESCUE_M, b).transpose(2, 0, 1)
