"""Device limb format and the host <-> device conversions.

A batch of field elements is an ``(8, *batch)`` ``torch.int32`` tensor of
16-bit limbs, limb-major and little-endian: ``[l, i]`` holds bits
``[16*l, 16*l + 16)`` of element ``i``.  This is bit for bit the JAX
package's ``(8, n) uint32`` layout (:mod:`stark_tpu.ops.limbs`), so a
limb compares one to one across the two packages.  Merkle digest levels
are ``(8, w)`` ``int32`` tensors holding the u32 word bits.

``torch.uint32`` is avoided on purpose: PyTorch implements only a few
operations for it.  Plain field arithmetic widens to ``int64``
(:mod:`stark_tpu_torch.ops.field_ops`).

The numpy table helpers below are copies of the ones in
``stark_tpu/ops/ntt.py`` and ``stark_tpu/ops/fold.py``: those modules
import JAX at the top, which this package never does.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch

from stark_tpu.ops.limbs import pack
from stark_tpu.params import P, R_MOD_P


def from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """``(r, n) uint32`` array (JAX-package layout) -> ``int32`` tensor on
    ``device`` with the same bits."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.tensor(a.view(np.int32), device=device)  # a copy: never aliases the caller's array


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """``int32`` tensor -> ``uint32`` numpy array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def _bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int32)
    rev = np.zeros(n, dtype=np.int32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _mont_pack(values: Sequence[int]) -> np.ndarray:
    """Pack Python residues directly into Montgomery form on host."""
    return pack([v * R_MOD_P % P for v in values])


def _power_table(base: int, n: int) -> List[int]:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % P
    return out


@lru_cache(maxsize=64)
def _fold_tables(offset: int, omega: int, half: int) -> np.ndarray:
    """Montgomery tables: inv_i = (offset * omega^i)^{-1}, i < half."""
    inv_offset = pow(offset, -1, P)
    inv_omega = pow(omega, -1, P)
    invs = _power_table(inv_omega, half)
    invs = [v * inv_offset % P for v in invs]
    return _mont_pack(invs)


def mont_tensor(values: Sequence[int], device) -> torch.Tensor:
    """Python residues -> ``(8, k)`` Montgomery limb tensor on ``device``."""
    return from_numpy(_mont_pack(values), device)
