"""FRI folds of a sharded codeword in the four-step layout.

Counterpart of :mod:`stark_tpu.parallel.fold_sharded`.  A codeword of
n = R*C points from :class:`~stark_tpu_torch.parallel.ntt_sharded.ShardedNTT`
lives as shards ``(8, C, R/D)`` indexed ``[k2, k1_local]``, natural index
k = k1 + R*k2.  The fold pairs k with k + n/2 = k1 + R*(k2 + C/2): the
same shard, at flat positions i and i + n/(2D), which is the fold kernel's
own pairing, so a fold is one launch of K6 (``cuda_fold.fri_fold``) a
shard and no shard talks to another.  The folded shard ``(8, C/2, R/D)``
is again in the four-step layout of the halved domain.

The kernel's table of (offset * omega^k)^-1 over the shard's first half
separates:

    (offset * omega^{k1 + R*k2})^{-1} = [(omega^{-R})^{k2}] * [offset^{-1} omega^{-k1}]

a row table over k2 < C/2 times a column table over the shard's k1, each
a K9 power table, joined by K10's row-by-column form
(``cuda_field.mont_outer``).
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

from ..params import NUM_LIMBS, P
from ..ops import cuda_field as cf
from ..ops.cuda_fold import fri_fold
from ..ops.device_prover import geometric_table
from ..ops.limbs import mont_tensor
from .mesh import Mesh, ShardedArray, normalize, owned


def power_table(base: int, start: int, n: int, device) -> torch.Tensor:
    """(8, n) Montgomery start * base^i: K9 on the card (one element is the
    start itself, uploaded)."""
    if n == 1:
        return mont_tensor([start % P], device)
    return geometric_table(base, start, n, device)


def separable_table(row_base: int, rows: int, col_base: int, col_start: int, cols: int, device) -> torch.Tensor:
    """(8, rows * cols) table row_base^r * col_start * col_base^c at
    r * cols + c: two power tables and one row-by-column product."""
    return cf.mont_outer(power_table(row_base, 1, rows, device), power_table(col_base, col_start, cols, device))


class ShardedFold:
    """Shard-local FRI folds over a mesh (see the module docstring); the
    tables are built for this process's shards only."""

    def __init__(self, mesh: Mesh, r: int) -> None:
        self.mesh = normalize(mesh)
        self.r = r
        self.d = len(self.mesh)
        if r % self.d:
            raise ValueError(f"{r} rows do not split over {self.d} shards")
        self._tables: Dict[tuple, torch.Tensor] = {}
        self._lock = threading.Lock()

    def inv_table(self, s: int, offset: int, omega: int, c_half: int) -> torch.Tensor:
        """Shard s's (8, c_half * R/D) table of (offset * omega^k)^-1."""
        key = (s, offset % P, omega % P, c_half)
        with self._lock:  # threads sharing the fold build each table once
            tab = self._tables.get(key)
            if tab is None:
                rl = self.r // self.d
                inv_omega = pow(omega, -1, P)
                start = pow(offset, -1, P) * pow(inv_omega, s * rl, P) % P
                tab = self._tables[key] = separable_table(pow(inv_omega, self.r, P), c_half, inv_omega, start, rl,
                                                          self.mesh[s])
        return tab

    def __call__(self, codeword: ShardedArray, alpha: int, offset: int, omega: int) -> ShardedArray:
        """(8, C, R/D) shards -> (8, C/2, R/D); ``alpha``, ``offset`` and
        ``omega`` are the round's plain ints (offset and omega square
        between rounds, reference: fri.rs:141-142)."""
        _, c, rl = codeword.shards[0].shape
        if c < 2 or c % 2:
            raise ValueError(f"a shard of {c} rows does not fold")
        mine = owned(self.mesh)
        alphas = {dev: mont_tensor([alpha % P], dev) for dev in {dev for _, dev in mine}}  # one upload a device
        out = []
        for (s, dev), t in zip(mine, codeword.shards):
            inv = self.inv_table(s, offset, omega, c // 2)
            folded = fri_fold(t.reshape(NUM_LIMBS, -1).contiguous(), alphas[dev], inv)
            out.append(folded.reshape(NUM_LIMBS, c // 2, rl))
        return ShardedArray(out, self.mesh)
