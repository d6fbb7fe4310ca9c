"""Domain-sharded NTT by the four-step (Bailey) decomposition.

Counterpart of :mod:`stark_tpu.parallel.ntt_sharded`.  For n = R * C,
view the coefficients as an R x C matrix x[j1, j2], j = j1*C + j2; with
k = k1 + R*k2:

    X[k1 + R*k2] = sum_{j2} [ omega^{j2*k1} * sum_{j1} x[j1,j2] w_R^{j1 k1} ]
                   * w_C^{j2 k2}

(1) size-R NTTs down the columns, (2) the twiddle omega^{k1*j2}, (3)
size-C NTTs along the rows.  Over a mesh of D shards
(:mod:`~stark_tpu_torch.parallel.mesh`):

* the input is column-sharded, shard s the ``(8, R, C/D)`` columns
  [s C/D, (s + 1) C/D) of the natural matrix: steps (1) and (2) are one
  launch of the column pass K2 (``cuda_ntt.ntt_pass1``) a shard, the
  twiddle its epilogue (the shard's columns of the W table) and the coset
  prologue of an extension its row/column multipliers;
* one chunk exchange (:func:`~stark_tpu_torch.parallel.mesh.exchange`, the
  JAX module's ``all_to_all``) gives shard s the rows k1 in [s R/D,
  (s + 1) R/D) of every column, ``(8, R/D, C)``;
* step (3) is one launch of the row pass K3 (``cuda_ntt.ntt_pass2``) a
  shard, which stores its rows transposed.

On a mesh that spans processes each process runs the passes of its own
shards, builds the W and coset tables of those shards only, and the
exchange is one all-to-all between the ranks.

**The four-step layout.**  A shard of the output is ``(8, C, R/D)``
indexed ``[k2, k1_local]``: the JAX module keeps ``(8, R/D, C)`` indexed
``[k1_local, k2]``; this is its transpose, exactly what K3 stores.  The
global array (the shards joined along the last axis) is ``(8, C, R)``,
whose row-major flattening is the natural order k = k1 + R*k2.  The FRI
pair (k, k + n/2) = (k1 + R k2, k1 + R (k2 + C/2)) lies in one shard, at
flat positions i and i + n/(2D) of it: the fold kernel's own pairing.

:meth:`ShardedNTT.inverse_from_fourstep` runs the same two passes in
reverse on that layout: K2 along k2 with the twiddle omega^{-k1*j2} as
its epilogue, the exchange back, K3 along k1 with 1/n and a coset's undo
as its epilogue; it returns the natural coefficient matrix column-sharded
``(8, R, C/D)``, ``[j1, j2_local]``.

On the card the passes run one block a transform, in clusters of 8
blocks, or of as many as a shard's batch has (C/D columns for K2, R/D
rows for K3) where that is fewer: a mesh of D shards takes every n from
D^2 up, as the JAX module does (e.g. 64 at D = 8).  A pass is at most
``MAX_PASS_LEN`` points long on the card.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ..field import FieldElement
from ..params import NUM_LIMBS, P
from ..ops.cuda_ntt import MAX_PASS_LEN, _pack_stage_twiddles, coset_tables, ntt_pass1, ntt_pass2, power_grid
from ..ops.limbs import from_numpy, mont_tensor
from .mesh import Mesh, ShardedArray, exchange, normalize, owned, shard_columns


def _split(n: int, d: int) -> Tuple[int, int]:
    """R, C with R*C = n, both divisible by d, R as square as possible."""
    logn = n.bit_length() - 1
    logd = d.bit_length() - 1
    if (1 << logd) != d:
        raise ValueError("shard count must be a power of two")
    logr = max(logn // 2, logd)
    if logn - logr < logd:
        raise ValueError(f"size 2^{logn} too small to shard over {d} shards")
    return 1 << logr, 1 << (logn - logr)


class ShardedNTT:
    """Four-step NTT of size n over a mesh of D shards (see the module
    docstring for the layouts)."""

    def __init__(self, n: int, mesh: Mesh) -> None:
        if n < 2 or n & (n - 1):
            raise ValueError("size must be a power of two")
        self.n = n
        self.mesh = normalize(mesh)
        self.d = len(self.mesh)
        self.R, self.C = _split(n, self.d)
        self.omega = FieldElement.primitive_nth_root(n).value
        if any(dev.type == "cuda" for _, dev in owned(self.mesh)) and max(self.R, self.C) > MAX_PASS_LEN:
            raise ValueError(f"a {n}-point transform has passes of {self.R} and {self.C} points; the CUDA passes "
                             f"take at most {MAX_PASS_LEN}")
        self._tables: Dict[tuple, object] = {}
        self._lock = threading.Lock()

    # -- tables (built on first use, kept per shard or per device) ---------

    def _cached(self, key, build):
        with self._lock:  # threads sharing the transform build each table once
            tab = self._tables.get(key)
            if tab is None:
                tab = self._tables[key] = build()
        return tab

    def _twiddles(self, length: int, inverse: bool, dev: torch.device) -> torch.Tensor:
        return self._cached(("tw", length, inverse, dev),
                            lambda: from_numpy(_pack_stage_twiddles(length, inverse), dev))

    def _w(self, inverse: bool, s: int) -> torch.Tensor:
        """K2's epilogue for shard s of a transform: (8, R, C/D),
        omega^(+-k1 * j2) over the shard's columns j2."""
        cl = self.C // self.d
        base = pow(self.omega, -1, P) if inverse else self.omega
        return self._cached(("w", inverse, s), lambda: power_grid(base, self.R, range(s * cl, (s + 1) * cl),
                                                                  self.mesh[s]))

    def _w4(self, s: int) -> torch.Tensor:
        """K2's epilogue for shard s of the inverse from the four-step
        layout: (8, C, R/D), omega^(-k1 * j2) at [j2, k1_local]."""
        rl = self.R // self.d
        return self._cached(("w4", s), lambda: power_grid(pow(self.omega, -1, P), self.C,
                                                          range(s * rl, (s + 1) * rl), self.mesh[s]))

    def _coset(self, s: int, offset: int, inverse: bool, swap: bool = False):
        """The one-device transform's coset tables
        (:func:`~stark_tpu_torch.ops.cuda_ntt.coset_tables`) for shard s,
        the column table cut to the shard's part.  Forward: K2's prologue,
        row[j1] (8, R) and col[j2] over the shard's columns (8, C/D).
        Inverse: K3's epilogue, 1/n over k2 (8, C) and 1 over the shard's
        rows (8, R/D).  With ``swap`` (the inverse from the four-step
        layout, whose passes run along k2, then k1) R and C trade places:
        row[j1] = n^-1 (offset^-C)^j1 (8, R) and col[j2] = offset^-j2 over
        the shard's columns (8, C/D), the coset's undo."""
        def build():
            rows, cols = (self.C, self.R) if swap else (self.R, self.C)
            row, col = coset_tables(offset, inverse, rows, cols)
            part = len(col) // self.d
            dev = self.mesh[s]
            return mont_tensor(row, dev), mont_tensor(col[s * part:(s + 1) * part], dev)

        return self._cached(("coset", offset, inverse, swap, s), build)

    # -- transforms ---------------------------------------------------------

    def _check(self, x: ShardedArray, shape) -> None:
        mine = owned(self.mesh)
        if len(x.shards) != len(mine):
            raise ValueError(f"{len(x.shards)} shards, this process drives {len(mine)} of a mesh of {self.d}")
        for t, (_, dev) in zip(x.shards, mine):
            if tuple(t.shape) != shape or t.device != dev:
                raise ValueError(f"expected {shape} shards on {[str(d) for _, d in mine]}, "
                                 f"got {tuple(t.shape)} on {t.device}")

    def _transform(self, x: ShardedArray, inverse: bool, offset: int) -> ShardedArray:
        cl = self.C // self.d
        self._check(x, (NUM_LIMBS, self.R, cl))
        ys = []
        for (s, dev), t in zip(owned(self.mesh), x.shards):
            row, col = self._coset(s, offset, False) if offset != 1 else (None, None)
            ys.append(ntt_pass1(t.contiguous(), self._twiddles(self.R, inverse, dev), self._w(inverse, s), row, col))
        y = exchange(ShardedArray(ys, self.mesh))  # (8, R/D, C): the shard's rows k1, every column
        out = []
        for (s, dev), t in zip(owned(self.mesh), y.shards):
            row, col = self._coset(s, 1, True) if inverse else (None, None)
            out.append(ntt_pass2(t, self._twiddles(self.C, inverse, dev), row, col))
        return ShardedArray(out, self.mesh)

    def forward(self, x: ShardedArray, offset: int = 1) -> ShardedArray:
        """Column-sharded (8, R, C/D) Montgomery coefficients (the natural
        matrix, j = j1*C + j2) -> (8, C, R/D) evaluations in the four-step
        layout; with ``offset`` != 1 over the coset {offset * omega^k}."""
        return self._transform(x, False, offset % P)

    def inverse(self, x: ShardedArray) -> ShardedArray:
        """The inverse DFT with :meth:`forward`'s layout contract: a natural
        column-sharded matrix in, the four-step layout out."""
        return self._transform(x, True, 1)

    def inverse_from_fourstep(self, x: ShardedArray, offset: int = 1) -> ShardedArray:
        """(8, C, R/D) four-step evaluations (forward's output) -> the
        column-sharded (8, R, C/D) natural coefficient matrix; with
        ``offset`` the coset's undo: the exact inverse of :meth:`forward`."""
        rl = self.R // self.d
        self._check(x, (NUM_LIMBS, self.C, rl))
        ys = [ntt_pass1(t.contiguous(), self._twiddles(self.C, True, dev), self._w4(s))
              for (s, dev), t in zip(owned(self.mesh), x.shards)]
        y = exchange(ShardedArray(ys, self.mesh))  # (8, C/D, R): the shard's columns j2, every k1
        out = []
        for (s, dev), t in zip(owned(self.mesh), y.shards):
            row, col = self._coset(s, offset % P, True, swap=True)
            out.append(ntt_pass2(t, self._twiddles(self.R, True, dev), row, col))
        return ShardedArray(out, self.mesh)

    # -- layout helpers (tests, the prover's uploads) ------------------------

    def to_matrix(self, vec):
        """(8, n) natural order -> (8, R, C) input matrix (j = j1*C + j2)."""
        return vec.reshape(NUM_LIMBS, self.R, self.C)

    def from_output_matrix(self, out: ShardedArray) -> torch.Tensor:
        """Four-step output -> (8, n) natural order on the mesh's home
        device (the global (8, C, R) array flattens to it; on a spanning
        mesh every rank gets it)."""
        return out.gather().reshape(NUM_LIMBS, self.n)

    def shard_input(self, mat) -> ShardedArray:
        """An (8, R, C) matrix (int32 tensor, or the JAX package's uint32
        numpy layout) -> its column shards on the mesh; on a spanning mesh
        each rank takes its own shards' columns from its copy of the whole
        matrix, which every rank holds alike (the JAX module's
        ``make_array_from_callback``)."""
        if isinstance(mat, np.ndarray):
            mat = torch.from_numpy(np.ascontiguousarray(mat.astype(np.uint32)).view(np.int32))
        return shard_columns(mat, self.mesh)

