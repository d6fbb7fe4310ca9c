"""A full STARK prove over a mesh of shards.

Counterpart of :mod:`stark_tpu.parallel.stark_sharded`.
:class:`ShardedProverCore` has the device-prover core interface
(:mod:`stark_tpu_torch.ops.device_prover`) with every codeword a
:class:`~stark_tpu_torch.parallel.mesh.ShardedArray` in the four-step
layout, ``(8, C, R/D)`` shards indexed ``[k2, k1_local]``
(:mod:`~stark_tpu_torch.parallel.ntt_sharded`):

* RS-extension: each shard's coefficient columns uploaded and put into
  Montgomery form (K10), then the sharded four-step NTT (K2 with the coset
  prologue, one chunk exchange, K3);
* the x^shift columns and the fold tables: separable row-by-column
  tables (K9 twice, K10's row-by-column form);
* the combination: one launch of K11 a shard, with the next-row operand:
  the point ``expansion`` steps on crosses shards in this layout (E rows
  of k1 come from the next shard, and past k1 = R the index wraps to
  k2 + 1, the JAX module's ``roll``), so each trace column's next rows
  are built by slices and copies and passed beside it;
* the degree probe: the inverse from the four-step layout
  (:meth:`ShardedNTT.inverse_from_fourstep`, the second exchange), is-zero
  and the largest nonzero index reduced on the device;
* FRI folds: shard-local (K6 a shard); once a shard's k2 axis is used up
  the tail is gathered onto the first shard's device and folds there;
* commitments: a device Merkle subtree a natural-order block
  (:mod:`~stark_tpu_torch.parallel.merkle_sharded`) while a block is
  device-tree sized, the host tree over the codeword's digits below;
  openings are one ``mont_digits`` gather launch a shard.

The core has no fused FRI cascade, no ``extend_mont`` and no
``extend_codeword_be17``: ``Stark`` and ``Fri`` test for them, so a
sharded prove interpolates its trace on the host (its products on the
backend's device), commits the FRI rounds one by one with Fiat-Shamir on
the host, and packs the randomizer's bytes on the host.  Transcripts are
byte-identical to the host and one-device provers.

:class:`ShardedBackend` attaches the core to ``Stark`` (the models'
``backend=`` keyword).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..merkle import MerkleTree
from ..params import NUM_LIMBS, P
from ..ops import cuda_combination, device_merkle
from ..ops import cuda_field as cf
from ..ops import field_ops as fo
from ..ops.backend import TorchBackend
from ..ops.cuda_fold import fri_fold
from ..ops.cuda_merkle import mont_digits
from ..ops.device_merkle import TAIL_WIDTH, DeviceMerkleTree
from ..ops.device_prover import DeviceCodeword, mont_to_digits
from ..ops.limbs import from_numpy, mont_tensor, pack, to_numpy
from .fold_sharded import ShardedFold, power_table, separable_table
from .merkle_sharded import ShardedMerkleTree
from .mesh import Mesh, ShardedArray, exchange, normalize
from .ntt_sharded import ShardedNTT


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(NUM_LIMBS, -1)


class ShardedProverCore:
    """Device-prover core over a mesh; codewords in the four-step layout."""

    def __init__(self, n: int, offset: int, mesh: Mesh) -> None:
        self.n = n
        self.offset = offset % P
        self.mesh = normalize(mesh)
        self.device = self.mesh[0]  # where gathers, fetches and the tail meet
        self.sntt = ShardedNTT(n, self.mesh)
        self.R, self.C, self.d = self.sntt.R, self.sntt.C, self.sntt.d
        self.fold_sharded = ShardedFold(self.mesh, self.R)
        self._inv_tables: Dict[Tuple[int, int, int], torch.Tensor] = {}
        self._shift_tables: Dict[Tuple[int, int], ShardedArray] = {}
        self._comb_cache: Dict[tuple, object] = {}

    # -- RS extension ------------------------------------------------------

    def extend(self, coeffs) -> ShardedArray:
        """Coefficients (plain ints lowest first, or a packed (8, m) uint32
        limb array) -> the codeword over the coset in the four-step layout."""
        if not isinstance(coeffs, np.ndarray):
            coeffs = list(coeffs)
            coeffs = pack(coeffs) if coeffs else np.zeros((NUM_LIMBS, 0), np.uint32)  # the zero polynomial
        m = int(coeffs.shape[1])
        if m > self.n:
            raise ValueError("coefficient vector longer than the domain")
        mat = np.concatenate([coeffs, np.zeros((NUM_LIMBS, self.n - m), np.uint32)], axis=1).reshape(
            NUM_LIMBS, self.R, self.C)
        cl = self.C // self.d
        shards = []
        for s, dev in enumerate(self.mesh):  # each shard's columns uploaded, into Montgomery form (K10)
            block = from_numpy(np.ascontiguousarray(mat[:, :, s * cl:(s + 1) * cl]), dev)
            shards.append(cf.to_mont(_flat(block)).reshape(NUM_LIMBS, self.R, cl))
        return self.sntt.forward(ShardedArray(shards), self.offset)

    def extend_codeword(self, coeffs: Sequence[int]) -> DeviceCodeword:
        return DeviceCodeword(self.extend(coeffs), self)

    def _coefficients(self, cw: ShardedArray) -> ShardedArray:
        """The codeword's coefficients, column-sharded (8, R, C/D) natural
        matrix (j = j1*C + j2)."""
        return self.sntt.inverse_from_fourstep(cw, self.offset)

    def restrict_iszero(self, cw: ShardedArray) -> np.ndarray:
        """Degree probe: natural-order is-zero bitmap of the coefficients."""
        coeffs = self._coefficients(cw)
        z = torch.cat([fo.is_zero(t).cpu() for t in coeffs.shards], dim=1)  # (R, C)
        return z.reshape(self.n).numpy()

    def degree_probe(self, stack: Sequence[ShardedArray]) -> List[int]:
        """Degrees of codewords (the zero polynomial reports 0, the host
        quirk), reduced on the devices to one (k,)-int fetch."""
        cl = self.C // self.d
        outs = []
        for cw in stack:
            per = []
            for s, t in enumerate(self._coefficients(cw).shards):
                j = (torch.arange(self.R, device=t.device)[:, None] * self.C + s * cl
                     + torch.arange(cl, device=t.device)[None, :])
                per.append(torch.where(fo.is_zero(t), 0, j).max().to(self.device))
            outs.append(torch.stack(per).max())
        return [int(v) for v in torch.stack(outs).cpu()] if outs else []

    # -- layout / commitment ------------------------------------------------

    def _locate(self, k: int) -> Tuple[int, int]:
        """(shard, flat index in the shard) of natural index k of a sharded
        codeword (any round: the k1 axis, R, never changes)."""
        k1, k2 = k % self.R, k // self.R
        rl = self.R // self.d
        return k1 // rl, k2 * rl + k1 % rl

    def to_digits(self, mont) -> np.ndarray:
        """Natural-order (len, 4) digit matrix of either layout: one
        ``mont_digits`` launch a shard, joined on the host."""
        if isinstance(mont, torch.Tensor):  # the tail, on one device
            return mont_to_digits(mont)
        _, c, rl = mont.shards[0].shape
        parts = [to_numpy(mont_digits(_flat(t))).reshape(4, c, rl) for t in mont.shards]
        return np.ascontiguousarray(np.concatenate(parts, axis=2).reshape(4, -1).T)

    def gather_values(self, mont: ShardedArray, idx: List[int]):
        """(order, (4, K) digits on the first shard's device) of natural
        indices ``idx``: one gather launch a shard that holds any of them,
        ``order`` the indices in the order of the columns."""
        per: Dict[int, Tuple[List[int], List[int]]] = {}
        for k in idx:
            s, local = self._locate(k)
            per.setdefault(s, ([], []))
            per[s][0].append(k)
            per[s][1].append(local)
        order, arrs = [], []
        for s in sorted(per):
            ks, local = per[s]
            order += ks
            arrs.append(mont_digits(_flat(mont.shards[s]), local).to(self.device))
        return order, torch.cat(arrs, dim=1)

    def natural_digit_blocks(self, mont: ShardedArray) -> List[np.ndarray]:
        """Shard b's natural-order block of n/D leaves as (n/D, 4) digit
        rows, after the block exchange (the JAX module's API; the prover
        commits through :meth:`merkle_tree`)."""
        return [np.ascontiguousarray(to_numpy(mont_digits(_flat(b))).T) for b in exchange(mont).shards]

    def merkle_tree(self, dcw: DeviceCodeword):
        """Commitment: while a natural-order block of n/D leaves is
        device-tree sized, a device subtree a block after the block
        exchange and the top levels from the D subtree roots on the host
        (:class:`ShardedMerkleTree`); below, the host's native C over the
        codeword's digits, which then also serve the openings."""
        mont = dcw.mont
        if (isinstance(mont, ShardedArray) and mont.shape[1] % self.d == 0 and dcw._digits is None
                and len(dcw) // self.d >= max(device_merkle.DEVICE_TREE_MIN, 2 * TAIL_WIDTH)):
            return ShardedMerkleTree([DeviceMerkleTree(_flat(b)) for b in exchange(mont).shards], self.device)
        return MerkleTree.from_digits(dcw.digits)

    # -- FRI fold ------------------------------------------------------------

    def _tail_inv_table(self, offset: int, omega: int, half: int) -> torch.Tensor:
        key = (offset % P, omega % P, half)
        tab = self._inv_tables.get(key)
        if tab is None:
            tab = self._inv_tables[key] = power_table(pow(omega, -1, P), pow(offset, -1, P), half, self.device)
        return tab

    def fold(self, dcw: DeviceCodeword, alpha: int, offset: int, omega: int) -> DeviceCodeword:
        mont = dcw.mont
        if isinstance(mont, ShardedArray) and mont.shape[1] == 1:
            # k2 used up: natural index k = k1, gathered onto the first
            # shard's device for the tail
            mont = mont.gather(self.device).reshape(NUM_LIMBS, -1)
        if isinstance(mont, ShardedArray):
            return DeviceCodeword(self.fold_sharded(mont, alpha, offset, omega), self)
        inv = self._tail_inv_table(offset, omega, int(mont.shape[1]) // 2)
        return DeviceCodeword(fri_fold(mont.contiguous(), mont_tensor([alpha % P], self.device), inv), self)

    # -- x^shift columns -------------------------------------------------------

    def shift_table(self, shift: int, omega: int) -> ShardedArray:
        """x^shift over the coset in the four-step layout: row[k2] =
        omega^(shift*R*k2) times col[k1] = offset^shift * omega^(shift*k1),
        materialized a shard (the combination kernel reads codewords)."""
        key = (shift, omega % P)
        tab = self._shift_tables.get(key)
        if tab is None:
            rl = self.R // self.d
            step = pow(omega, shift, P)
            row_base = pow(omega, shift * self.R % (P - 1), P)
            shards = []
            for s, dev in enumerate(self.mesh):
                start = pow(self.offset, shift, P) * pow(step, s * rl, P) % P
                shards.append(separable_table(row_base, self.C, step, start, rl, dev).reshape(NUM_LIMBS, self.C, rl))
            tab = self._shift_tables[key] = ShardedArray(shards)
        return tab

    # -- batch inversion -------------------------------------------------------

    def inverse(self, mont: ShardedArray) -> ShardedArray:
        """Elementwise inversion, zero to zero: K7 a shard."""
        return ShardedArray([cf.mont_inv(_flat(t).contiguous()).reshape(t.shape) for t in mont.shards])

    # -- the combination -------------------------------------------------------

    def next_rows(self, cw: ShardedArray, expansion: int) -> List[torch.Tensor]:
        """Per shard, the (8, C * R/D) codeword of next[k] = cw[(k + E) mod
        n] at the shard's points, by slices and copies: the shard's k1
        range moved on by E, the part past R wrapped to k1 - R and k2 + 1."""
        _, c, rl = cw.shards[0].shape
        out = []
        for s, dev in enumerate(self.mesh):
            pieces = []
            g, end = s * rl + expansion, (s + 1) * rl + expansion
            while g < end:
                wraps, k1 = divmod(g, self.R)
                src, off = divmod(k1, rl)
                take = min(rl - off, end - g)
                piece = cw.shards[src][:, :, off:off + take]
                if wraps:
                    piece = torch.roll(piece, -wraps, dims=1)  # row k2 takes row k2 + wraps
                pieces.append(piece.to(dev))
                g += take
            out.append(_flat(torch.cat(pieces, dim=2)))
        return out

    def combination_fn(self, structure: tuple, num_bq: int, expansion: int):
        """The one-device core's combination, one K11 launch a shard with
        the next-row operand; returns (combination, the transition
        quotients as a list of sharded codewords)."""
        key = (structure, num_bq, expansion)
        fn = self._comb_cache.get(key)
        if fn is not None:
            return fn
        program = cuda_combination.encode(structure, num_bq, expansion)

        def comb_fn(trace_cws, group_cws, tz_invs, rand_cw, bq_cws, weights, tq_shift_tabs, bq_shift_tabs):
            nexts = [self.next_rows(cw, expansion) for cw in trace_cws]
            combs, tqs = [], [[] for _ in structure]
            for s, dev in enumerate(self.mesh):
                def local(arrs):
                    return [_flat(a.shards[s]) for a in arrs]

                comb, stack = cuda_combination.combination(
                    program, local(trace_cws), local(group_cws), local(tz_invs), _flat(rand_cw.shards[s]),
                    local(bq_cws), weights.to(dev), local(tq_shift_tabs), local(bq_shift_tabs),
                    next_cws=[nx[s] for nx in nexts])
                shape = rand_cw.shards[s].shape
                combs.append(comb.reshape(shape))
                for c in range(len(structure)):
                    tqs[c].append(stack[c].reshape(shape))
            return ShardedArray(combs), [ShardedArray(t) for t in tqs]

        self._comb_cache[key] = comb_fn
        return comb_fn


class ShardedBackend(TorchBackend):
    """Backend that runs the device-resident prover over a mesh: attach it
    to ``Stark`` (the models' ``backend=``) for a sharded prove.  Its
    host-list stages (the trace interpolation's products) run on the
    mesh's first device."""

    def __init__(self, mesh: Mesh, device_prover_min: int = 4096) -> None:
        super().__init__(mesh[0])
        self.mesh = normalize(mesh)
        self.device_prover_min = device_prover_min
        self._core_cache: Dict[Tuple[int, int], ShardedProverCore] = {}

    def make_prover_core(self, n: int, offset: int) -> ShardedProverCore:
        # cached per backend (one mesh): Stark instances sharing a FRI
        # domain share the core's tables
        key = (n, offset % P)
        core = self._core_cache.get(key)
        if core is None:
            core = self._core_cache[key] = ShardedProverCore(n, offset, self.mesh)
        return core
