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

On a mesh that spans ranks (:class:`~stark_tpu_torch.parallel.mesh.SpanningMesh`)
each rank runs the same prover program and the core's per-shard steps on
its own shards only; every crossing is a collective that every rank
calls in the same order: the exchanges and the next-row halo (one
all-to-all each), and the all-gathers of the degree probe's maxima, the
digits, the opened values, the FRI tail and the trees' roots, siblings
and tails.  Every rank gets the same bytes, so every rank's transcript
is the same.

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

import threading
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
from .merkle_sharded import RemoteBlock, ShardedMerkleTree
from .mesh import Mesh, ShardedArray, allgather_shards, exchange, home, move_pieces, normalize, owned
from .ntt_sharded import ShardedNTT


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(NUM_LIMBS, -1)


class ShardedProverCore:
    """Device-prover core over a mesh; codewords in the four-step layout."""

    def __init__(self, n: int, offset: int, mesh: Mesh) -> None:
        self.n = n
        self.offset = offset % P
        self.mesh = normalize(mesh)
        self.device = home(self.mesh)  # where gathers, fetches and the tail meet
        self.sntt = ShardedNTT(n, self.mesh)
        self.R, self.C, self.d = self.sntt.R, self.sntt.C, self.sntt.d
        self.fold_sharded = ShardedFold(self.mesh, self.R)
        self._inv_tables: Dict[Tuple[int, int, int], torch.Tensor] = {}
        self._shift_tables: Dict[Tuple[int, int], ShardedArray] = {}
        self._comb_cache: Dict[tuple, object] = {}
        self._lock = threading.RLock()  # as DeviceProverCore's: each table built once

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
        for s, dev in owned(self.mesh):  # each own shard's columns uploaded, into Montgomery form (K10)
            block = from_numpy(np.ascontiguousarray(mat[:, :, s * cl:(s + 1) * cl]), dev)
            shards.append(cf.to_mont(_flat(block)).reshape(NUM_LIMBS, self.R, cl))
        return self.sntt.forward(ShardedArray(shards, self.mesh), self.offset)

    def extend_codeword(self, coeffs: Sequence[int]) -> DeviceCodeword:
        return DeviceCodeword(self.extend(coeffs), self)

    def _coefficients(self, cw: ShardedArray) -> ShardedArray:
        """The codeword's coefficients, column-sharded (8, R, C/D) natural
        matrix (j = j1*C + j2)."""
        return self.sntt.inverse_from_fourstep(cw, self.offset)

    def restrict_iszero(self, cw: ShardedArray) -> np.ndarray:
        """Degree probe: natural-order is-zero bitmap of the coefficients
        (every rank's shards gathered)."""
        coeffs = self._coefficients(cw)
        z = torch.cat([fo.is_zero(t).to(self.device, torch.uint8) for t in coeffs.shards], dim=1)  # (R, own columns)
        z = allgather_shards(self.mesh, z, [self.C // self.d] * self.d)  # (R, C)
        return z.cpu().numpy().astype(bool).reshape(self.n)

    def degree_probe(self, stack: Sequence[ShardedArray]) -> List[int]:
        """Degrees of codewords (the zero polynomial reports 0, the host
        quirk): each process's shards reduced on their devices, then the
        maxima of every rank's, one (k,)-int fetch."""
        cl = self.C // self.d
        outs = []
        for cw in stack:
            per = []
            for s, t in self._coefficients(cw).owned():
                j = (torch.arange(self.R, device=t.device)[:, None] * self.C + s * cl
                     + torch.arange(cl, device=t.device)[None, :])
                per.append(torch.where(fo.is_zero(t), 0, j).max().to(self.device))
            outs.append(torch.stack(per).max())
        if not outs:
            return []
        mine = torch.stack(outs).reshape(-1, 1)  # (k, 1): this process's maxima
        per_process = len(owned(self.mesh))
        cols = [int(s % per_process == 0) for s in range(self.d)]  # one column a process, on its first shard
        return [int(v) for v in allgather_shards(self.mesh, mine, cols).max(dim=1).values.cpu()]

    # -- layout / commitment ------------------------------------------------

    def _locate(self, k: int) -> Tuple[int, int]:
        """(shard, flat index in the shard) of natural index k of a sharded
        codeword (any round: the k1 axis, R, never changes)."""
        k1, k2 = k % self.R, k // self.R
        rl = self.R // self.d
        return k1 // rl, k2 * rl + k1 % rl

    def to_digits(self, mont) -> np.ndarray:
        """Natural-order (len, 4) digit matrix of either layout: one
        ``mont_digits`` launch a shard, every rank's shards gathered."""
        if isinstance(mont, torch.Tensor):  # the tail, on one device
            return mont_to_digits(mont)
        _, c, rl = mont.shards[0].shape
        local = torch.cat([mont_digits(_flat(t)).to(self.device).reshape(4 * c, rl) for t in mont.shards], dim=1)
        full = allgather_shards(self.mesh, local, [int(rl)] * self.d)  # (4 c, R): [k2, k1] a digit
        return np.ascontiguousarray(to_numpy(full).reshape(4, -1).T)

    def gather_values(self, mont: ShardedArray, idx: List[int]):
        """(order, (4, K) digits on the home device) of natural indices
        ``idx``: one gather launch a shard this process holds that holds
        any of them, every rank's gathered; ``order`` the indices in the
        order of the columns."""
        per: Dict[int, Tuple[List[int], List[int]]] = {}
        for k in idx:
            s, local = self._locate(k)
            per.setdefault(s, ([], []))
            per[s][0].append(k)
            per[s][1].append(local)
        order, arrs = [], []
        mine = dict(mont.owned())
        for s in sorted(per):
            ks, local = per[s]
            order += ks
            if s in mine:
                arrs.append(mont_digits(_flat(mine[s]), local).to(self.device))
        local = torch.cat(arrs, dim=1) if arrs else torch.zeros((4, 0), dtype=torch.int32, device=self.device)
        return order, allgather_shards(self.mesh, local, [len(per[s][0]) if s in per else 0 for s in range(self.d)])

    def natural_digit_blocks(self, mont: ShardedArray) -> List[np.ndarray]:
        """Shard b's natural-order block of n/D leaves as (n/D, 4) digit
        rows, after the block exchange, every block on every rank (the JAX
        module's API, sized for small codewords; the prover commits
        through :meth:`merkle_tree`, which gathers no block)."""
        blocks = exchange(mont)
        w = mont.shape[1] * mont.shape[2] // self.d
        local = torch.cat([mont_digits(_flat(b)).to(self.device) for b in blocks.shards], dim=1)
        full = to_numpy(allgather_shards(self.mesh, local, [w] * self.d))
        return [np.ascontiguousarray(full[:, b * w:(b + 1) * w].T) for b in range(self.d)]

    def merkle_tree(self, dcw: DeviceCodeword):
        """Commitment: while a natural-order block of n/D leaves is
        device-tree sized, a device subtree a block after the block
        exchange and the top levels from the D subtree roots on the host
        (:class:`ShardedMerkleTree`); below, the host's native C over the
        codeword's digits, which then also serve the openings."""
        mont = dcw.mont
        block = len(dcw) // self.d
        if (isinstance(mont, ShardedArray) and mont.shape[1] % self.d == 0 and dcw._digits is None
                and block >= max(device_merkle.DEVICE_TREE_MIN, 2 * TAIL_WIDTH)):
            trees = {s: DeviceMerkleTree(_flat(b)) for s, b in exchange(mont).owned()}
            blocks = [trees[s] if s in trees else RemoteBlock(block) for s in range(self.d)]
            return ShardedMerkleTree(blocks, self.device, self.mesh)
        return MerkleTree.from_digits(dcw.digits)

    # -- FRI fold ------------------------------------------------------------

    def _tail_inv_table(self, offset: int, omega: int, half: int) -> torch.Tensor:
        key = (offset % P, omega % P, half)
        with self._lock:
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
        with self._lock:
            tab = self._shift_tables.get(key)
            if tab is None:
                rl = self.R // self.d
                step = pow(omega, shift, P)
                row_base = pow(omega, shift * self.R % (P - 1), P)
                shards = []
                for s, dev in owned(self.mesh):
                    start = pow(self.offset, shift, P) * pow(step, s * rl, P) % P
                    shards.append(separable_table(row_base, self.C, step, start, rl, dev)
                                  .reshape(NUM_LIMBS, self.C, rl))
                tab = self._shift_tables[key] = ShardedArray(shards, self.mesh)
        return tab

    # -- batch inversion -------------------------------------------------------

    def inverse(self, mont: ShardedArray) -> ShardedArray:
        """Elementwise inversion, zero to zero: K7 a shard."""
        return ShardedArray([cf.mont_inv(_flat(t).contiguous()).reshape(t.shape) for t in mont.shards], self.mesh)

    # -- the combination -------------------------------------------------------

    def next_rows(self, cw: ShardedArray, expansion: int) -> List[torch.Tensor]:
        """Per own shard, the (8, C * R/D) codeword of next[k] = cw[(k + E)
        mod n] at the shard's points, by slices and copies: the shard's k1
        range moved on by E, the part past R wrapped to k1 - R and k2 + 1.
        The pieces from another rank's shards (the halo) come in one
        all-to-all."""
        _, c, rl = cw.shards[0].shape

        def piece(src: int, off: int, take: int, wraps: int):
            def make():
                t = cw.shard(src)[:, :, off:off + take]
                return torch.roll(t, -wraps, dims=1) if wraps else t  # row k2 takes row k2 + wraps
            return make

        plan = []  # (source shard, destination shard, shape, make), every destination's
        for s in range(self.d):
            g, end = s * rl + expansion, (s + 1) * rl + expansion
            while g < end:
                wraps, k1 = divmod(g, self.R)
                src, off = divmod(k1, rl)
                take = min(rl - off, end - g)
                plan.append((src, s, (NUM_LIMBS, int(c), take), piece(src, off, take, wraps)))
                g += take
        got = move_pieces(self.mesh, plan)
        return [_flat(torch.cat([t for t, p in zip(got, plan) if p[1] == s], dim=2)) for s, _ in owned(self.mesh)]

    def combination_fn(self, structure: tuple, num_bq: int, expansion: int):
        """The one-device core's combination, one K11 launch a shard with
        the next-row operand; returns (combination, the transition
        quotients as a list of sharded codewords)."""
        key = (structure, num_bq, expansion)
        with self._lock:
            fn = self._comb_cache.get(key)
            if fn is None:
                fn = self._comb_cache[key] = self._combination(cuda_combination.encode(structure, num_bq, expansion),
                                                               structure, expansion)
        return fn

    def _combination(self, program, structure: tuple, expansion: int):
        """The combination function of one encoded program."""

        def comb_fn(trace_cws, group_cws, tz_invs, rand_cw, bq_cws, weights, tq_shift_tabs, bq_shift_tabs):
            nexts = [self.next_rows(cw, expansion) for cw in trace_cws]
            combs, tqs = [], [[] for _ in structure]
            for i, (s, dev) in enumerate(owned(self.mesh)):  # i: the shard's place among this process's
                def local(arrs):
                    return [_flat(a.shards[i]) for a in arrs]

                comb, stack = cuda_combination.combination(
                    program, local(trace_cws), local(group_cws), local(tz_invs), _flat(rand_cw.shards[i]),
                    local(bq_cws), weights.to(dev), local(tq_shift_tabs), local(bq_shift_tabs),
                    next_cws=[nx[i] for nx in nexts])
                shape = rand_cw.shards[i].shape
                combs.append(comb.reshape(shape))
                for c in range(len(structure)):
                    tqs[c].append(stack[c].reshape(shape))
            return ShardedArray(combs, self.mesh), [ShardedArray(t, self.mesh) for t in tqs]

        return comb_fn


class ShardedBackend(TorchBackend):
    """Backend that runs the device-resident prover over a mesh: attach it
    to ``Stark`` (the models' ``backend=``) for a sharded prove.  Its
    host-list stages (the trace interpolation's products) run on the
    mesh's home device (each rank's own on a spanning mesh)."""

    def __init__(self, mesh: Mesh, device_prover_min: int = 4096) -> None:
        self.mesh = normalize(mesh)
        super().__init__(home(self.mesh))
        self.device_prover_min = device_prover_min
        self._core_cache: Dict[Tuple[int, int], ShardedProverCore] = {}
        self._lock = threading.Lock()

    def make_prover_core(self, n: int, offset: int) -> ShardedProverCore:
        # cached per backend (one mesh): Stark instances sharing a FRI
        # domain share the core's tables
        key = (n, offset % P)
        with self._lock:
            core = self._core_cache.get(key)
            if core is None:
                core = self._core_cache[key] = ShardedProverCore(n, offset, self.mesh)
        return core
