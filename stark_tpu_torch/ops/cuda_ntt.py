"""Four-step NTT through the hand-written CUDA passes (K2, K3).

Counterpart of :class:`stark_tpu.ops.pallas_ntt.PallasNTT`.  A size-n
transform, n = R * C with R = 2^floor(log2(n) / 2), runs as two passes:

    x[j1, j2] --column NTTs over j1--> A[k1, j2] --* W[k1, j2] = w^(k1*j2)-->
    transposed row NTTs over j2 --> X[k1 + R*k2]

:func:`ntt_pass1` and :func:`ntt_pass2` are the wrappers of the two CUDA
kernels (``csrc/ntt.cu``); beside each sits its plain PyTorch version,
which runs only for tensors on the CPU.  For a CUDA tensor a wrapper
launches its kernel or raises.  The TPU plan gathers the bit-reversed rows
and transposes between the passes in XLA; the kernels fold both into their
loads and stores, and the plain versions do the same indexing in torch, so
the two agree at the wrapper boundary.

The table builders are the TPU plan's: packed stage twiddles, the
inter-pass table W, and the coset row/column multipliers (prologue of
forward transforms, epilogue of inverse ones, which also carries 1/n).
The pre-tiled small-stage twiddles were a Mosaic layout device and are
not ported.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..field import FieldElement
from ..params import NUM_LIMBS, P
from . import cuda_field
from . import field_ops as fo
from . import kernels
from .limbs import _bit_reverse_indices, _mont_pack, _power_table, from_numpy

#: smallest transform the prover hands to the four-step plan on every
#: device (R = 64, C = 128); the host NTT takes the smaller host-list
#: transforms, as in the JAX package
CUDA_NTT_MIN_SIZE = 1 << 13
#: smallest transform the one-device plan takes (R = C = 8: one 8-wide
#: cluster of columns, a cluster's share of rows); on the card the device
#: trace interpolation's transforms run on it from here
FOUR_STEP_MIN_SIZE = 1 << 6
#: longest size-L pass the kernels hold in shared memory
MAX_PASS_LEN = 1 << 12
#: most transforms a pass takes (csrc/ntt.cu check_shape)
_MAX_BATCH = 1 << 20

#: bytes of one field element in the kernels' shared memory
_FE_BYTES = 16
#: shared memory of one H100 SM, and what the card reserves for each block
_SM_SHARED_BYTES = 228 * 1024
_BLOCK_RESERVED_BYTES = 1024
#: the kernel's block bound (``__launch_bounds__`` in csrc/ntt.cu)
_MAX_THREADS = 256
#: blocks of a cluster (``__cluster_dims__`` in csrc/ntt.cu): 8 one-column
#: blocks load and store 32-byte runs, the card's memory sector; a batch
#: of fewer columns (a shard of a sharded transform) runs in clusters of
#: as many as it has
CLUSTER_BLOCKS = 8


class LaunchShape(NamedTuple):
    """One pass's launch: a block's threads and dynamic shared memory, the
    blocks of a cluster and the rows each of them loads and stores."""

    threads: int
    smem_bytes: int
    cluster: int
    rows: int


def launch_shape(log_l: int, log_b: int) -> LaunchShape:
    """The :class:`LaunchShape` of one pass of ``2^log_b`` transforms of
    length ``L = 2^log_l``.

    A block takes one transform (one batch column, fixed in the kernel):
    a pass launches ``2^log_b`` blocks, at least 256 from 2^17 up, in
    clusters of min(:data:`CLUSTER_BLOCKS`, batch, L) blocks, each of
    which loads and stores L / cluster rows of the cluster's columns: 8
    for every one-device transform, fewer only for a shard narrower than
    that.  A block has one thread per
    radix-2 butterfly of a stage (L / 2) up to the kernel's bound of 256,
    in whole warps.  The stage twiddles sit in shared memory beside the
    data where two blocks still fit on an SM (L <= 2048); otherwise the
    kernel reads them through the read-only cache and smem_bytes holds
    the data alone.  A sweep of tiles of 1-16 columns, clusters of 1-8
    blocks, 64-256 threads and both twiddle placements chose this shape
    at 2^17-2^20 on the card (PERF.md)."""
    L = 1 << log_l
    threads = min(_MAX_THREADS, max(32, L // 2))
    smem = L * _FE_BYTES
    if 2 * (2 * smem + _BLOCK_RESERVED_BYTES) <= _SM_SHARED_BYTES:
        smem *= 2
    cluster = min(CLUSTER_BLOCKS, 1 << log_b, L)
    return LaunchShape(threads, smem, cluster, L // cluster)


def _pack_stage_twiddles(n_t: int, inverse: bool) -> np.ndarray:
    """(8, n_t) buffer with stage-s twiddles at [half : 2*half]."""
    omega = FieldElement.primitive_nth_root(n_t).value
    if inverse:
        omega = pow(omega, -1, P)
    out = np.zeros((NUM_LIMBS, n_t), dtype=np.uint32)
    length = 2
    while length <= n_t:
        half = length // 2
        w = pow(omega, n_t // length, P)
        out[:, half : 2 * half] = _mont_pack(_power_table(w, half))
        length *= 2
    return out


# -- plain versions -----------------------------------------------------------


@lru_cache(maxsize=32)
def _bitrev(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_bit_reverse_indices(n).astype(np.int64)).to(device)


def _stages(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Size-L NTTs down axis 1 of an (8, L, B) tensor whose rows are in
    bit-reversed order."""
    _, L, B = x.shape
    length = 2
    while length <= L:
        half = length // 2
        xv = x.reshape(NUM_LIMBS, L // length, length, B)
        u = xv[:, :, :half]
        v = fo.mont_mul(xv[:, :, half:], tw[:, half : 2 * half].reshape(NUM_LIMBS, 1, half, 1))
        x = torch.cat([fo.add(u, v), fo.sub(u, v)], dim=2).reshape(NUM_LIMBS, L, B)
        length *= 2
    return x


def _row_col(x: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    return fo.mont_mul(fo.mont_mul(x, row[:, :, None]), col[:, None, :])


def ntt_pass1_plain(x, tw, w, row=None, col=None) -> torch.Tensor:
    """Plain version of :func:`ntt_pass1`."""
    R = x.shape[1]
    x = x[:, _bitrev(R, str(x.device)), :]
    if row is not None:
        x = _row_col(x, row, col)
    return fo.mont_mul(_stages(x, tw), w)


def ntt_pass2_plain(y, tw, row=None, col=None) -> torch.Tensor:
    """Plain version of :func:`ntt_pass2`."""
    C = y.shape[2]
    z = y.transpose(1, 2)[:, _bitrev(C, str(y.device)), :]
    z = _stages(z, tw)
    if row is not None:
        z = _row_col(z, row, col)
    return z.contiguous()


# -- wrappers -----------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape, device: torch.device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_pass(x, L, batch, tables, row_len, col_len, row, col):
    """Checks of one pass of ``batch`` transforms of length ``L``."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if (row is None) != (col is None):
        raise ValueError("row and col multipliers come together")
    for name, t, shape in tables:
        _check(name, t, shape, dev)
    if row is not None:
        _check("row", row, (NUM_LIMBS, row_len), dev)
        _check("col", col, (NUM_LIMBS, col_len), dev)
    if dev.type == "cuda":
        if L & (L - 1) or batch & (batch - 1) or not 2 <= L <= MAX_PASS_LEN or not 1 <= batch <= _MAX_BATCH:
            raise ValueError(f"the CUDA NTT passes take power-of-two transforms of 2 to {MAX_PASS_LEN} points, "
                             f"1 to {_MAX_BATCH} of them; got {batch} of {L}")


def ntt_pass1(x, tw, w, row=None, col=None) -> torch.Tensor:
    """K2: column NTTs of the (8, R, C) natural-order input, with the coset
    prologue ``x[j1, j2] *= row[bitrev(j1)] * col[j2]`` when ``row``/``col``
    are given and the epilogue ``*= W``.  Returns A*W as (8, R, C).

    Replaces ``PallasNTT._pass1`` (stark_tpu/ops/pallas_ntt.py).  One
    block per transform holds it in shared memory, so a pass touches
    device memory once; clusters of up to 8 blocks share the loads and
    stores along the column axis (see csrc/ntt.cu)."""
    _, R, C = x.shape
    _check("x", x, (NUM_LIMBS, R, C), x.device)
    _check_pass(x, R, C, [("tw", tw, (NUM_LIMBS, R)), ("w", w, (NUM_LIMBS, R, C))], R, C, row, col)
    if x.device.type == "cpu":
        return ntt_pass1_plain(x, tw, w, row, col)
    out = torch.empty_like(x)
    log_r, log_c = R.bit_length() - 1, C.bit_length() - 1
    shape = launch_shape(log_r, log_c)
    kernels.launch(
        "ntt_pass1", "stark_ntt_pass1",
        kernels.ptr(x), kernels.ptr(out), log_r, log_c,
        kernels.ptr(tw), kernels.ptr(w), kernels.ptr(row), kernels.ptr(col),
        shape.threads, shape.smem_bytes, shape.cluster.bit_length() - 1,
        device=x.device, size=R * C,
    )
    return out


def ntt_pass2(y, tw, row=None, col=None) -> torch.Tensor:
    """K3: row NTTs over pass 1's (8, R, C) output read transposed, with the
    epilogue ``*= row[k2] * col[k1]`` when given.  Returns (8, C, R), whose
    flattening is the natural order k = k1 + R*k2.

    Replaces ``PallasNTT._pass2`` (stark_tpu/ops/pallas_ntt.py); same
    bounds and design as :func:`ntt_pass1`."""
    _, R, C = y.shape
    _check("y", y, (NUM_LIMBS, R, C), y.device)
    _check_pass(y, C, R, [("tw", tw, (NUM_LIMBS, C))], C, R, row, col)
    if y.device.type == "cpu":
        return ntt_pass2_plain(y, tw, row, col)
    out = torch.empty((NUM_LIMBS, C, R), dtype=torch.int32, device=y.device)
    log_r, log_c = R.bit_length() - 1, C.bit_length() - 1
    shape = launch_shape(log_c, log_r)
    kernels.launch(
        "ntt_pass2", "stark_ntt_pass2",
        kernels.ptr(y), kernels.ptr(out), log_r, log_c,
        kernels.ptr(tw), kernels.ptr(row), kernels.ptr(col),
        shape.threads, shape.smem_bytes, shape.cluster.bit_length() - 1,
        device=y.device, size=R * C,
    )
    return out


def occupancy(log_l: int, log_b: int, pass1: bool, device="cuda") -> dict:
    """One pass's launch as the card sees it, for the 8-wide kernel with
    row/col multipliers (the prover's coset extension in pass 1, its
    inverse in pass 2): :func:`launch_shape`, the blocks of the grid, the
    kernel's registers a thread and spilled bytes, the blocks an SM holds
    at once and the clusters the card holds at once."""
    threads, smem = launch_shape(log_l, log_b)[:2]
    regs, local, resident, clusters = (ctypes.c_int() for _ in range(4))
    with torch.cuda.device(torch.device(device)):
        err = kernels.library().stark_ntt_occupancy(int(pass1), log_l, threads, smem, *(ctypes.byref(v) for v in (
            regs, local, resident, clusters)))
    if err != 0:
        raise RuntimeError(f"stark_ntt_occupancy failed with CUDA error {err}")
    return {"threads": threads, "smem_bytes": smem, "cluster": CLUSTER_BLOCKS, "blocks": 1 << log_b,
            "registers": regs.value, "local_bytes": local.value, "blocks_per_sm": resident.value,
            "resident_clusters": clusters.value}


# -- the plan -----------------------------------------------------------------


def power_grid(base: int, rows: int, cols: range, device) -> torch.Tensor:
    """(8, rows, len(cols)) Montgomery table base^(r * j) over rows r and
    the columns j in ``cols``, built on the device from the bits of j: for
    each bit b, the row table (base^(2^b))^r multiplies the columns whose
    index has bit b (one K10 product of the whole table on the card).
    The W table of a transform is ``power_grid(omega, R, range(C))``; a
    shard of the sharded transform takes its own column range."""
    shape = (NUM_LIMBS, rows, len(cols))
    acc = from_numpy(_mont_pack([1]), device)[:, :, None].expand(shape).contiguous()
    idx = torch.arange(cols.start, cols.stop, device=device)
    for bit in range(max(cols).bit_length()):
        if not any((j >> bit) & 1 for j in cols):
            continue  # no column index in the range has this bit
        factor = from_numpy(_mont_pack(_power_table(pow(base, 1 << bit, P), rows)), device)[:, :, None].expand(shape)
        mult = cuda_field.mont_mul(acc.reshape(NUM_LIMBS, -1), factor.reshape(NUM_LIMBS, -1).contiguous())
        acc = torch.where((((idx >> bit) & 1) == 1)[None, None, :], mult.reshape(shape), acc)
    return acc.contiguous()


def coset_tables(offset: int, inverse: bool, R: int, C: int):
    """The coset multipliers of a four-step transform of size n = R * C,
    as host lists of residues.

    forward (pass-1 prologue, input index j = j1*C + j2):
        row[j1] = offset^(C*j1) in bit-reversed order, col[j2] = offset^j2
    inverse (pass-2 epilogue, output index k = k1 + R*k2):
        row over k2: (offset^-R)^k2 with 1/n folded in,
        col over k1: (offset^-1)^k1
    """
    if not inverse:
        row = _power_table(pow(offset, C, P), R)
        return [row[i] for i in _bit_reverse_indices(R)], _power_table(offset % P, C)
    inv_off = pow(offset, -1, P)
    n_inv = pow(R * C, -1, P)
    return [v * n_inv % P for v in _power_table(pow(inv_off, R, P), C)], _power_table(inv_off, R)


class CudaNTT:
    """Four-step NTT/INTT of size n = R * C on one device."""

    def __init__(self, n: int, device) -> None:
        if n & (n - 1) or n < FOUR_STEP_MIN_SIZE:
            raise ValueError(f"size must be a power of two >= {FOUR_STEP_MIN_SIZE}")
        logn = n.bit_length() - 1
        self.n = n
        self.R = 1 << (logn // 2)
        self.C = n // self.R
        if self.C > MAX_PASS_LEN:
            raise ValueError(f"size too large for the four-step passes (C = {self.C})")
        self.device = torch.device(device)
        self.omega = FieldElement.primitive_nth_root(n).value
        self._tw_R = {}
        self._tw_C = {}
        self._W = {}
        for inv in (False, True):
            self._tw_R[inv] = from_numpy(_pack_stage_twiddles(self.R, inv), self.device)
            self._tw_C[inv] = from_numpy(_pack_stage_twiddles(self.C, inv), self.device)
            self._W[inv] = self._build_w_table(inv)
        self._row_col_cache = {}
        self._lock = threading.Lock()

    def _build_w_table(self, inverse: bool) -> torch.Tensor:
        """W[k1, j2] = omega^(+-k1*j2), (8, R, C) Montgomery."""
        base = pow(self.omega, -1, P) if inverse else self.omega
        return power_grid(base, self.R, range(self.C), self.device)

    def _row_col_tables(self, offset: int, inverse: bool):
        """Coset multipliers (:func:`coset_tables`) on the device."""
        key = (offset % P, inverse)
        with self._lock:  # threads sharing the plan build each entry once
            if key not in self._row_col_cache:
                row, col = coset_tables(offset, inverse, self.R, self.C)
                self._row_col_cache[key] = (
                    from_numpy(_mont_pack(row), self.device),
                    from_numpy(_mont_pack(col), self.device),
                )
            return self._row_col_cache[key]

    def op_tables(self, inverse: bool, offset: int = 1):
        """Everything :meth:`apply` reads: (W, tw_R, tw_C, row, col) with
        row/col the coset prologue tables (forward, offset != 1), the
        epilogue tables (inverse; they carry 1/n even at offset 1), or
        None/None."""
        if inverse or offset % P != 1:
            row, col = self._row_col_tables(offset, inverse)
        else:
            row = col = None
        return (self._W[inverse], self._tw_R[inverse], self._tw_C[inverse], row, col)

    def apply(self, a: torch.Tensor, tables, inverse: bool) -> torch.Tensor:
        """Transform of one (8, n) Montgomery tensor, reading only ``tables``."""
        w_table, tw_r, tw_c, row, col = tables
        if tuple(a.shape) != (NUM_LIMBS, self.n):
            raise ValueError(f"expected shape (8, {self.n}), got {tuple(a.shape)}")
        x = a.contiguous().reshape(NUM_LIMBS, self.R, self.C)
        pro = not inverse and row is not None
        y = ntt_pass1(x, tw_r, w_table, row if pro else None, col if pro else None)
        out = ntt_pass2(y, tw_c, row if inverse else None, col if inverse else None)
        return out.reshape(NUM_LIMBS, self.n)

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        return self.apply(a, self.op_tables(False), False)

    def inverse(self, a: torch.Tensor) -> torch.Tensor:
        return self.apply(a, self.op_tables(True), True)

    def coset_forward(self, a: torch.Tensor, offset: int) -> torch.Tensor:
        return self.apply(a, self.op_tables(False, offset), False)

    def coset_inverse(self, a: torch.Tensor, offset: int) -> torch.Tensor:
        return self.apply(a, self.op_tables(True, offset), True)


@lru_cache(maxsize=8)
def _cuda_plan(n: int, device: str) -> CudaNTT:
    return CudaNTT(n, device)


_PLAN_LOCK = threading.Lock()


def get_cuda_plan(n: int, device) -> CudaNTT:
    """Four-step plan for size n on ``device``, cached per (n, device) and
    built once however many threads ask for it."""
    with _PLAN_LOCK:
        return _cuda_plan(n, str(torch.device(device)))
