"""Blake2b-256 Merkle tree through the hand-written CUDA kernels (K4, K5,
the subtrees kernel and the top kernel), and the digit conversion.

Counterpart of :mod:`stark_tpu.ops.pallas_merkle`
(``leaf_digests_pallas``, ``level_hash_pallas``, ``tree_levels``).
:func:`merkle_leaves`, :func:`merkle_level`, :func:`merkle_subtrees` and
:func:`merkle_top` wrap the four kernels of ``csrc/merkle.cu``; their
plain PyTorch versions are
:func:`stark_tpu_torch.ops.device_merkle.leaf_digests_from_digits`,
:func:`~stark_tpu_torch.ops.device_merkle.level_hash`,
:func:`~stark_tpu_torch.ops.device_merkle.merkle_subtrees_plain` and
:func:`~stark_tpu_torch.ops.device_merkle.merkle_top_plain`, and run only
for tensors on the CPU.  For a CUDA tensor a wrapper launches its kernel or
raises.

K4 also takes the prover's (8, n) Montgomery codewords as they are
(:func:`merkle_leaves_mont`: the conversion to plain digits in the
kernel's loads), and :func:`mont_digits` runs that conversion alone: on a
whole codeword (``stark_mont_digits``) for the host fetches, and, given
``indices``, on those columns of one or more codewords
(``stark_mont_digits_gather``, counted as ``mont_digits_gather``) for the
opening gathers, one launch a gather that reads its columns itself: the
JAX package's jitted ``_plain_digits`` / ``_value_gather``
(stark_tpu/ops/device_prover.py:55, :65), whose plain version here is
:func:`stark_tpu_torch.ops.device_merkle.plain_digits` (of the indexed
columns, concatenated codeword by codeword).

A tree (:func:`tree_levels`) runs the leaf kernel, then the level kernel,
one launch a level, while its level is wider than :data:`SUBTREE_WIDTH`,
then the subtrees kernel once for every level down to :data:`TOP_WIDTH`,
then the top kernel once for every level down to the root.  The JAX
package runs its Pallas level kernel a level at a time down to 256-wide
parents (``pallas_merkle.MIN_KERNEL_WIDTH``) and the narrower levels as
one XLA function.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from . import kernels
from .device_merkle import (leaf_digests_from_digits, level_hash, merkle_subtrees_plain, merkle_top_plain,
                            plain_digits, top_slabs)

#: widest level that :func:`tree_levels` hands to the top kernel: one
#: block hashing the levels above it beats a launch a level
TOP_WIDTH = 512
#: widest level that :func:`tree_levels` hands to the subtrees kernel,
#: which hashes every level above it down to TOP_WIDTH in one launch: the
#: cheapest split of a fib-2^16 prove's trees in chip_smoke.py's sweep;
#: read at call time, so tests may lower it
SUBTREE_WIDTH = 1 << 19
# widest level the top kernel takes, and the widest subtree a block of the
# subtrees kernel hashes (their shared memory; csrc/merkle.cu kTopMaxWidth)
_TOP_MAX_WIDTH = 8192
#: codewords and indices one launch of the gather form takes
#: (csrc/merkle.cu kGatherMaxCodewords, kGatherMaxIndices); a larger gather
#: is split into several launches
GATHER_MAX_CODEWORDS = 64
GATHER_MAX_INDICES = 256


def _check(name: str, t: torch.Tensor, rows: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name}: expected shape ({rows}, w), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def merkle_leaves(digits: torch.Tensor) -> torch.Tensor:
    """K4: (4, n) plain base-2^32 digits -> (8, n) leaf digest words
    (Blake2b-256 of each ``bincode(FieldElement)``).

    Replaces ``leaf_digests_pallas`` / ``_leaf_kernel``
    (stark_tpu/ops/pallas_merkle.py).  One thread per leaf with the state
    in registers; bound by 64-bit integer throughput (one 12-round
    compress per 16 bytes read), see csrc/merkle.cu."""
    _check("digits", digits, 4)
    n = int(digits.shape[1])
    if n == 0:
        raise ValueError("no leaves")
    if digits.device.type == "cpu":
        return leaf_digests_from_digits(digits)
    out = torch.empty((8, n), dtype=torch.int32, device=digits.device)
    kernels.launch("merkle_leaves", "stark_merkle_leaves", kernels.ptr(digits), kernels.ptr(out), n,
                   device=digits.device, size=n)
    return out


def merkle_leaves_mont_plain(mont: torch.Tensor) -> torch.Tensor:
    """:func:`merkle_leaves_mont`'s plain version: the digits, then the leaves."""
    return leaf_digests_from_digits(plain_digits(mont))


def merkle_leaves_mont(mont: torch.Tensor) -> torch.Tensor:
    """K4 on an (8, n) Montgomery codeword: the (8, n) leaf digests of its
    plain values, with the conversion (one Montgomery reduction an
    element, ``fe_from_mont``) in the kernel's loads; the same digests as
    ``merkle_leaves(plain_digits(mont))``.  Counted as ``merkle_leaves``."""
    _check("mont", mont, 8)
    n = int(mont.shape[1])
    if n == 0:
        raise ValueError("no leaves")
    if mont.device.type == "cpu":
        return merkle_leaves_mont_plain(mont)
    out = torch.empty((8, n), dtype=torch.int32, device=mont.device)
    kernels.launch("merkle_leaves", "stark_merkle_leaves_mont", kernels.ptr(mont), kernels.ptr(out), n,
                   device=mont.device, size=n)
    return out


def mont_digits(mont: Union[torch.Tensor, Sequence[torch.Tensor]], indices=None) -> torch.Tensor:
    """Plain base-2^32 digits (``int32`` holding u32 bits) of Montgomery limbs.

    Without ``indices``: the (8, K) tensor ``mont`` -> (4, K), one launch of
    ``stark_mont_digits`` on the card.  With ``indices`` (ints in [0, n)):
    ``mont`` is one (8, n) codeword or a sequence of G of them, and the
    result the (4, G * K) digits of columns ``indices`` of each, codeword
    by codeword (column g K + r is codeword g at indices[r]): one launch of
    ``stark_mont_digits_gather`` a gather of at most
    :data:`GATHER_MAX_CODEWORDS` codewords and :data:`GATHER_MAX_INDICES`
    indices, several for a larger one; the kernel reads the columns itself,
    so no index tensor is copied to the card and no other kernel runs.  On
    the CPU: :func:`~stark_tpu_torch.ops.device_merkle.plain_digits`, of the
    indexed columns."""
    if indices is not None:
        return _gather_digits([mont] if isinstance(mont, torch.Tensor) else list(mont), [int(i) for i in indices])
    _check("mont", mont, 8)
    k = int(mont.shape[1])
    if k == 0:
        raise ValueError("no elements")
    if mont.device.type == "cpu":
        return plain_digits(mont)
    out = torch.empty((4, k), dtype=torch.int32, device=mont.device)
    kernels.launch("mont_digits", "stark_mont_digits", kernels.ptr(mont), kernels.ptr(out), k,
                   device=mont.device, size=k)
    return out


class _GatherParams(ctypes.Structure):
    """csrc/merkle.cu ``GatherParams``, field for field."""

    _fields_ = [
        ("codewords", ctypes.c_void_p * GATHER_MAX_CODEWORDS),
        ("indices", ctypes.c_uint32 * GATHER_MAX_INDICES),
        ("digits", ctypes.c_void_p),
        ("n", ctypes.c_int64),
        ("stride", ctypes.c_int64),
        ("group_stride", ctypes.c_int64),
        ("first", ctypes.c_int64),
        ("n_codewords", ctypes.c_int32),
        ("n_indices", ctypes.c_int32),
    ]


def gather_launches(codewords: Sequence[torch.Tensor], indices: Sequence[int], out: torch.Tensor):
    """The :class:`_GatherParams` of each launch of a gather of ``indices``
    from ``codewords`` into the (4, G * K) ``out``: blocks of at most
    GATHER_MAX_CODEWORDS codewords by GATHER_MAX_INDICES indices."""
    k = len(indices)
    n = int(codewords[0].shape[1])
    launches = []
    for g0 in range(0, len(codewords), GATHER_MAX_CODEWORDS):
        cws = codewords[g0 : g0 + GATHER_MAX_CODEWORDS]
        for r0 in range(0, k, GATHER_MAX_INDICES):
            idx = indices[r0 : r0 + GATHER_MAX_INDICES]
            p = _GatherParams()
            for j, cw in enumerate(cws):
                p.codewords[j] = cw.data_ptr()
            for j, i in enumerate(idx):
                p.indices[j] = i
            p.digits, p.n, p.stride, p.group_stride = out.data_ptr(), n, int(out.shape[1]), k
            p.first, p.n_codewords, p.n_indices = g0 * k + r0, len(cws), len(idx)
            launches.append(p)
    return launches


def _gather_digits(codewords, indices) -> torch.Tensor:
    if not codewords:
        raise ValueError("no codewords to gather from")
    if not indices:
        raise ValueError("no indices to gather")
    for cw in codewords:
        _check("codeword", cw, 8)
    n = int(codewords[0].shape[1])
    if any(int(cw.shape[1]) != n for cw in codewords):
        raise ValueError(f"codewords of different lengths: {sorted({int(cw.shape[1]) for cw in codewords})}")
    if not all(0 <= i < n for i in indices):
        raise ValueError(f"an index outside [0, {n}): {min(indices)} .. {max(indices)}")
    devices = {cw.device for cw in codewords}
    if len(devices) != 1:
        raise ValueError(f"codewords on different devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return torch.cat([plain_digits(cw[:, indices]) for cw in codewords], dim=1)
    lib = kernels.library()
    if lib.stark_mont_digits_gather_params_size() != ctypes.sizeof(_GatherParams):
        raise RuntimeError(f"GatherParams is {lib.stark_mont_digits_gather_params_size()} bytes in the library, "
                           f"{ctypes.sizeof(_GatherParams)} here")
    out = torch.empty((4, len(codewords) * len(indices)), dtype=torch.int32, device=dev)
    for p in gather_launches(codewords, indices, out):
        kernels.launch("mont_digits_gather", "stark_mont_digits_gather", ctypes.addressof(p), device=dev,
                       size=p.n_codewords * p.n_indices)
    return out


def merkle_level(level: torch.Tensor) -> torch.Tensor:
    """K5: (8, w) child digests -> (8, w/2) parents H(left || right).

    Replaces ``level_hash_pallas`` / ``_level_kernel``
    (stark_tpu/ops/pallas_merkle.py).  One thread per parent, reading its
    children 2i and 2i + 1 itself; compute-bound like
    :func:`merkle_leaves`."""
    _check("level", level, 8)
    w = int(level.shape[1])
    if w < 2 or w % 2:
        raise ValueError(f"level width must be even and >= 2, got {w}")
    if level.device.type == "cpu":
        return level_hash(level)
    out = torch.empty((8, w // 2), dtype=torch.int32, device=level.device)
    kernels.launch("merkle_level", "stark_merkle_level", kernels.ptr(level), kernels.ptr(out), w,
                   device=level.device, size=w)
    return out


def merkle_top(level: torch.Tensor) -> torch.Tensor:
    """(8, w) level, w a power of two, 2 <= w <= 8192 -> every level above
    it down to the root, as one flat int32 buffer of 8 * (w - 1) words
    (:func:`~stark_tpu_torch.ops.device_merkle.top_slabs` cuts it into
    the (8, w / 2^k) levels, the root last).

    Replaces the narrow levels of the JAX package's ``tree_levels``
    (stark_tpu/ops/pallas_merkle.py), which it hashes outside its Pallas
    kernel.  One block: each level from the previous one in shared memory,
    a barrier between levels, so a tree's top costs one launch instead of
    one a level; bound by the latency of its chain of compressions."""
    _check("level", level, 8)
    w = int(level.shape[1])
    if not 2 <= w <= _TOP_MAX_WIDTH or w & (w - 1):
        raise ValueError(f"top level width must be a power of two in [2, {_TOP_MAX_WIDTH}], got {w}")
    if level.device.type == "cpu":
        return merkle_top_plain(level)
    out = torch.empty(8 * (w - 1), dtype=torch.int32, device=level.device)
    kernels.launch("merkle_top", "stark_merkle_top", kernels.ptr(level), kernels.ptr(out), w,
                   device=level.device, size=w)
    return out


def merkle_subtrees(level: torch.Tensor, depth: int) -> torch.Tensor:
    """(8, w) level, w a power of two, 1 <= depth, 2^depth <= min(w, 8192)
    -> the ``depth`` levels above it, as one flat int32 buffer of
    8 * (w - w / 2^depth) words (:func:`~stark_tpu_torch.ops.device_merkle.top_slabs`
    cuts it into the (8, w / 2^k) levels, k = 1 .. depth).

    Replaces the chain of ``level_hash_pallas`` calls in the JAX package's
    ``tree_levels`` (stark_tpu/ops/pallas_merkle.py) for the middle levels
    of a tree.  One launch: a block hashes whole subtrees of 2^depth
    children, level 1 from global memory, each later level from the
    previous one in shared memory; bound by the ALU work of its
    compressions, it saves depth - 1 launches and global round trips."""
    _check("level", level, 8)
    w = int(level.shape[1])
    if w < 2 or w & (w - 1):
        raise ValueError(f"level width must be a power of two >= 2, got {w}")
    if not 1 <= depth or (1 << depth) > min(w, _TOP_MAX_WIDTH):
        raise ValueError(f"depth must be >= 1 with 2^depth <= min(w, {_TOP_MAX_WIDTH}), got {depth} at width {w}")
    if level.device.type == "cpu":
        return merkle_subtrees_plain(level, depth)
    out = torch.empty(8 * (w - (w >> depth)), dtype=torch.int32, device=level.device)
    kernels.launch("merkle_subtrees", "stark_merkle_subtrees", kernels.ptr(level), kernels.ptr(out), w, depth,
                   device=level.device, size=w)
    return out


def tree_levels(values: torch.Tensor, tail_width: int, *, mont: bool = False):
    """All levels from the (4, n) digits, or with ``mont`` the (8, n)
    Montgomery codeword, n a power of two: the (8, w) levels for w = n ..
    tail_width (kept on the device for openings) and the (8,) root words.
    The leaves come from K4 (:func:`merkle_leaves` or
    :func:`merkle_leaves_mont`), the levels wider than SUBTREE_WIDTH from
    the level kernel, those down to TOP_WIDTH from one launch of the
    subtrees kernel, the rest from one launch of the top kernel."""
    cur = (merkle_leaves_mont if mont else merkle_leaves)(values.contiguous())
    levels = [cur]
    while cur.shape[1] > SUBTREE_WIDTH:
        cur = merkle_level(cur)
        levels.append(cur)
    w = int(cur.shape[1])
    if w > TOP_WIDTH:
        levels += top_slabs(merkle_subtrees(cur, (w // TOP_WIDTH).bit_length() - 1), w)
        cur = levels[-1]
        w = TOP_WIDTH
    if w > 1:
        levels += top_slabs(merkle_top(cur), w)
    kept = tuple(lv for lv in levels if lv.shape[1] >= tail_width)
    return kept, levels[-1][:, 0]
