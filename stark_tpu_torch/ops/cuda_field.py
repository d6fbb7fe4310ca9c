"""GF(p) vector operations through the hand-written CUDA kernels K7-K10.

The wrappers of ``csrc/fieldvec.cu``, the field arithmetic of device trace
interpolation (:mod:`stark_tpu_torch.ops.geometric_device`) and of the
boundary quotients:

* :func:`mont_inv` (K7, ``stark_mont_inv``): a^-1, zero to zero, by
  Montgomery's batch inversion inside each block of 2048 elements (one
  Fermat chain a warp's total), in one launch;
* :func:`prefix_mul` (K8, ``stark_prefix_mul``): inclusive prefix product
  along the columns, in one launch by a decoupled look-back;
* :func:`geometric_table` (K9, ``stark_geometric_table``): start * base^i,
  each of 2^m threads raising the base to its first index by the bit
  bases and stepping by base^(2^m) (:func:`geometric_step_bits`);
* :func:`mont_mul`, :func:`add`, :func:`sub`, :func:`neg` (K10,
  ``stark_mont_binary``): one elementwise operation, either operand an
  (8, 1) column broadcast along the other; :func:`to_mont` and
  :func:`from_mont` are its product by the column R^2 and by 1;
  :func:`mont_outer` (``stark_mont_outer``) is its row-by-column form,
  the (8, r * c) table a[i] * b[j] of an (8, r) and an (8, c) table.

In the JAX package these are XLA-fused functions with no Pallas form
(``field_ops.mont_inv`` / ``mont_mul`` / ``add`` / ``sub``,
``geometric_device.prefix_mont_mul``, ``device_prover.geometric_table``).
Each wrapper checks dtype, shape and contiguity, runs its plain PyTorch
version for CPU tensors, and on a CUDA tensor launches its kernel or
raises; it refuses any other device.  Kernels and plain versions agree
limb for limb.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

from ..params import NUM_LIMBS, R2_MOD_P
from . import field_ops as fo
from . import kernels
from .cuda_fold import _check
from .limbs import limbs_of

MUL, ADD, SUB = 0, 1, 2
_PLAIN = {MUL: fo.mont_mul, ADD: fo.add, SUB: fo.sub}


def _device(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device of ``tensors``: CPU (plain version) or CUDA (kernel)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on different devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _columns(name: str, t: torch.Tensor) -> int:
    _check(name, t)
    n = int(t.shape[1])
    if n == 0:
        raise ValueError(f"{name}: empty")
    return n


# -- K10 ----------------------------------------------------------------------


def mont_binary(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K10: ``a op b`` elementwise (op MUL: Montgomery product, ADD, SUB)
    over (8, n) tensors, where either may be an (8, 1) column broadcast
    along the other's n."""
    if op not in _PLAIN:
        raise ValueError(f"unknown op {op}")
    na, nb = _columns("a", a), _columns("b", b)
    if na != nb and 1 not in (na, nb):
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do not broadcast")
    n = max(na, nb)
    dev = _device("mont_binary", a, b)
    if dev.type == "cpu":
        return _PLAIN[op](a, b)
    out = torch.empty((NUM_LIMBS, n), dtype=torch.int32, device=dev)
    kernels.launch("mont_binary", "stark_mont_binary", kernels.ptr(a), kernels.ptr(b), kernels.ptr(out), n, op,
                   int(na < n), int(nb < n), device=dev, size=n)
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mont_binary(MUL, a, b)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mont_binary(ADD, a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mont_binary(SUB, a, b)


def mont_outer_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`mont_outer`."""
    rows, cols = int(a.shape[1]), int(b.shape[1])
    return fo.mont_mul(a[:, :, None].expand(NUM_LIMBS, rows, cols),
                       b[:, None, :].expand(NUM_LIMBS, rows, cols)).reshape(NUM_LIMBS, rows * cols)


def mont_outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K10's row-by-column form: the (8, r * c) Montgomery table
    ``out[:, i * c + j] = a[:, i] * b[:, j]`` of an (8, r) and an (8, c)
    table, i.e. the (8, r, c) outer product flattened.  One launch on the
    card (counter ``mont_outer``)."""
    rows, cols = _columns("a", a), _columns("b", b)
    dev = _device("mont_outer", a, b)
    if dev.type == "cpu":
        return mont_outer_plain(a, b)
    out = torch.empty((NUM_LIMBS, rows * cols), dtype=torch.int32, device=dev)
    kernels.launch("mont_outer", "stark_mont_outer", kernels.ptr(a), kernels.ptr(b), kernels.ptr(out), rows, cols,
                   device=dev, size=rows * cols)
    return out


def neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p: 0 - a, the zero a broadcast column."""
    return sub(torch.zeros((NUM_LIMBS, 1), dtype=torch.int32, device=a.device), a)


#: (value, device) -> its (8, 1) limb column, uploaded once: an upload from
#: host memory waits for the device's queue
_COLUMNS: Dict[tuple, torch.Tensor] = {}
_COLUMNS_LOCK = threading.Lock()


def _plain_column(value: int, device) -> torch.Tensor:
    """(8, 1) int32 limbs of a plain constant on ``device``."""
    key = (value, torch.device(device))
    with _COLUMNS_LOCK:
        col = _COLUMNS.get(key)
        if col is None:
            col = _COLUMNS[key] = torch.tensor(limbs_of(value), dtype=torch.int32,
                                               device=device).reshape(NUM_LIMBS, 1)
    return col


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Plain residues (any value < 2^128) -> canonical Montgomery form:
    REDC(a * R^2), one K10 product by the (8, 1) column R^2 mod p."""
    return mont_mul(a, _plain_column(R2_MOD_P, a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> plain residues: REDC(a * 1), one K10 product."""
    return mont_mul(a, _plain_column(1, a.device))


# -- K7 -----------------------------------------------------------------------


def mont_inv(a: torch.Tensor) -> torch.Tensor:
    """K7: elementwise inverse of an (8, n) Montgomery tensor, zero to
    zero.  On the card one launch: each block of 2048 elements is a batch
    inversion of its own (prefix and suffix products, each warp's total
    inverted by a Fermat chain, a block's 8 side by side)."""
    n = _columns("a", a)
    dev = _device("mont_inv", a)
    if dev.type == "cpu":
        return fo.mont_inv(a)
    out = torch.empty_like(a)
    kernels.launch("mont_inv", "stark_mont_inv", kernels.ptr(a), kernels.ptr(out), n, device=dev, size=n)
    return out


# -- K8 -----------------------------------------------------------------------


#: elements a K8 tile holds (csrc/fieldvec.cu kScanChunk)
PREFIX_TILE = 1024
#: calls a status buffer serves before it is zeroed again: a flag word is
#: epoch << 2 | state in 32 bits
EPOCHS = 1 << 30


class ScanStatus:
    """The look-back status buffer K8 keeps on one device: a tile ticket
    counter, a flag word a tile, and an aggregate and an inclusive prefix a
    tile (``values[0]``, ``values[1]``), zeroed when allocated.  Each call
    takes a new epoch, so the flags of earlier calls read as "nothing
    published" and no launch resets the buffer, and the ticket's count at
    its start (``base``): calls run in order on the current stream, so each
    call's tiles take the tickets base .. base + tiles - 1."""

    def __init__(self, tiles: int, device) -> None:
        self.capacity = 1 << (tiles - 1).bit_length()
        self.ticket = torch.zeros(1, dtype=torch.int64, device=device)
        self.flags = torch.zeros(self.capacity, dtype=torch.int32, device=device)
        self.values = torch.zeros((2, self.capacity, 4), dtype=torch.int32, device=device)
        self.epoch = 0
        self.base = 0

    def claim(self, tiles: int):
        """(epoch, base) of the next call, of ``tiles`` tiles; past the
        last epoch the buffer is zeroed (queued on the current stream)."""
        if tiles > self.capacity:
            raise ValueError(f"{tiles} tiles exceed the status buffer's {self.capacity}")
        if self.epoch + 1 >= EPOCHS:
            self.ticket.zero_()
            self.flags.zero_()
            self.epoch = self.base = 0
        self.epoch += 1
        base = self.base
        self.base += tiles
        return self.epoch, base


#: device -> its K8 status buffer
_STATUS: Dict[torch.device, ScanStatus] = {}
#: held from a call's claim to its launch: calls from several threads
#: queue on one stream in the order they claimed their tickets
_SCAN_LOCK = threading.Lock()


def scan_status(tiles: int, device: torch.device) -> ScanStatus:
    """The device's status buffer, allocated (zeroed) or grown to hold
    ``tiles`` tiles.  A buffer dropped here may still be read by a launch
    queued on the stream; the caching allocator hands its memory only to
    later work of that stream."""
    status = _STATUS.get(device)
    if status is None or status.capacity < tiles:
        status = _STATUS[device] = ScanStatus(tiles, device)
    return status


def prefix_mul(a: torch.Tensor) -> torch.Tensor:
    """K8: [a0, a0*a1, a0*a1*a2, ...] of an (8, n) Montgomery tensor.  On
    the card one launch: a tile of :data:`PREFIX_TILE` elements a block,
    the tiles chained by a decoupled look-back over the device's
    :class:`ScanStatus`.  Two streams must not run it on one device at
    once (the port uses one; threads launching on it take turns from
    claim to launch).  On a failed launch the status buffer is dropped,
    so that the next call starts from a zeroed one."""
    n = _columns("a", a)
    dev = _device("prefix_mul", a)
    if dev.type == "cpu":
        return fo.prefix_mul(a)
    out = torch.empty_like(a)
    tiles = -(-n // PREFIX_TILE)
    with _SCAN_LOCK:
        status = scan_status(tiles, dev)
        epoch, base = status.claim(tiles)
        aggregates, inclusives = status.values
        try:
            kernels.launch("prefix_mul", "stark_prefix_mul", kernels.ptr(a), kernels.ptr(out), n,
                           kernels.ptr(status.ticket), kernels.ptr(status.flags), kernels.ptr(aggregates),
                           kernels.ptr(inclusives), status.capacity, epoch, base, device=dev, size=n)
        except RuntimeError:
            _STATUS.pop(dev, None)
            raise
    return out


# -- K9 -----------------------------------------------------------------------


def geometric_table_plain(start: torch.Tensor, bit_bases: torch.Tensor, n: int) -> torch.Tensor:
    """start * base^i for i < n, multiplying by base^(2^b) where bit b of
    i is set (log2(n) batched products)."""
    acc = start.expand(NUM_LIMBS, n)
    idx = torch.arange(n, device=start.device)
    for b in range((n - 1).bit_length()):
        acc = torch.where((((idx >> b) & 1) == 1)[None, :], fo.mont_mul(acc, bit_bases[:, b : b + 1]), acc)
    return acc.contiguous()


def geometric_step_bits(n: int) -> int:
    """The m of :func:`geometric_table` at n on the card: its grid has
    min(2^m, n) threads, thread i0 writes the elements i0 + k * 2^m < n,
    stepping by the bit base base^(2^m) (m = the bits of n - 1 where that
    grid is one element a thread)."""
    return kernels.library().stark_geometric_step_bits(n)


def geometric_table(start: torch.Tensor, bit_bases: torch.Tensor, n: int) -> torch.Tensor:
    """K9: the (8, n) Montgomery table start * base^i, i < n, from the
    (8, 1) Montgomery ``start`` and the (8, k) bit bases base^(2^b),
    k = (n - 1).bit_length().  On the card a thread multiplies out its
    first power from the bit bases, then one product an element
    (:func:`geometric_step_bits`)."""
    _check("start", start, 1)
    _check("bit_bases", bit_bases)
    bits = (n - 1).bit_length() if n > 0 else 0
    if n <= 0 or bit_bases.shape[1] != bits:
        raise ValueError(f"n = {n} needs {bits} bit bases, got {bit_bases.shape[1]}")
    dev = _device("geometric_table", start, bit_bases)
    if dev.type == "cpu":
        return geometric_table_plain(start, bit_bases, n)
    out = torch.empty((NUM_LIMBS, n), dtype=torch.int32, device=dev)
    kernels.launch("geometric_table", "stark_geometric_table", kernels.ptr(start), kernels.ptr(bit_bases), bits,
                   kernels.ptr(out), n, device=dev, size=n)
    return out
