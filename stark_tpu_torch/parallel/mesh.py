"""Meshes of shards, sharded arrays and the chunk exchange (one controller).

Counterpart of :mod:`stark_tpu.parallel.mesh`.  A mesh is an ordered
tuple of ``torch.device``s, one a shard; a device may repeat, so 8 shards
can live on one card, on the CPU, or spread over several cards.  One
process drives every shard: a shard's work is launched on its device's
current stream, one shard after another.

A sharded array (:class:`ShardedArray`) is a list of per-shard ``(8, a,
b)`` tensors, shard s on ``mesh[s]``; its global array is their
concatenation along the last axis, ``(8, a, D * b)``.  JAX's ``all_to_all``
becomes :func:`exchange`: slices, copies within a device and copies
between devices, no field arithmetic.  :data:`EXCHANGES` counts its
calls, the bytes it moves and the chunks it copies.

The multi-controller mode of the JAX module (``init_distributed``,
``global_device_get``: one process a host over ``jax.distributed``) is not
part of this module; over ``torch.distributed`` it is a design of its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..params import NUM_LIMBS

Mesh = Tuple[torch.device, ...]

#: chunk exchanges since the last :func:`reset_exchange_counts`: calls,
#: bytes moved (each element of the array once), chunks copied and the
#: bytes of the chunks that crossed from one device to another
EXCHANGES: Dict[str, int] = {"calls": 0, "bytes": 0, "chunks": 0, "peer_bytes": 0}


def reset_exchange_counts() -> None:
    for key in EXCHANGES:
        EXCHANGES[key] = 0


def normalize(mesh: Sequence) -> Mesh:
    """The mesh as torch devices, a CUDA device without an index given the
    current one (tensors report ``cuda:0``, never ``cuda``)."""
    out = []
    for d in mesh:
        dev = torch.device(d)
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev} in a mesh")
        if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return tuple(out)


def make_mesh(num_shards: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``num_shards`` shards laid round-robin over ``devices``
    (default: every CUDA device); ``num_shards`` defaults to one a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch finds no CUDA device (cpu_mesh builds a mesh on the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = normalize(devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    if num_shards is None:
        num_shards = len(devices)
    if num_shards < 1:
        raise ValueError(f"make_mesh: {num_shards} shards")
    return tuple(devices[s % len(devices)] for s in range(num_shards))


def cpu_mesh(num_shards: int) -> Mesh:
    """A mesh of ``num_shards`` shards, all on the CPU (the plain versions)."""
    return make_mesh(num_shards, [torch.device("cpu")])


class ShardedArray:
    """Per-shard ``(8, a, b)`` tensors, shard s on the mesh's s-th device;
    the global ``(8, a, D * b)`` array is their concatenation along the
    last axis.  ``ndim`` is 3: the device prover's capability checks tell
    it from a one-device ``(8, n)`` codeword by that."""

    __slots__ = ("shards",)
    ndim = 3

    def __init__(self, shards: Sequence[torch.Tensor]) -> None:
        self.shards = list(shards)

    @property
    def shape(self) -> Tuple[int, int, int]:
        _, a, b = self.shards[0].shape
        return (NUM_LIMBS, int(a), int(b) * len(self.shards))

    def gather(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (default: the first shard's)."""
        dev = self.shards[0].device if device is None else torch.device(device)
        return torch.cat([t.to(dev) for t in self.shards], dim=2)


def shard_columns(mat: torch.Tensor, mesh: Mesh) -> ShardedArray:
    """An (8, a, c) array cut into D blocks of c / D columns, block s
    copied to ``mesh[s]``."""
    d = len(mesh)
    c = int(mat.shape[2])
    if c % d:
        raise ValueError(f"{c} columns do not split over {d} shards")
    w = c // d
    return ShardedArray([mat[:, :, s * w:(s + 1) * w].to(dev).contiguous() for s, dev in enumerate(mesh)])


def exchange(arr: ShardedArray) -> ShardedArray:
    """The all-to-all: shard t of the result holds rows [t a / D, (t + 1)
    a / D) of every shard, shard order along the last axis, so ``(8, a,
    b)`` shards become ``(8, a / D, D * b)`` shards.  Within a device it is
    a copy; a chunk between devices is a peer copy."""
    shards = arr.shards
    d = len(shards)
    _, a, b = shards[0].shape
    if a % d:
        raise ValueError(f"{a} rows do not split over {d} shards")
    m = a // d
    out: List[torch.Tensor] = []
    for t, dst in enumerate(shards):
        chunks = [src[:, t * m:(t + 1) * m, :] for src in shards]
        EXCHANGES["peer_bytes"] += sum(c.numel() * c.element_size() for c in chunks if c.device != dst.device)
        out.append(torch.cat([c.to(dst.device) for c in chunks], dim=2))
    EXCHANGES["calls"] += 1
    EXCHANGES["chunks"] += d * d
    EXCHANGES["bytes"] += sum(t.numel() * t.element_size() for t in shards)
    return ShardedArray(out)
