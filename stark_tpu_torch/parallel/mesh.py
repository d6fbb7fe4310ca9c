"""Meshes of shards, sharded arrays and the crossings between shards.

Counterpart of :mod:`stark_tpu.parallel.mesh`.  Two kinds of mesh:

* **one controller**: an ordered tuple of ``torch.device``s, one a shard;
  a device may repeat, so 8 shards can live on one card, on the CPU, or
  spread over several cards.  One process drives every shard, one shard
  after another on its device's current stream;
* **several controllers** (the JAX module's ``init_distributed``: one
  process a host there, one a card or a group of shards here): a
  :class:`SpanningMesh` of D shards over the W ranks of a
  ``torch.distributed`` process group (:func:`init_distributed`), shard s
  owned by rank ``s // (D / W)``, all of a rank's shards on its device.
  Every rank runs the same host prover program in lockstep, so every
  crossing between ranks is a collective that every rank calls in the
  same order, with sizes every rank can compute.

A sharded array (:class:`ShardedArray`) is the list of the process's
per-shard ``(8, a, b)`` tensors; its global array is every shard's
concatenated along the last axis, ``(8, a, D * b)``.  On a spanning mesh
a process holds only its own shards.  JAX's ``all_to_all`` becomes
:func:`exchange`: slices and copies between shards of one process, one
``all_to_all`` between ranks.  JAX's ``global_device_get``
(``process_allgather``) becomes :meth:`ShardedArray.gather` and
:func:`allgather_shards`.

Transport between ranks is the process group's backend, which the caller
names: ``"gloo"`` for CPU shards, and for CUDA shards of ranks that share
a card (NCCL refuses two ranks on one device, and gloo moves no CUDA
tensor in an all-to-all), through host buffers; ``"nccl"`` for one rank a
card, on device buffers.  :data:`EXCHANGES` counts the exchanges and what
crossed.
"""

from __future__ import annotations

import datetime
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..params import NUM_LIMBS

#: a process group's collectives fail after this many seconds instead of
#: hanging on a rank that never calls them
DEFAULT_TIMEOUT_S = 120.0

#: since the last :func:`reset_exchange_counts`: chunk exchanges (calls),
#: the bytes they moved (each element of the process's shards once) and the
#: chunks they assembled; ``peer_bytes``: bytes copied between two devices
#: of one process; ``remote_bytes``: bytes this rank received from other
#: ranks (exchanges, gathers, the next-row halo); ``staged_bytes``: bytes
#: copied between a card and host buffers for those crossings (down and up)
EXCHANGES: Dict[str, int] = {"calls": 0, "bytes": 0, "chunks": 0, "peer_bytes": 0, "remote_bytes": 0,
                             "staged_bytes": 0}


def reset_exchange_counts() -> None:
    for key in EXCHANGES:
        EXCHANGES[key] = 0


class SpanningMesh:
    """D shards over the W ranks of a process group: shard s owned by rank
    ``s // (D / W)``, all of a rank's shards on ``device``.  ``staged``:
    crossings go through host buffers (gloo with CUDA shards).  Build one
    with :func:`spanning_mesh` once :func:`init_distributed` has run; the
    arithmetic needs no process group."""

    def __init__(self, num_shards: int, world_size: int, rank: int, device, staged: bool = False) -> None:
        if world_size < 1 or not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} of {world_size}")
        if num_shards < world_size or num_shards % world_size:
            raise ValueError(f"{num_shards} shards do not split over {world_size} ranks")
        self.num_shards = num_shards
        self.world_size = world_size
        self.rank = rank
        self.per_rank = num_shards // world_size
        self.device = normalize([device])[0]
        self.staged = staged

    def __len__(self) -> int:
        return self.num_shards

    def __getitem__(self, s: int) -> torch.device:
        if self.owner(s) != self.rank:
            raise IndexError(f"shard {s} lives on rank {self.owner(s)}, not on rank {self.rank}")
        return self.device

    def __iter__(self):
        # without it, iteration would stop silently at the first foreign shard
        raise TypeError("a spanning mesh holds other ranks' shards: iterate owned(mesh)")

    def __repr__(self) -> str:
        return (f"SpanningMesh({self.num_shards} shards, rank {self.rank} of {self.world_size}, {self.device}, "
                f"{'host-staged' if self.staged else 'direct'})")

    def owner(self, s: int) -> int:
        if not 0 <= s < self.num_shards:
            raise IndexError(f"shard {s} of {self.num_shards}")
        return s // self.per_rank

    def shards_of(self, rank: int) -> range:
        return range(rank * self.per_rank, (rank + 1) * self.per_rank)


Mesh = Union[Tuple[torch.device, ...], SpanningMesh]


def check_backend(backend: str, devices: Sequence) -> None:
    """Refuse a transport that cannot serve ``devices`` (every rank's device,
    in rank order, on one host): NCCL runs one rank a card, gloo serves CPU
    shards and CUDA shards through host buffers."""
    devs = [torch.device(d) for d in devices]
    if backend == "gloo":
        bad = [str(d) for d in devs if d.type not in ("cpu", "cuda")]
        if bad:
            raise ValueError(f"gloo serves CPU and CUDA shards, not {bad}")
        return
    if backend != "nccl":
        raise ValueError(f"unsupported backend {backend!r}: 'gloo' or 'nccl'")
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"NCCL moves CUDA tensors only: {list(map(str, devs))}")
    cards = [d.index or 0 for d in devs]
    shared = sorted({c for c in cards if cards.count(c) > 1})
    if shared:
        raise ValueError(f"NCCL runs one rank a card, but ranks share cuda:{shared[0]} ({list(map(str, devs))}); "
                         f"ranks that share a card use gloo, through host buffers")


def init_distributed(init_method: str, world_size: int, rank: int, backend: str, devices: Sequence,
                     timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group (``torch.distributed.init_process_group``):
    ``init_method`` a ``file://`` or ``tcp://host:port`` rendezvous,
    ``devices`` every rank's device in rank order (checked by
    :func:`check_backend`), ``timeout`` the seconds after which a
    collective that a rank never joins fails.  Returns this rank's device,
    made the current CUDA device where it is one."""
    import torch.distributed as dist

    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    check_backend(backend, devices)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} was given {device}, but torch finds no CUDA device")
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return device


def spanning_mesh(num_shards: int, device) -> SpanningMesh:
    """The D-shard mesh over the process group that
    :func:`init_distributed` joined, this rank's shards on ``device``."""
    import torch.distributed as dist

    dev = normalize([device])[0]
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group moves CUDA tensors; this rank's shards are on {dev}")
    return SpanningMesh(num_shards, dist.get_world_size(), dist.get_rank(), dev,
                        staged=backend == "gloo" and dev.type == "cuda")


def normalize(mesh) -> Mesh:
    """The mesh as torch devices, a CUDA device without an index given the
    current one (tensors report ``cuda:0``, never ``cuda``); a spanning
    mesh as it is."""
    if isinstance(mesh, SpanningMesh):
        return mesh
    out = []
    for d in mesh:
        dev = torch.device(d)
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev} in a mesh")
        if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return tuple(out)


def owned(mesh: Mesh) -> List[Tuple[int, torch.device]]:
    """(shard, device) of every shard this process drives, in shard order."""
    if isinstance(mesh, SpanningMesh):
        return [(s, mesh.device) for s in mesh.shards_of(mesh.rank)]
    return list(enumerate(mesh))


def home(mesh: Mesh) -> torch.device:
    """Where this process's gathers, fetches and the FRI tail meet."""
    return mesh.device if isinstance(mesh, SpanningMesh) else mesh[0]


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


# ---------------------------------------------------------------------------
# crossings between ranks
# ---------------------------------------------------------------------------


def _all_to_all(mesh: SpanningMesh, sends: Dict[int, torch.Tensor], recv_numel: Dict[int, int],
                dtype: torch.dtype) -> Dict[int, torch.Tensor]:
    """One ``all_to_all_single`` over the process group: the flat
    ``sends[q]`` to rank q, ``recv_numel[q]`` elements from rank q, as flat
    tensors on the mesh's device.  Host-staged meshes send and receive
    through CPU buffers."""
    import torch.distributed as dist

    w = mesh.world_size
    in_splits = [int(sends[q].numel()) if q in sends else 0 for q in range(w)]
    out_splits = [int(recv_numel.get(q, 0)) for q in range(w)]
    buf = torch.device("cpu") if mesh.staged else mesh.device
    parts = [sends[q].reshape(-1) for q in range(w) if in_splits[q]]
    send = torch.cat(parts).to(buf) if parts else torch.empty(0, dtype=dtype, device=buf)
    recv = torch.empty(sum(out_splits), dtype=dtype, device=buf)
    dist.all_to_all_single(recv, send, out_splits, in_splits)
    size = recv.element_size()
    EXCHANGES["remote_bytes"] += recv.numel() * size
    if mesh.staged:
        EXCHANGES["staged_bytes"] += (send.numel() + recv.numel()) * size
    recv = recv.to(mesh.device)
    out, off = {}, 0
    for q in range(w):
        out[q] = recv[off:off + out_splits[q]]
        off += out_splits[q]
    return out


def allgather_shards(mesh: Mesh, local: torch.Tensor, cols: Sequence[int]) -> torch.Tensor:
    """Every shard's columns on every rank: ``local`` is this process's
    shards' (r, k) columns joined in shard order, ``cols[s]`` the columns
    of shard s (every shard's, known to every rank); returns the (r,
    sum(cols)) join in shard order on the mesh's device.  On a
    one-controller mesh ``local`` is already all of it."""
    if not isinstance(mesh, SpanningMesh):
        return local
    r = int(local.shape[0])
    counts = [sum(cols[s] for s in mesh.shards_of(q)) for q in range(mesh.world_size)]
    if int(local.shape[1]) != counts[mesh.rank]:
        raise ValueError(f"rank {mesh.rank} holds {int(local.shape[1])} columns, its shards {counts[mesh.rank]}")
    local = local.contiguous()
    flat = local.reshape(-1)
    got = _all_to_all(mesh, {q: flat for q in range(mesh.world_size) if q != mesh.rank},
                      {q: r * counts[q] for q in range(mesh.world_size) if q != mesh.rank}, local.dtype)
    parts = [local if q == mesh.rank else got[q].view(r, counts[q]) for q in range(mesh.world_size)]
    return torch.cat(parts, dim=1)


#: a piece of a shard bound for a shard: (source shard, destination shard,
#: shape, a function that returns it, called only where the source lives)
Piece = Tuple[int, int, Tuple[int, ...], Callable[[], torch.Tensor]]


def move_pieces(mesh: Mesh, pieces: Sequence[Piece]) -> List[Optional[torch.Tensor]]:
    """Each piece on its destination shard's device (None where another
    rank owns the destination).  ``pieces`` is the same list on every
    rank; the pieces between ranks (int32) travel in one all-to-all."""
    out: List[Optional[torch.Tensor]] = [None] * len(pieces)
    if not isinstance(mesh, SpanningMesh):
        for i, (_, dst, _, make) in enumerate(pieces):
            t, dev = make(), mesh[dst]
            if t.device != dev:
                EXCHANGES["peer_bytes"] += t.numel() * t.element_size()
            out[i] = t.to(dev)
        return out
    me = mesh.rank
    sends: Dict[int, List[torch.Tensor]] = {}
    recvs: Dict[int, List[int]] = {}
    for i, (src, dst, _, make) in enumerate(pieces):
        s_rank, d_rank = mesh.owner(src), mesh.owner(dst)
        if s_rank == me and d_rank == me:
            out[i] = make()
        elif s_rank == me:
            sends.setdefault(d_rank, []).append(make().reshape(-1))
        elif d_rank == me:
            recvs.setdefault(s_rank, []).append(i)
    got = _all_to_all(mesh, {q: torch.cat(ts) for q, ts in sends.items()},
                      {q: sum(math.prod(pieces[i][2]) for i in idx) for q, idx in recvs.items()}, torch.int32)
    for q, idx in recvs.items():
        off = 0
        for i in idx:
            k = math.prod(pieces[i][2])
            out[i] = got[q][off:off + k].view(pieces[i][2])
            off += k
    return out


# ---------------------------------------------------------------------------
# sharded arrays
# ---------------------------------------------------------------------------


class ShardedArray:
    """This process's per-shard ``(8, a, b)`` tensors, in shard order, on
    ``mesh`` (default: the one-controller mesh of the shards' devices);
    the global ``(8, a, D * b)`` array is every shard's concatenation along
    the last axis.  ``ndim`` is 3: the device prover's capability checks
    tell it from a one-device ``(8, n)`` codeword by that."""

    __slots__ = ("shards", "_mesh")
    ndim = 3

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> None:
        self.shards = list(shards)
        self._mesh = mesh
        if isinstance(mesh, SpanningMesh) and len(self.shards) != mesh.per_rank:
            raise ValueError(f"{len(self.shards)} shards for rank {mesh.rank}, which owns {mesh.per_rank}")

    @property
    def mesh(self) -> Mesh:
        return self._mesh if self._mesh is not None else tuple(t.device for t in self.shards)

    @property
    def shape(self) -> Tuple[int, int, int]:
        _, a, b = self.shards[0].shape
        return (NUM_LIMBS, int(a), int(b) * len(self.mesh))

    def owned(self) -> List[Tuple[int, torch.Tensor]]:
        """(shard, tensor) of the shards this process holds."""
        return [(s, t) for (s, _), t in zip(owned(self.mesh), self.shards)]

    def shard(self, s: int) -> torch.Tensor:
        """Shard s, which this process must hold."""
        mesh = self.mesh
        if isinstance(mesh, SpanningMesh):
            mine = mesh.shards_of(mesh.rank)
            if s not in mine:
                raise IndexError(f"shard {s} lives on rank {mesh.owner(s)}, not on rank {mesh.rank}")
            return self.shards[s - mine.start]
        return self.shards[s]

    def gather(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (default: the mesh's home); on a
        spanning mesh every rank gets it (an all-gather)."""
        mesh = self.mesh
        dev = home(mesh) if device is None else torch.device(device)
        local = torch.cat([t.to(home(mesh)) for t in self.shards], dim=2)
        _, a, b = local.shape
        width = int(self.shards[0].shape[2])
        full = allgather_shards(mesh, local.reshape(NUM_LIMBS * a, b), [width] * len(mesh))
        return full.reshape(NUM_LIMBS, a, -1).to(dev)


def shard_columns(mat: torch.Tensor, mesh: Mesh) -> ShardedArray:
    """An (8, a, c) array cut into D blocks of c / D columns, block s
    copied to ``mesh[s]`` (on a spanning mesh: this rank's blocks only,
    from its copy of the whole array)."""
    d = len(mesh)
    c = int(mat.shape[2])
    if c % d:
        raise ValueError(f"{c} columns do not split over {d} shards")
    w = c // d
    return ShardedArray([mat[:, :, s * w:(s + 1) * w].to(dev).contiguous() for s, dev in owned(mesh)], mesh)


def exchange(arr: ShardedArray) -> ShardedArray:
    """The all-to-all: shard t of the result holds rows [t a / D, (t + 1)
    a / D) of every shard, shard order along the last axis, so ``(8, a,
    b)`` shards become ``(8, a / D, D * b)`` shards.  Within a device a
    chunk is a copy, between devices of one process a peer copy, between
    ranks part of one all-to-all."""
    mesh = arr.mesh
    d = len(mesh)
    _, a, b = arr.shards[0].shape
    if a % d:
        raise ValueError(f"{a} rows do not split over {d} shards")
    m = a // d

    def chunk(s: int, t: int):
        return lambda: arr.shard(s)[:, t * m:(t + 1) * m, :]

    got = move_pieces(mesh, [(s, t, (NUM_LIMBS, m, int(b)), chunk(s, t)) for t in range(d) for s in range(d)])
    out = [torch.cat(got[t * d:(t + 1) * d], dim=2) for t, _ in owned(mesh)]
    EXCHANGES["calls"] += 1
    EXCHANGES["chunks"] += d * len(out)
    EXCHANGES["bytes"] += sum(t.numel() * t.element_size() for t in arr.shards)
    return ShardedArray(out, arr._mesh)
