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

The numpy helpers (``pack``, ``unpack``, ``pack_be17``, ``limbs_of`` and
the table builders) are the JAX package's host-side limb code
(``stark_tpu/ops/limbs.py``, ``ops/ntt.py``, ``ops/fold.py``), carried
here so that the port needs nothing from that package.

A trace in limb form is a ``(registers, 8, rows)`` uint32 array of
canonical residues, register s's column in ``pack``'s layout at slice s:
the form the models hand to :meth:`stark_tpu_torch.stark.Stark.prove`.
``pack_trace`` and ``unpack_trace`` convert it from and to rows.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch

from ..field import FieldElement
from ..params import LIMB_BITS, LIMB_MASK, NUM_LIMBS, P, R_MOD_P


def pack(values: Sequence[int]) -> np.ndarray:
    """Python ints (canonical residues) -> uint32 array of shape (8, N)."""
    n = len(values)
    buf = bytearray(16 * n)
    for i, v in enumerate(values):
        buf[16 * i : 16 * i + 16] = int(v % P).to_bytes(16, "little")
    u16 = np.frombuffer(bytes(buf), dtype="<u2").reshape(n, NUM_LIMBS)
    return np.ascontiguousarray(u16.T).astype(np.uint32)


def unpack(arr) -> List[int]:
    """uint32 (8, N) limb array -> list of Python ints (through a
    little-endian byte buffer: one transpose + one int.from_bytes each)."""
    a = np.asarray(arr, dtype=np.uint32)
    if a.ndim == 1:
        a = a[:, None]
    n = a.shape[-1]
    u16 = np.ascontiguousarray((a & LIMB_MASK).T.astype("<u2"))  # (N, 8)
    buf = u16.tobytes()
    return [int.from_bytes(buf[16 * i : 16 * i + 16], "little") for i in range(n)]


def pack_trace(rows: Sequence[Sequence[FieldElement]], num_registers: int) -> np.ndarray:
    """Trace rows -> the limb trace: a ``(num_registers, 8, rows)`` uint32
    array, register s's column packed into slice s."""
    return np.stack([pack([row[s].value for row in rows]) for s in range(num_registers)])


def unpack_trace(trace: np.ndarray) -> List[List[FieldElement]]:
    """The limb trace -> new trace rows (the inverse of :func:`pack_trace`)."""
    columns = [unpack(register) for register in trace]
    return [[FieldElement(v) for v in row] for row in zip(*columns)]


@lru_cache(maxsize=1)
def _b0_table() -> np.ndarray:
    """(256, 4) uint64 digit rows of ``b << 128 mod p`` for each byte b."""
    tab = np.empty((256, 4), np.uint64)
    for b in range(256):
        v = (b << 128) % P
        for i in range(4):
            tab[b, i] = (v >> (32 * i)) & 0xFFFFFFFF
    return tab


def pack_be17(raw: bytes) -> np.ndarray:
    """Concatenated 17-byte big-endian chunks -> (8, N) uint32 limb array
    of ``int.from_bytes(chunk, "big") % P`` per chunk, vectorized.

    Reduction: v = b0 * 2^128 + v0 with b0 the leading byte.  v0 < 2^128
    < 2p needs one conditional subtraction, and b0 * 2^128 mod p comes
    from a 256-entry digit table; their mod-p sum is the canonical
    residue.  The device version is
    :func:`stark_tpu_torch.ops.device_prover.be17_mont`."""
    from .. import hostops as ho

    a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 17)
    n = a.shape[0]
    b0 = a[:, 0]
    le = np.ascontiguousarray(a[:, 1:][:, ::-1])  # v0, little-endian bytes
    d = le.view("<u4")  # (N, 4) 32-bit digits
    v0 = np.ascontiguousarray(d.T).astype(np.uint64)  # (4, N)
    t = np.concatenate([v0, np.zeros((1, n), np.uint64)], axis=0)
    v0c = ho._canonicalize(t)
    term = np.ascontiguousarray(_b0_table()[b0].T)  # (4, N)
    out32 = ho.add(v0c, term)  # canonical (4, N) 32-bit digit rows
    out = np.empty((8, n), np.uint32)
    out[0::2] = (out32 & np.uint64(0xFFFF)).astype(np.uint32)
    out[1::2] = (out32 >> np.uint64(16)).astype(np.uint32)
    return out


def limbs_of(value: int) -> List[int]:
    """Static little-endian 16-bit limbs of a Python int (for constants)."""
    return [(int(value) >> (LIMB_BITS * l)) & LIMB_MASK for l in range(NUM_LIMBS)]


def from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """``(r, n) uint32`` array (JAX-package layout) -> ``int32`` tensor on
    ``device`` with the same bits."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.tensor(a.view(np.int32), device=device)  # a copy: never aliases the caller's array


def seeded_mont(n: int, seed: int) -> np.ndarray:
    """(8, n) uint32 limbs of n seeded canonical Montgomery values, the
    forms of 0, 1 and p - 1 first: a top limb below p's keeps each value
    below p.  Made in bulk with numpy, so large inputs cost no Python ints."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << LIMB_BITS, (NUM_LIMBS, n), dtype=np.uint32)
    limbs[NUM_LIMBS - 1] = rng.integers(0, P >> (LIMB_BITS * (NUM_LIMBS - 1)), n, dtype=np.uint32)
    for i, v in enumerate((0, R_MOD_P, P - R_MOD_P)):
        limbs[:, i] = limbs_of(v)
    return limbs


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
