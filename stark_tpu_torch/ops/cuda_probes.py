"""The TPU timing probes B1-B4 through their hand-written CUDA kernels.

The JAX package times pieces of the prover's arithmetic alone with four
Pallas probes under ``benches/``.  ``csrc/probes.cu`` holds their
counterparts for the card; this module wraps them beside their plain
PyTorch versions:

* :func:`mont13_chain` (B1, ``stark_probe_mont13_chain``; the kernel of
  benches/lazy_limb_experiment.py): 10 chained Montgomery products
  a * t * 2^-130 mod p on 10 limbs of 13 bits with lazy column sums;
* :func:`mont_chain` (B2, ``stark_probe_mont_chain``; the kernel of
  benches/quick_pallas_timing.py ``mont_mul_microbench``): 10 chained
  production products a * t * 2^-128 mod p, the card's ``fe_mul``;
* :func:`mont16_chain` (B3, ``stark_probe_mont16_chain``; the kernel of
  benches/mont_mul_experiments.py): 10 chained ``_mont_mul_variant`` on 8
  limbs of 16 bits in mode ``base``, ``hint16`` or ``xor``;
* :func:`level_stub` and :func:`level_rounds` (B4,
  ``stark_probe_level_stub`` / ``stark_probe_level_rounds``; the kernels
  of benches/merkle_roofline.py): on an (8, w) level of digest words, the
  XOR of each parent's two children's words, or the level hash with its
  compress cut to 1 or 6 rounds (the level kernel's own template); at 12
  rounds, the level hash, :func:`level_rounds` launches the level kernel
  (K5, ``cuda_merkle.merkle_level``).

The chain probes take ``x``, an (L, rows, cols) ``int32`` tensor of limb
planes (L = 10 of 13 bits for B1, 8 of 16 bits for B2 and B3) holding
values below p, and ``t``, an (L, rows, t_cols) tensor with t_cols a power
of two, reused for every block of t_cols columns as the Pallas probes'
``t_spec`` index map (0, 0, 0) reuses it: element (r, c) is multiplied
:data:`N_MULS` times by ``t[:, r, c % t_cols]``.  t's limbs may be drawn
over their full width (t >= p), as the probes draw them.

Each wrapper checks dtype, shape, device and contiguity, runs its plain
version for CPU tensors, and on a CUDA tensor launches its kernel or
raises.  The plain versions repeat the JAX bodies line for line in
``int64``; where those rely on uint32 wrap-around (``(0 - t0) & MASK``,
``(t[i] - need) & MASK``) the mask does the same on ``int64``, and every
other uint32 sum of the bodies stays below 2^32 for limbs in range.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..params import LIMB_BITS, LIMB_MASK, NUM_LIMBS, P, P_TOP
from . import field_ops as fo
from . import kernels
from . import cuda_merkle
from .cuda_field import _device
from .device_merkle import level_hash

#: chained products a launch of B1-B3 (the probes' N_MULS)
N_MULS = 10
#: B1's limbs: 10 of 13 bits (R' = 2^130), and p = 1 + P_LIMB9 * 2^(13 * 9)
W13 = 13
L13 = 10
MASK13 = (1 << W13) - 1
P_LIMB9 = (P - 1) >> (W13 * 9)  # 1628
#: B3's modes, as ``stark_probe_mont16_chain`` numbers them
MODES = {"base": 0, "hint16": 1, "xor": 2}
#: B4's compress lengths (12: the level hash)
ROUNDS = (1, 6, 12)
#: the lengths ``stark_probe_level_rounds`` runs; at 12 B4 runs the level kernel
PROBE_ROUNDS = (1, 6)


def pack13(values: Sequence[int]) -> np.ndarray:
    """Python ints -> (10, N) uint32 array of 13-bit limbs."""
    out = np.zeros((L13, len(values)), np.uint32)
    for i, v in enumerate(values):
        for limb in range(L13):
            out[limb, i] = (int(v) >> (W13 * limb)) & MASK13
    return out


def unpack13(arr) -> List[int]:
    """(10, N) array of 13-bit limbs -> Python ints."""
    arr = np.asarray(arr)
    return [sum(int(arr[limb, i]) << (W13 * limb) for limb in range(L13)) for i in range(arr.shape[1])]


# -- plain versions --------------------------------------------------------------


def mont_mul13_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-130 mod p on (10, ...) tensors of 13-bit limbs (a < p,
    b < 2^130): the CIOS of ``mont_mul13`` with its 26-bit partials summed
    unsplit and one carry sweep, in ``int64``."""
    a, b = fo._wide(a, b)
    zero = torch.zeros_like(a[0])
    t = [zero] * (L13 + 1)
    for i in range(L13):
        bi = b[i]
        for j in range(L13):
            t[j] = t[j] + a[j] * bi
        m = (0 - t[0]) & MASK13  # p == 1 (mod 2^13)
        t[0] = t[0] + m
        t[9] = t[9] + m * P_LIMB9
        carry = t[0] >> W13
        t = t[1:] + [zero]
        t[0] = t[0] + carry
    out = []
    carry = zero
    for limb in t:
        s = limb + carry
        out.append(s & MASK13)
        carry = s >> W13
    out.append(carry)
    p_limbs = [1] + [0] * 8 + [P_LIMB9] + [0] * (len(out) - L13)
    diff = []
    borrow = zero
    for i, limb in enumerate(out):
        need = p_limbs[i] + borrow
        below = (limb < need).to(torch.int64)
        diff.append((limb - need) & MASK13)
        borrow = below
    keep = borrow == 0
    return torch.stack([torch.where(keep, d, o) for d, o in zip(diff[:L13], out[:L13])]).to(torch.int32)


def mont_mul_variant_plain(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``_mont_mul_variant(a, b, mode)`` on (8, ...) tensors of 16-bit
    limbs, in ``int64``: the TPU's CIOS (``base``, a * b * 2^-128 mod p
    for a < p, b < 2^128), with every operand masked to 16 bits
    (``hint16``, the same values), or with every product an XOR (``xor``,
    no field meaning)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")
    a, b = fo._wide(a, b)

    def product(x, y):
        if mode == "xor":
            return x ^ y
        if mode == "hint16":
            return (x & LIMB_MASK) * (y & LIMB_MASK)
        return x * y

    zero = torch.zeros_like(a[0])
    t = [zero] * (NUM_LIMBS + 1)
    for i in range(NUM_LIMBS):
        bi = b[i]
        for j in range(NUM_LIMBS):
            prod = product(a[j], bi)
            t[j] = t[j] + (prod & LIMB_MASK)
            t[j + 1] = t[j + 1] + (prod >> LIMB_BITS)
        m = (0 - t[0]) & LIMB_MASK
        t0 = t[0] + m
        mp = m ^ P_TOP if mode == "xor" else (m & LIMB_MASK) * P_TOP if mode == "hint16" else m * P_TOP
        t[NUM_LIMBS - 1] = t[NUM_LIMBS - 1] + (mp & LIMB_MASK)
        t[NUM_LIMBS] = t[NUM_LIMBS] + (mp >> LIMB_BITS)
        carry = t0 >> LIMB_BITS
        t = t[1:] + [zero]
        t[0] = t[0] + carry
    out = []
    carry = zero
    for limb in t:
        s = limb + carry
        out.append(s & LIMB_MASK)
        carry = s >> LIMB_BITS
    p_limbs = [1] + [0] * 6 + [P_TOP, 0]
    diff = []
    borrow = zero
    for i in range(NUM_LIMBS + 1):
        need = p_limbs[i] + borrow
        below = (out[i] < need).to(torch.int64)
        diff.append((out[i] - need) & LIMB_MASK)
        borrow = below
    keep = borrow == 0
    return torch.stack([torch.where(keep, d, o) for d, o in zip(diff[:NUM_LIMBS], out[:NUM_LIMBS])]).to(torch.int32)


def _t_columns(t: torch.Tensor, cols: int) -> torch.Tensor:
    """t's column c mod t_cols for each of ``cols`` columns."""
    return t[:, :, torch.arange(cols, device=t.device) % t.shape[2]]


def _chain(product, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    tt = _t_columns(t, x.shape[2])
    for _ in range(N_MULS):
        x = product(x, tt)
    return x


def mont13_chain_plain(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """B1's plain version: :data:`N_MULS` chained :func:`mont_mul13_plain`."""
    return _chain(mont_mul13_plain, x, t)


def mont_chain_plain(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """B2's plain version: :data:`N_MULS` chained ``field_ops.mont_mul``."""
    return _chain(fo.mont_mul, x, t)


def mont16_chain_plain(x: torch.Tensor, t: torch.Tensor, mode: str) -> torch.Tensor:
    """B3's plain version: :data:`N_MULS` chained :func:`mont_mul_variant_plain`."""
    return _chain(lambda a, b: mont_mul_variant_plain(a, b, mode), x, t)


def level_stub_plain(level: torch.Tensor) -> torch.Tensor:
    """B4's stub: out[k, i] = level[k, 2i] ^ level[k, 2i + 1]."""
    return (level[:, 0::2] ^ level[:, 1::2]).contiguous()


def level_rounds_plain(level: torch.Tensor, rounds: int) -> torch.Tensor:
    """B4's round probe: the level hash with a ``rounds``-round compress."""
    return level_hash(level, rounds)


# -- the kernels -----------------------------------------------------------------


def _check_chain(name: str, x: torch.Tensor, t: torch.Tensor, limbs: int):
    """(device, rows, cols, t_cols) of a chain probe's operands."""
    for label, v in (("x", x), ("t", t)):
        if v.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {v.dtype}")
        if v.dim() != 3 or v.shape[0] != limbs:
            raise ValueError(f"{name}: {label} must have shape ({limbs}, rows, cols), got {tuple(v.shape)}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    rows, cols, t_cols = (int(d) for d in (x.shape[1], x.shape[2], t.shape[2]))
    if int(t.shape[1]) != rows:
        raise ValueError(f"{name}: t has {t.shape[1]} rows, x {rows}")
    if not 1 <= rows <= 65535 or not 1 <= cols <= 1 << 30:
        raise ValueError(f"{name}: rows must be in [1, 65535] and cols in [1, 2^30], got {rows} x {cols}")
    if t_cols < 1 or t_cols & (t_cols - 1):
        raise ValueError(f"{name}: t's columns must be a power of two, got {t_cols}")
    return _device(name, x, t), rows, cols, t_cols


def mont13_chain(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """B1: x <- x * t * 2^-130 mod p, :data:`N_MULS` times, on (10, rows,
    cols) 13-bit limbs (t: (10, rows, t_cols), reused across columns).
    One element a thread, its limbs in registers."""
    dev, rows, cols, t_cols = _check_chain("mont13_chain", x, t, L13)
    if dev.type == "cpu":
        return mont13_chain_plain(x, t)
    out = torch.empty_like(x)
    kernels.launch("probe_mont13_chain", "stark_probe_mont13_chain", kernels.ptr(x), kernels.ptr(t),
                   kernels.ptr(out), rows, cols, t_cols, device=dev, size=rows * cols)
    return out


def mont_chain(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """B2: x <- x * t * 2^-128 mod p, :data:`N_MULS` times, on (8, rows,
    cols) 16-bit limbs: the card's production product (``fe_mul``)."""
    dev, rows, cols, t_cols = _check_chain("mont_chain", x, t, NUM_LIMBS)
    if dev.type == "cpu":
        return mont_chain_plain(x, t)
    out = torch.empty_like(x)
    kernels.launch("probe_mont_chain", "stark_probe_mont_chain", kernels.ptr(x), kernels.ptr(t), kernels.ptr(out),
                   rows, cols, t_cols, device=dev, size=rows * cols)
    return out


def mont16_chain(x: torch.Tensor, t: torch.Tensor, mode: str) -> torch.Tensor:
    """B3: x <- ``_mont_mul_variant(x, t, mode)``, :data:`N_MULS` times, on
    (8, rows, cols) 16-bit limbs, mode ``base``, ``hint16`` or ``xor``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")
    dev, rows, cols, t_cols = _check_chain("mont16_chain", x, t, NUM_LIMBS)
    if dev.type == "cpu":
        return mont16_chain_plain(x, t, mode)
    out = torch.empty_like(x)
    kernels.launch(f"probe_mont16_chain/{mode}", "stark_probe_mont16_chain", kernels.ptr(x), kernels.ptr(t),
                   kernels.ptr(out), rows, cols, t_cols, MODES[mode], device=dev, size=rows * cols)
    return out


def _level_width(level: torch.Tensor) -> int:
    cuda_merkle._check("level", level, 8)
    w = int(level.shape[1])
    if w < 2 or w % 2:
        raise ValueError(f"level width must be even and >= 2, got {w}")
    return w


def level_stub(level: torch.Tensor) -> torch.Tensor:
    """B4's stub: (8, w) level -> (8, w/2), each parent the XOR of its two
    children's words; the level kernel's grid and I/O with no compress."""
    w = _level_width(level)
    if level.device.type == "cpu":
        return level_stub_plain(level)
    out = torch.empty((8, w // 2), dtype=torch.int32, device=level.device)
    kernels.launch("probe_level_stub", "stark_probe_level_stub", kernels.ptr(level), kernels.ptr(out), w,
                   device=level.device, size=w)
    return out


def level_rounds(level: torch.Tensor, rounds: int) -> torch.Tensor:
    """B4's round probe: (8, w) level -> (8, w/2) parents hashed with a
    compress of ``rounds`` (1, 6 or 12) rounds; at 12 the level hash, by
    the level kernel itself."""
    if rounds not in ROUNDS:
        raise ValueError(f"rounds must be one of {ROUNDS}, got {rounds}")
    w = _level_width(level)
    if level.device.type == "cpu":
        return level_rounds_plain(level, rounds)
    if rounds not in PROBE_ROUNDS:
        return cuda_merkle.merkle_level(level)
    out = torch.empty((8, w // 2), dtype=torch.int32, device=level.device)
    kernels.launch(f"probe_level_rounds/{rounds}", "stark_probe_level_rounds", kernels.ptr(level),
                   kernels.ptr(out), w, rounds, device=level.device, size=w)
    return out
