"""The combination (K11) through the hand-written CUDA kernel.

Counterpart of the jitted ``comb_fn`` of the JAX package's
``DeviceProverCore.combination_fn`` (stark_tpu/ops/device_prover.py:614,
jitted at :695: XLA there, not a Pallas kernel).  From the extended trace
codewords it computes, in one pass over the points, the AIR codewords
(the grouped-monomial evaluation), the transition quotients and the
weighted combination with the x^shift columns; see ``csrc/combination.cu``.

The AIR's ``structure`` (per constraint, a tuple of (state-tail exponent
tuple, group-codeword index)) is encoded once on the host into a
:class:`Program`: the powers of the state columns to build, each a state
column or the square of an earlier power times the column where its
exponent is odd (the JAX function's ``pow_col`` cache), and each
constraint's terms as a group codeword and the power slots it multiplies
in.  :func:`encode` refuses a structure beyond the kernel's limits with
``ValueError``.  :func:`combination_plain` interprets the same program
with :mod:`~stark_tpu_torch.ops.field_ops`, so the CPU tests hold the
encoding too; :func:`combination` runs it for CPU tensors and launches the
kernel for CUDA tensors (or raises).  Outputs agree limb for limb.

``next_cws``, the next-row operand: a prover whose shard of the domain
does not hold the point ``expansion`` steps on (the sharded core,
:mod:`stark_tpu_torch.parallel.stark_sharded`) passes, per trace column,
the next rows of its points as a codeword of their own; the kernel's
next-row instantiation reads them there (counter ``combination_next``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from ..params import NUM_LIMBS
from . import field_ops as fo
from . import kernels

# the kernel's limits (csrc/combination.cu): trace columns, power slots,
# constraints, terms over all constraints, power slots a term, group
# codewords, boundary quotients
MAX_TRACE = 8
MAX_POWERS = 48
MAX_CONSTRAINTS = 8
MAX_TERMS = 64
MAX_FACTORS = 4
MAX_GROUPS = 64
MAX_BQ = 8


@dataclass(frozen=True)
class Program:
    """An encoded combination.

    ``powers``: a (base, mul) pair a slot: base < 0 loads state column
    ``mul`` (column j < w is trace codeword j, column j >= w trace codeword
    j - w at the next row); otherwise the slot is slot ``base`` squared,
    times slot ``mul`` where ``mul`` >= 0.  ``terms``: a (group codeword,
    power slots) pair a term, constraint c's terms ending at
    ``constraint_end[c]``."""

    powers: Tuple[Tuple[int, int], ...]
    terms: Tuple[Tuple[int, Tuple[int, ...]], ...]
    constraint_end: Tuple[int, ...]
    n_state: int  # state columns the structure names: at most 2 w
    n_groups: int  # group codewords it names: the largest index + 1
    n_bq: int
    expansion: int

    @property
    def n_constraints(self) -> int:
        return len(self.constraint_end)


def encode(structure: Sequence, num_bq: int, expansion: int) -> Program:
    """The program of an AIR ``structure`` (see the module docstring) with
    ``num_bq`` boundary quotients and next rows ``expansion`` points on;
    ``ValueError`` beyond the kernel's limits."""
    slots = {}  # (state column, exponent) -> slot
    powers = []

    def slot(i: int, e: int) -> int:
        if (i, e) not in slots:
            entry = (-1, i) if e == 1 else (slot(i, e // 2), slot(i, 1) if e & 1 else -1)
            slots[i, e] = len(powers)
            powers.append(entry)
        return slots[i, e]

    if len(structure) > MAX_CONSTRAINTS:
        raise ValueError(f"{len(structure)} constraints exceed the combination kernel's {MAX_CONSTRAINTS}")
    if not 0 <= num_bq <= MAX_BQ:
        raise ValueError(f"{num_bq} boundary quotients exceed the combination kernel's {MAX_BQ}")
    if expansion < 0:
        raise ValueError(f"negative expansion {expansion}")
    terms, ends, n_state, n_groups = [], [], 0, 0
    for groups in structure:
        for tail, gi in groups:
            if not 0 <= gi < MAX_GROUPS:
                raise ValueError(f"group codeword {gi} is beyond the combination kernel's {MAX_GROUPS}")
            if len(tail) > 2 * MAX_TRACE:
                raise ValueError(f"a tail of {len(tail)} state columns exceeds the combination kernel's "
                                 f"{2 * MAX_TRACE}")
            if any(e < 0 for e in tail):
                raise ValueError(f"negative exponent in {tail}")
            factors = tuple(slot(i, e) for i, e in enumerate(tail) if e)
            if len(factors) > MAX_FACTORS:
                raise ValueError(f"a term of {len(factors)} state powers exceeds the combination kernel's "
                                 f"{MAX_FACTORS}")
            terms.append((gi, factors))
            n_state = max([n_state] + [i + 1 for i, e in enumerate(tail) if e])
            n_groups = max(n_groups, gi + 1)
        ends.append(len(terms))
    if len(terms) > MAX_TERMS:
        raise ValueError(f"{len(terms)} terms exceed the combination kernel's {MAX_TERMS}")
    if len(powers) > MAX_POWERS:
        raise ValueError(f"{len(powers)} state powers exceed the combination kernel's {MAX_POWERS}")
    return Program(tuple(powers), tuple(terms), tuple(ends), n_state, n_groups, num_bq, expansion)


def _check(program: Program, trace_cws, group_cws, tz_invs, rand_cw, bq_cws, weights, tq_shift_tabs,
           bq_shift_tabs, next_cws=None) -> torch.device:
    """The one device of the operands, after checking them against the program."""
    w, nc = len(trace_cws), program.n_constraints
    if next_cws is not None and len(next_cws) != w:
        raise ValueError(f"{len(next_cws)} next-row codewords for {w} trace codewords")
    if not 1 <= w <= MAX_TRACE or program.n_state > 2 * w:
        raise ValueError(f"{w} trace codewords for a program over {program.n_state} state columns")
    if len(group_cws) < program.n_groups or len(group_cws) > MAX_GROUPS:
        raise ValueError(f"{len(group_cws)} group codewords for a program naming {program.n_groups}")
    if len(tz_invs) != nc or len(tq_shift_tabs) != nc:
        raise ValueError(f"{len(tz_invs)} zeroifier inverses and {len(tq_shift_tabs)} shift tables "
                         f"for {nc} constraints")
    if len(bq_cws) != program.n_bq or len(bq_shift_tabs) != program.n_bq:
        raise ValueError(f"{len(bq_cws)} boundary quotients and {len(bq_shift_tabs)} shift tables, "
                         f"expected {program.n_bq}")
    n = int(rand_cw.shape[-1])
    columns = [*trace_cws, *group_cws, *tz_invs, rand_cw, *bq_cws, *tq_shift_tabs, *bq_shift_tabs, *(next_cws or ())]
    for t in columns + [weights]:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != NUM_LIMBS or not t.is_contiguous():
            raise ValueError(f"expected contiguous (8, k) int32 tensors, got {t.dtype} {tuple(t.shape)}")
    if any(int(t.shape[1]) != n for t in columns):
        raise ValueError("codewords of different lengths")
    if int(weights.shape[1]) != 1 + 2 * (nc + program.n_bq):
        raise ValueError(f"{int(weights.shape[1])} weights, expected {1 + 2 * (nc + program.n_bq)}")
    if not 0 <= program.expansion < n:
        raise ValueError(f"expansion {program.expansion} outside [0, {n})")
    devices = {t.device for t in columns + [weights]}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def combination_plain(program: Program, trace_cws, group_cws, tz_invs, rand_cw, bq_cws, weights, tq_shift_tabs,
                      bq_shift_tabs, next_cws=None):
    """K11's plain version: the program interpreted over whole codewords
    with :mod:`~stark_tpu_torch.ops.field_ops`, the next rows from
    ``next_cws`` where given.  Returns (combination, (k, 8, n) stack of
    the transition quotients)."""
    w = len(trace_cws)
    vals = []
    for base, mul in program.powers:
        if base < 0:
            if mul < w:
                v = trace_cws[mul]
            elif next_cws is not None:
                v = next_cws[mul - w]
            else:
                v = torch.roll(trace_cws[mul - w], -program.expansion, dims=-1)
        else:
            v = fo.mont_mul(vals[base], vals[base])
            if mul >= 0:
                v = fo.mont_mul(v, vals[mul])
        vals.append(v)
    comb = fo.mont_mul(weights[:, 0:1], rand_cw)
    tqs, start, k = [], 0, 1
    for c, end in enumerate(program.constraint_end):
        air = None
        for gi, factors in program.terms[start:end]:
            term = group_cws[gi]
            for s in factors:
                term = fo.mont_mul(term, vals[s])
            air = term if air is None else fo.add(air, term)
        if air is None:  # no terms: the zero polynomial
            air = torch.zeros_like(rand_cw)
        start = end
        tqs.append(fo.mont_mul(air, tz_invs[c]))
    for cws, tabs in ((tqs, tq_shift_tabs), (bq_cws, bq_shift_tabs)):
        for q, tab in zip(cws, tabs):
            comb = fo.add(comb, fo.mont_mul(weights[:, k : k + 1], q))
            comb = fo.add(comb, fo.mont_mul(weights[:, k + 1 : k + 2], fo.mont_mul(tab, q)))
            k += 2
    stack = torch.stack(tqs) if tqs else rand_cw.new_zeros((0,) + tuple(rand_cw.shape))
    return comb, stack


class _Params(ctypes.Structure):
    """csrc/combination.cu ``CombParams``, field for field."""

    _fields_ = [
        ("trace", ctypes.c_void_p * MAX_TRACE),
        ("next", ctypes.c_void_p * MAX_TRACE),
        ("groups", ctypes.c_void_p * MAX_GROUPS),
        ("tz_inv", ctypes.c_void_p * MAX_CONSTRAINTS),
        ("tq_shift", ctypes.c_void_p * MAX_CONSTRAINTS),
        ("bq", ctypes.c_void_p * MAX_BQ),
        ("bq_shift", ctypes.c_void_p * MAX_BQ),
        ("rand", ctypes.c_void_p),
        ("weights", ctypes.c_void_p),
        ("comb", ctypes.c_void_p),
        ("tqs", ctypes.c_void_p),
        ("n", ctypes.c_int64),
        ("expansion", ctypes.c_int64),
        ("n_trace", ctypes.c_int32),
        ("n_weights", ctypes.c_int32),
        ("n_powers", ctypes.c_int32),
        ("n_constraints", ctypes.c_int32),
        ("n_bq", ctypes.c_int32),
        ("n_groups", ctypes.c_int32),
        ("pow_base", ctypes.c_int8 * MAX_POWERS),
        ("pow_mul", ctypes.c_int8 * MAX_POWERS),
        ("term_group", ctypes.c_uint8 * MAX_TERMS),
        ("term_slots", (ctypes.c_int8 * MAX_FACTORS) * MAX_TERMS),
        ("constraint_end", ctypes.c_uint8 * MAX_CONSTRAINTS),
    ]


def _params(program: Program, trace_cws, group_cws, tz_invs, rand_cw, bq_cws, weights, tq_shift_tabs,
            bq_shift_tabs, comb, tqs, next_cws=None) -> _Params:
    p = _Params()
    for field, tensors in (("trace", trace_cws), ("groups", group_cws), ("tz_inv", tz_invs),
                           ("tq_shift", tq_shift_tabs), ("bq", bq_cws), ("bq_shift", bq_shift_tabs),
                           ("next", next_cws or ())):
        arr = getattr(p, field)
        for j, t in enumerate(tensors):
            arr[j] = t.data_ptr()
    p.rand, p.weights, p.comb, p.tqs = rand_cw.data_ptr(), weights.data_ptr(), comb.data_ptr(), tqs.data_ptr()
    p.n, p.expansion = int(rand_cw.shape[1]), program.expansion
    p.n_trace, p.n_weights = len(trace_cws), int(weights.shape[1])
    p.n_powers, p.n_constraints, p.n_bq, p.n_groups = (len(program.powers), program.n_constraints, program.n_bq,
                                                       len(group_cws))
    for s, (base, mul) in enumerate(program.powers):
        p.pow_base[s], p.pow_mul[s] = base, mul
    for t, (gi, factors) in enumerate(program.terms):
        p.term_group[t] = gi
        for f in range(MAX_FACTORS):
            p.term_slots[t][f] = factors[f] if f < len(factors) else -1
    for c, end in enumerate(program.constraint_end):
        p.constraint_end[c] = end
    return p


def combination(program: Program, trace_cws, group_cws, tz_invs, rand_cw, bq_cws, weights, tq_shift_tabs,
                bq_shift_tabs, next_cws=None):
    """K11: (combination (8, n), transition quotients (k, 8, n)) of the
    program over the given (8, n) Montgomery codewords and the (8, 1 + 2
    (k + b)) Montgomery weights, the next rows read from ``next_cws``
    where given (one (8, n) codeword a trace column).  One launch on the
    card, the plain interpreter for CPU tensors."""
    args = (trace_cws, group_cws, tz_invs, rand_cw, bq_cws, weights, tq_shift_tabs, bq_shift_tabs)
    dev = _check(program, *args, next_cws)
    if dev.type == "cpu":
        return combination_plain(program, *args, next_cws)
    lib = kernels.library()
    if lib.stark_combination_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError(f"CombParams is {lib.stark_combination_params_size()} bytes in the library, "
                           f"{ctypes.sizeof(_Params)} here")
    n = int(rand_cw.shape[1])
    comb = torch.empty((NUM_LIMBS, n), dtype=torch.int32, device=dev)
    tqs = torch.empty((program.n_constraints, NUM_LIMBS, n), dtype=torch.int32, device=dev)
    params = _params(program, *args, comb, tqs, next_cws)
    kernels.launch("combination" if next_cws is None else "combination_next", "stark_combination",
                   ctypes.addressof(params), device=dev, size=n)
    return comb, tqs
