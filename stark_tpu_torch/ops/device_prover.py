"""Device-resident prover core: codewords live on one torch device.

Counterpart of :mod:`stark_tpu.ops.device_prover`.  Every prover-side
codeword is an ``(8, n)`` Montgomery limb tensor on the device across the
pipeline

    RS-extension -> AIR evaluation -> transition quotients -> weighted
    combination -> FRI folds

and crosses to the host only as the handful of opened values and
auth-path siblings (batched into one fetch per phase, see
:func:`fetch_absorb`), or as a digit matrix once a codeword is small.
Commitments hash on the device (:mod:`stark_tpu_torch.ops.device_merkle`).

Not in this module yet: the fused FRI commit cascade (``fri_cascade``),
``extend_mont`` (device trace interpolation) and ``extend_codeword_be17``;
the torch prover takes the per-round FRI loop, host interpolation and the
host randomizer pack instead.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from stark_tpu.merkle import MerkleTree
from stark_tpu.ops.limbs import pack
from stark_tpu.params import NUM_LIMBS, P

from . import field_ops as fo
from .backend import best_plan
from .device_merkle import DEVICE_TREE_MIN, TAIL_WIDTH, DeviceMerkleTree, plain_digits
from .fold import fold_mont
from .limbs import from_numpy, mont_tensor, to_numpy


# ---------------------------------------------------------------------------
# digit conversion (device Montgomery limbs <-> host base-2^32 digit rows)
# ---------------------------------------------------------------------------


def mont_to_digits(mont: torch.Tensor) -> np.ndarray:
    """Device (8, n) Montgomery tensor -> host (n, 4) uint32 digit rows —
    the exact input of the native serialize+hash Merkle path."""
    return np.ascontiguousarray(to_numpy(plain_digits(mont)).T)


def digits_value(digits: np.ndarray, i: int) -> int:
    """One digit row -> Python int (for opened leaves / transcripts)."""
    d = digits[i]
    return int(d[0]) | int(d[1]) << 32 | int(d[2]) << 64 | int(d[3]) << 96


class DigitsView:
    """List-of-ints facade over a digit matrix (len / index / iterate)."""

    __slots__ = ("digits",)

    def __init__(self, digits: np.ndarray) -> None:
        self.digits = digits

    def __len__(self) -> int:
        return self.digits.shape[0]

    def __getitem__(self, i: int) -> int:
        return digits_value(self.digits, i)

    def __iter__(self):
        for i in range(len(self)):
            yield digits_value(self.digits, i)


class DeviceCodeword:
    """An (8, n) Montgomery codeword on the device, with a lazily fetched
    host digit matrix and a cache of single opened values."""

    __slots__ = ("mont", "core", "_digits", "_val_cache")

    def __init__(self, mont: torch.Tensor, core: "DeviceProverCore") -> None:
        self.mont = mont
        self.core = core
        self._digits = None
        self._val_cache: Dict[int, int] = {}

    def __len__(self) -> int:
        return int(self.mont.shape[1])

    @property
    def digits(self) -> np.ndarray:
        if self._digits is None:
            self._digits = self.core.to_digits(self.mont)
        return self._digits

    def gather_values_async(self, indices):
        """Gather (without fetching) the digits of the not yet cached
        ``indices``: (index list, (4, K) tensor) or ([], None)."""
        if self._digits is not None:
            return [], None
        idx = sorted({int(i) for i in indices} - self._val_cache.keys())
        if not idx:
            return [], None
        cols = self.mont[:, torch.tensor(idx, device=self.mont.device)]
        return idx, plain_digits(cols)

    def absorb_values(self, idx, digits_cols: np.ndarray) -> None:
        """Fill the value cache from a fetched (4, K) digit gather."""
        d = digits_cols.T
        for row, i in enumerate(idx):
            self._val_cache[i] = digits_value(d, row)

    def prefetch_values(self, indices) -> None:
        """Fetch a handful of leaf values in one transfer."""
        idx, arr = self.gather_values_async(indices)
        if idx:
            self.absorb_values(idx, to_numpy(arr))

    def value(self, i: int) -> int:
        i = int(i)
        if self._digits is None:
            if i not in self._val_cache:
                self.prefetch_values([i])
            return self._val_cache[i]
        return digits_value(self._digits, i)

    def view(self) -> "DeviceCodewordView":
        return DeviceCodewordView(self)


class DeviceCodewordView:
    """List-of-ints facade over a :class:`DeviceCodeword`: single values
    through the gather cache, the full digit matrix only when iterated."""

    __slots__ = ("_dcw",)

    def __init__(self, dcw: DeviceCodeword) -> None:
        self._dcw = dcw

    def __len__(self) -> int:
        return len(self._dcw)

    def __getitem__(self, i: int) -> int:
        return self._dcw.value(i)

    def prefetch(self, indices) -> None:
        self._dcw.prefetch_values(indices)

    def __iter__(self):
        digits = self._dcw.digits  # full fetch: only for small codewords
        for i in range(len(self)):
            yield digits_value(digits, i)


# ---------------------------------------------------------------------------
# geometric tables and batched fetches
# ---------------------------------------------------------------------------


def geometric_table(base: int, start: int, n: int, device) -> torch.Tensor:
    """Montgomery (8, n) table of start * base^i, built on the device from
    the bits of i (log2(n) batched multiplies)."""
    acc = mont_tensor([start % P], device).expand(NUM_LIMBS, n)
    idx = torch.arange(n, device=acc.device)
    for b in range((n - 1).bit_length()):
        factor = mont_tensor([pow(base, 1 << b, P)], device)
        acc = torch.where((((idx >> b) & 1) == 1)[None, :], fo.mont_mul(acc, factor), acc)
    return acc.contiguous()


def fetch_absorb(jobs) -> None:
    """One device fetch for many gathers: ``jobs`` is a sequence of
    ``(tensor, absorb_fn)`` pairs (tensors all (R, K) with one R).  The
    tensors are concatenated along axis 1 and fetched once; each absorb_fn
    gets its column slice in order."""
    jobs = [(a, f) for a, f in jobs if a is not None]
    if not jobs:
        return
    flat = to_numpy(torch.cat([a for a, _ in jobs], dim=1))
    off = 0
    for a, f in jobs:
        k = int(a.shape[1])
        f(flat[:, off : off + k])
        off += k


def pad_rows(arr: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad an (r, K) tensor to (rows, K) so differently shaped
    gathers can share one :func:`fetch_absorb` transfer."""
    r = int(arr.shape[0])
    if r == rows:
        return arr
    return torch.cat([arr, torch.zeros((rows - r,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device)])


def degree_probe_with(core, restrict_iszero_raw, stack: torch.Tensor, tabs=None) -> List[int]:
    """Degrees of a (k, 8, n) stack of codewords with one (k,)-int fetch:
    restrict each to coefficients and reduce max(index of nonzero) on the
    device (the zero polynomial reports 0, the host quirk)."""
    outs = []
    for i in range(int(stack.shape[0])):
        z = restrict_iszero_raw(stack[i], tabs).reshape(-1)
        idx = torch.arange(z.shape[0], device=z.device)
        outs.append(torch.where(z, 0, idx).max())
    return [int(d) for d in torch.stack(outs).cpu()]


# ---------------------------------------------------------------------------
# the core
# ---------------------------------------------------------------------------

_CORE_CACHE: Dict[Tuple[int, int, str], "DeviceProverCore"] = {}
_CORE_CACHE_LOCK = threading.Lock()


def get_core(n: int, offset: int, device) -> "DeviceProverCore":
    """Process-wide DeviceProverCore per (n, offset, device): its tables
    (twiddles, W, coset multipliers, fold and shift tables) depend on
    nothing else, so Stark instances sharing a FRI domain share them."""
    dev = torch.device(device)
    key = (n, offset % P, str(dev))
    with _CORE_CACHE_LOCK:
        core = _CORE_CACHE.get(key)
        if core is None:
            core = _CORE_CACHE[key] = DeviceProverCore(n, offset, dev)
    return core


class DeviceProverCore:
    """Device machinery for one (fri_domain_length, offset, device)."""

    def __init__(self, n: int, offset: int, device) -> None:
        self.n = n
        self.offset = offset % P
        self.device = torch.device(device)
        self.plan = best_plan(n, self.device)
        self._inv_tables: Dict[Tuple[int, int, int], torch.Tensor] = {}
        self._shift_tables: Dict[Tuple[int, int], torch.Tensor] = {}
        self._comb_cache: Dict[tuple, object] = {}
        self._fwd_tabs = self.plan.op_tables(False, self.offset)
        self._inv_tabs = self.plan.op_tables(True, self.offset)

    def _restrict_iszero_raw(self, cw: torch.Tensor, tabs) -> torch.Tensor:
        return fo.is_zero(self.plan.apply(cw, tabs, True))

    # -- RS extension ------------------------------------------------------

    def extend(self, coeffs) -> torch.Tensor:
        """Coefficients (plain ints lowest first, or a packed (8, m) uint32
        limb array) -> (8, n) Montgomery codeword over the coset
        {offset * omega^i}; the zero padding to n happens on the device."""
        packed = coeffs if isinstance(coeffs, np.ndarray) else pack(list(coeffs))
        m = packed.shape[1]
        if m > self.n:
            raise ValueError("coefficient vector longer than the domain")
        dev = from_numpy(packed, self.device)
        if m < self.n:
            dev = torch.cat([dev, torch.zeros((NUM_LIMBS, self.n - m), dtype=torch.int32, device=self.device)], dim=1)
        return self.plan.apply(fo.to_mont(dev), self._fwd_tabs, False)

    def extend_codeword(self, coeffs: Sequence[int]) -> DeviceCodeword:
        return DeviceCodeword(self.extend(coeffs), self)

    def restrict_iszero(self, cw_mont: torch.Tensor) -> np.ndarray:
        """Codeword -> is-zero bitmap of its coefficient vector."""
        return self._restrict_iszero_raw(cw_mont, self._inv_tabs).cpu().numpy()

    def degree_probe(self, stack: torch.Tensor) -> List[int]:
        """Degrees of a (k, 8, n) stack of codewords, one (k,)-int fetch."""
        return degree_probe_with(self, self._restrict_iszero_raw, stack, self._inv_tabs)

    def to_digits(self, mont: torch.Tensor) -> np.ndarray:
        return mont_to_digits(mont)

    def merkle_tree(self, dcw: DeviceCodeword):
        """Merkle commitment over the codeword's bincode leaves: hashed on
        the device for large codewords, by the host's native C over the
        fetched digits below DEVICE_TREE_MIN.  Roots and paths are
        byte-identical either way."""
        if len(dcw) >= max(DEVICE_TREE_MIN, 2 * TAIL_WIDTH) and dcw._digits is None:
            return DeviceMerkleTree(dcw.mont)
        return MerkleTree.from_digits(dcw.digits)

    # -- FRI fold ----------------------------------------------------------

    def _inv_table(self, offset: int, omega: int, half: int) -> torch.Tensor:
        """[(offset * omega^i)^{-1}, i < half] = geometric series with base
        omega^{-1} and start offset^{-1}, built on the device."""
        key = (offset % P, omega % P, half)
        tab = self._inv_tables.get(key)
        if tab is None:
            tab = self._inv_tables[key] = geometric_table(pow(omega, -1, P), pow(offset, -1, P), half, self.device)
        return tab

    def fold(self, dcw: DeviceCodeword, alpha: int, offset: int, omega: int) -> DeviceCodeword:
        """One FRI fold round on the device."""
        inv = self._inv_table(offset, omega, len(dcw) // 2)
        return DeviceCodeword(fold_mont(dcw.mont, mont_tensor([alpha % P], self.device), inv), self)

    # -- x^shift columns ---------------------------------------------------

    def shift_table(self, shift: int, omega: int) -> torch.Tensor:
        """Codeword of x^shift over the coset: offset^shift * omega^(shift*i)."""
        key = (shift, omega % P)
        tab = self._shift_tables.get(key)
        if tab is None:
            tab = self._shift_tables[key] = geometric_table(
                pow(omega, shift, P), pow(self.offset, shift, P), self.n, self.device
            )
        return tab

    # -- batch inversion ---------------------------------------------------

    def inverse(self, mont: torch.Tensor) -> torch.Tensor:
        """Elementwise inversion via Fermat (zero maps to zero)."""
        return fo.mont_inv(mont)

    # -- the combination ---------------------------------------------------

    def combination_fn(self, structure: tuple, num_bq: int, expansion: int):
        """Function computing, from pre-extended trace codewords:

            shifted "next" rows (t(omicron*x_i) = t(x_{i+expansion})) ->
            AIR codewords (grouped-monomial evaluation) -> transition
            quotients (times the inverted zeroifier codeword) -> weighted
            combination with the x^shift columns.

        Returns (combination, stacked transition-quotient codewords).
        ``structure``: per constraint, a tuple of (state-tail exponent
        tuple, group-codeword index)."""
        key = (structure, num_bq, expansion)
        fn = self._comb_cache.get(key)
        if fn is not None:
            return fn

        def comb_fn(trace_cws, group_cws, tz_invs, rand_cw, bq_cws, weights, tq_shift_tabs, bq_shift_tabs):
            next_cws = [torch.roll(cw, -expansion, dims=-1) for cw in trace_cws]
            state = list(trace_cws) + next_cws
            pow_cache: Dict[Tuple[int, int], torch.Tensor] = {}

            def pow_col(i: int, e: int) -> torch.Tensor:
                if e == 1:
                    return state[i]
                if (i, e) not in pow_cache:
                    half = pow_col(i, e // 2)
                    sq = fo.mont_mul(half, half)
                    if e & 1:
                        sq = fo.mont_mul(sq, state[i])
                    pow_cache[(i, e)] = sq
                return pow_cache[(i, e)]

            airs = []
            for groups in structure:
                acc = None
                for tail, gi in groups:
                    term = group_cws[gi]
                    for i, e in enumerate(tail):
                        if e:
                            term = fo.mont_mul(term, pow_col(i, e))
                    acc = term if acc is None else fo.add(acc, term)
                airs.append(acc)

            tqs = [fo.mont_mul(a, tz_invs[i]) for i, a in enumerate(airs)]
            comb = fo.mont_mul(weights[:, 0:1], rand_cw)
            k = 1
            for cws, tabs in ((tqs, tq_shift_tabs), (bq_cws, bq_shift_tabs)):
                for i, cw in enumerate(cws):
                    comb = fo.add(comb, fo.mont_mul(weights[:, k : k + 1], cw))
                    shifted = fo.mont_mul(tabs[i], cw)
                    comb = fo.add(comb, fo.mont_mul(weights[:, k + 1 : k + 2], shifted))
                    k += 2
            return comb, torch.stack(tqs)

        self._comb_cache[key] = comb_fn
        return comb_fn
