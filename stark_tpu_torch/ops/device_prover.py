"""Device-resident prover core: codewords live on one torch device.

Counterpart of :mod:`stark_tpu.ops.device_prover`.  Every prover-side
codeword is an ``(8, n)`` Montgomery limb tensor on the device across the
pipeline

    RS-extension -> AIR evaluation -> transition quotients -> weighted
    combination -> FRI folds

and crosses to the host only as the handful of opened values and
auth-path siblings (batched into one fetch per phase, see
:func:`fetch_absorb`), or as a digit matrix once a codeword is small.
Commitments hash on the device (:mod:`stark_tpu_torch.ops.device_merkle`);
the large FRI rounds run as the fused commit cascade
(:meth:`DeviceProverCore.fri_cascade`), with Fiat-Shamir on the device.

Coefficients that never lived on the host (device trace interpolation,
:mod:`stark_tpu_torch.ops.geometric_device`) extend through
:meth:`DeviceProverCore.extend_mont`.  Power tables, inversions and the
conversions into Montgomery form run through the field vector kernels
(:mod:`stark_tpu_torch.ops.cuda_field`: K9, K7 and K10 on the card), the
combination through K11 (:mod:`stark_tpu_torch.ops.cuda_combination`),
the conversion out of it through ``mont_digits``
(:func:`stark_tpu_torch.ops.cuda_merkle.mont_digits`; an opening gather
is one launch of its gather form).  No function of
:mod:`stark_tpu_torch.ops.field_ops` runs on a CUDA tensor here.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..merkle import MerkleTree
from ..params import NUM_LIMBS, P
from . import cuda_combination, cuda_field, device_merkle
from . import field_ops as fo
from .backend import best_plan
from .cuda_fold import fri_fold
from .cuda_fs import fs_round
from .cuda_merkle import mont_digits
from .device_fs import APPENDED_BYTES
from .device_merkle import TAIL_WIDTH, DeviceMerkleTree, tree_arrays_with_root
from .limbs import from_numpy, mont_tensor, pack, to_numpy


# ---------------------------------------------------------------------------
# digit conversion (device Montgomery limbs <-> host base-2^32 digit rows)
# ---------------------------------------------------------------------------


def mont_to_digits(mont: torch.Tensor) -> np.ndarray:
    """Device (8, n) Montgomery tensor -> host (n, 4) uint32 digit rows —
    the exact input of the native serialize+hash Merkle path."""
    return np.ascontiguousarray(to_numpy(mont_digits(mont.contiguous())).T)


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
        # codeword length in either layout: (8, n) on one device, or a
        # sharded (8, a, b) whose global array flattens to natural order
        n = 1
        for d in self.mont.shape[1:]:
            n *= int(d)
        return n

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
        if isinstance(self.mont, torch.Tensor):
            return idx, mont_digits(self.mont, idx)
        return self.core.gather_values(self.mont, idx)  # a sharded layout: the core's gathers

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
    the bit bases base^(2^b), made on the host (K9 on the card)."""
    bit_bases = mont_tensor([pow(base, 1 << b, P) for b in range((n - 1).bit_length())], device)
    return cuda_field.geometric_table(mont_tensor([start % P], device), bit_bases, n)


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


#: device -> the (8, 256) Montgomery table of b * 2^128 mod p, b < 256
_B0_TABLES: Dict[torch.device, torch.Tensor] = {}
_B0_LOCK = threading.Lock()


def be17_mont(raw: bytes, device) -> torch.Tensor:
    """Concatenated 17-byte big-endian chunks -> (8, N) Montgomery limbs of
    ``int.from_bytes(chunk, "big") % p`` on ``device``: the Montgomery form
    of :func:`stark_tpu_torch.ops.limbs.pack_be17`'s values.  The host
    only splits bytes into 32-bit digits (half the bytes of the limbs to
    upload); v = b0 * 2^128 + v0 with b0 the leading byte, and on the
    device v0 goes into Montgomery form by one K10 product by R^2
    (canonical for any v0 < 2^128, so no subtraction first), then one K10
    sum adds the Montgomery form of b0 * 2^128 mod p from a 256-entry
    table."""
    a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 17)
    dev = torch.device(device)
    b0 = torch.from_numpy(a[:, 0].astype(np.int64)).to(dev)
    le = np.ascontiguousarray(a[:, 1:][:, ::-1])
    digits = from_numpy(np.ascontiguousarray(le.view("<u4").T), dev).to(torch.int64) & 0xFFFFFFFF
    v0 = torch.stack([digits[k // 2] >> (16 * (k % 2)) & 0xFFFF for k in range(NUM_LIMBS)]).to(torch.int32)
    with _B0_LOCK:
        table = _B0_TABLES.get(dev)
        if table is None:
            table = _B0_TABLES[dev] = mont_tensor([(b << 128) % P for b in range(256)], dev)
    return cuda_field.add(cuda_field.to_mont(v0), table[:, b0].contiguous())


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
    """Device machinery for one (fri_domain_length, offset, device).  Its
    table caches are filled under one lock, so threads that share the
    core (a service's requests, ``Stark.precompile``'s pool) build each
    entry once."""

    def __init__(self, n: int, offset: int, device) -> None:
        self.n = n
        self.offset = offset % P
        self.device = torch.device(device)
        self.plan = best_plan(n, self.device)
        self._inv_tables: Dict[Tuple[int, int, int], torch.Tensor] = {}
        self._shift_tables: Dict[Tuple[int, int], torch.Tensor] = {}
        self._comb_cache: Dict[tuple, object] = {}
        self._lock = threading.RLock()
        self._fwd_tabs = self.plan.op_tables(False, self.offset)
        self._inv_tabs = self.plan.op_tables(True, self.offset)

    def _restrict_iszero_raw(self, cw: torch.Tensor, tabs) -> torch.Tensor:
        return fo.is_zero(self.plan.apply(cw, tabs, True))

    # -- RS extension ------------------------------------------------------

    def extend(self, coeffs) -> torch.Tensor:
        """Coefficients (plain ints lowest first, a packed (8, m) uint32
        limb array, or an (8, m) int32 plain limb tensor on the device) ->
        (8, n) Montgomery codeword over the coset {offset * omega^i}.  The
        m coefficients go into Montgomery form on the device (one K10
        product by R^2), then :meth:`extend_mont` pads them to n there."""
        if isinstance(coeffs, torch.Tensor):
            dev = coeffs.to(self.device)
        else:
            packed = coeffs if isinstance(coeffs, np.ndarray) else pack(list(coeffs))
            dev = from_numpy(packed, self.device)
        m = int(dev.shape[1])
        if m > self.n:
            raise ValueError("coefficient vector longer than the domain")
        if m == 0:  # the zero polynomial
            return torch.zeros((NUM_LIMBS, self.n), dtype=torch.int32, device=self.device)
        return self.extend_mont(cuda_field.to_mont(dev.contiguous()))

    def extend_mont(self, coeffs_mont: torch.Tensor) -> torch.Tensor:
        """Montgomery coefficients (8, m) on the device -> (8, n) codeword
        over the coset: the RS-extension of coefficients that never lived
        on the host (device trace interpolation), zero-padded to n."""
        m = int(coeffs_mont.shape[1])
        if m > self.n:
            raise ValueError("coefficient vector longer than the domain")
        dev = coeffs_mont.to(self.device)
        if m < self.n:
            dev = torch.cat([dev, torch.zeros((NUM_LIMBS, self.n - m), dtype=torch.int32, device=self.device)], dim=1)
        return self.plan.apply(dev, self._fwd_tabs, False)

    def extend_codeword(self, coeffs: Sequence[int]) -> DeviceCodeword:
        return DeviceCodeword(self.extend(coeffs), self)

    def extend_codeword_be17(self, raw: bytes) -> DeviceCodeword:
        """Randomizer path: concatenated 17-byte big-endian rng chunks ->
        extended codeword, with the mod-p reduction into Montgomery form on
        the device (:func:`be17_mont`; same codeword as
        ``extend_codeword(pack_be17(raw))``)."""
        return DeviceCodeword(self.extend_mont(be17_mont(raw, self.device)), self)

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
        if len(dcw) >= max(device_merkle.DEVICE_TREE_MIN, 2 * TAIL_WIDTH) and dcw._digits is None:
            return DeviceMerkleTree(dcw.mont)
        return MerkleTree.from_digits(dcw.digits)

    # -- FRI fold ----------------------------------------------------------

    def _inv_table(self, offset: int, omega: int, half: int) -> torch.Tensor:
        """[(offset * omega^i)^{-1}, i < half] = geometric series with base
        omega^{-1} and start offset^{-1}, built on the device."""
        key = (offset % P, omega % P, half)
        with self._lock:
            tab = self._inv_tables.get(key)
            if tab is None:
                tab = self._inv_tables[key] = geometric_table(pow(omega, -1, P), pow(offset, -1, P), half,
                                                              self.device)
        return tab

    def fold(self, dcw: DeviceCodeword, alpha: int, offset: int, omega: int) -> DeviceCodeword:
        """One FRI fold round on the device (the K6 kernel on the card)."""
        inv = self._inv_table(offset, omega, len(dcw) // 2)
        alpha_mont = mont_tensor([alpha % P], self.device)
        return DeviceCodeword(fri_fold(dcw.mont.contiguous(), alpha_mont, inv), self)

    # -- fused FRI commit cascade (on-device Fiat-Shamir) -------------------

    def fri_cascade(self, mont: torch.Tensor, prefix_body: bytes, count0: int, offset: int, omega: int,
                    rounds: int):
        """``rounds`` fused FRI commit rounds.  Per round, on the device's
        current stream: Merkle tree to the root (K4, K5) -> ``fs_round``
        (bincode hex root appended to the transcript body, Shake256
        Fiat-Shamir, fold challenge alpha) -> ``fri_fold`` (K6).  Nothing
        waits for the device until the caller fetches the stacked roots
        once; the fold tables are built before the first round enqueues.

        ``prefix_body`` is the serialized proof stream WITHOUT its leading
        u64 count (the count changes with every push, so round r hashes
        with ``count0 + r + 1``); transcript semantics are the reference's
        exactly (proof_stream.rs:36-58, fri.rs:100-146).

        Returns ``(per_round, roots, final_mont)``: ``per_round[r]`` is
        ``(codeword_mont_r, tree_levels_r)``, ``roots`` an (rounds, 8)
        int32 tensor of root words, ``final_mont`` the codeword after the
        last fused fold."""
        n0 = int(mont.shape[1])
        tables = []
        o, w = offset % P, omega % P
        for r in range(rounds):
            tables.append(self._inv_table(o, w, (n0 >> r) // 2))
            o, w = o * o % P, w * w % P
        body = torch.zeros(len(prefix_body) + APPENDED_BYTES * rounds, dtype=torch.uint8, device=self.device)
        body[: len(prefix_body)] = torch.from_numpy(np.frombuffer(prefix_body, dtype=np.uint8).copy())
        body_len = len(prefix_body)
        cur = mont.contiguous()
        per_round = []
        roots = []
        for r in range(rounds):
            levels, root = tree_arrays_with_root(cur, n0 >> r)
            alpha = fs_round(body, body_len, count0 + r + 1, root.contiguous())
            body_len += APPENDED_BYTES
            per_round.append((cur, levels))
            roots.append(root)
            cur = fri_fold(cur, alpha, tables[r])
        return tuple(per_round), torch.stack(roots), cur

    # -- x^shift columns ---------------------------------------------------

    def shift_table(self, shift: int, omega: int) -> torch.Tensor:
        """Codeword of x^shift over the coset: offset^shift * omega^(shift*i)."""
        key = (shift, omega % P)
        with self._lock:
            tab = self._shift_tables.get(key)
            if tab is None:
                tab = self._shift_tables[key] = geometric_table(
                    pow(omega, shift, P), pow(self.offset, shift, P), self.n, self.device
                )
        return tab

    # -- batch inversion ---------------------------------------------------

    def inverse(self, mont: torch.Tensor) -> torch.Tensor:
        """Elementwise inversion, zero to zero: K7 on the card (a batch
        inversion a block of 2048 elements), the plain batch inversion of
        ``field_ops.mont_inv`` on the CPU."""
        return cuda_field.mont_inv(mont.contiguous())

    # -- the combination ---------------------------------------------------

    def combination_fn(self, structure: tuple, num_bq: int, expansion: int):
        """Function computing, from pre-extended trace codewords:

            shifted "next" rows (t(omicron*x_i) = t(x_{i+expansion})) ->
            AIR codewords (grouped-monomial evaluation) -> transition
            quotients (times the inverted zeroifier codeword) -> weighted
            combination with the x^shift columns.

        Returns (combination, stacked transition-quotient codewords).
        ``structure``: per constraint, a tuple of (state-tail exponent
        tuple, group-codeword index), encoded once a key into a
        :class:`~stark_tpu_torch.ops.cuda_combination.Program` (a
        ``ValueError`` beyond the kernel's limits); the function runs it as
        one K11 launch on the card, its plain interpreter on the CPU."""
        key = (structure, num_bq, expansion)
        with self._lock:
            fn = self._comb_cache.get(key)
            if fn is None:
                program = cuda_combination.encode(structure, num_bq, expansion)
                fn = self._comb_cache[key] = functools.partial(cuda_combination.combination, program)
        return fn
