"""Radix-2 NTT over GF(p) in plain PyTorch (stage by stage).

Counterpart of :class:`stark_tpu.ops.ntt.NTTPlan`: ``forward`` maps
Montgomery coefficients (natural order, lowest first) to evaluations at
consecutive powers of the canonical primitive n-th root; the coset
variants evaluate over {offset * omega^i} by pre/post-scaling with a power
table.  One bit-reversal gather, then log2(n) butterfly stages, each a
reshape to (limbs, ..., groups, len) and one batched multiply + add/sub.
Outputs equal the host :class:`stark_tpu.ntt.NTT` exactly.

Large transforms on the card go through the four-step kernels instead
(:mod:`stark_tpu_torch.ops.cuda_ntt`); this plan is the plain version for
every size and the only one below 2^13.
"""

from __future__ import annotations

import threading
from functools import lru_cache

import torch

from ..field import FieldElement
from ..params import NUM_LIMBS, P

from . import field_ops as fo
from .limbs import _bit_reverse_indices, _power_table, mont_tensor


class NTTPlan:
    """Twiddle tables on one device + transforms for one size n."""

    def __init__(self, n: int, device) -> None:
        if n & (n - 1) or n <= 1:
            raise ValueError("NTT size must be a power of 2 and > 1")
        self.n = n
        self.device = torch.device(device)
        self.omega = FieldElement.primitive_nth_root(n).value
        omega_inv = pow(self.omega, -1, P)
        self.bitrev = torch.from_numpy(_bit_reverse_indices(n).astype("int64")).to(self.device)
        self.twiddles_fwd = []
        self.twiddles_inv = []
        length = 2
        while length <= n:
            half = length // 2
            w_f = pow(self.omega, n // length, P)
            w_i = pow(omega_inv, n // length, P)
            self.twiddles_fwd.append(mont_tensor(_power_table(w_f, half), self.device))
            self.twiddles_inv.append(mont_tensor(_power_table(w_i, half), self.device))
            length *= 2
        self.n_inv_mont = mont_tensor([pow(n, -1, P)], self.device)  # (8, 1)
        self._offset_cache = {}
        self._lock = threading.Lock()

    def _offset_tables(self, offset: int):
        key = offset % P
        with self._lock:  # threads sharing the plan build each entry once
            if key not in self._offset_cache:
                self._offset_cache[key] = (
                    mont_tensor(_power_table(key, self.n), self.device),
                    mont_tensor(_power_table(pow(key, -1, P), self.n), self.device),
                )
            return self._offset_cache[key]

    def op_tables(self, inverse: bool, offset: int = 1):
        """Everything :meth:`apply` reads for one transform."""
        tws = self.twiddles_inv if inverse else self.twiddles_fwd
        if offset % P == 1:
            return (tws, None)
        return (tws, self._offset_tables(offset)[1 if inverse else 0])

    def _bshape(self, table: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return table.reshape((NUM_LIMBS,) + (1,) * (like.dim() - 2) + (self.n,))

    def apply(self, a: torch.Tensor, tables, inverse: bool) -> torch.Tensor:
        """Transform along the LAST axis of an (8, *batch, n) Montgomery
        tensor, reading only ``tables`` (from :meth:`op_tables`)."""
        tws, off = tables
        if off is not None and not inverse:
            a = fo.mont_mul(a, self._bshape(off, a))
        x = self._transform(a, tws, inverse)
        if off is not None and inverse:
            x = fo.mont_mul(x, self._bshape(off, x))
        return x

    def _transform(self, a: torch.Tensor, tables, inverse: bool) -> torch.Tensor:
        n = self.n
        x = a[..., self.bitrev]
        lead = x.shape[:-1]
        length = 2
        s = 0
        while length <= n:
            half = length // 2
            xv = x.reshape(NUM_LIMBS, -1, n // length, length)
            tw = tables[s].reshape(NUM_LIMBS, 1, 1, half)
            u = xv[..., :half]
            v = fo.mont_mul(xv[..., half:], tw)
            x = torch.cat([fo.add(u, v), fo.sub(u, v)], dim=-1).reshape(*lead, n)
            length *= 2
            s += 1
        if inverse:
            x = fo.mont_mul(x, self.n_inv_mont.reshape((NUM_LIMBS,) + (1,) * (x.dim() - 1)))
        return x

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        """(8, n) Montgomery coefficients -> evaluations at {omega^i}."""
        return self.apply(a, self.op_tables(False), False)

    def inverse(self, evals: torch.Tensor) -> torch.Tensor:
        """Evaluations at {omega^i} -> Montgomery coefficients."""
        return self.apply(evals, self.op_tables(True), True)

    def coset_forward(self, a: torch.Tensor, offset: int) -> torch.Tensor:
        """Evaluate over {offset * omega^i}: scale coeff j by offset^j, NTT."""
        return self.apply(a, self.op_tables(False, offset), False)

    def coset_inverse(self, evals: torch.Tensor, offset: int) -> torch.Tensor:
        return self.apply(evals, self.op_tables(True, offset), True)


@lru_cache(maxsize=32)
def _plan(n: int, device: str) -> NTTPlan:
    return NTTPlan(n, device)


_PLAN_LOCK = threading.Lock()


def get_plan(n: int, device) -> NTTPlan:
    """Plan for size n on ``device``, cached per (n, device) and built
    once however many threads ask for it."""
    with _PLAN_LOCK:
        return _plan(n, str(torch.device(device)))
