"""Device compute backend wired into the protocol layers.

Counterpart of :class:`stark_tpu.ops.backend.JaxBackend`.  ``TorchBackend``
routes the prover's numeric stages to one explicit torch device:

* ``rs_extend`` / ``rs_restrict`` — coset NTT evaluation / interpolation;
* ``poly_multiply`` — NTT products (trace interpolation chirps);
* ``fri_fold`` — the FRI fold (the K6 kernel on the card);
* ``rescue_hash`` / ``rescue_trace`` — batched Rescue-Prime permutations
  (the R1 kernel on the card), the witnesses of ``RescueStark.prove_batch``;
* ``make_prover_core`` — the device-resident prover core
  (:mod:`stark_tpu_torch.ops.device_prover`).

Below ``min_device_size`` points the host NTT does the work, exactly as in
the JAX backend.  Transforms of 2^13 points and more use the four-step
plan, whose passes are the CUDA kernels on the card and their plain
versions on the CPU; on the card so do the smaller transforms of the
device trace interpolation, down to 64 points (:func:`best_plan`).  The
conversions into and out of Montgomery form and the pointwise products
run on K10 (:mod:`stark_tpu_torch.ops.cuda_field`) on the card.  Results
are bit-equal to the host either way.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..params import P
from . import cuda_field as cf
from . import rescue
from .cuda_fold import fri_fold
from .cuda_ntt import CUDA_NTT_MIN_SIZE, FOUR_STEP_MIN_SIZE, get_cuda_plan
from .limbs import _fold_tables, from_numpy, mont_tensor, pack, to_numpy, unpack
from .ntt import get_plan


def best_plan(n: int, device):
    """Four-step plan (CUDA passes) from 2^13 points; below, the
    stage-by-stage plain plan on the CPU, and on the card the four-step
    plan down to FOUR_STEP_MIN_SIZE (the plain plan's arithmetic would run
    eagerly on the card); smaller transforms raise there."""
    dev = torch.device(device)
    if n >= CUDA_NTT_MIN_SIZE or (dev.type == "cuda" and n >= FOUR_STEP_MIN_SIZE):
        return get_cuda_plan(n, dev)
    if dev.type == "cuda":
        raise ValueError(f"no transform of {n} points on the card: the four-step passes take n >= "
                         f"{FOUR_STEP_MIN_SIZE}")
    return get_plan(n, dev)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch finds no CUDA device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class TorchBackend:
    """Execution of the prover's batched numeric stages on one torch device."""

    #: below this codeword size the host NTT does the work
    min_device_size = 8192

    #: FRI domains at/above this size run the device-resident prover
    #: (stark.Stark._prove_device)
    device_prover_min = 8192

    def __init__(self, device) -> None:
        self.device = resolve_device(device)

    def make_prover_core(self, n: int, offset: int):
        """Device-resident prover core for one FRI domain on this device."""
        from .device_prover import get_core

        return get_core(n, offset, self.device)

    def _upload_mont(self, values: Sequence[int], n: int) -> torch.Tensor:
        padded = list(values) + [0] * (n - len(values))
        return cf.to_mont(from_numpy(pack(padded), self.device))

    def rs_extend(self, coeffs: Sequence[int], n: int, offset: int) -> List[int]:
        """Evaluate the polynomial (coeffs, lowest first) over the coset
        {offset * omega_n^i}; returns n plain residues."""
        if n < self.min_device_size:
            from ..ntt import NTT

            return NTT(n).coset_evaluate(list(coeffs), offset)
        out = best_plan(n, self.device).coset_forward(self._upload_mont(coeffs, n), offset % P)
        return unpack(to_numpy(cf.from_mont(out)))

    def rs_restrict(self, evals: Sequence[int], offset: int) -> List[int]:
        """Inverse of :meth:`rs_extend`: coset evaluations -> coefficients."""
        n = len(evals)
        if n < self.min_device_size:
            from ..ntt import NTT

            return NTT(n).coset_interpolate(list(evals), offset)
        out = best_plan(n, self.device).coset_inverse(self._upload_mont(evals, n), offset % P)
        return unpack(to_numpy(cf.from_mont(out)))

    def poly_multiply(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        """Polynomial product via device NTTs."""
        if not a or not b:
            return []
        result_size = len(a) + len(b) - 1
        n = 1 << (result_size - 1).bit_length()
        if n < self.min_device_size:
            from ..ntt import poly_multiply

            return poly_multiply(list(a), list(b))
        plan = best_plan(n, self.device)
        fa = plan.forward(self._upload_mont(a, n))
        fb = plan.forward(self._upload_mont(b, n))
        prod = plan.inverse(cf.mont_mul(fa, fb))
        return unpack(to_numpy(cf.from_mont(prod)))[:result_size]

    def fri_fold(self, codeword: Sequence[int], alpha: int, offset: int, omega: int) -> List[int]:
        """One FRI fold of a host codeword on the device: plain residues
        in and out."""
        half = len(codeword) // 2
        cw = cf.to_mont(from_numpy(pack(list(codeword)), self.device))
        a = mont_tensor([alpha % P], self.device)
        inv_table = from_numpy(_fold_tables(offset % P, omega % P, half), self.device)
        return unpack(to_numpy(cf.from_mont(fri_fold(cw, a, inv_table))))

    def rescue_hash(self, inputs: Sequence[int]) -> List[int]:
        """Batched Rescue-Prime hashes of ``inputs`` on this device (the
        Rescue permutation kernel on the card)."""
        return rescue.hash_batch(inputs, self.device)

    def rescue_trace(self, inputs: Sequence[int]):
        """Batched Rescue-Prime traces: object array (B, N+1, m) of ints."""
        return rescue.trace_batch(inputs, self.device)
