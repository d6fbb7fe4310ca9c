"""Device compute backend wired into the protocol layers.

Counterpart of :class:`stark_tpu.ops.backend.JaxBackend`.  ``TorchBackend``
routes the prover's numeric stages to one explicit torch device:

* ``rs_extend`` / ``rs_restrict`` — coset NTT evaluation / interpolation;
* ``poly_multiply`` — NTT products (trace interpolation chirps);
* ``fri_fold`` — the FRI fold;
* ``make_prover_core`` — the device-resident prover core
  (:mod:`stark_tpu_torch.ops.device_prover`).

Below ``min_device_size`` points the host NTT does the work, exactly as in
the JAX backend.  Transforms of 2^13 points and more use the four-step
plan, whose passes are the CUDA kernels on the card and their plain
versions on the CPU.  Results are bit-equal to the host either way.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from stark_tpu.ops.limbs import pack, unpack
from stark_tpu.params import P

from . import field_ops as fo
from . import fold as fold_ops
from .cuda_ntt import CUDA_NTT_MIN_SIZE, get_cuda_plan
from .limbs import from_numpy, to_numpy
from .ntt import get_plan


def best_plan(n: int, device):
    """Four-step plan (CUDA passes) from 2^13 points, stage-by-stage below."""
    if n >= CUDA_NTT_MIN_SIZE:
        return get_cuda_plan(n, device)
    return get_plan(n, device)


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
        return fo.to_mont(from_numpy(pack(padded), self.device))

    def rs_extend(self, coeffs: Sequence[int], n: int, offset: int) -> List[int]:
        """Evaluate the polynomial (coeffs, lowest first) over the coset
        {offset * omega_n^i}; returns n plain residues."""
        if n < self.min_device_size:
            from stark_tpu.ntt import NTT

            return NTT(n).coset_evaluate(list(coeffs), offset)
        out = best_plan(n, self.device).coset_forward(self._upload_mont(coeffs, n), offset % P)
        return unpack(to_numpy(fo.from_mont(out)))

    def rs_restrict(self, evals: Sequence[int], offset: int) -> List[int]:
        """Inverse of :meth:`rs_extend`: coset evaluations -> coefficients."""
        n = len(evals)
        if n < self.min_device_size:
            from stark_tpu.ntt import NTT

            return NTT(n).coset_interpolate(list(evals), offset)
        out = best_plan(n, self.device).coset_inverse(self._upload_mont(evals, n), offset % P)
        return unpack(to_numpy(fo.from_mont(out)))

    def poly_multiply(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        """Polynomial product via device NTTs."""
        if not a or not b:
            return []
        result_size = len(a) + len(b) - 1
        n = 1 << (result_size - 1).bit_length()
        if n < self.min_device_size:
            from stark_tpu.ntt import poly_multiply

            return poly_multiply(list(a), list(b))
        plan = best_plan(n, self.device)
        fa = plan.forward(self._upload_mont(a, n))
        fb = plan.forward(self._upload_mont(b, n))
        prod = plan.inverse(fo.mont_mul(fa, fb))
        return unpack(to_numpy(fo.from_mont(prod)))[:result_size]

    def fri_fold(self, codeword: Sequence[int], alpha: int, offset: int, omega: int) -> List[int]:
        return fold_ops.fri_fold(codeword, alpha, offset, omega, self.device)

    def rescue_hash(self, inputs: Sequence[int]) -> List[int]:
        raise NotImplementedError("batched Rescue is not ported to the torch backend yet")

    def rescue_trace(self, inputs: Sequence[int]):
        raise NotImplementedError("batched Rescue is not ported to the torch backend yet")
