"""The JAX package's TPU timing probes (``benches/``) on the card, and its
multi-process mesh run.

    python -m stark_tpu_torch.benches.lazy_limb_experiment      # B1: 13-bit lazy limbs
    python -m stark_tpu_torch.benches.quick_timing              # B2: the chained production product, the NTT
    python -m stark_tpu_torch.benches.mont_mul_experiments      # B3: the product's variants
    python -m stark_tpu_torch.benches.merkle_roofline [--out F] # B4: the Merkle roofline
    python -m stark_tpu_torch.benches.multiprocess_mesh         # one mesh over 2 processes (its own docstring)

Each probe module's ``check(device)`` runs its kernels (:mod:`stark_tpu_torch.ops.cuda_probes`;
on CPU tensors their plain versions) at the probe's own seeds and shapes
and holds them bit for bit against their plain versions and Python ints;
``run(device="cuda")`` checks at the full shape, then times the kernels
with CUDA events (:func:`stark_tpu_torch.ops.timing.device_ms`) beside
their plain versions; ``main()`` prints what the JAX script prints, the
card's name and power limit first.  ``run`` measures a card and raises
without one.  Nothing here launches, builds or allocates on import.
"""

from __future__ import annotations

import subprocess

import torch


def card(device) -> torch.device:
    """``device`` if it is a CUDA device torch can use; raises otherwise:
    the probes' numbers are the card's, never a CPU's."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the probes time a CUDA card: got {device!r}, and torch finds "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} CUDA devices")
    return dev


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest limb difference of two int32 tensors of one shape (0: equal)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype mismatch: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
