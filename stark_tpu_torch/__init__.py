"""stark_tpu_torch — the STARK/FRI prover of :mod:`stark_tpu` on PyTorch and CUDA.

A port of the JAX package's device-resident prover to one torch device.
The host protocol layers (field, polynomials, Merkle, transcript, FRI and
STARK logic, models) are imported from :mod:`stark_tpu`, which needs no
JAX for them; only what the JAX package couples to JAX is ported here:

* :mod:`stark_tpu_torch.ops` — the limb format, field arithmetic, NTT
  plans, FRI fold, device Merkle trees, the backend seam and the prover
  core; the hand-written CUDA kernels (``csrc/``) are the four-step NTT
  passes and the Blake2b-256 leaf and level kernels;
* :class:`stark_tpu_torch.stark.TorchStark` and
  :class:`stark_tpu_torch.fri.TorchFri` — the protocol overrides;
* :mod:`stark_tpu_torch.models.fibonacci` and :mod:`stark_tpu_torch.cli`.

Nothing in this package imports JAX.  Proofs are byte-identical to the
host prover's on the same seeded randomness.
"""

__version__ = "0.1.0"
