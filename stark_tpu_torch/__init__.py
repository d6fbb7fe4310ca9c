"""stark_tpu_torch — the STARK/FRI prover of :mod:`stark_tpu` on PyTorch and CUDA.

A self-contained port of the JAX package's prover to one torch device: it
imports torch and nothing of ``stark_tpu`` or JAX.

* the host protocol layers — ``params``, ``field``, ``poly``, ``mpoly``,
  ``ntt``, ``geometric``, ``hostops``, ``hashing``, ``merkle``,
  ``serialization``, ``proof_stream``, ``rng``, ``utils`` — and the host
  C library (:mod:`stark_tpu_torch.native`, sources in ``csrc/host/``,
  built with the system C compiler at first use);
* :class:`stark_tpu_torch.stark.Stark` and :class:`stark_tpu_torch.fri.Fri`:
  the host prover and verifier, and with a
  :class:`~stark_tpu_torch.ops.backend.TorchBackend` the device-resident
  prover, whose FRI commit phase runs as the fused cascade with
  Fiat-Shamir on the device;
* :mod:`stark_tpu_torch.ops` — the limb format, plain torch field ops,
  NTT plans, fold, Blake2b tree and Shake256, the backend seam and the
  prover core; the hand-written CUDA kernels (``csrc/*.cu``) are the
  four-step NTT passes, the Blake2b-256 leaf and level kernels, the FRI
  fold, the Fiat-Shamir round, the field vector kernels and the Rescue
  permutation;
* :class:`RescuePrime` (:mod:`stark_tpu_torch.rescue_prime`, the host
  golden model of the hash and its AIR), and the batched permutation
  :mod:`stark_tpu_torch.ops.rescue`, whose kernel is ``csrc/rescue.cu``;
* the models (:mod:`stark_tpu_torch.models`: ``RescueStark``,
  ``FibonacciStark``, ``MimcStark``, ``RescueChainStark``) and
  :mod:`stark_tpu_torch.cli`.

Proofs are byte-identical to the JAX package's host prover on the same
seeded randomness.
"""

from .rescue_prime import RescuePrime

__all__ = ["RescuePrime"]

__version__ = "0.2.0"
