"""Fibonacci-sequence STARKs proved on a torch device.

:class:`FibonacciStark` is the model of :mod:`stark_tpu.models.fibonacci`
(same AIR, boundary and degree target) with a
:class:`~stark_tpu_torch.stark.TorchStark` behind it, whose backend runs
on the ``device`` the caller names.  Proofs verify with, and are
byte-identical to, the host model's on the same seeded randomness.
"""

from __future__ import annotations

from stark_tpu.models.fibonacci import FibonacciAir
from stark_tpu.models.fibonacci import FibonacciStark as _FibonacciStark
from stark_tpu.rng import RandomBytes, os_random_bytes

from ..ops.backend import TorchBackend
from ..stark import TorchStark


class FibonacciStark(_FibonacciStark):
    """End-to-end Fibonacci proofs on ``device`` ("cuda", "cuda:1", "cpu")."""

    def __init__(
        self,
        num_steps: int,
        *,
        device,
        expansion_factor: int = 4,
        num_colinearity_tests: int = 2,
        security_level: int = 2,
        rng: RandomBytes = os_random_bytes,
    ) -> None:
        self.air = FibonacciAir(num_steps)
        self.stark = TorchStark(
            expansion_factor,
            num_colinearity_tests,
            security_level,
            self.air.num_registers,
            self.air.trace_length,
            backend=TorchBackend(device),
            rng=rng,
            # degree-1 constraints: target the FRI budget (see the host model)
            degree_target="fri",
        )
        self._constraints = self.air.transition_constraints()

    def precompile(self, threads: int = 6):
        """Nothing to compile ahead of time: the CUDA kernels build at first use."""
        return None
