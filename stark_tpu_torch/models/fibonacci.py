"""Fibonacci-sequence STARKs, proved on a torch device.

Proves knowledge of the n-th element of a Fibonacci-like sequence
(a, b) -> (a + b, a) from public seeds.  The trace length is a free
parameter.

AIR: 2 registers, 2 transition constraints of degree 1 in the 5 variables
(x, prev0, prev1, next0, next1):

    next0 - (prev0 + prev1) = 0
    next1 - prev0 = 0

Boundary: register values at cycle 0 (the seeds) and register 0 at the
last cycle (the claimed result).

:class:`FibonacciStark` runs on the CUDA card unless the caller names
another torch device ("cuda:1", "cpu"); ``device=None`` gives the host
prover, with no backend.  ``backend=`` (the JAX models' keyword)
takes a backend in place of ``device``, e.g. a
``stark_tpu_torch.parallel.ShardedBackend`` for a prove over a mesh.  Proofs are byte-identical across all of them
(and to the JAX package's host prover) on the same seeded randomness.
"""

from __future__ import annotations

from typing import List, Tuple

from ..field import FieldElement
from ..mpoly import MPolynomial
from ..ops.backend import TorchBackend
from ..rng import RandomBytes, os_random_bytes
from ..stark import BoundaryCondition, Stark
from ..utils.profiling import prove_span, span


class FibonacciAir:
    """Trace generator + AIR for (a, b) -> (a + b, a)."""

    num_registers = 2

    def __init__(self, num_steps: int) -> None:
        if num_steps < 1:
            raise ValueError("need at least one step")
        self.num_steps = num_steps
        self.trace_length = num_steps + 1

    def trace(
        self, seed_a: FieldElement, seed_b: FieldElement
    ) -> List[List[FieldElement]]:
        rows = [[seed_a, seed_b]]
        a, b = seed_a, seed_b
        for _ in range(self.num_steps):
            a, b = a + b, a
            rows.append([a, b])
        return rows

    def result(self, seed_a: FieldElement, seed_b: FieldElement) -> FieldElement:
        return self.trace(seed_a, seed_b)[-1][0]

    def transition_constraints(self) -> List[MPolynomial]:
        x, prev0, prev1, next0, next1 = MPolynomial.variables(5)
        return [
            next0 - (prev0 + prev1),
            next1 - prev0,
        ]

    def boundary_constraints(
        self,
        seed_a: FieldElement,
        seed_b: FieldElement,
        claimed_result: FieldElement,
    ) -> List[BoundaryCondition]:
        return [
            (0, 0, seed_a),
            (0, 1, seed_b),
            (self.num_steps, 0, claimed_result),
        ]


class FibonacciStark:
    """End-to-end Fibonacci proofs of any trace length on ``device``."""

    def __init__(
        self,
        num_steps: int,
        *,
        device="cuda",
        backend=None,
        expansion_factor: int = 4,
        num_colinearity_tests: int = 2,
        security_level: int = 2,
        rng: RandomBytes = os_random_bytes,
    ) -> None:
        self.air = FibonacciAir(num_steps)
        self.stark = Stark(
            expansion_factor,
            num_colinearity_tests,
            security_level,
            self.air.num_registers,
            self.air.trace_length,
            backend=backend if backend is not None else None if device is None else TorchBackend(device),
            rng=rng,
            # degree-1 constraints put the reference's max_degree far below
            # the FRI budget; target the budget so FRI colinearity holds
            degree_target="fri",
        )
        self._constraints = self.air.transition_constraints()

    def precompile(self, threads: int = 6):
        """Warm the device prover before the first prove (see
        :meth:`stark_tpu_torch.stark.Stark.precompile`)."""
        zero = FieldElement(0)
        return self.stark.precompile(self._constraints, threads=threads,
                                     boundary=self.air.boundary_constraints(zero, zero, zero))

    def prove(
        self, seed_a: FieldElement, seed_b: FieldElement
    ) -> Tuple[FieldElement, bytes]:
        with prove_span():
            with span("stark.entry.trace"):
                trace = self.air.trace(seed_a, seed_b)
            result = trace[-1][0]
            boundary = self.air.boundary_constraints(seed_a, seed_b, result)
            proof = self.stark.prove(trace, self._constraints, boundary)
        return result, proof

    def verify(
        self,
        seed_a: FieldElement,
        seed_b: FieldElement,
        claimed_result: FieldElement,
        proof: bytes,
    ) -> bool:
        boundary = self.air.boundary_constraints(seed_a, seed_b, claimed_result)
        try:
            return self.stark.verify(proof, self._constraints, boundary)
        except (ValueError, IndexError, KeyError, AssertionError):
            return False
