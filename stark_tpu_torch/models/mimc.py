"""Third model family: MiMC-style cubing-chain STARKs.

Proves knowledge of the result of iterating the keyed cubing map

    x_{i+1} = x_i^3 + k

from a public seed — the classic MiMC/VDF "slow function" AIR
(x^3 is a permutation of GF(p) here because gcd(3, p-1) = 1, exactly the
property Rescue-Prime's S-box relies on; see rescue_prime.py).  The map
is cheap to run forward and expensive to invert, so the proof's value is
certifying a long sequential computation.

Beyond being a recognizable benchmark, this family exercises machinery
the other two models don't:

* ``num_registers = 1`` — exponent vectors of length 3 (x, prev0,
  next0), probing the reference's truncating-zip degree bookkeeping
  (stark.rs:143-167, reproduced in stark.py) at a register count the
  Rescue (m=2) and Fibonacci (2 registers) models never hit;
* a degree-3, x-independent transition constraint at arbitrary trace
  length (Rescue's degree-3 AIR is pinned to 28 cycles; Fibonacci scales
  but is degree 1).

AIR: 1 register, 1 transition constraint in the 3 variables
(x, prev0, next0):

    next0 - prev0^3 - k = 0

Boundary: register 0 at cycle 0 (the seed) and at the last cycle (the
claimed result).

:class:`MimcStark` runs on the CUDA card unless the caller names another
torch device ("cpu" runs the plain versions); ``device=None`` gives the
host prover, with no backend.  ``backend=`` (the JAX models' keyword)
takes a backend in place of ``device``, e.g. a
``stark_tpu_torch.parallel.ShardedBackend`` for a prove over a mesh.  Proofs are byte-identical on all of them
on the same seeded randomness.
"""

from __future__ import annotations

from typing import List, Tuple

from ..field import FieldElement
from ..mpoly import MPolynomial
from ..ops.backend import TorchBackend
from ..rng import RandomBytes, os_random_bytes
from ..stark import BoundaryCondition, Stark

# default round key: a fixed nothing-up-my-sleeve field element (the
# byte-fold reduction of the tag below; FieldElement.sample matches the
# reference's sampler semantics, field.rs:110-116)
DEFAULT_KEY = FieldElement.sample(b"stark_tpu/mimc/round-key/v1")


class MimcAir:
    """Trace generator + AIR for x -> x^3 + k."""

    num_registers = 1

    def __init__(self, num_steps: int, key: FieldElement = DEFAULT_KEY) -> None:
        if num_steps < 1:
            raise ValueError("need at least one step")
        self.num_steps = num_steps
        self.trace_length = num_steps + 1
        self.key = key

    def trace(self, seed: FieldElement) -> List[List[FieldElement]]:
        rows = [[seed]]
        x = seed
        for _ in range(self.num_steps):
            x = x * x * x + self.key
            rows.append([x])
        return rows

    def result(self, seed: FieldElement) -> FieldElement:
        return self.trace(seed)[-1][0]

    def transition_constraints(self) -> List[MPolynomial]:
        _x, prev0, next0 = MPolynomial.variables(3)
        return [next0 - prev0.pow(3) - MPolynomial.constant(self.key.value)]

    def boundary_constraints(
        self, seed: FieldElement, claimed_result: FieldElement
    ) -> List[BoundaryCondition]:
        return [
            (0, 0, seed),
            (self.num_steps, 0, claimed_result),
        ]


class MimcStark:
    """End-to-end pipeline for MiMC cubing-chain proofs."""

    def __init__(
        self,
        num_steps: int,
        key: FieldElement = DEFAULT_KEY,
        *,
        device="cuda",
        backend=None,
        expansion_factor: int = 4,
        num_colinearity_tests: int = 2,
        security_level: int = 2,
        rng: RandomBytes = os_random_bytes,
    ) -> None:
        self.air = MimcAir(num_steps, key)
        self.stark = Stark(
            expansion_factor,
            num_colinearity_tests,
            security_level,
            self.air.num_registers,
            self.air.trace_length,
            backend=backend if backend is not None else None if device is None else TorchBackend(device),
            rng=rng,
            # the degree-3 constraint sits below the reference-style
            # max_degree at most lengths; target the FRI budget so the
            # shifted-term bookkeeping holds at every trace length
            degree_target="fri",
        )
        self._constraints = self.air.transition_constraints()

    def prove(self, seed: FieldElement) -> Tuple[FieldElement, bytes]:
        trace = self.air.trace(seed)
        result = trace[-1][0]
        boundary = self.air.boundary_constraints(seed, result)
        proof = self.stark.prove(trace, self._constraints, boundary)
        return result, proof

    def verify(
        self, seed: FieldElement, claimed_result: FieldElement, proof: bytes
    ) -> bool:
        boundary = self.air.boundary_constraints(seed, claimed_result)
        try:
            return self.stark.verify(proof, self._constraints, boundary)
        except (ValueError, IndexError, KeyError, AssertionError):
            return False
