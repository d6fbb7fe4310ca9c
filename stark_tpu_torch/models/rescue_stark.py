"""The flagship "model": Rescue-Prime hash-preimage STARK proofs.

High-level pipeline API over the protocol stack — the analogue of the
reference's end-to-end test scenario (reference: stark.rs:730-777) as a
first-class, batchable object:

* ``prove(input)`` — one proof of knowledge of a hash preimage;
* ``prove_batch(inputs)`` — data-parallel batch proving: witness traces
  for ALL instances are generated in one batched device call
  (:mod:`stark_tpu_torch.ops.rescue`, the Rescue permutation kernel on
  the card), then proofs are produced per instance (each proof is an
  independent transcript, as in the reference protocol);
* ``verify(claimed_output, proof)``.

:class:`RescueStark` runs on the CUDA card unless the caller names another
torch device ("cpu" runs the plain versions); ``device=None`` gives the
host prover, with no backend.  ``backend=`` (the JAX models' keyword)
takes a backend in place of ``device``, e.g. a
``stark_tpu_torch.parallel.ShardedBackend`` for a prove over a mesh.  Its 512-point FRI domain lies below the
backend's ``device_prover_min``, so ``prove`` is host work on every
device; ``prove_batch`` takes its witnesses from the device.  Proofs are
byte-identical on all of them on the same seeded randomness.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field import FieldElement
from ..ops.backend import TorchBackend
from ..rescue_prime import RescuePrime
from ..rng import RandomBytes, os_random_bytes
from ..stark import Stark
from ..utils import get_logger

log = get_logger("stark_tpu_torch.models.rescue_stark")


class RescueStark:
    """Proofs of knowledge of Rescue-Prime hash preimages."""

    def __init__(
        self,
        *,
        device="cuda",
        backend=None,
        expansion_factor: int = 4,
        num_colinearity_tests: int = 2,
        security_level: int = 2,
        rng: RandomBytes = os_random_bytes,
    ) -> None:
        self.rescue = RescuePrime()
        self.backend = backend if backend is not None else None if device is None else TorchBackend(device)
        self.stark = Stark(
            expansion_factor,
            num_colinearity_tests,
            security_level,
            self.rescue.m,
            self.rescue.N + 1,
            backend=self.backend,
            rng=rng,
        )
        self._air = self.rescue.transition_constraints(self.stark.omicron)

    # -- single instance --------------------------------------------------

    def hash(self, input_element: FieldElement) -> FieldElement:
        return self.rescue.hash(input_element)

    def prove(self, input_element: FieldElement) -> Tuple[FieldElement, bytes]:
        """Returns (hash output, proof bytes)."""
        output = self.rescue.hash(input_element)
        trace = self.rescue.trace(input_element)
        boundary = self.rescue.boundary_constraints(output)
        proof = self.stark.prove(trace, self._air, boundary)
        return output, proof

    def verify(self, claimed_output: FieldElement, proof: bytes) -> bool:
        boundary = self.rescue.boundary_constraints(claimed_output)
        try:
            return self.stark.verify(proof, self._air, boundary)
        except (ValueError, IndexError, KeyError, AssertionError) as exc:
            # crafted proofs must yield a clean rejection, never a crash
            log.debug("proof rejected while parsing: %s", exc)
            return False

    # -- batch ------------------------------------------------------------

    def prove_batch(
        self, inputs: Sequence[FieldElement]
    ) -> List[Tuple[FieldElement, bytes]]:
        """Prove many instances; witness generation is batched on the
        device when there is a backend.  Each proof is an independent
        Fiat-Shamir transcript, exactly as in the reference protocol —
        there is no cross-instance aggregation, so instances can also be
        distributed across processes/hosts by the caller."""
        inputs = list(inputs)
        if self.backend is not None and len(inputs) > 1:
            raw = self.backend.rescue_trace([x.value for x in inputs])
            traces = [
                [
                    [FieldElement(raw[i, c, r]) for r in range(self.rescue.m)]
                    for c in range(self.rescue.N + 1)
                ]
                for i in range(len(inputs))
            ]
        else:
            traces = [self.rescue.trace(x) for x in inputs]

        results = []
        for trace in traces:
            output = FieldElement(trace[-1][0].value)
            boundary = self.rescue.boundary_constraints(output)
            proof = self.stark.prove(trace, self._air, boundary)
            results.append((output, proof))
        return results
