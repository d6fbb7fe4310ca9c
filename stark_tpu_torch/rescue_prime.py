"""Rescue-Prime hash over GF(p) and its AIR (host golden model).

Parameters: m=2, rate=1, capacity=1, N=27 rounds, S-box x^3 / x^{1/3}
(reference: rescue_prime.rs:27-36).  The batched device implementation lives
in :mod:`stark_tpu_torch.ops.rescue`; this module defines scalar semantics, trace
generation, and the AIR (boundary + transition constraints) consumed by the
STARK prover.

Golden vectors (reference: rescue_prime.rs:415-422):
  hash(1) = 244180265933090377212304188905974087294
  hash(57322816861100832358702415967512842988)
         = 89633745865384635541695204788332415101
"""

from __future__ import annotations

from typing import List, Tuple

from .field import FieldElement
from .mpoly import MPolynomial
from .poly import Polynomial
from .params import (
    P,
    RESCUE_ALPHA,
    RESCUE_ALPHA_INV,
    RESCUE_CAPACITY,
    RESCUE_M,
    RESCUE_MDS,
    RESCUE_MDS_INV,
    RESCUE_N,
    RESCUE_RATE,
    RESCUE_ROUND_CONSTANTS,
)

BoundaryCondition = Tuple[int, int, FieldElement]  # (cycle, register, value)


class RescuePrime:
    """Scalar Rescue-Prime permutation + AIR generator."""

    def __init__(self) -> None:
        self.p = P
        self.m = RESCUE_M
        self.rate = RESCUE_RATE
        self.capacity = RESCUE_CAPACITY
        self.N = RESCUE_N
        self.alpha = RESCUE_ALPHA
        self.alpha_inv = RESCUE_ALPHA_INV
        self.MDS = [[c % P for c in row] for row in RESCUE_MDS]
        self.MDS_inv = [[c % P for c in row] for row in RESCUE_MDS_INV]
        self.round_constants = [c % P for c in RESCUE_ROUND_CONSTANTS]

    # -- permutation ------------------------------------------------------

    def _round(self, state: List[int], r: int) -> List[int]:
        """One full round: S-box, MDS, constants; inverse S-box, MDS,
        constants (reference: rescue_prime.rs:180-223)."""
        m, MDS, rc = self.m, self.MDS, self.round_constants
        # forward half-round
        state = [pow(s, self.alpha, P) for s in state]
        state = [
            (sum(MDS[i][j] * state[j] for j in range(m)) + rc[2 * r * m + i]) % P
            for i in range(m)
        ]
        # backward half-round
        state = [pow(s, self.alpha_inv, P) for s in state]
        state = [
            (sum(MDS[i][j] * state[j] for j in range(m)) + rc[2 * r * m + m + i]) % P
            for i in range(m)
        ]
        return state

    def hash(self, input_element: FieldElement) -> FieldElement:
        state = [input_element.value % P] + [0] * (self.m - 1)
        for r in range(self.N):
            state = self._round(state, r)
        return FieldElement(state[0])

    def trace(self, input_element: FieldElement) -> List[List[FieldElement]]:
        """All N+1 states of the permutation as a (N+1) x m trace
        (reference: rescue_prime.rs:230-293)."""
        state = [input_element.value % P] + [0] * (self.m - 1)
        rows = [list(state)]
        for r in range(self.N):
            state = self._round(state, r)
            rows.append(list(state))
        return [[FieldElement(v) for v in row] for row in rows]

    # -- AIR --------------------------------------------------------------

    def boundary_constraints(
        self, output_element: FieldElement
    ) -> List[BoundaryCondition]:
        """(cycle, register, value) triples (reference:
        rescue_prime.rs:296-306): capacity register starts at zero, rate
        register ends at the hash output."""
        return [
            (0, 1, FieldElement.zero()),
            (self.N, 0, output_element),
        ]

    def round_constants_polynomials(
        self, omicron: FieldElement
    ) -> Tuple[List[MPolynomial], List[MPolynomial]]:
        """Interpolants of the two per-round constant vectors over
        {omicron^r, r < N}, lifted into variable 0
        (reference: rescue_prime.rs:309-359)."""
        domain = [omicron.pow(r) for r in range(self.N)]
        first, second = [], []
        for i in range(self.m):
            vals = [
                FieldElement(self.round_constants[2 * r * self.m + i])
                for r in range(self.N)
            ]
            first.append(MPolynomial.lift(Polynomial.lagrange(domain, vals), 0))
        for i in range(self.m):
            vals = [
                FieldElement(self.round_constants[2 * r * self.m + self.m + i])
                for r in range(self.N)
            ]
            second.append(MPolynomial.lift(Polynomial.lagrange(domain, vals), 0))
        return first, second

    def transition_constraints(self, omicron: FieldElement) -> List[MPolynomial]:
        """The AIR: m polynomials in 1 + 2m variables
        (x, prev_0..prev_{m-1}, next_0..next_{m-1}), each asserting one
        register's half-round consistency
        (reference: rescue_prime.rs:363-394):

            MDS . prev^alpha + C1_i(x)  ==  (MDS^-1 . (next - C2(x)))_i^alpha
        """
        first_step, second_step = self.round_constants_polynomials(omicron)
        variables = MPolynomial.variables(1 + 2 * self.m)
        previous_state = variables[1 : 1 + self.m]
        next_state = variables[1 + self.m : 1 + 2 * self.m]
        air = []
        for i in range(self.m):
            lhs = MPolynomial.constant(0)
            for k in range(self.m):
                lhs = lhs + MPolynomial.constant(self.MDS[i][k]) * previous_state[
                    k
                ].pow(self.alpha)
            lhs = lhs + first_step[i]

            rhs = MPolynomial.constant(0)
            for k in range(self.m):
                rhs = rhs + MPolynomial.constant(self.MDS_inv[i][k]) * (
                    next_state[k] - second_step[k]
                )
            rhs = rhs.pow(self.alpha)

            air.append(lhs - rhs)
        return air
