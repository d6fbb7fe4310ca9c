"""Fourth model family: Rescue-Prime HASH-CHAIN STARKs.

Proves that ``hash^L(input) == output`` for the Rescue-Prime hash — a
chain of L permutations certified by ONE proof over one trace, the
classic STARK workload (hash-chain / VDF certification).  The reference
can only prove a single 28-cycle permutation (rescue_prime.rs:230-293
hard-wires one segment); this model chains arbitrarily many through the
framework's per-constraint ``transition_exemptions``.

Trace: ``28 * L`` rows of the m=2 Rescue state; segment k (rows
``28k .. 28k+27``) holds the permutation states for input ``h_k``, and
``h_{k+1} = state[0]`` of its last row.

AIR — four constraints in two groups with complementary exemption sets:

* the 2 Rescue round constraints (reference semantics
  rescue_prime.rs:363-394), EXEMPT on the segment-crossing transitions
  ``{28k+27}``.  Their round-constant interpolants are periodic with
  period 28 over the whole trace domain (degree ~28L instead of the
  reference's 26), so the S-box cube lifts x-degrees up to ``3*(28L-2)``
  — the model enlarges ``omicron_domain_length`` when that outruns the
  reference's 2x-trace sizing (stark.rs:53-55).
* 2 chain-link constraints active ONLY on the crossings (exempt
  everywhere else): ``next0 - prev0`` (the squeezed digest is
  re-absorbed as the next segment's rate register) and ``next1`` (the
  capacity register resets to zero, exactly the fresh-hash initial
  state of rescue_prime.rs:174).

Boundary: register 1 is 0 at cycle 0 (capacity starts clean) and
register 0 at the last cycle is the claimed chain output.  The chain
INPUT is intentionally *not* a boundary condition, mirroring the
reference's hash-preimage statement (rescue_prime.rs:296-306): the proof
certifies knowledge of a preimage whose L-fold hash is the public
output.  Callers wanting a public-input VDF statement can add
``(0, 0, input)`` to the boundary themselves.

Symbolic-blowup note: the constraint is assembled directly in grouped
monomial form — cubing ``(A - D(x))`` with A register-linear and D the
degree-~28L constant interpolant via three univariate NTT products —
because ``MPolynomial.pow(3)`` on a 28L-term dict would be O(T^2).

A prove builds the trace in limb form (:meth:`RescueChainAir.trace_limbs`),
never as rows of :class:`FieldElement`.

:class:`RescueChainStark` runs on the CUDA card unless the caller names
another torch device ("cpu" runs the plain versions); ``device=None``
gives the host prover, with no backend.  ``backend=`` (the JAX models' keyword)
takes a backend in place of ``device``, e.g. a
``stark_tpu_torch.parallel.ShardedBackend`` for a prove over a mesh.  From 4096 hashes on its FRI
domain is 2^20 points, and the prove is the device-resident pipeline.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..field import FieldElement
from ..mpoly import MPolynomial
from ..ntt import poly_square_and_cube
from ..ops.backend import TorchBackend
from ..ops.limbs import pack_trace, unpack
from ..params import RESCUE_N
from ..poly import Polynomial
from ..rescue_prime import RescuePrime
from ..rng import RandomBytes, os_random_bytes
from ..stark import BoundaryCondition, Stark
from ..utils.profiling import Timer, prove_span, span

SEGMENT_ROWS = RESCUE_N + 1  # 28 states per permutation

_NATIVE = None
_NATIVE_TRIED = False


def _native_rescue():
    """The C chain kernel module, or None (the host library does not
    build or load -> Python golden model)."""
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        try:
            from ..native import rescue_native

            _NATIVE = rescue_native
        except ImportError:
            _NATIVE = None
    return _NATIVE


class RescueChainAir:
    """Trace generator + AIR for a chain of L Rescue-Prime hashes."""

    num_registers = 2

    def __init__(self, num_hashes: int) -> None:
        if num_hashes < 1:
            raise ValueError("need at least one hash in the chain")
        self.num_hashes = num_hashes
        self.trace_length = SEGMENT_ROWS * num_hashes
        self.rp = RescuePrime()
        #: crossing transitions: row 28k+27 -> row 28k+28
        self.crossings = [
            SEGMENT_ROWS * (k + 1) - 1 for k in range(num_hashes - 1)
        ]

    # -- witness ------------------------------------------------------------

    def chain(self, input_element: FieldElement) -> FieldElement:
        native = _native_rescue()
        if native is not None:
            out = native.chain_trace(input_element.value, self.num_hashes)
            return FieldElement(int(out[-1][0]))
        h = input_element
        for _ in range(self.num_hashes):
            h = self.rp.hash(h)
        return h

    def trace(self, input_element: FieldElement) -> List[List[FieldElement]]:
        native = _native_rescue()
        if native is not None:
            # two-limb Montgomery C kernel (csrc/host/rescue.c): bit-identical
            # rows, far faster than the CPython big-int chain at L=4096
            # (the chain is sequential — device batching can't apply)
            with span("stark.entry.trace/witness"):
                out = native.chain_trace(input_element.value, self.num_hashes)
            return [[FieldElement(a), FieldElement(b)] for a, b in out]
        rows: List[List[FieldElement]] = []
        h = input_element
        for _ in range(self.num_hashes):
            seg = self.rp.trace(h)  # 28 rows
            rows.extend(seg)
            h = seg[-1][0]
        return rows

    def trace_limbs(self, input_element: FieldElement) -> np.ndarray:
        """The trace of :meth:`trace` in limb form, a (2, 8, trace_length)
        uint32 array (:func:`stark_tpu_torch.ops.limbs.pack_trace`): the C
        chain's words reshaped by numpy, with no Python int a value; the
        Python golden model's rows packed where the library does not build."""
        native = _native_rescue()
        if native is None:
            return pack_trace(self.trace(input_element), self.num_registers)
        with span("stark.entry.trace/witness"):
            pairs = native.chain_limb_pairs(input_element.value, self.num_hashes)
        return native.trace_limbs(pairs)

    # -- AIR ------------------------------------------------------------------

    def boundary_constraints(
        self, output_element: FieldElement
    ) -> List[BoundaryCondition]:
        return [
            (0, 1, FieldElement.zero()),
            (self.trace_length - 1, 0, output_element),
        ]

    def _periodic_constant_polys(
        self, stark: Stark
    ) -> Tuple[List[Polynomial], List[Polynomial]]:
        """C1_i(x), C2_i(x): interpolants over {omicron^c, c < T-1} of the
        period-28 round-constant schedule (value at a crossing cycle is a
        free choice — the round constraints are exempt there; 0 is used).
        Chirp interpolation via Polynomial.lagrange's geometric dispatch
        keeps this O(T log T)."""
        rp = self.rp
        m, n_rounds = rp.m, rp.N
        t = self.trace_length - 1  # number of transitions
        domain = stark.omicron_domain[:t]
        first, second = [], []
        for i in range(m):
            v1 = [0] * t
            v2 = [0] * t
            for c in range(t):
                r = c % SEGMENT_ROWS
                if r < n_rounds:
                    v1[c] = rp.round_constants[2 * r * m + i]
                    v2[c] = rp.round_constants[2 * r * m + m + i]
            first.append(
                Polynomial.lagrange(domain, [FieldElement(v) for v in v1])
            )
            second.append(
                Polynomial.lagrange(domain, [FieldElement(v) for v in v2])
            )
        return first, second

    def transition_constraints(self, stark: Stark, prof: Timer) -> List[MPolynomial]:
        """[rescue_0, rescue_1, link_0, link_1] — pair with
        :meth:`transition_exemptions`.  The build's parts are regions of
        ``prof``: ``periodic`` (the four round-constant interpolants),
        ``square_cube`` (``poly_square_and_cube``) and ``assemble`` (the
        rest: the ``MPolynomial`` arithmetic).

        rescue_i (reference semantics rescue_prime.rs:363-394):

            sum_k MDS[i][k] prev_k^3 + C1_i(x)
              - (A_i - D_i(x))^3  == 0,
            A_i = sum_k MDSinv[i][k] next_k,
            D_i = sum_k MDSinv[i][k] C2_k(x)

        expanded as A^3 - 3A^2 D + 3A D^2 - D^3 with D^2, D^3 computed by
        univariate NTT products, so the dict stays O(T) instead of the
        O(T^2) a symbolic ``pow(3)`` would cost.
        """
        rp = self.rp
        m = rp.m
        with prof.region("periodic"):
            first, second = self._periodic_constant_polys(stark)
        variables = MPolynomial.variables(1 + 2 * m)
        prev = variables[1 : 1 + m]
        nxt = variables[1 + m : 1 + 2 * m]

        constraints: List[MPolynomial] = []
        for i in range(m):
            with prof.region("assemble"):
                lhs = MPolynomial.constant(0)
                for k in range(m):
                    lhs = lhs + MPolynomial.constant(rp.MDS[i][k]) * prev[k].pow(3)
                lhs = lhs + MPolynomial.lift(first[i], 0)

                a_lin = MPolynomial.constant(0)
                d_poly = Polynomial.zero()
                for k in range(m):
                    a_lin = a_lin + MPolynomial.constant(rp.MDS_inv[i][k]) * nxt[k]
                    d_poly = d_poly + second[k].scale(rp.MDS_inv[i][k])
            with prof.region("square_cube"):
                sq_c, cu_c = poly_square_and_cube(d_poly.coeffs)
            with prof.region("assemble"):
                d_sq, d_cu = Polynomial(sq_c), Polynomial(cu_c)

                # (A - D)^3 = A^3 - 3 A^2 D + 3 A D^2 - D^3
                rhs = a_lin.pow(3)
                rhs = rhs - MPolynomial.constant(3) * a_lin.pow(2) * MPolynomial.lift(
                    d_poly, 0
                )
                rhs = rhs + MPolynomial.constant(3) * a_lin * MPolynomial.lift(
                    d_sq, 0
                )
                rhs = rhs - MPolynomial.lift(d_cu, 0)

                constraints.append(lhs - rhs)

        # chain links: digest carries, capacity resets
        constraints.append(nxt[0] - prev[0])
        constraints.append(nxt[1])
        return constraints

    def transition_exemptions(self) -> List[List[int]]:
        """Per-constraint exemption lists matching
        :meth:`transition_constraints`: rescue constraints skip the
        crossings; link constraints hold ONLY there."""
        crossing_set = set(self.crossings)
        non_crossings = [
            c for c in range(self.trace_length - 1) if c not in crossing_set
        ]
        return [
            self.crossings,
            self.crossings,
            non_crossings,
            non_crossings,
        ]


class RescueChainStark:
    """End-to-end pipeline for Rescue-Prime hash-chain proofs."""

    #: the AIR build's regions (``periodic``, ``square_cube``,
    #: ``assemble``), summed over the process's builds (:attr:`constraints`),
    #: so that code without the model, as a benchmark's reader, finds them
    air_profile = Timer("air")

    def __init__(
        self,
        num_hashes: int,
        *,
        device="cuda",
        backend=None,
        expansion_factor: int = 4,
        num_colinearity_tests: int = 2,
        security_level: int = 2,
        rng: RandomBytes = os_random_bytes,
    ) -> None:
        self.air = RescueChainAir(num_hashes)
        t = self.air.trace_length
        num_randomizers = 4 * num_colinearity_tests
        t_r = t + num_randomizers
        # quotient degree bound of the rescue constraints: the cubed
        # trace polys dominate (3*(T_r-1)), their zeroifier keeps
        # T-1-(L-1) cycles; the combination target (omicron_domain - 1
        # under degree_target="fri") must cover it
        worst_bound = 3 * (t_r - 1) - (t - self.air.num_hashes)
        omicron_domain_length = 1 << (2 * t_r).bit_length()
        while omicron_domain_length - 1 < worst_bound:
            omicron_domain_length *= 2
        self.stark = Stark(
            expansion_factor,
            num_colinearity_tests,
            security_level,
            self.air.num_registers,
            t,
            backend=backend if backend is not None else None if device is None else TorchBackend(device),
            rng=rng,
            degree_target="fri",
            transition_exemptions=self.air.transition_exemptions(),
            omicron_domain_length=omicron_domain_length,
        )
        self._constraints = None

    @property
    def constraints(self) -> Sequence[MPolynomial]:
        """The AIR, built lazily (degree-T interpolants) and cached."""
        if self._constraints is None:
            self._constraints = self.air.transition_constraints(
                self.stark, self.air_profile
            )
        return self._constraints

    def precompile(self, threads: int = 6):
        """Warm the device prover before the first prove (see
        :meth:`stark_tpu_torch.stark.Stark.precompile`), the AIR built
        first."""
        return self.stark.precompile(self.constraints, threads=threads,
                                     boundary=self.air.boundary_constraints(FieldElement(0)))

    def prove(self, input_element: FieldElement) -> Tuple[FieldElement, bytes]:
        with prove_span():
            with span("stark.entry.trace"):
                trace = self.air.trace_limbs(input_element)
            output = FieldElement(unpack(trace[0, :, -1])[0])
            boundary = self.air.boundary_constraints(output)
            proof = self.stark.prove(trace, self.constraints, boundary)
        return output, proof

    def verify(self, claimed_output: FieldElement, proof: bytes) -> bool:
        boundary = self.air.boundary_constraints(claimed_output)
        try:
            return self.stark.verify(proof, self.constraints, boundary)
        except (ValueError, IndexError, KeyError, AssertionError):
            return False
