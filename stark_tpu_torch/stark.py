"""STARK prover and verifier.

Pipeline (reference: stark.rs:223-471 prove, :474-723 verify):

  trace (+ randomizer rows) -> trace polynomials -> boundary quotients
  -> Merkle commitments -> transition quotients (pointwise AIR evaluation
  over the FRI coset by default; symbolic composition like the reference
  under algorithm="symbolic") -> randomizer polynomial -> weighted
  combination -> FRI low-degree proof -> leaf openings.

All degree bookkeeping reproduces the reference exactly, including its
quirks, because the bookkeeping feeds the x^shift terms and therefore the
transcript:

* ``transition_degree_bounds`` builds a point-degree vector of length
  1 + 2*num_randomizers but zips it against the 5-entry exponent vectors,
  truncating (reference: stark.rs:143-167) — semantically the vector is
  [1] + [randomized_trace_degree] * 2m;
* ``max_degree`` is (next power of two of the max quotient bound) - 1
  (reference: stark.rs:191-202);
* the zero polynomial reports degree 0 (see :mod:`stark_tpu_torch.poly`).

Performance: Reed-Solomon extensions of all committed polynomials run
through the coset NTT (see :meth:`stark_tpu_torch.poly.Polynomial.eval_domain`),
not per-point Horner like the reference's hottest loop
(reference: stark.rs:291-298); Merkle trees are built once and reused for
all openings; the verifier hoists loop-invariant AIR data.

With no backend, :class:`Stark` is the host prover.  With a
:class:`~stark_tpu_torch.ops.backend.TorchBackend` attached and a FRI
domain of at least ``device_prover_min`` points, ``prove`` runs the
device-resident pipeline (:meth:`Stark._prove_device`): every full-length
codeword lives on the torch device from RS-extension to the FRI folds,
and the proof bytes equal the host prover's on the same randomness.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from .field import FieldElement
from .fri import Fri
from .hashing import blake2b_256
from .merkle import MerkleTree, verify as merkle_verify
from .mpoly import MPolynomial
from .params import NUM_LIMBS, P, TRANSITION_CONSTRAINTS_DEGREE
from .poly import Polynomial
from .proof_stream import ProofStream
from .rng import RandomBytes, os_random_bytes
from .serialization import (
    bincode_field_element,
    json_field_element,
    json_hash_path,
    json_parse_field_element,
    json_parse_hash_path,
)

BoundaryCondition = Tuple[int, int, FieldElement]

#: a trace: rows of one FieldElement a register, or the limb trace, a
#: (registers, 8, rows) uint32 array (:mod:`stark_tpu_torch.ops.limbs`)
Trace = Union[Sequence[Sequence[FieldElement]], np.ndarray]

#: AIR dict sizes above this use the grouped verifier evaluation
#: (per-point dictionary walks scale with the lifted interpolant degree)
BIG_AIR_DICT = 4096

#: Process-wide trace-independent table caches, keyed by the statement
#: shape they derive from (AIR group codewords, transition zeroifiers,
#: ...).  Stark instances are cheap throwaway objects — a prover service
#: constructs one per proof — so per-instance caching re-derives
#: identical tables every prove; sharing them process-wide is the same
#: decision already made for the compiled device cores
#: (:func:`stark_tpu_torch.ops.device_prover.get_core`).  The LRU is keyed by
#: statement SHAPE (one entry per statement, each holding every named
#: table for that shape) so the cap bounds the number of concurrently
#: cached statements — a single shape uses ~9 distinct table names, and
#: counting those against the cap would make one workload thrash itself.
#: Guarded by a lock: serve.py drives this from a threaded HTTP server,
#: and the refresh/eviction pops are not idempotent.
_SHARED_TABLES: Dict[tuple, Dict[str, dict]] = {}
_SHARED_TABLES_CAP = 8
_SHARED_TABLES_LOCK = threading.Lock()


def _shared_table(shape_key: tuple, name: str) -> dict:
    with _SHARED_TABLES_LOCK:
        entry = _SHARED_TABLES.get(shape_key)
        if entry is None:
            while len(_SHARED_TABLES) >= _SHARED_TABLES_CAP:
                _SHARED_TABLES.pop(next(iter(_SHARED_TABLES)))
            entry = _SHARED_TABLES[shape_key] = {}
        else:  # LRU refresh
            _SHARED_TABLES.pop(shape_key, None)
            _SHARED_TABLES[shape_key] = entry
        return entry.setdefault(name, {})


def _shared_entry(shape_key: tuple, name: str, key, build):
    """``_shared_table(shape_key, name)[key]``, built by ``build()`` once:
    threads that miss the same entry wait on its lock (kept with the
    statement's tables, so evicted with them) while one of them builds
    it; other entries build meanwhile."""
    cache = _shared_table(shape_key, name)
    value = cache.get(key)
    if value is None:
        locks = _shared_table(shape_key, "_locks")
        with _SHARED_TABLES_LOCK:
            lock = locks.setdefault((name, key), threading.Lock())
        with lock:
            value = cache.get(key)
            if value is None:
                value = cache[key] = build()
    return value


def _batch_inverse(values: Sequence[int]) -> List[int]:
    """Batch modular inversion via Montgomery's running-product trick
    (one pow(-1) for the whole batch).  All values must be nonzero."""
    n = len(values)
    if n >= 64:
        try:  # native two-limb Montgomery kernel (bit-identical)
            from .native import fieldvec as _fv

            return _fv.batch_inverse(values)
        except ImportError:
            pass
    prefix = [1] * (n + 1)
    for i in range(n):
        prefix[i + 1] = prefix[i] * values[i] % P
    inv_all = pow(prefix[n], -1, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % P
        inv_all = inv_all * values[i] % P
    return out


class Stark:
    """STARK prover/verifier for one AIR instance shape."""

    def __init__(
        self,
        expansion_factor: int,
        num_colinearity_tests: int,
        security_level: int,
        num_registers: int,
        original_trace_length: int,
        backend=None,
        rng: RandomBytes = os_random_bytes,
        algorithm: str = "evaluation",
        degree_target: str = "reference",
        transition_exemptions: Sequence[int] = (),
        omicron_domain_length: int = None,
    ) -> None:
        if expansion_factor & (expansion_factor - 1):
            raise ValueError("expansion factor must be a power of 2")
        if algorithm not in ("evaluation", "symbolic"):
            raise ValueError("algorithm must be 'evaluation' or 'symbolic'")
        #: "evaluation" computes transition quotients and the combination
        #: pointwise over the FRI domain (codeword space — the device-native
        #: formulation); "symbolic" composes coefficient-form polynomials
        #: like the reference (stark.rs:309-341).  Both produce identical
        #: transcripts for honest traces (tests pin this).
        self.algorithm = algorithm
        if degree_target not in ("reference", "fri"):
            raise ValueError("degree_target must be 'reference' or 'fri'")
        #: The degree all combination terms are shifted up to (and the
        #: randomizer polynomial's degree).  "reference" reproduces the
        #: reference's max_degree formula (stark.rs:191-202) — correct
        #: ONLY when it coincides with the FRI degree budget, which holds
        #: for the reference's Rescue-Prime configs but not in general:
        #: FRI's colinearity check demands degree exactly 1 at every
        #: round, so a combination far below the budget degenerates to a
        #: constant mid-cascade and HONEST proofs get rejected.  "fri"
        #: targets the FRI budget (fri_domain/expansion - 1) directly,
        #: which is identical for the reference configs and correct for
        #: arbitrary AIRs (e.g. low-degree constraints like Fibonacci).
        self.degree_target = degree_target
        self.expansion_factor = expansion_factor
        self.num_colinearity_tests = num_colinearity_tests
        # stored but unused, as in the reference (stark.rs:21)
        self.security_level = security_level
        self.num_registers = num_registers
        self.original_trace_length = original_trace_length
        self.backend = backend
        self.rng = rng
        #: cycle indices i (transitions i -> i+1) where the transition
        #: constraints are NOT enforced: the transition zeroifier skips
        #: omicron^i, so the AIR may be violated there without breaking
        #: low-degreeness of the quotient.  The selector for periodic
        #: computations (segmented/restarted traces, multi-phase AIRs) —
        #: the reference enforces its constraints on every cycle
        #: (stark.rs:134-137, the () default).  Two forms:
        #:
        #: * a flat sequence of ints — one list shared by every
        #:   transition constraint;
        #: * a sequence of sequences — one list PER constraint, matched
        #:   positionally to ``transition_constraints`` at prove/verify
        #:   time (constraint groups: e.g. a chained-permutation AIR
        #:   whose round constraints skip segment crossings while its
        #:   chain-link constraints hold ONLY there).
        #:
        #: SOUNDNESS: an exempted transition is genuinely unconstrained
        #: for that constraint; exemptions are part of the statement and
        #: the verifier must use the same lists.
        def _norm(one) -> Tuple[int, ...]:
            vals = sorted(set(int(e) for e in one))
            if vals and not (
                0 <= vals[0] and vals[-1] < original_trace_length - 1
            ):
                raise ValueError(
                    "transition exemptions must lie in "
                    f"[0, {original_trace_length - 1})"
                )
            return tuple(vals)

        ex = list(transition_exemptions)
        nested = [isinstance(e, (list, tuple, set, frozenset, range)) for e in ex]
        if any(nested):
            if not all(nested):
                raise ValueError(
                    "transition_exemptions mixes ints and sequences; use "
                    "either one flat list or one list per constraint"
                )
            self._per_constraint_exemptions: Tuple[Tuple[int, ...], ...] = (
                tuple(_norm(e) for e in ex)
            )
            self.transition_exemptions = self._per_constraint_exemptions
        else:
            self._per_constraint_exemptions = None
            self.transition_exemptions = _norm(ex)

        self.num_randomizers = 4 * num_colinearity_tests
        randomized_trace_length = original_trace_length + self.num_randomizers
        product = randomized_trace_length * TRANSITION_CONSTRAINTS_DEGREE
        default_odl = 1 << product.bit_length()
        if omicron_domain_length is None:
            omicron_domain_length = default_odl
        else:
            # explicit override for AIRs whose quotient degree outruns
            # the reference's 2x-trace sizing (stark.rs:53-55), e.g.
            # chained permutations whose lifted round-constant
            # interpolants are cubed by the S-box.  Enlargement only:
            # shrinking would silently break the FRI degree budget.
            if omicron_domain_length & (omicron_domain_length - 1):
                raise ValueError("omicron_domain_length must be a power of 2")
            if omicron_domain_length < default_odl:
                raise ValueError(
                    f"omicron_domain_length {omicron_domain_length} below "
                    f"the minimum {default_odl} for this configuration"
                )
        self.omicron_domain_length = omicron_domain_length
        self.fri_domain_length = omicron_domain_length * expansion_factor

        self.omega = FieldElement.primitive_nth_root(self.fri_domain_length)
        self.omicron = FieldElement.primitive_nth_root(omicron_domain_length)
        # incremental powers: one multiply per element (a .pow() per element
        # would cost O(n log n) bigint multiplies at large domains)
        omicron_value = self.omicron.value
        domain_values = [1] * omicron_domain_length
        for i in range(1, omicron_domain_length):
            domain_values[i] = domain_values[i - 1] * omicron_value % P
        self.omicron_domain = [FieldElement(v) for v in domain_values]
        self.generator = FieldElement.generator()
        #: per-prove stage timings (utils.profiling.Timer), set by prove()
        self.last_profile = None

        self.fri = Fri(
            self.generator,
            self.omega,
            self.fri_domain_length,
            expansion_factor,
            num_colinearity_tests,
            backend=backend,
        )

    # ------------------------------------------------------------------
    # degree bookkeeping (reference: stark.rs:89-220)
    # ------------------------------------------------------------------

    def boundary_zeroifiers(
        self, boundary: Sequence[BoundaryCondition]
    ) -> List[Polynomial]:
        zeroifiers = []
        for s in range(self.num_registers):
            points = [self.omicron.pow(c) for (c, r, v) in boundary if r == s]
            zeroifiers.append(Polynomial.zeroifier_domain(points))
        return zeroifiers

    def boundary_interpolants(
        self, boundary: Sequence[BoundaryCondition]
    ) -> List[Polynomial]:
        interpolants = []
        for s in range(self.num_registers):
            domain = [self.omicron.pow(c) for (c, r, v) in boundary if r == s]
            values = [v for (c, r, v) in boundary if r == s]
            interpolants.append(Polynomial.lagrange(domain, values))
        return interpolants

    def _exemption_list(self, constraint_index: int) -> Tuple[int, ...]:
        """The exemption list for one constraint (shared flat list, or
        the positional entry in per-constraint mode)."""
        if self._per_constraint_exemptions is None:
            return self.transition_exemptions
        return self._per_constraint_exemptions[constraint_index]

    def _check_constraint_count(self, num_constraints: int) -> None:
        if self._per_constraint_exemptions is not None and len(
            self._per_constraint_exemptions
        ) != num_constraints:
            raise ValueError(
                f"{len(self._per_constraint_exemptions)} per-constraint "
                f"exemption lists for {num_constraints} transition "
                "constraints"
            )

    def transition_zeroifier(self, constraint_index: int = 0) -> Polynomial:
        """prod (x - omicron^i) for i < original_trace_length - 1
        (reference: stark.rs:134-137), skipping the exemptions of
        ``constraint_index``'s list (all indices agree in flat mode).
        Trace-independent — cached per exemption set (it dominated
        repeat verifies at large trace lengths)."""
        return self._tz_poly(self._exemption_list(constraint_index))

    def _shape_key(self) -> tuple:
        return (
            self.fri_domain_length,
            self.generator.value,
            self.omicron.value,
            self.original_trace_length,
        )

    def _tables(self, name: str) -> dict:
        """Process-wide trace-independent table cache for this statement
        shape (see :data:`_SHARED_TABLES`)."""
        return _shared_table(self._shape_key(), name)

    def _tz_poly(self, exemptions: Tuple[int, ...]) -> Polynomial:
        def build():
            skip = set(exemptions)
            domain = [
                p
                for i, p in enumerate(
                    self.omicron_domain[: self.original_trace_length - 1]
                )
                if i not in skip
            ]
            return Polynomial.zeroifier_domain(domain)

        return _shared_entry(self._shape_key(), "tz_poly", exemptions, build)

    def transition_zeroifier_degree(self, constraint_index: int = 0) -> int:
        """Degree of the transition zeroifier (trace_length - 1 minus
        the exempted cycles) for one constraint's exemption list."""
        return (
            self.original_trace_length
            - 1
            - len(self._exemption_list(constraint_index))
        )

    def _tz_eval_batch(
        self,
        xs: Sequence[FieldElement],
        exemptions: Tuple[int, ...] = None,
    ) -> List[FieldElement]:
        """Evaluate the transition zeroifier prod_{i<T-1}(x - omicron^i)
        at many points, vectorized over the omicron power table in
        numpy Montgomery columns (:mod:`stark_tpu_torch.hostops`).

        Bit-identical to ``self.transition_zeroifier().eval(x)`` (a
        mod-p product is association-independent), but O(T) *vector*
        lane-multiplies per point instead of O(T) Python-int Horner
        steps — the dense walk dominated large-trace verifies.  Also
        skips *constructing* the dense zeroifier polynomial, which a
        verify-only caller would otherwise pay once per instance.

        Transition exemptions divide out their factors afterwards:
        (prod over ALL i) * prod_e (x - omicron^e)^{-1} equals the
        filtered product exactly in GF(p) (x is always a coset point,
        never omicron^e, so the factor is invertible)."""
        if exemptions is None:
            exemptions = self._exemption_list(0)
        m = self.original_trace_length - 1
        kept_count = m - len(exemptions)
        if m <= 64 or kept_count <= 64 or not xs:
            # tiny filtered product: direct per-point evaluation
            tz = self._tz_poly(exemptions)
            return [tz.eval(x) for x in xs]
        if len(exemptions) > m // 2:
            # mostly-exempt (e.g. a chain-link constraint active only on
            # segment crossings): run the batched product over the KEPT
            # columns directly rather than correcting out most of them
            kept = sorted(set(range(m)) - set(exemptions))
            exempt = []
        else:
            kept = None
            exempt = [self.omicron.pow(e) for e in exemptions]

        import numpy as np

        from . import hostops as ho

        pts_cache = self._tables("tz_points")
        pts = pts_cache.get(m)
        if pts is None:
            # Montgomery power table by doubling: log2(m) vector
            # multiplies, no per-element Python packing loop
            om = self.omicron.value % P
            pts = ho.to_mont([1])
            k = 1
            while k < m:
                step = ho.to_mont([pow(om, k, P)])
                pts = np.concatenate([pts, ho.mul(pts, step)], axis=1)
                k *= 2
            # cache as uint32 (the limbs are 32-bit values) — halves the
            # footprint of a 2^24-point table; upcast per block at use
            pts = np.ascontiguousarray(pts[:, :m]).astype(np.uint32)
            pts_cache[m] = pts
        if kept is not None:
            pts = np.ascontiguousarray(pts[:, kept])
            m = len(kept)
        npts = len(xs)
        xm = ho.to_mont([fe.value for fe in xs])  # (4, npts)
        one = ho.to_mont([1])
        # process the m point-factors in blocks so peak memory stays
        # O(npts * block) — a 2^24-step verify would otherwise build
        # several GB-scale temporaries (mod-p products are associative,
        # so block-wise accumulation is bit-identical)
        block = max(1024, (1 << 22) // max(npts, 1))
        acc = np.ascontiguousarray(np.broadcast_to(one, (4, npts)))
        for lo in range(0, m, block):
            hi = min(lo + block, m)
            w = hi - lo
            fac = ho.sub(
                np.repeat(xm, w, axis=1),
                np.tile(pts[:, lo:hi].astype(np.uint64), npts),
            )  # (4, npts*w): column p*w+i holds mont(x_p - omicron^{lo+i})
            wpad = 1 << max(w - 1, 1).bit_length()
            buf = np.empty((4, npts, wpad), dtype=np.uint64)
            buf[:, :, :w] = fac.reshape(4, npts, w)
            buf[:, :, w:] = one[:, :, None]
            width = wpad
            while width > 1:  # log-depth pairwise product reduction
                h = width // 2
                a = np.ascontiguousarray(buf[:, :, :h].reshape(4, -1))
                b = np.ascontiguousarray(buf[:, :, h:width].reshape(4, -1))
                buf = ho.mul(a, b).reshape(4, npts, h)
                width = h
            acc = ho.mul(acc, np.ascontiguousarray(buf.reshape(4, npts)))
        out = ho.from_mont(acc)
        vals = [FieldElement(v) for v in out]
        if exempt:
            corrected = []
            for v, x in zip(vals, xs):
                prod = FieldElement(1)
                for om_e in exempt:
                    prod = prod * (x - om_e)
                corrected.append(v * prod.inverse())
            vals = corrected
        return vals

    def _tz_inv_codeword(
        self, exemptions: Tuple[int, ...], fri_domain
    ) -> List[int]:
        """Inverted transition-zeroifier codeword over the FRI coset
        (host evaluation path); cached per exemption set."""
        cache = self._tables("tz_inv")
        tz_inv = cache.get(exemptions)
        if tz_inv is None:
            tz_codeword = self._rs_extend(self._tz_poly(exemptions), fri_domain)
            tz_inv = cache[exemptions] = _batch_inverse(tz_codeword)
        return tz_inv

    def transition_degree_bounds(
        self, transition_constraints: Sequence[MPolynomial]
    ) -> List[int]:
        point_degrees = [1] + [
            self.original_trace_length + self.num_randomizers - 1
        ] * (2 * self.num_randomizers)
        maxes = []
        # cached per constraint OBJECT (walking a chained-permutation
        # AIR's millions of monomials per call dominated repeat
        # verifies); the key pins the degree vector, and the term count
        # guards against post-construction mutation
        pd_key = (tuple(point_degrees), )
        for a in transition_constraints:
            cache = getattr(a, "_degree_bound_cache", None)
            if cache is None:
                cache = a._degree_bound_cache = {}
            hit = cache.get(pd_key)
            if hit is not None and hit[0] == len(a.dict):
                maxes.append(hit[1])
                continue
            best = None
            for exps in a.dict:
                # zip truncates to the shorter sequence, as in the reference
                total = sum(r * l for r, l in zip(point_degrees, exps))
                if best is None or total > best:
                    best = total
            cache[pd_key] = (len(a.dict), best)
            maxes.append(best)
        return maxes

    def transition_quotient_degree_bounds(
        self, transition_constraints: Sequence[MPolynomial]
    ) -> List[int]:
        self._check_constraint_count(len(transition_constraints))
        return [
            d - self.transition_zeroifier_degree(i)
            for i, d in enumerate(
                self.transition_degree_bounds(transition_constraints)
            )
        ]

    def boundary_quotient_degree_bounds(
        self, randomized_trace_length: int, boundary: Sequence[BoundaryCondition]
    ) -> List[int]:
        randomized_trace_degree = randomized_trace_length - 1
        return [
            randomized_trace_degree - bz.degree()
            for bz in self.boundary_zeroifiers(boundary)
        ]

    def max_degree(self, transition_constraints: Sequence[MPolynomial]) -> int:
        md = max(self.transition_quotient_degree_bounds(transition_constraints))
        if md == 0:
            return 0
        return (1 << md.bit_length()) - 1

    def combination_degree(
        self, transition_constraints: Sequence[MPolynomial]
    ) -> int:
        """The target degree for the nonlinear combination (see
        ``degree_target``)."""
        if self.degree_target == "fri":
            return self.fri_domain_length // self.expansion_factor - 1
        return self.max_degree(transition_constraints)

    def sample_weights(self, number: int, randomness: bytes) -> List[FieldElement]:
        """Blake2b-256(randomness || i_le_u64) -> sample
        (reference: stark.rs:205-220)."""
        return [
            FieldElement.sample(blake2b_256(randomness + i.to_bytes(8, "little")))
            for i in range(number)
        ]

    # ------------------------------------------------------------------
    # prover (reference: stark.rs:223-471)
    # ------------------------------------------------------------------

    def _interpolate_trace(self, trace_domain, column) -> Polynomial:
        """Interpolate one trace column; device chirp products when a
        backend is attached and the trace is long."""
        if self.backend is not None and len(trace_domain) > 256:
            from .geometric import geometric_interpolate

            xs = [fe.value for fe in trace_domain]
            ys = [fe.value for fe in column]
            return Polynomial(
                geometric_interpolate(
                    xs, ys, self.omicron.value,
                    multiply=self.backend.poly_multiply,
                )
            )
        return Polynomial.lagrange(trace_domain, column)

    def _rs_extend(self, poly: Polynomial, fri_domain) -> List[int]:
        """Reed-Solomon-extend a polynomial onto the FRI coset, on device
        when a backend is attached (bit-equal either way)."""
        if self.backend is not None:
            return self.backend.rs_extend(
                poly.coeffs, self.fri_domain_length, self.generator.value
            )
        return [fe.value for fe in poly.eval_domain(fri_domain)]

    def _rs_extend_rows(self, coeff_rows, fri_domain) -> List[List[int]]:
        """Reed-Solomon-extend many coefficient lists onto the FRI coset
        in one batched transform when the domain is the standard coset
        {generator * omega^i} (twiddle/offset tables amortize across the
        batch); falls back to per-polynomial extension otherwise."""
        n = self.fri_domain_length
        device_min = getattr(self.backend, "min_device_size", None)
        on_device = (
            self.backend is not None
            and device_min is not None
            and n >= device_min
        )
        standard = (
            len(fri_domain) == n
            and n >= 2
            and fri_domain[0].value == self.generator.value
            and fri_domain[1].value
            == self.generator.value * self.omega.value % P
        )
        if on_device or not standard:
            return [
                self._rs_extend(Polynomial(row), fri_domain)
                for row in coeff_rows
            ]
        from .ntt import NTT

        return NTT(n).coset_evaluate_batch(coeff_rows, self.generator.value)

    def _combination_symbolic(
        self,
        trace_polynomials,
        transition_constraints,
        boundary_quotients,
        randomizer_poly,
        weights,
        max_degree,
        tq_bounds,
        bq_bounds,
        fri_domain,
    ) -> List[int]:
        """Coefficient-form combination, mirroring the reference's symbolic
        composition pipeline (reference: stark.rs:309-406)."""
        point: List[Polynomial] = [Polynomial.x()]
        point.extend(trace_polynomials)
        point.extend(
            tp.scale_argument(self.omicron) for tp in trace_polynomials
        )
        transition_polynomials = [
            a.eval_symbolic(point) for a in transition_constraints
        ]
        transition_quotients = [
            tp / self._tz_poly(self._exemption_list(i))
            for i, tp in enumerate(transition_polynomials)
        ]

        tq_degrees = [tq.degree() for tq in transition_quotients]
        if tq_degrees != tq_bounds:
            raise ValueError(
                f"transition quotient degrees {tq_degrees} do not match "
                f"degree bounds {tq_bounds}"
            )

        terms: List[Polynomial] = [randomizer_poly]
        for i in range(len(transition_quotients)):
            terms.append(transition_quotients[i])
            shift = max_degree - tq_bounds[i]
            terms.append(Polynomial.monomial(shift, 1) * transition_quotients[i])
        for i in range(self.num_registers):
            terms.append(boundary_quotients[i])
            shift = max_degree - bq_bounds[i]
            terms.append(Polynomial.monomial(shift, 1) * boundary_quotients[i])

        combination = Polynomial.zero()
        for w, term in zip(weights, terms):
            combination = combination + term.scale(w)
        return self._rs_extend(combination, fri_domain)

    def _air_groups_extended(self, tc: MPolynomial, fri_domain):
        """Grouped-monomial decomposition of one AIR polynomial with its
        univariate coefficient polys RS-extended over the FRI coset:
        a list of (state-tail exponent tuple, base codeword ints).  The
        AIR is rewritten as sum_m  m(state) * c_m(x)  with c_m univariate
        in x (the round-constant interpolants concentrate there).  Cached
        per AIR content — trace-independent."""
        cache = self._tables("air_groups")
        # content-keyed: id() could alias a new object after GC and serve a
        # stale table, silently corrupting transcripts
        key = tc.content_key()
        cached = cache.get(key)
        if cached is None:
            tails, rows = self._air_group_rows(tc)
            codewords = self._rs_extend_rows(rows, fri_domain)
            cached = cache[key] = list(zip(tails, codewords))
        return cached

    def _air_group_rows(self, tc: MPolynomial):
        """The grouped-monomial decomposition itself: (tails, coefficient
        rows) with the AIR rewritten as sum_m m(state) * c_m(x); cached
        per AIR content (shared by the extension and point-eval paths)."""
        cache = self._tables("air_group_rows")
        key = tc.content_key()
        cached = cache.get(key)
        if cached is None:
            groups = {}
            for exps, coeff in tc.dict.items():
                if coeff == 0:
                    continue
                x_e = exps[0] if exps else 0
                tail = tuple(exps[1:])
                g = groups.setdefault(tail, {})
                g[x_e] = (g.get(x_e, 0) + coeff) % P
            tails = []
            rows = []
            for tail, xdict in groups.items():
                max_e = max(xdict)
                coeffs = [0] * (max_e + 1)
                for e, c in xdict.items():
                    coeffs[e] = c
                tails.append(tail)
                rows.append(coeffs)
            cached = cache[key] = (tuple(tails), tuple(rows))
        return cached

    def _air_group_point_values(self, tc: MPolynomial, indices):
        """Per group, (tail, {index: c_m(g * omega^index)}) — the
        verify-only alternative to RS-extending every group polynomial
        over the whole FRI coset just to read a handful of query points
        (a multi-GB transient at flagship sizes).  (k+1)*deg Montgomery
        multiplies per group via the native multi-point Horner kernel;
        values are identical to the extended codeword's entries."""
        tails, rows = self._air_group_rows(tc)
        g = self.generator.value
        omega = self.omega.value
        idx = sorted(set(int(i) for i in indices))
        xs = [g * pow(omega, i, P) % P for i in idx]
        try:
            from .native import fieldvec as fvn
        except ImportError:
            fvn = None
        out = []
        for tail, coeffs in zip(tails, rows):
            if fvn is not None:
                vals = fvn.poly_eval_many(list(coeffs), xs)
            else:
                poly = Polynomial(list(coeffs))
                vals = [poly.eval(FieldElement(x)).value for x in xs]
            out.append((tail, dict(zip(idx, vals))))
        return out

    def _device_air_group_values(
        self, transition_constraints, big, indices
    ):
        """Verifier fast path for large AIRs with the device pipeline:
        RS-extend the grouped coefficient polys ON the device (cached —
        shared with the prover's combination kernel) and gather ONLY the
        query indices in one stacked fetch, instead of pulling whole
        codewords (16 MB each at 2^20) over the host link.  Returns, per
        constraint, a list of (tail, {index: base value}) or None for
        small constraints (dict evaluation stays cheaper)."""
        from .ops.cuda_merkle import mont_digits
        from .ops.device_prover import digits_value
        from .ops.limbs import to_numpy

        core = self._device_core()
        group_cws, structure = self._device_air_groups(
            core, transition_constraints
        )
        if any(cw.ndim != 2 for cw in group_cws):
            return None  # four-step sharded layout: the host path handles it
        idx = sorted(set(int(i) for i in indices))
        # one gather launch for every group codeword: (G * K, 4), group-major
        digits = to_numpy(mont_digits(group_cws, idx)).T
        k = len(idx)
        out = []
        for s in range(len(transition_constraints)):
            if not big[s]:
                out.append(None)
                continue
            vals = []
            for tail, gi in structure[s]:
                base = digits[gi * k : (gi + 1) * k]
                vals.append(
                    (tail, {i: digits_value(base, r) for r, i in enumerate(idx)})
                )
            out.append(vals)
        return out

    def _air_codeword(
        self, tc: MPolynomial, state_columns, fri_domain
    ) -> List[int]:
        """Evaluate one AIR polynomial over the whole FRI domain via the
        grouped decomposition (:meth:`_air_groups_extended`) — one coset
        NTT per group + elementwise products instead of per-point
        dictionary evaluation."""
        n = self.fri_domain_length
        cached = self._air_groups_extended(tc, fri_domain)

        fvn = None
        if n >= 256:
            try:
                from .native import fieldvec as fvn
            except ImportError:
                fvn = None
        if fvn is not None:
            # native two-limb Montgomery columns (bit-identical); the
            # Montgomery-packed group codewords are trace-independent —
            # cache them beside the int lists
            mont_cache = self._tables("air_groups_mont")
            mkey = tc.content_key()
            packed = mont_cache.get(mkey)
            if packed is None:
                packed = mont_cache[mkey] = [
                    (tail, fvn.col_from_ints(cw)) for tail, cw in cached
                ]
            state_cols = [fvn.col_from_ints(col) for col in state_columns]
            pc = {}

            def pow_col_fv(i: int, e: int):
                if e == 1:
                    return state_cols[i]
                k = (i, e)
                if k not in pc:
                    half = pow_col_fv(i, e // 2)
                    sq = fvn.col_mul(half, half)
                    if e & 1:
                        sq = fvn.col_mul(sq, state_cols[i])
                    pc[k] = sq
                return pc[k]

            acc = None
            for tail, base in packed:
                term = base
                for i, e in enumerate(tail):
                    if e == 0:
                        continue
                    term = fvn.col_mul(term, pow_col_fv(i, e))
                acc = term if acc is None else fvn.col_add(acc, term)
            return fvn.col_to_ints(acc)

        if n >= 4096:
            # vectorized numpy column algebra (bit-identical; see hostops)
            from . import hostops as ho

            state_np = [ho.to_mont(col) for col in state_columns]
            pow_cache_np = {}

            def pow_col_np(i: int, e: int):
                if e == 1:
                    return state_np[i]
                k = (i, e)
                if k not in pow_cache_np:
                    half = pow_col_np(i, e // 2)
                    sq = ho.mul(half, half)
                    if e & 1:
                        sq = ho.mul(sq, state_np[i])
                    pow_cache_np[k] = sq
                return pow_cache_np[k]

            acc = None
            for tail, base_codeword in cached:
                term = ho.to_mont(base_codeword)
                for i, e in enumerate(tail):
                    if e == 0:
                        continue
                    term = ho.mul(term, pow_col_np(i, e))
                acc = term if acc is None else ho.add(acc, term)
            return ho.from_mont(acc)

        pow_cache = {}

        def pow_col(i: int, e: int) -> List[int]:
            if e == 1:
                return state_columns[i]
            key = (i, e)
            if key not in pow_cache:
                half = pow_col(i, e // 2)
                sq = [v * v % P for v in half]
                if e & 1:
                    sq = [a * b % P for a, b in zip(sq, state_columns[i])]
                pow_cache[key] = sq
            return pow_cache[key]

        acc = [0] * n
        for tail, base_codeword in cached:
            term = base_codeword
            for i, e in enumerate(tail):
                if e == 0:
                    continue
                pc = pow_col(i, e)
                term = [t * v % P for t, v in zip(term, pc)]
            acc = [(a + t) % P for a, t in zip(acc, term)]
        return acc

    def _combination_evaluation(
        self,
        trace_polynomials,
        transition_constraints,
        boundary_quotient_codewords,
        randomizer_codeword,
        weights,
        max_degree,
        tq_bounds,
        bq_bounds,
        fri_domain,
    ) -> List[int]:
        """Evaluation-space combination: everything pointwise on the FRI
        coset — the device-native formulation.

        Identities used (all exact; same polynomials as the symbolic path,
        hence identical transcripts):

        * trace codewords come from coset-NTT extension of the trace
          polynomials; t(omicron * x_i) = t(x_{(i+expansion) mod N})
          because omicron = omega^expansion on the FRI coset;
        * the AIR is evaluated pointwise over the domain
          (:meth:`stark_tpu_torch.mpoly.MPolynomial.eval_batch`);
        * transition quotients are pointwise products with the inverted
          transition-zeroifier codeword (nonzero on the coset; one batch
          inversion), and their coefficients — needed only for the degree
          assertion — come from one inverse coset-NTT each;
        * x^shift codewords are geometric tables
          g^shift * (omega^shift)^i.
        """
        n = self.fri_domain_length
        g = self.generator.value
        omega = self.omega.value

        trace_codewords = [
            self._rs_extend(tp, fri_domain) for tp in trace_polynomials
        ]
        shift_by = self.expansion_factor
        next_codewords = [
            cw[shift_by:] + cw[:shift_by] for cw in trace_codewords
        ]

        state_columns = trace_codewords + next_codewords
        air_codewords = [
            self._air_codeword(tc, state_columns, fri_domain)
            for tc in transition_constraints
        ]

        # the zeroifier codewords are trace-independent too — cache them
        # per exemption set
        tq_codewords = [
            [
                a * zi % P
                for a, zi in zip(
                    air_cw, self._tz_inv_codeword(self._exemption_list(i), fri_domain)
                )
            ]
            for i, air_cw in enumerate(air_codewords)
        ]

        # degree assertion via inverse coset-NTT (reference: stark.rs:379-380)
        from .ntt import NTT

        ntt = NTT(n)
        tq_degrees = []
        for tq_cw in tq_codewords:
            coeffs = (
                self.backend.rs_restrict(tq_cw, g)
                if self.backend is not None
                else ntt.coset_interpolate(tq_cw, g)
            )
            tq_degrees.append(Polynomial(coeffs).degree())
        if tq_degrees != tq_bounds:
            raise ValueError(
                f"transition quotient degrees {tq_degrees} do not match "
                f"degree bounds {tq_bounds}"
            )

        def shift_column(shift: int) -> List[int]:
            if shift == 0:
                return [1] * n
            base = pow(omega, shift, P)
            out = [0] * n
            cur = pow(g, shift, P)
            for i in range(n):
                out[i] = cur
                cur = cur * base % P
            return out

        fvn = None
        if n >= 256:
            try:
                from .native import fieldvec as fvn
            except ImportError:
                fvn = None
        if fvn is not None:
            # native Montgomery columns (bit-identical); the x^shift
            # geometric columns are statement-pure — cache them packed
            shift_cache = self._tables("shift_cols_mont")

            def shift_col_fv(shift: int):
                col = shift_cache.get(shift)
                if col is None:
                    if shift == 0:
                        col = fvn.col_from_ints([1] * n)
                    else:
                        col = fvn.to_mont_arr(
                            fvn.geom_series(
                                pow(omega, shift, P), pow(g, shift, P), n
                            )
                        )
                    shift_cache[shift] = col
                return col

            comb = fvn.col_scale(
                fvn.col_from_ints(randomizer_codeword),
                fvn.mont_scalar(weights[0].value),
            )
            widx = 1
            for codewords, bounds in (
                (tq_codewords, tq_bounds),
                (boundary_quotient_codewords, bq_bounds),
            ):
                for i, cw in enumerate(codewords):
                    w1 = fvn.mont_scalar(weights[widx].value)
                    w2 = fvn.mont_scalar(weights[widx + 1].value)
                    widx += 2
                    fvn.comb_term(
                        comb,
                        fvn.col_from_ints(cw),
                        shift_col_fv(max_degree - bounds[i]),
                        w1,
                        w2,
                    )
            return fvn.col_to_ints(comb)

        if n >= 4096:
            # vectorized numpy column algebra (bit-identical; see hostops)
            from . import hostops as ho

            w0 = ho.to_mont([weights[0].value])
            comb = ho.mul(w0, ho.to_mont(randomizer_codeword))
            widx = 1
            terms = [
                (tq_codewords, tq_bounds),
                (boundary_quotient_codewords, bq_bounds),
            ]
            for codewords, bounds in terms:
                for i, cw in enumerate(codewords):
                    w1 = ho.to_mont([weights[widx].value])
                    w2 = ho.to_mont([weights[widx + 1].value])
                    widx += 2
                    cw_np = ho.to_mont(cw)
                    xs_np = ho.to_mont(shift_column(max_degree - bounds[i]))
                    comb = ho.add(comb, ho.mul(w1, cw_np))
                    comb = ho.add(comb, ho.mul(w2, ho.mul(xs_np, cw_np)))
            return ho.from_mont(comb)

        w0 = weights[0].value
        combination = [w0 * c % P for c in randomizer_codeword]
        widx = 1
        for i, tq_cw in enumerate(tq_codewords):
            w1 = weights[widx].value
            w2 = weights[widx + 1].value
            widx += 2
            xs = shift_column(max_degree - tq_bounds[i])
            for k in range(n):
                combination[k] = (
                    combination[k]
                    + w1 * tq_cw[k]
                    + w2 * xs[k] * tq_cw[k]
                ) % P
        for i, bq_cw in enumerate(boundary_quotient_codewords):
            w1 = weights[widx].value
            w2 = weights[widx + 1].value
            widx += 2
            xs = shift_column(max_degree - bq_bounds[i])
            for k in range(n):
                combination[k] = (
                    combination[k]
                    + w1 * bq_cw[k]
                    + w2 * xs[k] * bq_cw[k]
                ) % P
        return combination

    # ------------------------------------------------------------------
    # device-resident prover (codewords stay on the torch device)
    # ------------------------------------------------------------------

    def precompile(
        self,
        transition_constraints: Sequence[MPolynomial],
        trace_length: int = None,
        threads: int = 6,
        boundary: Sequence[BoundaryCondition] = None,
    ):
        """Warm the device prover before the first prove: build the kernel
        library, the prover core and every table the prove caches for this
        statement, and launch each kernel once at the prove's shapes, on a
        thread pool (see :mod:`stark_tpu_torch.ops.precompile`).  No-op
        (returns None) when the device pipeline is not in use; otherwise
        returns job name -> seconds, and raises once the pool drains if a
        job failed.  ``boundary`` (the statement's boundary conditions:
        their cycles and registers are read, not their values) lets it
        also build the boundary quotients' x^shift tables; the models pass
        theirs."""
        if not self._use_device_pipeline():
            return None
        from .ops.precompile import precompile_stark

        if trace_length is None:
            trace_length = self.original_trace_length
        return precompile_stark(
            self, transition_constraints, trace_length, threads, boundary=boundary
        )

    def _use_device_pipeline(self) -> bool:
        """Whether prove() runs the device-resident pipeline: a backend is
        attached, the evaluation-space algorithm is selected, and the FRI
        domain is large enough that device dispatch beats host lists."""
        if self.backend is None or self.algorithm != "evaluation":
            return False
        floor = getattr(self.backend, "device_prover_min", 1 << 13)
        return self.fri_domain_length >= floor

    def _device_core(self):
        core = getattr(self, "_device_core_cache", None)
        if core is None:
            core = self._device_core_cache = self.backend.make_prover_core(
                self.fri_domain_length, self.generator.value
            )
        return core

    def _device_air_groups(self, core, transition_constraints):
        """Per-constraint grouped-monomial structure + cached device group
        codewords.  The AIR is rewritten as sum_m m(state) * c_m(x) with
        c_m univariate (round-constant interpolants concentrate there);
        each c_m is RS-extended once and cached per AIR content (same
        grouping as the host evaluation path)."""
        # keyed by the core OBJECT too: plain and sharded cores produce
        # different array layouts for the same statement shape (and the
        # reference in the key keeps the core alive, so ids can't alias)
        key = (core,) + tuple(
            tc.content_key() for tc in transition_constraints
        )

        def build():
            group_cws = []
            structure = []
            for tc in transition_constraints:
                groups: Dict[tuple, Dict[int, int]] = {}
                for exps, coeff in tc.dict.items():
                    if coeff == 0:
                        continue
                    x_e = exps[0] if exps else 0
                    tail = tuple(exps[1:])
                    g = groups.setdefault(tail, {})
                    g[x_e] = (g.get(x_e, 0) + coeff) % P
                per_constraint = []
                for tail, xdict in groups.items():
                    max_e = max(xdict)
                    coeffs = [0] * (max_e + 1)
                    for e, c in xdict.items():
                        coeffs[e] = c
                    per_constraint.append((tail, len(group_cws)))
                    group_cws.append(core.extend(coeffs))
                structure.append(tuple(per_constraint))
            return tuple(group_cws), tuple(structure)

        return _shared_entry(self._shape_key(), "device_air_groups", key, build)

    def _device_tz_inv(self, core, exemptions: Tuple[int, ...] = ()):
        """Inverted transition-zeroifier codeword (trace-independent),
        cached on device per exemption set."""
        return _shared_entry(
            self._shape_key(), "device_tz_inv", (core, exemptions),
            lambda: core.inverse(core.extend(self._tz_poly(exemptions).coeffs)),
        )

    def _combination_device(
        self,
        core,
        trace_polynomials,
        transition_constraints,
        bq_codewords,
        randomizer_codeword,
        weights,
        max_degree,
        tq_bounds,
        bq_bounds,
        prof,
        check_degrees: bool = True,
    ):
        """Evaluation-space combination as one device executable (K11 on
        the card); returns a DeviceCodeword.  Same algebra as
        :meth:`_combination_evaluation` (identical transcripts), but no
        codeword ever reaches the host.  ``prof`` (the prove's
        :class:`~stark_tpu_torch.utils.profiling.Timer`) gets the
        sub-regions ``combination/air_groups``, ``/tz_inv``,
        ``/shift_tables``, ``/trace_extend``, ``/kernel`` and
        ``/degree_probe``."""
        from .ops.device_prover import DeviceCodeword
        from .ops.limbs import mont_tensor

        def region(name):
            return prof.region(f"combination/{name}")

        omega = self.omega.value
        with region("air_groups"):
            group_cws, structure = self._device_air_groups(
                core, transition_constraints
            )
        with region("tz_inv"):
            tz_invs = tuple(
                self._device_tz_inv(core, self._exemption_list(i))
                for i in range(len(transition_constraints))
            )
        with region("shift_tables"):
            tq_tabs = tuple(
                core.shift_table(max_degree - b, omega) for b in tq_bounds
            )
            bq_tabs = tuple(
                core.shift_table(max_degree - b, omega) for b in bq_bounds
            )
            weights_mont = mont_tensor([w.value for w in weights], core.device)

        with region("trace_extend"):
            trace_cws = tuple(
                # host Polynomial, or a device-resident Montgomery
                # coefficient tensor from the device trace interpolation
                core.extend(tp.coeffs) if hasattr(tp, "coeffs")
                else core.extend_mont(tp)
                for tp in trace_polynomials
            )

        with region("kernel"):
            fn = core.combination_fn(
                structure, len(bq_codewords), self.expansion_factor
            )
            comb_mont, tq_stack = fn(
                trace_cws,
                group_cws,
                tz_invs,
                randomizer_codeword.mont,
                tuple(cw.mont for cw in bq_codewords),
                weights_mont,
                tq_tabs,
                bq_tabs,
            )

        # degree check, reduced on device to one (k,)-int fetch (zero
        # poly -> degree 0, matching the host quirk); reference:
        # stark.rs:379-380
        with region("degree_probe"):
            tq_degrees = core.degree_probe(tq_stack)
        if check_degrees and tq_degrees != list(tq_bounds):
            raise ValueError(
                f"transition quotient degrees {tq_degrees} do not match "
                f"degree bounds {list(tq_bounds)}"
            )
        return DeviceCodeword(comb_mont, core)

    def _prove_device(
        self,
        trace: Trace,
        transition_constraints: Sequence[MPolynomial],
        boundary: Sequence[BoundaryCondition],
        dry_run: bool = False,
    ) -> bytes:
        """Device-resident prove: same pipeline, randomness consumption and
        transcript bytes as the host path (pinned by tests), with every
        full-length codeword living on the device from RS-extension to the
        FRI folds.  Host crossings: one digit matrix per committed codeword
        (Merkle leaves are host/native-C work) and the opened leaves.

        The trace's limb form is uploaded as it is, a register at a time,
        when the device interpolates it (more than 256 rows); rows are
        packed into limbs there first (counted in
        ``profiling.PACKED_ROW_TRACES``).  The host interpolation takes
        rows, made from the limb form there.

        ``dry_run`` (``precompile``'s last job): zero bytes in place of the
        rng, which is not read, and no check that the transition quotients
        meet their degree bounds, so that a trace of zeros runs every
        stage; its bytes are no proof."""
        from .ops.limbs import pack_trace, unpack_trace
        from .utils import profiling

        rng = (lambda k: bytes(k)) if dry_run else self.rng
        prof = profiling.Timer("protocol")
        self.last_profile = prof
        proof_stream = ProofStream()
        with prof.region("trace_copy"):
            # the device trace: the limb form as it came, or a new list of
            # the rows, which the randomizer rows extend
            limb_form = isinstance(trace, np.ndarray)
            if not limb_form:
                trace = list(trace)

        with prof.region("randomizer_rows"):
            randomizer_rows = [
                [FieldElement.sample(rng(17)) for _ in range(self.num_registers)]
                for _ in range(self.num_randomizers)
            ]
            if limb_form:
                trace = np.concatenate(
                    [trace, pack_trace(randomizer_rows, self.num_registers)], axis=2
                )
            else:
                trace.extend(randomizer_rows)
        num_rows = trace.shape[2] if limb_form else len(trace)

        with prof.region("core"):
            core = self._device_core()

        # randomizer polynomial: drawn and dispatched first (rng order —
        # rows, then poly — and transcript push order are unchanged; only
        # wall-clock order moves) so its upload and extend + tree kernels
        # queue on the device while the host interpolates the trace below
        with prof.region("randomizer_poly"):
            from .rng import draw_concat

            max_degree = self.combination_degree(transition_constraints)
            with prof.region("randomizer_poly/draw"):
                rand_bytes = draw_concat(rng, max_degree + 1, 17)
            if hasattr(core, "extend_codeword_be17"):
                # byte->limb unpack and mod-p reduce on the device
                with prof.region("randomizer_poly/extend"):
                    randomizer_codeword = core.extend_codeword_be17(rand_bytes)
            else:
                from .ops.limbs import pack_be17

                with prof.region("randomizer_poly/pack"):
                    rand_limbs = pack_be17(rand_bytes)
                with prof.region("randomizer_poly/extend"):
                    randomizer_codeword = core.extend_codeword(rand_limbs)
            with prof.region("randomizer_poly/tree"):
                randomizer_tree = core.merkle_tree(randomizer_codeword)

        # long traces: interpolate, RS-extend and form boundary quotients
        # entirely on the device (device chirp interpolation + pointwise
        # eval-space division by the boundary zeroifier; exact division
        # makes the codewords bit-identical to the host polynomial path)
        dev_interp = num_rows > 256 and hasattr(core, "extend_mont")
        with prof.region("trace_interpolation"):
            if dev_interp:
                from .ops import cuda_field as cf
                from .ops.geometric_device import device_geometric_interpolate
                from .ops.limbs import from_numpy

                if not limb_form:
                    profiling.PACKED_ROW_TRACES += 1
                    trace = pack_trace(trace, self.num_registers)
                trace_polynomials = []
                for s in range(self.num_registers):
                    # REDC(a * R^2) = a * R: one K10 product on the card
                    col_mont = cf.to_mont(from_numpy(trace[s], core.device))
                    trace_polynomials.append(
                        device_geometric_interpolate(
                            col_mont, 1, self.omicron.value
                        )
                    )
            else:
                if limb_form:
                    trace = unpack_trace(trace)
                trace_domain = self.omicron_domain[: len(trace)]
                trace_polynomials = []
                for s in range(self.num_registers):
                    column = [trace[c][s] for c in range(len(trace))]
                    trace_polynomials.append(
                        self._interpolate_trace(trace_domain, column)
                    )

        with prof.region("boundary_polys"):
            interpolants = self.boundary_interpolants(boundary)
            zeroifiers = self.boundary_zeroifiers(boundary)
            if not dev_interp:
                boundary_quotients = [
                    (trace_polynomials[s] - interpolants[s]) / zeroifiers[s]
                    for s in range(self.num_registers)
                ]

        with prof.region("bq_extend"):
            if dev_interp:
                from .ops.device_prover import DeviceCodeword, geometric_table
                from .ops.geometric_device import horner_eval

                x_tab = geometric_table(
                    self.omega.value, self.generator.value,
                    self.fri_domain_length, core.device,
                )
                boundary_quotient_codewords = []
                for s in range(self.num_registers):
                    t_cw = core.extend_mont(trace_polynomials[s])
                    i_cw = horner_eval(interpolants[s].coeffs, x_tab)
                    z_cw = horner_eval(zeroifiers[s].coeffs, x_tab)
                    bq_mont = cf.mont_mul(
                        cf.sub(t_cw, i_cw), cf.mont_inv(z_cw)
                    )
                    boundary_quotient_codewords.append(
                        DeviceCodeword(bq_mont, core)
                    )
            else:
                boundary_quotient_codewords = [
                    core.extend_codeword(bq.coeffs)
                    for bq in boundary_quotients
                ]
        # dispatch EVERY commitment's device work before the first root
        # fetch blocks: device trees are lazy (ops/device_merkle.py), so
        # the hash kernels all queue up front.  The randomizer extend +
        # tree were dispatched BEFORE trace interpolation (see above);
        # the transcript push order (bq roots, then randomizer root)
        # stays identical.
        with prof.region("bq_merkle_dispatch"):
            boundary_quotient_trees = [
                core.merkle_tree(cw) for cw in boundary_quotient_codewords
            ]
        with prof.region("bq_merkle"):
            from .ops.device_merkle import roots_batch

            # one stacked fetch for every commitment root (bq registers +
            # randomizer) instead of a blocking tail fetch per tree
            commit_roots = roots_batch(
                list(boundary_quotient_trees) + [randomizer_tree]
            )
            for root in commit_roots[:-1]:
                proof_stream.push(root.hex())
        with prof.region("randomizer_merkle"):
            proof_stream.push(commit_roots[-1].hex())

        fri_budget = self.fri_domain_length // self.expansion_factor - 1
        if max_degree > fri_budget:
            from .utils import get_logger

            get_logger("stark_tpu_torch.stark").warning(
                "combination degree bound %d exceeds the FRI degree budget "
                "%d for expansion factor %d — honest proofs will NOT verify "
                "with this configuration",
                max_degree,
                fri_budget,
                self.expansion_factor,
            )

        with prof.region("weights"):
            weights = self.sample_weights(
                1
                + 2 * len(transition_constraints)
                + 2 * len(boundary_quotient_codewords),
                proof_stream.prover_fiat_shamir(32),
            )

        with prof.region("degree_bounds"):
            tq_bounds = self.transition_quotient_degree_bounds(transition_constraints)
            bq_bounds = self.boundary_quotient_degree_bounds(num_rows, boundary)
            worst = max(tq_bounds + bq_bounds)
            if worst > max_degree:
                raise ValueError(
                    f"a quotient's degree bound ({worst}) exceeds the "
                    f"combination degree target ({max_degree}); this "
                    "configuration cannot produce a verifiable proof "
                    "(shrink the constraint degree or grow the domain)"
                )

        with prof.region("combination"):
            combined_codeword = self._combination_device(
                core,
                trace_polynomials,
                transition_constraints,
                boundary_quotient_codewords,
                randomizer_codeword,
                weights,
                max_degree,
                tq_bounds,
                bq_bounds,
                prof=prof,
                check_degrees=not dry_run,
            )

        with prof.region("fri"):
            indices = self.fri.prove(combined_codeword, proof_stream, prof)
        with prof.region("indices"):
            indices.sort()
            duplicated_indices = sorted(
                indices
                + [(i + self.expansion_factor) % self.fri.domain_length for i in indices]
            )

        with prof.region("openings"):
            # batch every device-side gather before the serialization
            # loops, and fetch them all in ONE host transfer
            from .ops.device_prover import fetch_absorb, pad_rows

            jobs = []
            with prof.region("openings/gather_dispatch"):
                for cw, idxs in [
                    (c, duplicated_indices)
                    for c in boundary_quotient_codewords
                ] + [(randomizer_codeword, indices)]:
                    if hasattr(cw, "gather_values_async"):
                        got, arr = cw.gather_values_async(idxs)
                        if got:
                            jobs.append((
                                pad_rows(arr, 8),
                                lambda s, c=cw, got=got: c.absorb_values(
                                    got, s[:4]
                                ),
                            ))
                for tree, idxs in [
                    (t, duplicated_indices) for t in boundary_quotient_trees
                ] + [(randomizer_tree, indices)]:
                    if hasattr(tree, "gather_siblings_async"):
                        keys, arr = tree.gather_siblings_async(
                            sorted(set(idxs))
                        )
                        if keys:
                            jobs.append((
                                arr,
                                lambda s, t=tree, keys=keys: (
                                    t.absorb_siblings(keys, s)
                                ),
                            ))
                    if hasattr(tree, "tail_async"):
                        tail = tree.tail_async()
                        if tail is not None:
                            jobs.append(
                                (tail, lambda s, t=tree: t.absorb_tail(s))
                            )
            with prof.region("openings/fetch"):
                fetch_absorb(jobs)
            with prof.region("openings/serialize"):
                for s in range(self.num_registers):
                    codeword = boundary_quotient_codewords[s]
                    tree = boundary_quotient_trees[s]
                    for i in duplicated_indices:
                        proof_stream.push(
                            json_field_element(codeword.value(i))
                        )
                        proof_stream.push(json_hash_path(tree.open(i)))
                for i in indices:
                    proof_stream.push(
                        json_field_element(randomizer_codeword.value(i))
                    )
                    proof_stream.push(
                        json_hash_path(randomizer_tree.open(i))
                    )

        with prof.region("serialize"):
            return proof_stream.serialize()

    def prove(
        self,
        trace: Trace,
        transition_constraints: Sequence[MPolynomial],
        boundary: Sequence[BoundaryCondition],
    ) -> bytes:
        """The proof of ``trace`` (without its randomizer rows): rows of
        ``num_registers`` elements, or the limb trace, a
        ``(num_registers, 8, rows)`` uint32 array of canonical residues
        (:func:`stark_tpu_torch.ops.limbs.pack_trace`).  Both forms give
        the same bytes; the device pipeline takes the limb form without
        packing, the host prover turns it into rows."""
        if isinstance(trace, np.ndarray) and (
            trace.dtype != np.uint32 or trace.ndim != 3
            or trace.shape[:2] != (self.num_registers, NUM_LIMBS)
        ):
            raise ValueError(
                f"a limb trace is a ({self.num_registers}, {NUM_LIMBS}, rows) "
                f"uint32 array, not {trace.dtype} of shape {trace.shape}"
            )
        if self._use_device_pipeline():
            return self._prove_device(trace, transition_constraints, boundary)
        from .ops.limbs import unpack_trace

        proof_stream = ProofStream()
        if isinstance(trace, np.ndarray):
            trace = unpack_trace(trace)
        else:
            trace = [list(row) for row in trace]

        # append randomizer rows (ZK; reference: stark.rs:237-253)
        for _ in range(self.num_randomizers):
            trace.append(
                [
                    FieldElement.sample(self.rng(17))
                    for _ in range(self.num_registers)
                ]
            )

        # interpolate trace polynomials over {omicron^i, i < len(trace)}
        # (a geometric progression: O(n log n) chirp interpolation, with
        # the chirp products on device for long traces)
        trace_domain = [self.omicron.pow(i) for i in range(len(trace))]
        trace_polynomials = []
        for s in range(self.num_registers):
            column = [trace[c][s] for c in range(len(trace))]
            trace_polynomials.append(
                self._interpolate_trace(trace_domain, column)
            )

        # boundary quotients (exact division)
        interpolants = self.boundary_interpolants(boundary)
        zeroifiers = self.boundary_zeroifiers(boundary)
        boundary_quotients = [
            (trace_polynomials[s] - interpolants[s]) / zeroifiers[s]
            for s in range(self.num_registers)
        ]

        # commit boundary quotient codewords over the FRI coset
        fri_domain = self.fri.eval_domain()
        boundary_quotient_codewords: List[List[int]] = []
        boundary_quotient_trees: List[MerkleTree] = []
        for s in range(self.num_registers):
            codeword = self._rs_extend(boundary_quotients[s], fri_domain)
            boundary_quotient_codewords.append(codeword)
            tree = MerkleTree.from_codeword(codeword)
            boundary_quotient_trees.append(tree)
            proof_stream.push(tree.root.hex())

        # randomizer polynomial (ZK; reference: stark.rs:343-360); draws
        # batched (byte-identical to sequential rng(17) calls)
        from .rng import draw_many

        max_degree = self.combination_degree(transition_constraints)
        randomizer_poly = Polynomial(
            [
                FieldElement.sample(chunk)
                for chunk in draw_many(self.rng, max_degree + 1, 17)
            ]
        )
        randomizer_codeword = self._rs_extend(randomizer_poly, fri_domain)
        randomizer_tree = MerkleTree.from_codeword(randomizer_codeword)
        proof_stream.push(randomizer_tree.root.hex())

        # diagnostic the reference lacks: if the combination degree exceeds
        # what FRI can accept, honest proofs will be rejected (true of the
        # reference's own (8,8,32) benchmark config)
        fri_budget = self.fri_domain_length // self.expansion_factor - 1
        if max_degree > fri_budget:
            from .utils import get_logger

            get_logger("stark_tpu_torch.stark").warning(
                "combination degree bound %d exceeds the FRI degree budget "
                "%d for expansion factor %d — honest proofs will NOT verify "
                "with this configuration",
                max_degree,
                fri_budget,
                self.expansion_factor,
            )

        # weights for the nonlinear combination
        weights = self.sample_weights(
            1 + 2 * len(transition_constraints) + 2 * len(boundary_quotients),
            proof_stream.prover_fiat_shamir(32),
        )

        tq_bounds = self.transition_quotient_degree_bounds(transition_constraints)
        bq_bounds = self.boundary_quotient_degree_bounds(len(trace), boundary)

        worst = max(tq_bounds + bq_bounds)
        if worst > max_degree:
            raise ValueError(
                f"a quotient's degree bound ({worst}) exceeds the "
                f"combination degree target ({max_degree}); this "
                "configuration cannot produce a verifiable proof "
                "(shrink the constraint degree or grow the domain)"
            )

        if self.algorithm == "symbolic":
            combined_codeword = self._combination_symbolic(
                trace_polynomials,
                transition_constraints,
                boundary_quotients,
                randomizer_poly,
                weights,
                max_degree,
                tq_bounds,
                bq_bounds,
                fri_domain,
            )
        else:
            combined_codeword = self._combination_evaluation(
                trace_polynomials,
                transition_constraints,
                boundary_quotient_codewords,
                randomizer_codeword,
                weights,
                max_degree,
                tq_bounds,
                bq_bounds,
                fri_domain,
            )

        # FRI low-degree proof
        indices = self.fri.prove(combined_codeword, proof_stream)
        indices.sort()

        duplicated_indices = sorted(
            indices
            + [(i + self.expansion_factor) % self.fri.domain_length for i in indices]
        )

        # open boundary-quotient leaves (reference: stark.rs:429-443)
        for s in range(self.num_registers):
            codeword = boundary_quotient_codewords[s]
            tree = boundary_quotient_trees[s]
            for i in duplicated_indices:
                proof_stream.push(json_field_element(codeword[i]))
                proof_stream.push(json_hash_path(tree.open(i)))

        # open randomizer leaves (reference: stark.rs:449-464)
        for i in indices:
            proof_stream.push(json_field_element(randomizer_codeword[i]))
            proof_stream.push(json_hash_path(randomizer_tree.open(i)))

        return proof_stream.serialize()

    # ------------------------------------------------------------------
    # verifier (reference: stark.rs:474-723)
    # ------------------------------------------------------------------

    def verify(
        self,
        proof: bytes,
        transition_constraints: Sequence[MPolynomial],
        boundary: Sequence[BoundaryCondition],
    ) -> bool:
        # infer trace length from boundary conditions
        original_trace_length = 1 + max(c for (c, r, v) in boundary)
        randomized_trace_length = original_trace_length + self.num_randomizers

        proof_stream = ProofStream.deserialize(proof)

        boundary_quotient_roots = [
            proof_stream.pull() for _ in range(self.num_registers)
        ]
        randomizer_root = proof_stream.pull()

        weights = self.sample_weights(
            1 + 2 * len(transition_constraints) + 2 * self.num_registers,
            proof_stream.verifier_fiat_shamir(32),
        )

        polynomial_values: List[Tuple[int, FieldElement]] = []
        if not self.fri.verify(proof_stream, polynomial_values):
            return False
        polynomial_values.sort(key=lambda iv: iv[0])

        indices = [iv[0] for iv in polynomial_values]
        values = [iv[1] for iv in polynomial_values]

        duplicated_indices = sorted(
            indices
            + [(i + self.expansion_factor) % self.fri.domain_length for i in indices]
        )

        # boundary-quotient leaves
        leafs: List[Dict[int, FieldElement]] = []
        for r in range(len(boundary_quotient_roots)):
            root_bytes = bytes.fromhex(boundary_quotient_roots[r])
            leaf_map: Dict[int, FieldElement] = {}
            for i in duplicated_indices:
                leaf_value = json_parse_field_element(proof_stream.pull())
                leaf_map[i] = leaf_value
                auth_path = json_parse_hash_path(proof_stream.pull())
                if not merkle_verify(
                    root_bytes, i, auth_path, bincode_field_element(leaf_value)
                ):
                    return False
            leafs.append(leaf_map)

        # randomizer leaves
        randomizer_root_bytes = bytes.fromhex(randomizer_root)
        randomizer: Dict[int, FieldElement] = {}
        for i in indices:
            leaf_value = json_parse_field_element(proof_stream.pull())
            randomizer[i] = leaf_value
            auth_path = json_parse_hash_path(proof_stream.pull())
            if not merkle_verify(
                randomizer_root_bytes, i, auth_path, bincode_field_element(leaf_value)
            ):
                return False

        # hoisted loop invariants (the reference recomputes these per index)
        zeroifiers = self.boundary_zeroifiers(boundary)
        interpolants = self.boundary_interpolants(boundary)
        max_degree = self.combination_degree(transition_constraints)
        tq_bounds = self.transition_quotient_degree_bounds(transition_constraints)
        bq_bounds = self.boundary_quotient_degree_bounds(
            randomized_trace_length, boundary
        )

        # batched transition-zeroifier evaluation at all query points
        # (vectorized; the per-index dense Horner walk was the verifier's
        # scaling hot spot at large trace lengths) — one batch per
        # DISTINCT exemption set, then inverted once per point
        domain_points = [
            self.generator * self.omega.pow(i) for i in indices
        ]
        exemption_lists = [
            self._exemption_list(i) for i in range(len(transition_constraints))
        ]
        tz_inv_by_exs: Dict[Tuple[int, ...], List[FieldElement]] = {}
        for exs in set(exemption_lists):
            tz_inv_by_exs[exs] = [
                v.inverse() for v in self._tz_eval_batch(domain_points, exs)
            ]

        # large AIRs (e.g. chained permutations whose lifted round-constant
        # interpolants have degree ~trace_length) would walk hundreds of
        # thousands of dict monomials per query point; evaluate those via
        # the grouped decomposition instead — per constraint, a list of
        # (tail, {index: base value}) with base = c_m(g * omega^index)
        big = [len(tc.dict) > BIG_AIR_DICT for tc in transition_constraints]
        air_group_vals = [None] * len(transition_constraints)
        if any(big):
            if self._use_device_pipeline():
                air_group_vals = self._device_air_group_values(
                    transition_constraints, big, indices
                )
            if air_group_vals is None:
                air_group_vals = [None] * len(transition_constraints)
            if not any(air_group_vals):
                # host path: direct multi-point evaluation of the grouped
                # coefficient polys at the query points — never
                # materializes whole FRI-domain codewords (a multi-GB
                # transient at flagship sizes for a verify-only caller)
                air_group_vals = [
                    self._air_group_point_values(tc, indices)
                    if big[s]
                    else None
                    for s, tc in enumerate(transition_constraints)
                ]

        for pos, current_index in enumerate(indices):
            domain_current_index = domain_points[pos]
            next_index = (
                current_index + self.expansion_factor
            ) % self.fri.domain_length
            trace_next_point = domain_current_index * self.omicron

            current_trace = [FieldElement.zero()] * self.num_registers
            next_trace = [FieldElement.zero()] * self.num_registers
            for s in range(self.num_registers):
                current_trace[s] = leafs[s][current_index] * zeroifiers[s].eval(
                    domain_current_index
                ) + interpolants[s].eval(domain_current_index)
                next_trace[s] = leafs[s][next_index] * zeroifiers[s].eval(
                    trace_next_point
                ) + interpolants[s].eval(trace_next_point)

            point = [domain_current_index] + current_trace + next_trace
            state_ints = [fe.value for fe in current_trace + next_trace]
            transition_constraints_values = []
            for s, tc in enumerate(transition_constraints):
                if air_group_vals[s] is None:
                    transition_constraints_values.append(tc.eval(point))
                    continue
                acc = 0
                for tail, base_vals in air_group_vals[s]:
                    term = base_vals[current_index]
                    for vi, e in enumerate(tail):
                        if e:
                            term = term * pow(state_ints[vi], e, P) % P
                    acc = (acc + term) % P
                transition_constraints_values.append(FieldElement(acc))

            terms: List[FieldElement] = [randomizer[current_index]]
            for s, tcv in enumerate(transition_constraints_values):
                quotient = tcv * tz_inv_by_exs[exemption_lists[s]][pos]
                terms.append(quotient)
                shift = max_degree - tq_bounds[s]
                terms.append(quotient * domain_current_index.pow(shift))
            for s in range(self.num_registers):
                bqv = leafs[s][current_index]
                terms.append(bqv)
                shift = max_degree - bq_bounds[s]
                terms.append(bqv * domain_current_index.pow(shift))

            combination = FieldElement.zero()
            for w, term in zip(weights, terms):
                combination = combination + term * w

            if combination != values[pos]:
                return False

        return True
