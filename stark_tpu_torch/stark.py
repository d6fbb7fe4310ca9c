"""STARK prover whose device-resident path runs on a torch device.

:class:`TorchStark` is :class:`stark_tpu.stark.Stark` with every method
that reaches the JAX device modules replaced:

* ``__init__`` swaps ``self.fri`` for a :class:`~stark_tpu_torch.fri.TorchFri`
  built from the same arguments;
* ``_device_core`` always asks the backend
  (:meth:`stark_tpu_torch.ops.backend.TorchBackend.make_prover_core`);
* ``precompile`` is a no-op (PyTorch runs eagerly; the CUDA kernels build
  at first use);
* ``_combination_device``, ``_prove_device`` and the verifier's fast path
  ``_device_air_group_values`` run on torch tensors.

The prove takes the host trace interpolation (its long chirp products go
through ``TorchBackend.poly_multiply``) and the host randomizer pack.
Randomness consumption and transcript bytes equal the host prover's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from stark_tpu.field import FieldElement
from stark_tpu.mpoly import MPolynomial
from stark_tpu.ops.limbs import pack_be17
from stark_tpu.proof_stream import ProofStream
from stark_tpu.rng import draw_concat
from stark_tpu.serialization import json_field_element, json_hash_path
from stark_tpu.stark import BoundaryCondition, Stark
from stark_tpu.utils.profiling import Timer

from .fri import TorchFri
from .ops.device_merkle import plain_digits, roots_batch
from .ops.device_prover import DeviceCodeword, digits_value, fetch_absorb, pad_rows
from .ops.limbs import mont_tensor, to_numpy


class TorchStark(Stark):
    """STARK prover/verifier with the device pipeline on a torch device."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.fri = TorchFri(
            self.generator,
            self.omega,
            self.fri_domain_length,
            self.expansion_factor,
            self.num_colinearity_tests,
            backend=self.backend,
        )

    def precompile(self, transition_constraints=None, trace_length=None, threads=6):
        """Nothing to compile ahead of time (returns None)."""
        return None

    def _device_core(self):
        core = getattr(self, "_device_core_cache", None)
        if core is None:
            core = self._device_core_cache = self.backend.make_prover_core(
                self.fri_domain_length, self.generator.value
            )
        return core

    def _device_air_group_values(self, transition_constraints, big, indices):
        """Verifier fast path for large AIRs: RS-extend the grouped
        coefficient polys on the device (cached, shared with the prover)
        and fetch only the query indices.  Per constraint, a list of
        (tail, {index: base value}), or None for small constraints."""
        core = self._device_core()
        group_cws, structure = self._device_air_groups(core, transition_constraints)
        idx = sorted(set(int(i) for i in indices))
        sel = torch.tensor(idx, device=core.device)
        cols = torch.cat([cw[:, sel] for cw in group_cws], dim=1)
        digits = to_numpy(plain_digits(cols)).T  # (G * K, 4), group-major
        k = len(idx)
        out = []
        for s in range(len(transition_constraints)):
            if not big[s]:
                out.append(None)
                continue
            vals = []
            for tail, gi in structure[s]:
                base = digits[gi * k : (gi + 1) * k]
                vals.append((tail, {i: digits_value(base, r) for r, i in enumerate(idx)}))
            out.append(vals)
        return out

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
    ):
        """Evaluation-space combination on the device; returns a
        DeviceCodeword (same algebra as ``_combination_evaluation``)."""
        omega = self.omega.value
        group_cws, structure = self._device_air_groups(core, transition_constraints)
        tz_invs = tuple(
            self._device_tz_inv(core, self._exemption_list(i)) for i in range(len(transition_constraints))
        )
        tq_tabs = tuple(core.shift_table(max_degree - b, omega) for b in tq_bounds)
        bq_tabs = tuple(core.shift_table(max_degree - b, omega) for b in bq_bounds)
        weights_mont = mont_tensor([w.value for w in weights], core.device)
        trace_cws = tuple(core.extend(tp.coeffs) for tp in trace_polynomials)

        fn = core.combination_fn(structure, len(bq_codewords), self.expansion_factor)
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
        # degree check reduced on the device (reference: stark.rs:379-380)
        tq_degrees = core.degree_probe(tq_stack)
        if tq_degrees != list(tq_bounds):
            raise ValueError(
                f"transition quotient degrees {tq_degrees} do not match "
                f"degree bounds {list(tq_bounds)}"
            )
        return DeviceCodeword(comb_mont, core)

    def _prove_device(
        self,
        trace: Sequence[Sequence[FieldElement]],
        transition_constraints: Sequence[MPolynomial],
        boundary: Sequence[BoundaryCondition],
    ) -> bytes:
        """Device-resident prove: the host pipeline's randomness
        consumption and transcript bytes, with every full-length codeword
        on the device from RS-extension to the FRI folds."""
        prof = Timer()
        self.last_profile = prof
        proof_stream = ProofStream()
        trace = [list(row) for row in trace]

        with prof.region("randomizer_rows"):
            for _ in range(self.num_randomizers):
                trace.append([FieldElement.sample(self.rng(17)) for _ in range(self.num_registers)])

        core = self._device_core()

        # randomizer polynomial drawn and committed first (rng order and
        # transcript push order are those of the host prover)
        with prof.region("randomizer_poly"):
            max_degree = self.combination_degree(transition_constraints)
            with prof.region("randomizer_poly/draw"):
                rand_bytes = draw_concat(self.rng, max_degree + 1, 17)
            with prof.region("randomizer_poly/pack"):
                rand_limbs = pack_be17(rand_bytes)
            with prof.region("randomizer_poly/extend"):
                randomizer_codeword = core.extend_codeword(rand_limbs)
            with prof.region("randomizer_poly/tree"):
                randomizer_tree = core.merkle_tree(randomizer_codeword)

        with prof.region("trace_interpolation"):
            trace_domain = self.omicron_domain[: len(trace)]
            trace_polynomials = [
                self._interpolate_trace(trace_domain, [trace[c][s] for c in range(len(trace))])
                for s in range(self.num_registers)
            ]

        with prof.region("boundary_polys"):
            interpolants = self.boundary_interpolants(boundary)
            zeroifiers = self.boundary_zeroifiers(boundary)
            boundary_quotients = [
                (trace_polynomials[s] - interpolants[s]) / zeroifiers[s] for s in range(self.num_registers)
            ]

        with prof.region("bq_extend"):
            boundary_quotient_codewords = [core.extend_codeword(bq.coeffs) for bq in boundary_quotients]
        with prof.region("bq_merkle_dispatch"):
            boundary_quotient_trees = [core.merkle_tree(cw) for cw in boundary_quotient_codewords]
        with prof.region("bq_merkle"):
            # one fetch for every commitment root (bq registers + randomizer)
            commit_roots = roots_batch(list(boundary_quotient_trees) + [randomizer_tree])
            for root in commit_roots[:-1]:
                proof_stream.push(root.hex())
        with prof.region("randomizer_merkle"):
            proof_stream.push(commit_roots[-1].hex())

        fri_budget = self.fri_domain_length // self.expansion_factor - 1
        if max_degree > fri_budget:
            from stark_tpu.utils import get_logger

            get_logger("stark_tpu_torch.stark").warning(
                "combination degree bound %d exceeds the FRI degree budget "
                "%d for expansion factor %d — honest proofs will NOT verify "
                "with this configuration",
                max_degree,
                fri_budget,
                self.expansion_factor,
            )

        weights = self.sample_weights(
            1 + 2 * len(transition_constraints) + 2 * len(boundary_quotient_codewords),
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
            )

        with prof.region("fri"):
            indices = self.fri.prove(combined_codeword, proof_stream)
        indices.sort()
        duplicated_indices = sorted(
            indices + [(i + self.expansion_factor) % self.fri.domain_length for i in indices]
        )

        with prof.region("openings"):
            # every device gather first, then ONE host transfer
            jobs = []
            with prof.region("openings/gather_dispatch"):
                for cw, idxs in [(c, duplicated_indices) for c in boundary_quotient_codewords] + [
                    (randomizer_codeword, indices)
                ]:
                    got, arr = cw.gather_values_async(idxs)
                    if got:
                        jobs.append((pad_rows(arr, 8), lambda s, c=cw, got=got: c.absorb_values(got, s[:4])))
                for tree, idxs in [(t, duplicated_indices) for t in boundary_quotient_trees] + [
                    (randomizer_tree, indices)
                ]:
                    if hasattr(tree, "gather_siblings_async"):
                        keys, arr = tree.gather_siblings_async(sorted(set(idxs)))
                        if keys:
                            jobs.append((arr, lambda s, t=tree, keys=keys: t.absorb_siblings(keys, s)))
                        tail = tree.tail_async()
                        if tail is not None:
                            jobs.append((tail, lambda s, t=tree: t.absorb_tail(s)))
            with prof.region("openings/fetch"):
                fetch_absorb(jobs)
            with prof.region("openings/serialize"):
                for s in range(self.num_registers):
                    codeword = boundary_quotient_codewords[s]
                    tree = boundary_quotient_trees[s]
                    for i in duplicated_indices:
                        proof_stream.push(json_field_element(codeword.value(i)))
                        proof_stream.push(json_hash_path(tree.open(i)))
                for i in indices:
                    proof_stream.push(json_field_element(randomizer_codeword.value(i)))
                    proof_stream.push(json_hash_path(randomizer_tree.open(i)))

        return proof_stream.serialize()
