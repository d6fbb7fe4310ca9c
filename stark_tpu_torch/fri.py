"""FRI prover over device-resident torch codewords.

:class:`TorchFri` is :class:`stark_tpu.fri.Fri` with the two methods that
reach the JAX device modules replaced: ``_prove_device`` and
``_batch_prefetch``.  The commit phase is the per-round loop: Merkle tree
on the device -> root -> Fiat-Shamir (host Shake256) -> fold on the
device, until the codeword is smaller than a device tree, after which one
fetch hands the rest of the cascade to the host (numpy folds and native-C
trees).  The JAX package's fused on-device Fiat-Shamir cascade is not
ported.  Transcripts are byte-identical to the host prover's.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List

from stark_tpu.field import FieldElement
from stark_tpu.fri import Fri, _fold_digits
from stark_tpu.merkle import MerkleTree
from stark_tpu.params import P
from stark_tpu.proof_stream import ProofStream
from stark_tpu.serialization import json_field_element_vec

from .ops.device_merkle import DEVICE_TREE_MIN, TAIL_WIDTH
from .ops.device_prover import DigitsView, fetch_absorb, pad_rows


class TorchFri(Fri):
    """FRI whose device-resident path runs on a torch device."""

    def _prove_device(self, dcw, proof_stream: ProofStream) -> List[int]:
        """FRI proof from a :class:`~stark_tpu_torch.ops.device_prover.DeviceCodeword`."""
        device_floor = max(DEVICE_TREE_MIN, 2 * TAIL_WIDTH)
        core = dcw.core
        omega = self.omega.value % P
        offset = self.offset.value % P
        rounds = self.num_rounds()

        views: List = []  # per-round DeviceCodewordView / DigitsView
        trees: List = []
        cur = dcw
        for r in range(rounds):
            n = len(cur)
            if pow(omega, n - 1, P) != pow(omega, -1, P):
                raise ValueError("error in commit: omega does not have the right order")
            on_device = hasattr(cur, "mont")
            if on_device and n < device_floor:
                # one fetch; the tail stays a host digit matrix
                cur = DigitsView(cur.digits)
                on_device = False
            tree = core.merkle_tree(cur) if on_device else MerkleTree.from_digits(cur.digits)
            trees.append(tree)
            proof_stream.push(tree.root.hex())

            if r == rounds - 1:
                break

            alpha = FieldElement.sample(proof_stream.prover_fiat_shamir(32)).value
            views.append(cur.view() if on_device else cur)
            if on_device:
                cur = core.fold(cur, alpha, offset, omega)
            else:
                cur = DigitsView(_fold_digits(cur.digits, alpha, offset, omega))
            omega = omega * omega % P
            offset = offset * offset % P

        last = cur.view() if hasattr(cur, "mont") else cur
        proof_stream.push(json_field_element_vec(list(last)))
        views.append(last)
        return self._query_phase(views, trees, proof_stream)

    def _batch_prefetch(self, codewords, trees, top_indices) -> None:
        """Gather every auth-path sibling, tree tail and opened value of the
        whole query phase (a deterministic function of the top-level
        indices) and fetch them in ONE transfer."""
        cw_idx: dict = defaultdict(set)
        tr_idx: dict = defaultdict(set)
        indices = list(top_indices)
        for i in range(len(codewords) - 1):
            half = len(codewords[i]) // 2
            indices = [x % half for x in indices]
            a = list(indices)
            b = [x + half for x in a]
            cw_idx[i].update(a + b)
            cw_idx[i + 1].update(a)
            tr_idx[i].update(a + b)
            tr_idx[i + 1].update(a)
            indices = a + b

        jobs = []
        for i, idxs in tr_idx.items():
            t = trees[i]
            if hasattr(t, "gather_siblings_async"):
                keys, arr = t.gather_siblings_async(sorted(idxs))
                if keys:
                    jobs.append((arr, lambda s, t=t, keys=keys: t.absorb_siblings(keys, s)))
                tail = t.tail_async()
                if tail is not None:
                    jobs.append((tail, lambda s, t=t: t.absorb_tail(s)))
        for i, idxs in cw_idx.items():
            dcw = getattr(codewords[i], "_dcw", None)
            if dcw is not None:
                idx, arr = dcw.gather_values_async(sorted(idxs))
                if idx:
                    jobs.append((pad_rows(arr, 8), lambda s, d=dcw, idx=idx: d.absorb_values(idx, s[:4])))
        fetch_absorb(jobs)
