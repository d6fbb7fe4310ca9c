"""FRI low-degree proof protocol (commit / fold / query / verify).

Protocol and transcript semantics match the reference exactly
(reference: fri.rs:28-417):

* per round the prover Merkle-commits the codeword (hex root in the
  transcript), samples alpha = sample(Shake256-FS 32B), and folds
      c'_i = 1/2 * [ (1 + alpha/(offset*omega^i)) * c_i
                   + (1 - alpha/(offset*omega^i)) * c_{i + N/2} ]
* the last codeword goes into the transcript as JSON
* query indices come from Blake2b-512(seed || counter_le_u64) folded mod
  size, deduplicated by (index mod reduced_size)
* colinearity points travel as decimal-string triples, auth paths as JSON

Compute backend: the fold and the inverse table are batched.  Unlike the
reference's per-element `alpha / (offset*omega^i)` division (two
extended-Euclid inversions per element, fri.rs:136), the fold uses a
precomputed table of (offset*omega^i)^{-1} built from one inversion via a
running-product.  A device-resident codeword (:meth:`Fri._prove_device`)
runs its large rounds as the fused commit cascade on the torch device:
tree -> hex root -> Shake256 Fiat-Shamir -> alpha -> fold, with no host
round trip until the stacked roots are fetched once
(:meth:`stark_tpu_torch.ops.device_prover.DeviceProverCore.fri_cascade`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .field import FieldElement
from .hashing import blake2b_512
from .merkle import MerkleTree, verify as merkle_verify
from .params import P
from .poly import Polynomial
from .proof_stream import ProofStream
from .serialization import (
    bincode_field_element,
    json_field_element_vec,
    json_hash_path,
    json_parse_field_element_vec,
    json_parse_hash_path,
    json_parse_string_triple,
    json_string_triple,
)

_U64_MASK = (1 << 64) - 1


def sample_index(byte_array: bytes, size: int) -> int:
    """Big-endian byte fold with 64-bit wraparound, mod size
    (reference: fri.rs:81-87 — `usize` arithmetic wraps at 2^64)."""
    acc = 0
    for b in byte_array:
        acc = ((acc << 8) ^ b) & _U64_MASK
    return acc % size


def sample_indices(
    seed: bytes, size: int, reduced_size: int, number: int
) -> List[int]:
    """Blake2b-512(seed || counter) index stream, deduplicated by reduced
    index (reference: fri.rs:54-78).

    Guard the reference lacks: asking for more samples than there are
    distinct reduced indices loops forever there (fri.rs:59); here it is
    a clear error."""
    if number > reduced_size:
        raise ValueError(
            f"cannot sample {number} indices with only {reduced_size} "
            "distinct reduced indices"
        )
    indices: List[int] = []
    reduced_indices: List[int] = []
    counter = 0
    while len(indices) < number:
        digest = blake2b_512(seed + counter.to_bytes(8, "little"))
        index = sample_index(digest, size)
        reduced = index % reduced_size
        counter += 1
        if reduced not in reduced_indices:
            indices.append(index)
            reduced_indices.append(reduced)
    return indices


def _serialize_leaves(codeword: Sequence[int]) -> List[bytes]:
    return [bincode_field_element(c) for c in codeword]


def _inverse_table(offset: int, omega: int, half: int) -> List[int]:
    """[(offset * omega^i)^{-1} for i < half] via a single inversion."""
    xs = [0] * half
    cur = offset % P
    for i in range(half):
        xs[i] = cur
        cur = cur * omega % P
    # batch inversion (Montgomery's trick)
    prefix = [1] * (half + 1)
    for i in range(half):
        prefix[i + 1] = prefix[i] * xs[i] % P
    inv_all = pow(prefix[half], -1, P)
    out = [0] * half
    for i in range(half - 1, -1, -1):
        out[i] = prefix[i] * inv_all % P
        inv_all = inv_all * xs[i] % P
    return out


def _fold_digits(digits, alpha: int, offset: int, omega: int):
    """One fold round over an (n, 4) uint32 plain-form digit matrix,
    vectorized in :mod:`stark_tpu_torch.hostops`; returns the folded (n/2, 4)
    matrix.  Bit-identical to :meth:`Fri._fold_host` on the same values
    (same mod-p algebra) — this is the device prover's host-tail fold,
    which never materializes Python ints for whole codewords."""
    import numpy as np

    from . import hostops as ho

    n = digits.shape[0]
    half = n // 2
    plain = np.ascontiguousarray(digits.T).astype(np.uint64)  # (4, n)
    r2 = ho.pack32([ho._R2_32])
    c1 = ho.mul(plain[:, :half], r2)  # -> Montgomery form
    c2 = ho.mul(plain[:, half:], r2)
    # Montgomery table of (offset * omega^i)^{-1} = offset^{-1} *
    # (omega^{-1})^i, built by doubling (log(half) vector multiplies)
    winv = pow(omega, -1, P)
    col = ho.to_mont([pow(offset, -1, P)])
    k = 1
    while k < half:
        step = ho.to_mont([pow(winv, k, P)])
        col = np.concatenate([col, ho.mul(col, step)], axis=1)
        k *= 2
    col = col[:, :half]
    aim = ho.mul(ho.to_mont([alpha % P]), col)  # mont(alpha * inv_i)
    onem = ho.to_mont([1])
    t1 = ho.add(np.broadcast_to(onem, aim.shape), aim)
    t2 = ho.sub(np.broadcast_to(onem, aim.shape), aim)
    s = ho.add(ho.mul(t1, c1), ho.mul(t2, c2))
    out_m = ho.mul(s, ho.to_mont([pow(2, -1, P)]))
    out_plain = ho.mul(out_m, ho.pack32([1]))  # de-Montgomery
    return np.ascontiguousarray(out_plain.T).astype(np.uint32)


class Fri:
    """FRI prover/verifier over the coset {offset * omega^i}."""

    def __init__(
        self,
        offset: FieldElement,
        omega: FieldElement,
        initial_domain_length: int,
        expansion_factor: int,
        num_colinearity_tests: int,
        backend=None,
    ) -> None:
        self.offset = offset
        self.omega = omega
        self.domain_length = initial_domain_length
        self.expansion_factor = expansion_factor
        self.num_colinearity_tests = num_colinearity_tests
        self.backend = backend
        #: rounds the last device prove ran as the fused commit cascade
        self.last_fused_rounds = 0
        if self.num_rounds() < 1:
            raise ValueError("cannot do FRI with less than 1 round")

    def num_rounds(self) -> int:
        """Halve while len > expansion and 4*tests < len
        (reference: fri.rs:39-51)."""
        codeword_length = self.domain_length
        num = 0
        while (
            codeword_length > self.expansion_factor
            and 4 * self.num_colinearity_tests < codeword_length
        ):
            codeword_length //= 2
            num += 1
        return num

    def eval_domain(self) -> List[FieldElement]:
        """The coset {offset * omega^i} (reference: fri.rs:90-97)."""
        out = []
        cur = self.offset.value % P
        w = self.omega.value % P
        for _ in range(self.domain_length):
            out.append(FieldElement(cur))
            cur = cur * w % P
        return out

    # -- prover -----------------------------------------------------------

    def _fold(
        self, codeword: List[int], alpha: int, offset: int, omega: int
    ) -> List[int]:
        half = len(codeword) // 2
        floor = getattr(self.backend, "min_device_size", 256)
        if self.backend is not None and half >= floor:
            return self.backend.fri_fold(codeword, alpha, offset, omega)
        return self._fold_host(codeword, alpha, offset, omega)

    @staticmethod
    def _fold_host(
        codeword: List[int], alpha: int, offset: int, omega: int
    ) -> List[int]:
        half = len(codeword) // 2
        if half >= 32:
            try:  # native two-limb Montgomery kernel (bit-identical)
                from .native import fieldvec as _fv

                return _fv.fri_fold(codeword, alpha, offset, omega)
            except ImportError:
                pass
        inv = _inverse_table(offset, omega, half)
        two_inv = pow(2, -1, P)
        out = [0] * half
        for i in range(half):
            ai = alpha * inv[i] % P
            out[i] = (
                two_inv
                * ((1 + ai) * codeword[i] + (1 - ai) * codeword[half + i])
                % P
            )
        return out

    def commit(
        self, codeword: List[int], proof_stream: ProofStream
    ) -> Tuple[List[List[int]], List[MerkleTree]]:
        """Commit phase: per-round Merkle root + fold
        (reference: fri.rs:100-152).  Also returns the per-round trees so
        the query phase can open leaves without re-hashing."""
        omega = self.omega.value % P
        offset = self.offset.value % P
        codewords: List[List[int]] = []
        trees: List[MerkleTree] = []
        rounds = self.num_rounds()
        for r in range(rounds):
            n = len(codeword)
            # omega must have order n (reference: fri.rs:116); a typed error
            # (not assert) so the invariant survives `python -O`
            if pow(omega, n - 1, P) != pow(omega, -1, P):
                raise ValueError(
                    "error in commit: omega does not have the right order"
                )
            tree = MerkleTree.from_codeword(codeword)
            trees.append(tree)
            proof_stream.push(tree.root.hex())

            if r == rounds - 1:
                break

            alpha = FieldElement.sample(proof_stream.prover_fiat_shamir(32)).value
            codewords.append(codeword)
            codeword = self._fold(codeword, alpha, offset, omega)
            omega = omega * omega % P
            offset = offset * offset % P

        proof_stream.push(json_field_element_vec(codeword))
        codewords.append(codeword)
        return codewords, trees

    def query(
        self,
        current_tree: MerkleTree,
        next_tree: MerkleTree,
        current_codeword: List[int],
        next_codeword: List[int],
        c_indices: List[int],
        proof_stream: ProofStream,
    ) -> List[int]:
        """Reveal colinearity points + auth paths for one round boundary
        (reference: fri.rs:155-209)."""
        half = len(current_codeword) // 2
        a_indices = list(c_indices)
        b_indices = [idx + half for idx in c_indices]

        # device-resident codewords/trees: pull every value and auth-path
        # sibling this round will open in a few batched fetches instead of
        # per-index round trips (no-ops for host lists/trees)
        for obj, idxs in (
            (current_codeword, a_indices + b_indices),
            (next_codeword, c_indices),
            (current_tree, a_indices + b_indices),
            (next_tree, c_indices),
        ):
            if hasattr(obj, "prefetch"):
                obj.prefetch(idxs)

        for s in range(self.num_colinearity_tests):
            proof_stream.push(
                json_string_triple(
                    str(current_codeword[a_indices[s]]),
                    str(current_codeword[b_indices[s]]),
                    str(next_codeword[c_indices[s]]),
                )
            )
        for s in range(self.num_colinearity_tests):
            proof_stream.push(json_hash_path(current_tree.open(a_indices[s])))
            proof_stream.push(json_hash_path(current_tree.open(b_indices[s])))
            proof_stream.push(json_hash_path(next_tree.open(c_indices[s])))

        return a_indices + b_indices

    def _batch_prefetch(self, codewords, trees, top_indices) -> None:
        """Device provers: every round's index set is a deterministic
        function of the top-level indices, so ALL auth-path siblings,
        tree tails and opened values of the whole query phase can be
        gathered up front and fetched ONCE.  No-op for host lists/trees."""
        from collections import defaultdict

        from .ops.device_prover import fetch_absorb, pad_rows

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
                    jobs.append(
                        (arr, lambda s, t=t, keys=keys: t.absorb_siblings(keys, s))
                    )
            if hasattr(t, "tail_async"):
                # trees from the fused cascade haven't fetched their 32 KB
                # top-level tail yet (the root came back with the cascade's
                # batched root fetch); bundle every tail into this one fetch
                # instead of a blocking fetch per tree at first open()
                tail = t.tail_async()
                if tail is not None:
                    jobs.append((tail, lambda s, t=t: t.absorb_tail(s)))
        for i, idxs in cw_idx.items():
            dcw = getattr(codewords[i], "_dcw", None)
            if dcw is not None and hasattr(dcw, "gather_values_async"):
                idx, arr = dcw.gather_values_async(sorted(idxs))
                if idx:
                    jobs.append((
                        pad_rows(arr, 8),
                        lambda s, d=dcw, idx=idx: d.absorb_values(idx, s[:4]),
                    ))
        fetch_absorb(jobs)

    def _query_phase(
        self, codewords: Sequence, trees: List[MerkleTree], proof_stream: ProofStream
    ) -> List[int]:
        """Top-index sampling + per-round queries (shared by the host and
        device provers; reference: fri.rs:218-254)."""
        top_level_indices = sample_indices(
            proof_stream.prover_fiat_shamir(32),
            len(codewords[0]) // 2,
            len(codewords[-1]),
            self.num_colinearity_tests,
        )
        self._batch_prefetch(codewords, trees, top_level_indices)
        indices = list(top_level_indices)

        for i in range(len(codewords) - 1):
            half = len(codewords[i]) // 2
            indices = [idx % half for idx in indices]
            indices = self.query(
                trees[i],
                trees[i + 1],
                codewords[i],
                codewords[i + 1],
                indices,
                proof_stream,
            )

        a_indices = list(top_level_indices)
        b_indices = [idx + len(codewords[0]) // 2 for idx in top_level_indices]
        return a_indices + b_indices

    def prove(self, codeword, proof_stream: ProofStream) -> List[int]:
        """Full FRI proof; returns the top-level a+b indices
        (reference: fri.rs:212-254).  Accepts a plain codeword (list of
        residues / FieldElements) or a device-resident
        :class:`stark_tpu_torch.ops.device_prover.DeviceCodeword`."""
        if hasattr(codeword, "mont"):
            return self._prove_device(codeword, proof_stream)
        codeword = [
            c.value if isinstance(c, FieldElement) else c % P for c in codeword
        ]
        codewords, trees = self.commit(codeword, proof_stream)
        return self._query_phase(codewords, trees, proof_stream)

    def _prove_device(self, dcw, proof_stream: ProofStream) -> List[int]:
        """FRI proof from a device-resident codeword.  While codewords are
        device-tree sized, the rounds run as the fused commit cascade
        (:meth:`~stark_tpu_torch.ops.device_prover.DeviceProverCore.fri_cascade`):
        tree, Fiat-Shamir and fold enqueue on the device round after round,
        and the host reads the round roots in one fetch afterwards.  The
        remaining rounds run per round, and once the codeword is smaller
        than a device tree the rest of the cascade runs on the host from
        ONE fetch.  Transcripts are byte-identical to :meth:`prove` on the
        gathered codeword.  ``last_fused_rounds`` records how many rounds
        the cascade took."""
        from .ops import device_merkle
        from .ops.device_merkle import TAIL_WIDTH, DeviceMerkleTree
        from .ops.device_prover import DeviceCodeword, DigitsView
        from .ops.limbs import to_numpy
        from .serialization import bincode_string_vec

        device_floor = max(device_merkle.DEVICE_TREE_MIN, 2 * TAIL_WIDTH)
        core = dcw.core
        omega = self.omega.value % P
        offset = self.offset.value % P
        rounds = self.num_rounds()

        views: List = []  # per-round DeviceCodewordView / DigitsView
        trees: List[MerkleTree] = []
        cur = dcw

        # fused commit cascade while codewords are device-tree sized, on a
        # core that has one (a sharded core commits round by round below,
        # with Fiat-Shamir on the host)
        n0 = len(cur)
        k = 0
        if hasattr(core, "fri_cascade"):
            while k < rounds - 1 and (n0 >> k) >= device_floor:
                k += 1
        if k < 2:
            k = 0
        self.last_fused_rounds = k
        if k:
            w, o = omega, offset
            for r in range(k):
                if pow(w, (n0 >> r) - 1, P) != pow(w, -1, P):
                    raise ValueError(
                        "error in commit: omega does not have the "
                        "right order"
                    )
                w, o = w * w % P, o * o % P
            body = bincode_string_vec(proof_stream.objects)[8:]
            per_round, roots_arr, final_mont = core.fri_cascade(
                cur.mont, body, len(proof_stream.objects),
                offset, omega, k,
            )
            roots = to_numpy(roots_arr)  # the cascade's one host fetch
            for r in range(k):
                root = np.ascontiguousarray(roots[r].astype("<u4")).tobytes()
                mont_r, levels_r = per_round[r]
                trees.append(
                    DeviceMerkleTree.from_cascade(n0 >> r, levels_r, root)
                )
                proof_stream.push(root.hex())
                views.append(DeviceCodeword(mont_r, core).view())
            cur = DeviceCodeword(final_mont, core)
            omega, offset = w, o

        for r in range(k, rounds):
            n = len(cur)
            if pow(omega, n - 1, P) != pow(omega, -1, P):
                raise ValueError(
                    "error in commit: omega does not have the right order"
                )
            on_device = hasattr(cur, "mont")
            if on_device and n < device_floor:
                # one fetch; the tail stays a host digit matrix (numpy
                # folds + native-C trees, no Python-int codewords)
                cur = DigitsView(cur.digits)
                on_device = False
            if on_device:
                tree = core.merkle_tree(cur)
            else:
                tree = MerkleTree.from_digits(cur.digits)
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

    # -- verifier ---------------------------------------------------------

    def verify(
        self,
        proof_stream: ProofStream,
        polynomial_values: List[Tuple[int, FieldElement]],
    ) -> bool:
        """Verify a FRI transcript; fills ``polynomial_values`` with the
        top-level (index, value) pairs (reference: fri.rs:256-417)."""
        omega = self.omega.value % P
        offset = self.offset.value % P
        rounds = self.num_rounds()

        roots: List[str] = []
        alphas: List[int] = []
        for _ in range(rounds):
            roots.append(proof_stream.pull())
            alphas.append(
                FieldElement.sample(proof_stream.verifier_fiat_shamir(32)).value
            )

        last_codeword = [fe.value for fe in json_parse_field_element_vec(proof_stream.pull())]

        # last codeword must match the last committed root
        if roots[-1] != MerkleTree.from_codeword(last_codeword).root.hex():
            return False

        # low-degree check on the last codeword
        degree = len(last_codeword) // self.expansion_factor - 1
        last_omega, last_offset = omega, offset
        for _ in range(rounds - 1):
            last_omega = last_omega * last_omega % P
            last_offset = last_offset * last_offset % P
        # the last codeword's length is proof-controlled: a crafted proof
        # shortening it (with a consistent root) must be cleanly rejected,
        # never crash the verifier (and `assert` would vanish under -O)
        if pow(last_omega, -1, P) != pow(last_omega, len(last_codeword) - 1, P):
            return False

        last_domain = []
        cur = last_offset
        for _ in range(len(last_codeword)):
            last_domain.append(cur)
            cur = cur * last_omega % P
        poly = Polynomial.lagrange(last_domain, last_codeword)
        if [fe.value for fe in poly.eval_domain(last_domain)] != last_codeword:
            return False
        if poly.degree() > degree:
            return False

        top_level_indices = sample_indices(
            proof_stream.verifier_fiat_shamir(32),
            self.domain_length >> 1,
            self.domain_length >> (rounds - 1),
            self.num_colinearity_tests,
        )

        for r in range(rounds - 1):
            half = self.domain_length >> (r + 1)
            c_indices = [idx % half for idx in top_level_indices]
            a_indices = list(c_indices)
            b_indices = [idx + half for idx in c_indices]

            aa: List[int] = []
            bb: List[int] = []
            cc: List[int] = []
            for s in range(self.num_colinearity_tests):
                ay_s, by_s, cy_s = json_parse_string_triple(proof_stream.pull())
                ay, by, cy = int(ay_s) % P, int(by_s) % P, int(cy_s) % P
                aa.append(ay)
                bb.append(by)
                cc.append(cy)

                if r == 0:
                    polynomial_values.append((a_indices[s], FieldElement(ay)))
                    polynomial_values.append((b_indices[s], FieldElement(by)))

                ax = offset * pow(omega, a_indices[s], P) % P
                bx = offset * pow(omega, b_indices[s], P) % P
                cx = alphas[r]
                if not Polynomial.test_colinearity([(ax, ay), (bx, by), (cx, cy)]):
                    return False

            for i in range(self.num_colinearity_tests):
                root_bytes = bytes.fromhex(roots[r])
                next_root_bytes = bytes.fromhex(roots[r + 1])
                path = json_parse_hash_path(proof_stream.pull())
                if not merkle_verify(
                    root_bytes, a_indices[i], path, bincode_field_element(aa[i])
                ):
                    return False
                path = json_parse_hash_path(proof_stream.pull())
                if not merkle_verify(
                    root_bytes, b_indices[i], path, bincode_field_element(bb[i])
                ):
                    return False
                path = json_parse_hash_path(proof_stream.pull())
                if not merkle_verify(
                    next_root_bytes, c_indices[i], path, bincode_field_element(cc[i])
                ):
                    return False

            omega = omega * omega % P
            offset = offset * offset % P

        return True
