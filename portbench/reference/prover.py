"""The reference STARK prover: the statement's trace, the randomizer rows
and polynomial from the seeded stream, the boundary quotients and their
commitments, the weighted combination of the transition and boundary
quotients over the FRI coset, FRI, and the openings, each as the protocol
defines it.  Its proof is the byte string the port must reproduce from the
same statement and the same stream."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from .. import load_file
from . import field as F, geometric as G, ntt as N
from .field import GENERATOR, P
from .merkle import Tree
from .transcript import (SeededStream, Transcript, json_field_element, json_field_element_vec, json_path,
                         json_triple, sample, sample_indices, sample_weights)

HERE = Path(__file__).resolve().parent
Boundary = List[Tuple[int, int, int]]


class Statement:
    """One statement family at one size: its trace, boundary, AIR and the
    domains the protocol sizes from them.  Each family is a file of
    ``families/``, found by the configuration's ``model``."""

    num_registers = 2

    def __init__(self, trace_length: int, num_randomizers: int, omicron_domain_length: int) -> None:
        self.trace_length = trace_length
        self.randomized_length = trace_length + num_randomizers
        self.omicron_domain_length = omicron_domain_length

    # AIR: each constraint's codeword from the state columns, its
    # transition degree bound, and its zeroifier's key
    def constraints(self, x, prev, nxt) -> List[torch.Tensor]:
        raise NotImplementedError

    def degree_bounds(self) -> List[int]:
        raise NotImplementedError
class Prover:
    """The protocol at expansion factor ``expansion``, ``tests``
    colinearity tests, over ``statement``."""

    def __init__(self, statement: Statement, expansion: int, tests: int, device) -> None:
        self.st = statement
        self.expansion = expansion
        self.tests = tests
        self.num_randomizers = 4 * tests
        self.device = device
        self.fri_length = statement.omicron_domain_length * expansion
        self.omega = F.primitive_root(self.fri_length)
        self.omicron = F.primitive_root(statement.omicron_domain_length)
        self.max_degree = self.fri_length // expansion - 1
        self._static = None

    @property
    def draws_per_prove(self) -> int:
        """Draws a prove takes from the stream: the randomizer rows' and the
        randomizer polynomial's coefficients."""
        return self.num_randomizers * self.st.num_registers + self.max_degree + 1

    def zeroifier_codeword(self, start: int, q: int, n: int) -> torch.Tensor:
        coeffs = F.from_ints(G.zeroifier(start, q, n), self.device)
        return N.coset_evaluate(coeffs, GENERATOR, self.fri_length)

    def _statics(self):
        """What depends on the statement's shape alone."""
        if self._static is None:
            dev = self.device
            x = F.powers(self.omega, self.fri_length, dev, start=GENERATOR)
            tz_inv, tz_deg = self.st.zeroifier_codewords(self)
            interp = G.Interpolator(self.omicron, self.st.randomized_length, dev)
            self._static = dict(x=x, tz_inv=tz_inv, tz_deg=tz_deg, interp=interp)
        return self._static

    def _poly_at(self, coeffs: Sequence[int], x: torch.Tensor) -> torch.Tensor:
        """A small polynomial's values at the points x (Horner)."""
        acc = torch.zeros_like(x)
        for c in reversed(coeffs):
            acc = F.add(F.mul(acc, x), F.constant(c, x.device))
        return acc

    def prove(self, inputs: Sequence[int], seed: bytes, counter: int) -> Tuple[int, bytes]:
        """(the claim, the proof) of the statement at ``inputs``, with the
        stream of ``seed`` from draw ``counter`` on."""
        st, dev = self.st, self.device
        s = self._statics()
        x = s["x"]
        n = self.fri_length
        rng = SeededStream(seed, counter)
        rows = st.trace(inputs)
        claim = rows[-1][0]
        boundary = st.boundary(inputs, rows)
        rows = rows + [[sample(rng.draw(17)) for _ in range(st.num_registers)]
                       for _ in range(self.num_randomizers)]
        rand_coeffs = [sample(rng.draw(17)) for _ in range(self.max_degree + 1)]

        ts = Transcript()
        trace_cws = []
        for r in range(st.num_registers):
            col = F.from_ints([row[r] for row in rows], dev)
            coeffs = s["interp"].interpolate(col)
            trace_cws.append(N.coset_evaluate(coeffs, GENERATOR, n))
        bq_cws, bq_bounds = [], []
        for r in range(st.num_registers):
            pts = [(pow(self.omicron, c, P), v) for (c, reg, v) in boundary if reg == r]
            interp = _lagrange(pts)
            zero = [1]
            for (xp, _) in pts:
                zero = _poly_mul(zero, [(-xp) % P, 1])
            num = F.sub(trace_cws[r], self._poly_at(interp, x))
            bq_cws.append(F.mul(num, F.inverse(self._poly_at(zero, x))))
            bq_bounds.append(st.randomized_length - 1 - len(pts))
        bq_trees = [Tree(F.from_mont(cw)) for cw in bq_cws]
        rand_cw = N.coset_evaluate(F.from_ints(rand_coeffs, dev), GENERATOR, n)
        rand_tree = Tree(F.from_mont(rand_cw))
        for t in bq_trees:
            ts.push(t.root.hex())
        ts.push(rand_tree.root.hex())

        n_tc = len(st.degree_bounds())
        weights = [F.constant(w, dev) for w in sample_weights(1 + 2 * n_tc + 2 * st.num_registers, ts.challenge(32))]
        tq_bounds = [b - z for b, z in zip(st.degree_bounds(), s["tz_deg"])]

        nxt = [torch.roll(cw, -self.expansion, dims=1) for cw in trace_cws]
        airs = st.constraints(x, trace_cws, nxt)
        tqs = [F.mul(a, zi) for a, zi in zip(airs, s["tz_inv"])]
        comb = F.mul(weights[0], rand_cw)
        for k, (q, bound) in enumerate(list(zip(tqs, tq_bounds)) + list(zip(bq_cws, bq_bounds))):
            shift = self.max_degree - bound
            xs = F.powers(pow(self.omega, shift, P), n, dev, start=pow(GENERATOR, shift, P))
            comb = F.add(comb, F.add(F.mul(weights[1 + 2 * k], q), F.mul(weights[2 + 2 * k], F.mul(xs, q))))

        indices = self._fri(comb, ts)
        indices.sort()
        dup = sorted(indices + [(i + self.expansion) % n for i in indices])
        for cw, tree in zip(bq_cws, bq_trees):
            vals = _values(cw, dup)
            for i in dup:
                ts.push(json_field_element(vals[i]))
                ts.push(json_path(tree.open(i)))
        vals = _values(rand_cw, indices)
        for i in indices:
            ts.push(json_field_element(vals[i]))
            ts.push(json_path(rand_tree.open(i)))
        return claim, ts.bytes()

    def _fri(self, codeword: torch.Tensor, ts: Transcript) -> List[int]:
        omega, offset = self.omega, GENERATOR
        rounds, length = 0, self.fri_length
        while length > self.expansion and 4 * self.tests < length:
            length //= 2
            rounds += 1
        codewords, trees = [], []
        inv2 = F.constant(pow(2, -1, P), self.device)
        for r in range(rounds):
            tree = Tree(F.from_mont(codeword))
            trees.append(tree)
            ts.push(tree.root.hex())
            codewords.append(codeword)
            if r == rounds - 1:
                break
            alpha = F.constant(sample(ts.challenge(32)), self.device)
            half = codeword.shape[1] // 2
            xinv = F.powers(pow(omega, -1, P), half, self.device, start=pow(offset, -1, P))
            c1, c2 = codeword[:, :half], codeword[:, half:]
            codeword = F.mul(inv2, F.add(F.add(c1, c2), F.mul(F.mul(alpha, xinv), F.sub(c1, c2))))
            omega, offset = omega * omega % P, offset * offset % P
        ts.push(json_field_element_vec(F.mont_ints(codewords[-1])))

        top = sample_indices(ts.challenge(32), codewords[0].shape[1] // 2, codewords[-1].shape[1], self.tests)
        indices = list(top)
        for i in range(len(codewords) - 1):
            half = codewords[i].shape[1] // 2
            c = [idx % half for idx in indices]
            a, b = c, [idx + half for idx in c]
            cur = _values(codewords[i], a[: self.tests] + b[: self.tests])
            nxt = _values(codewords[i + 1], c[: self.tests])
            for k in range(self.tests):
                ts.push(json_triple(cur[a[k]], cur[b[k]], nxt[c[k]]))
            for k in range(self.tests):
                ts.push(json_path(trees[i].open(a[k])))
                ts.push(json_path(trees[i].open(b[k])))
                ts.push(json_path(trees[i + 1].open(c[k])))
            indices = a + b
        return list(top) + [idx + codewords[0].shape[1] // 2 for idx in top]


def _values(cw: torch.Tensor, idxs) -> Dict[int, int]:
    uniq = sorted(set(idxs))
    got = F.mont_ints(cw[:, uniq])
    return dict(zip(uniq, got))


def _poly_mul(a: List[int], b: List[int]) -> List[int]:
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % P
    return out


def _lagrange(pts) -> List[int]:
    """Coefficients of the interpolant through a few points."""
    out = [0]
    for i, (xi, yi) in enumerate(pts):
        num, den = [1], 1
        for j, (xj, _) in enumerate(pts):
            if j != i:
                num = _poly_mul(num, [(-xj) % P, 1])
                den = den * (xi - xj) % P
        scale = yi * pow(den, -1, P) % P
        term = [c * scale % P for c in num]
        out = [((out[k] if k < len(out) else 0) + (term[k] if k < len(term) else 0)) % P
               for k in range(max(len(out), len(term)))]
    return out


def family(model: str):
    """The statement family a configuration's ``model`` names:
    ``families/<model>.py``, its ``FAMILY``."""
    return load_file(HERE / "families" / f"{model}.py", f"portbench.reference.families.{model}").FAMILY


def make_prover(model: str, size: int, expansion: int, tests: int, device) -> Prover:
    return Prover(family(model)(size, 4 * tests), expansion, tests, device)
