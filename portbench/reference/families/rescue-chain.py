"""The chain of Rescue-Prime hashes of ``configs/rescue-chain.json``."""

from __future__ import annotations

from portbench.reference import field as F, geometric as G, ntt as N, rescue
from portbench.reference.field import GENERATOR, P
from portbench.reference.prover import Boundary, Statement


class RescueChain(Statement):
    """A chain of ``hashes`` Rescue-Prime hashes, 28 rows a hash; the claim
    is register 0 of the last row.  The round constraints hold on every
    transition but the crossings between hashes, the link constraints
    (the digest carried, the capacity reset) only on the crossings."""

    def __init__(self, hashes: int, num_randomizers: int) -> None:
        t = (rescue.N + 1) * hashes
        t_r = t + num_randomizers
        worst = 3 * (t_r - 1) - (t - hashes)
        odl = 1 << (2 * t_r).bit_length()
        while odl - 1 < worst:
            odl *= 2
        super().__init__(t, num_randomizers, odl)
        self.hashes = hashes
        self._constants = None

    def trace(self, inputs):
        return rescue.chain_trace(inputs[0] % P, self.hashes)

    def boundary(self, inputs, rows) -> Boundary:
        return [(0, 1, 0), (self.trace_length - 1, 0, rows[-1][0])]

    def _constant_codewords(self, prover):
        """C1_i, C2_k over the coset: the interpolants over the first T - 1
        trace points of the round constants of each row (0 on crossings)."""
        if self._constants is None:
            t = self.trace_length - 1
            interp = G.Interpolator(prover.omicron, t, prover.device)
            cols = []
            for which in range(2 * rescue.M):  # C1_0, C1_1, C2_0, C2_1
                step, i = divmod(which, rescue.M)
                vals = [rescue.RC[2 * (c % 28) * rescue.M + step * rescue.M + i] if c % 28 < rescue.N else 0
                        for c in range(t)]
                coeffs = interp.interpolate(F.from_ints(vals, prover.device))
                cols.append(N.coset_evaluate(coeffs, GENERATOR, prover.fri_length))
            self._constants = cols
        return self._constants

    def constraints(self, x, prev, nxt):
        c1_0, c1_1, c2_0, c2_1 = self._constants
        mds = [[F.constant(v, x.device) for v in row] for row in rescue.MDS]
        inv = [[F.constant(v, x.device) for v in row] for row in rescue.MDS_INV]
        cubes = [F.mul(F.mul(s, s), s) for s in prev]
        c1, c2 = (c1_0, c1_1), (c2_0, c2_1)
        out = []
        for i in range(2):
            lhs = F.add(F.add(F.mul(mds[i][0], cubes[0]), F.mul(mds[i][1], cubes[1])), c1[i])
            r = F.add(F.mul(inv[i][0], F.sub(nxt[0], c2[0])), F.mul(inv[i][1], F.sub(nxt[1], c2[1])))
            out.append(F.sub(lhs, F.mul(F.mul(r, r), r)))
        out.append(F.sub(nxt[0], prev[0]))
        out.append(nxt[1])
        return out

    def degree_bounds(self):
        d = self.randomized_length - 1
        return [3 * d, 3 * d, d, d]

    def zeroifier_codewords(self, prover):
        self._constant_codewords(prover)
        o = prover.omicron
        every = prover.zeroifier_codeword(1, o, self.trace_length - 1)
        links = prover.zeroifier_codeword(pow(o, 27, P), pow(o, 28, P), self.hashes - 1)
        links_inv = F.inverse(links)
        rounds_inv = F.mul(F.inverse(every), links)
        n_rounds = self.trace_length - 1 - (self.hashes - 1)
        return ([rounds_inv, rounds_inv, links_inv, links_inv],
                [n_rounds, n_rounds, self.hashes - 1, self.hashes - 1])


FAMILY = RescueChain
