"""The Fibonacci-like statement of ``configs/fibonacci.json``."""

from __future__ import annotations

from typing import List, Sequence

from portbench.reference import field as F
from portbench.reference.field import P
from portbench.reference.prover import Boundary, Statement


class Fibonacci(Statement):
    """(a, b) -> (a + b, a), ``steps`` times; the claim is register 0 of
    the last row."""

    def __init__(self, steps: int, num_randomizers: int) -> None:
        t = steps + 1
        t_r = t + num_randomizers
        super().__init__(t, num_randomizers, 1 << (2 * t_r).bit_length())
        self.steps = steps

    def trace(self, inputs: Sequence[int]) -> List[List[int]]:
        a, b = inputs[0] % P, inputs[1] % P
        rows = [[a, b]]
        for _ in range(self.steps):
            a, b = (a + b) % P, a
            rows.append([a, b])
        return rows

    def boundary(self, inputs, rows) -> Boundary:
        return [(0, 0, inputs[0] % P), (0, 1, inputs[1] % P), (self.steps, 0, rows[-1][0])]

    def constraints(self, x, prev, nxt):
        return [F.sub(nxt[0], F.add(prev[0], prev[1])), F.sub(nxt[1], prev[0])]

    def degree_bounds(self):
        d = self.randomized_length - 1
        return [d, d]

    def zeroifier_codewords(self, prover) -> List[torch.Tensor]:
        z = prover.zeroifier_codeword(1, prover.omicron, self.trace_length - 1)
        inv = F.inverse(z)
        return [inv, inv], [self.trace_length - 1] * 2


FAMILY = Fibonacci
