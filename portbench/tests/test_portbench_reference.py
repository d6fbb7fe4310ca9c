"""The reference against the port's proofs and against the definitions,
at sizes the CPU holds."""

import hashlib
import random

import pytest

from portbench.reference import blake2b as B, field as F, geometric as G, merkle as M, ntt as N, rescue
from portbench.reference.prover import make_prover

P = F.P


def test_field_operations_against_python_integers():
    rnd = random.Random(1)
    a = [rnd.randrange(P) for _ in range(500)] + [0, P - 1, 1]
    b = [rnd.randrange(P) for _ in range(500)] + [P - 1, P - 1, 0]
    A, Bt = F.from_ints(a, "cpu"), F.from_ints(b, "cpu")
    assert F.mont_ints(F.mul(A, Bt)) == [x * y % P for x, y in zip(a, b)]
    assert F.mont_ints(F.add(A, Bt)) == [(x + y) % P for x, y in zip(a, b)]
    assert F.mont_ints(F.sub(A, Bt)) == [(x - y) % P for x, y in zip(a, b)]
    nz = [x or 1 for x in a]
    assert F.mont_ints(F.inverse(F.from_ints(nz, "cpu"))) == [pow(x, -1, P) for x in nz]
    assert F.mont_ints(F.powers(7, 37, "cpu", start=3)) == [3 * pow(7, i, P) % P for i in range(37)]


def test_transforms_against_their_definitions():
    rnd = random.Random(2)
    n = 32
    w = F.primitive_root(n)
    xs = [rnd.randrange(P) for _ in range(n)]
    got = F.mont_ints(N.ntt(F.from_ints(xs, "cpu"), w))
    assert got == [sum(x * pow(w, i * j, P) for j, x in enumerate(xs)) % P for i in range(n)]
    a, b = [rnd.randrange(P) for _ in range(5)], [rnd.randrange(P) for _ in range(9)]
    prod = [0] * 13
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            prod[i + j] = (prod[i + j] + x * y) % P
    assert F.mont_ints(N.multiply(F.from_ints(a, "cpu"), F.from_ints(b, "cpu"))) == prod
    q = F.primitive_root(128)
    ys = [rnd.randrange(P) for _ in range(45)]
    c = F.mont_ints(G.Interpolator(q, 45, "cpu").interpolate(F.from_ints(ys, "cpu")))
    assert all(sum(cc * pow(q, i * j, P) for j, cc in enumerate(c)) % P == ys[i] for i in range(45))


def _bincode(v):
    d = []
    while v:
        d.append(v & 0xFFFFFFFF)
        v >>= 32
    return (1 if not d else 2).to_bytes(4, "little") + len(d).to_bytes(8, "little") + b"".join(
        x.to_bytes(4, "little") for x in d)


def test_leaves_and_trees_against_hashlib(monkeypatch):
    rnd = random.Random(3)
    vals = [0, 1, 2**32, 2**64 + 5, 2**96, P - 1] + [rnd.randrange(P) for _ in range(250)]
    words, length = B.leaf_words(F.limbs(vals, "cpu"))
    assert B.digest_bytes(B.blake2b_256(words, length)) == [
        hashlib.blake2b(_bincode(v), digest_size=32).digest() for v in vals]
    monkeypatch.setattr(M, "HOST_WIDTH", 16)
    tree = M.Tree(F.limbs(vals, "cpu"))
    level = b"".join(hashlib.blake2b(_bincode(v), digest_size=32).digest() for v in vals)
    levels = [level]
    while len(level) > 32:
        level = b"".join(hashlib.blake2b(level[i:i + 64], digest_size=32).digest() for i in range(0, len(level), 64))
        levels.append(level)
    assert tree.root == levels[-1]
    assert tree.open(77) == [levels[k][32 * ((77 >> k) ^ 1):32 * ((77 >> k) ^ 1) + 32] for k in range(8)]


def test_rescue_golden_hashes():
    assert rescue.permutation_states(1)[-1][0] == 244180265933090377212304188905974087294
    assert rescue.permutation_states(57322816861100832358702415967512842988)[-1][0] == \
        89633745865384635541695204788332415101


@pytest.mark.parametrize("family,size,device", [("fibonacci", 1000, "cpu"), ("rescue-chain", 4, None),
                                                ("rescue-chain", 20, "cpu")])
def test_the_reference_reproduces_the_ports_proofs(family, size, device):
    """The port's proof bytes (device pipeline's plain versions on the CPU,
    or its host prover) from a seeded stream, and the reference's from the
    same statement and stream position."""
    from stark_tpu_torch.field import FieldElement
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.models.rescue_chain import RescueChainStark
    from stark_tpu_torch.rng import DeterministicRandom

    seed = hashlib.sha256(family.encode()).digest()
    rng = DeterministicRandom(seed)
    if family == "fibonacci":
        model, inputs = FibonacciStark(size, device=device, rng=rng), [(3, 5), (P - 2, 12345)]
    else:
        model, inputs = RescueChainStark(size, device=device, rng=rng), [(7,), (P - 1,)]
    progs = [model.prove(*[FieldElement(v) for v in inp]) for inp in inputs]
    ref = make_prover(family, size, 4, 2, "cpu")
    for k, (inp, (claim, proof)) in enumerate(zip(inputs, progs)):
        ref_claim, ref_proof = ref.prove(inp, seed, k * ref.draws_per_prove)
        assert ref_claim == claim.value
        assert ref_proof == proof
