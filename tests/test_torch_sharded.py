"""The port's sharded prover (stark_tpu_torch.parallel) on CPU meshes.

Mirrors the 13 tests of ``tests/test_sharded_{ntt,fri,merkle,stark}.py``
on meshes of 2, 4 and 8 shards on ``torch.device("cpu")`` (the plain
kernel versions), each held against the JAX package's host code on the
same inputs: ``ShardedNTT`` forward and inverse against its host NTT, the
round trip, ``inverse_from_fourstep``, ``_split``'s refusals, shard-local
fold pairs against its host fold, the sharded tree against its
``merkle.MerkleTree``, FRI transcripts identical to its host ``Fri``'s,
and proofs byte-identical to its host prover: fib-120 (the JAX package's
dryrun statement, a 2048-point domain) on 4 and 8 shards at seed 21 (the
JAX test's fib-2000, a 2^14-point domain, takes 5-7 s through the plain
versions on one core; the 2^14-point FRI transcript test runs the sharded
folds and block trees at that size), chain-4 at seed 9 on 8 shards with
``device_prover_min=1024``.  Beside them:
``ShardedNTT.forward`` against the JAX package's ``ShardedNTT`` on
``cpu_mesh(8)`` limb for limb, the next-row operand and K10's
row-by-column form against their definitions, the sharded device tree
(the block trees the card runs) against the host tree, and each
capability check of ``Stark`` / ``Fri`` with a stub core that lacks the
method.

Tolerance: none (limbs, roots, transcripts and proofs compared exactly).
"""

import random

import numpy as np
import pytest
import torch

from stark_tpu.field import FieldElement as JaxFieldElement
from stark_tpu.fri import Fri as JaxFri
from stark_tpu.merkle import MerkleTree as JaxMerkleTree
from stark_tpu.models.fibonacci import FibonacciStark as JaxFibonacciStark
from stark_tpu.models.rescue_chain import RescueChainStark as JaxRescueChainStark
from stark_tpu.ntt import NTT as JaxNTT
from stark_tpu.poly import Polynomial as JaxPolynomial
from stark_tpu.proof_stream import ProofStream as JaxProofStream
from stark_tpu.rng import DeterministicRandom as JaxRandom
from stark_tpu_torch.field import FieldElement
from stark_tpu_torch.fri import Fri
from stark_tpu_torch.models.fibonacci import FibonacciStark
from stark_tpu_torch.models.rescue_chain import RescueChainStark
from stark_tpu_torch.ops import cuda_combination as cc
from stark_tpu_torch.ops import cuda_field as cf
from stark_tpu_torch.ops import cuda_ntt
from stark_tpu_torch.ops import device_merkle
from stark_tpu_torch.ops.device_prover import DigitsView
from stark_tpu_torch.ops.limbs import mont_tensor, pack, to_numpy, unpack
from stark_tpu_torch.params import GENERATOR, P, R_MOD_P
from stark_tpu_torch.parallel import ShardedBackend, ShardedNTT, cpu_mesh
from stark_tpu_torch.parallel.merkle_sharded import ShardedMerkleTree, tree_from_blocks
from stark_tpu_torch.parallel.mesh import EXCHANGES, ShardedArray, reset_exchange_counts
from stark_tpu_torch.parallel.ntt_sharded import _split
from stark_tpu_torch.parallel.stark_sharded import ShardedProverCore
from stark_tpu_torch.proof_stream import ProofStream
from stark_tpu_torch.rng import DeterministicRandom

torch.set_num_threads(1)


def _mont_input(sntt, vals):
    return sntt.shard_input(sntt.to_matrix(pack([v * R_MOD_P % P for v in vals])))


def _plain(t: torch.Tensor):
    return unpack(to_numpy(cf.from_mont(t.reshape(8, -1).contiguous())))


def _values(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def _codeword(dcw):
    return list(DigitsView(dcw.digits))


# -- the transform ------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_forward_matches_host(shards):
    n = 1 << 12
    vals = _values(n, shards)
    sntt = ShardedNTT(n, cpu_mesh(shards))
    reset_exchange_counts()
    out = sntt.forward(_mont_input(sntt, vals))
    assert [tuple(t.shape) for t in out.shards] == [(8, sntt.C, sntt.R // shards)] * shards
    assert _plain(sntt.from_output_matrix(out)) == JaxNTT(n).forward(vals)
    assert EXCHANGES["calls"] == 1 and EXCHANGES["bytes"] == 32 * n and EXCHANGES["chunks"] == shards ** 2


def test_sharded_round_trip():
    n = 1 << 11
    vals = _values(n, 7)
    sntt = ShardedNTT(n, cpu_mesh(4))
    fwd = sntt.from_output_matrix(sntt.forward(_mont_input(sntt, vals)))
    inv = sntt.inverse(sntt.shard_input(sntt.to_matrix(fwd)))
    assert _plain(sntt.from_output_matrix(inv)) == vals


def test_sharded_inverse_matches_host():
    n = 1 << 12
    vals = _values(n, 3)
    sntt = ShardedNTT(n, cpu_mesh(8))
    out = sntt.inverse(_mont_input(sntt, vals))
    assert _plain(sntt.from_output_matrix(out)) == JaxNTT(n).inverse(vals)


def test_inverse_from_fourstep_roundtrip():
    """forward then inverse_from_fourstep, with and without a coset."""
    n = 1 << 11
    vals = _values(n, 5)
    sntt = ShardedNTT(n, cpu_mesh(8))
    for offset in (1, GENERATOR):
        back = sntt.inverse_from_fourstep(sntt.forward(_mont_input(sntt, vals), offset), offset)
        assert [tuple(t.shape) for t in back.shards] == [(8, sntt.R, sntt.C // 8)] * 8
        assert _plain(back.gather()) == vals
    coset = sntt.forward(_mont_input(sntt, vals), GENERATOR)
    assert _plain(sntt.from_output_matrix(coset)) == JaxNTT(n).coset_evaluate(vals, GENERATOR)


def test_split_validation():
    mesh = cpu_mesh(8)
    with pytest.raises(ValueError):
        ShardedNTT(1 << 5, mesh)  # too small to shard over 8 shards
    with pytest.raises(ValueError):
        ShardedNTT(100, mesh)  # not a power of two
    with pytest.raises(ValueError):
        _split(1 << 12, 6)  # the shard count must be a power of two
    assert _split(1 << 11, 8) == (32, 64) and _split(1 << 20, 8) == (1024, 1024)
    # on the card a shard narrower than a cluster of 8 runs in clusters of
    # as many blocks as it has columns (K2) or rows (K3): 2^12, 2^10, 2^8
    # and 2^6 over 8 shards give shards 8, 4, 2 and 1 wide
    cuda = [torch.device("cuda")] * 8
    for logn, width in ((12, 8), (10, 4), (8, 2), (6, 1)):
        sntt = ShardedNTT(1 << logn, cuda)
        log_r, log_c = sntt.R.bit_length() - 1, sntt.C.bit_length() - 1
        assert sntt.R // 8 == sntt.C // 8 == width
        for log_l, log_b in ((log_r, log_c - 3), (log_c, log_r - 3)):  # K2, K3 on a shard
            shape = cuda_ntt.launch_shape(log_l, log_b)
            assert (shape.cluster, shape.rows) == (width, (1 << log_l) // width)
    assert ShardedNTT(1 << 12, cuda).R == 64


def test_jax_sharded_ntt_equals_the_port_limb_for_limb():
    import jax

    from stark_tpu.parallel import ShardedNTT as JaxShardedNTT
    from stark_tpu.parallel import cpu_mesh as jax_cpu_mesh

    n = 1 << 12
    vals = _values(n, 11)
    mat = pack([v * R_MOD_P % P for v in vals]).reshape(8, 64, 64)
    jax_ntt = JaxShardedNTT(n, jax_cpu_mesh(8))
    want = np.asarray(jax.device_get(jax_ntt.forward(jax_ntt.shard_input(mat))))  # (8, R, C) [k1, k2]
    sntt = ShardedNTT(n, cpu_mesh(8))
    got = to_numpy(sntt.forward(sntt.shard_input(mat)).gather())  # (8, C, R) [k2, k1]
    np.testing.assert_array_equal(got, want.transpose(0, 2, 1))


# -- folds, next rows, tables ----------------------------------------------------


def test_fri_fold_pairs_are_shard_local():
    """(k, k + n/2) share k1, so each shard folds alone: the sharded fold
    equals the one-device fold of the whole codeword."""
    n = 1 << 12
    core = ShardedProverCore(n, GENERATOR, cpu_mesh(8))
    R, C = core.R, core.C
    for k in [0, 1, R - 1, n // 2 - 1, 137]:
        assert (k % R, k // R + C // 2) == ((k + n // 2) % R, (k + n // 2) // R)
        assert core._locate(k)[0] == core._locate(k + n // 2)[0]
    cw = core.extend_codeword(_values(n // 4, 1))
    omega = FieldElement.primitive_nth_root(n).value
    alpha = 123456789
    folded = core.fold(cw, alpha, GENERATOR, omega)
    assert _codeword(folded) == JaxFri._fold_host(_codeword(cw), alpha, GENERATOR, omega)


def test_next_rows_cross_shards_and_wrap():
    """The next-row operand of each shard equals the natural codeword
    rolled by E, for E inside a shard, across shards and past R."""
    n = 1 << 11
    core = ShardedProverCore(n, GENERATOR, cpu_mesh(8))
    cw = core.extend(_values(300, 2))
    natural = core.sntt.from_output_matrix(cw)
    for e in (1, 4, 5, 13, core.R - 1, core.R + 3):
        nexts = core.next_rows(cw, e)
        got = ShardedArray([t.reshape(8, core.C, -1) for t in nexts])
        assert torch.equal(core.sntt.from_output_matrix(got), torch.roll(natural, -e, dims=1)), e


def test_mont_outer_and_the_next_row_combination_plain():
    a = mont_tensor(_values(5, 4), "cpu")
    b = mont_tensor(_values(7, 5), "cpu")
    want = [x * y % P for x in _plain(a) for y in _plain(b)]
    assert _plain(cf.mont_outer(a, b)) == want
    # K11's plain version with the next rows passed equals its roll
    n, structure = 64, ((((1, 0, 2, 1), 0), ((0, 1, 0, 0), 1)),)
    program = cc.encode(structure, 1, 4)
    cols = [mont_tensor(_values(n, 10 + i), "cpu") for i in range(9)]
    trace, groups, tz, rand, bq = cols[:2], cols[2:4], cols[4:5], cols[5], cols[6:7]
    weights = mont_tensor(_values(5, 6), "cpu")
    args = (trace, groups, tz, rand, bq, weights, cols[7:8], cols[8:9])
    nexts = [torch.roll(t, -4, dims=1).contiguous() for t in trace]
    comb, tqs = cc.combination(program, *args)
    comb2, tqs2 = cc.combination(program, *args, next_cws=nexts)
    assert torch.equal(comb, comb2) and torch.equal(tqs, tqs2)
    comb3, _ = cc.combination(program, *args, next_cws=[t.flip(1).contiguous() for t in trace])
    assert not torch.equal(comb, comb3)


# -- commitments ---------------------------------------------------------------


def _digits_of(values):
    d = np.zeros((len(values), 4), dtype=np.uint32)
    for i, v in enumerate(values):
        for k in range(4):
            d[i, k] = (v >> (32 * k)) & 0xFFFFFFFF
    return d


def test_tree_from_blocks_matches_monolithic():
    values = _values(256, 1)
    whole = JaxMerkleTree.from_codeword(values)
    for d in (1, 2, 4, 8):
        m = 256 // d
        tree = tree_from_blocks([_digits_of(values[i * m:(i + 1) * m]) for i in range(d)])
        assert tree.root == whole.root and tree.levels == whole.levels, d
        for idx in (0, 97, 255):
            assert tree.open(idx) == whole.open(idx)


@pytest.mark.parametrize("n, tree_min", [(1 << 11, None), (1 << 14, 2048)])
def test_sharded_core_merkle_matches_host(monkeypatch, n, tree_min):
    """The core's commitment equals the host tree over the codeword: host
    subtrees below DEVICE_TREE_MIN, and with it lowered the device block
    trees (``ShardedMerkleTree``) the card runs, openings through its
    batched gathers."""
    if tree_min is not None:
        monkeypatch.setattr(device_merkle, "DEVICE_TREE_MIN", tree_min)
    core = ShardedProverCore(n, GENERATOR, cpu_mesh(8))
    coeffs = _values(300, 2)
    cw = core.extend_codeword(coeffs)
    tree = core.merkle_tree(cw)
    assert isinstance(tree, ShardedMerkleTree) == (tree_min is not None)
    host_cw = JaxNTT(n).coset_evaluate(coeffs + [0] * (n - len(coeffs)), GENERATOR)
    host_tree = JaxMerkleTree.from_codeword(host_cw)
    picks = [0, 1234, n // 8 + 5, n - 1]
    if tree_min is not None:
        tree.prefetch(picks)
    assert tree.root == host_tree.root
    for i in picks:
        assert tree.open(i) == host_tree.open(i)
    cw.prefetch_values(picks)
    assert [cw.value(i) for i in picks] == [host_cw[i] for i in picks]
    # the JAX module's block API: the exchanged blocks' host subtrees
    assert tree_from_blocks(core.natural_digit_blocks(cw.mont)).levels == host_tree.levels
    assert _codeword(cw) == host_cw


# -- FRI -----------------------------------------------------------------------


def _host_transcript(n, expansion, colinearity, coeffs):
    """The JAX package's host FRI on the codeword of ``coeffs``."""
    fri = JaxFri(JaxFieldElement.generator(), JaxFieldElement.primitive_nth_root(n), n, expansion, colinearity)
    codeword = [fe.value for fe in JaxPolynomial([JaxFieldElement(c) for c in coeffs]).eval_domain(fri.eval_domain())]
    ps = JaxProofStream()
    return fri.prove(codeword, ps), ps


def test_sharded_core_fri_transcript_identical(monkeypatch):
    """FRI from a sharded codeword: rounds committed one by one (the core
    has no fused cascade), shard-local folds and device block trees (the
    device-tree floor lowered to reach them at 2^14 points)."""
    monkeypatch.setattr(device_merkle, "DEVICE_TREE_MIN", 2048)
    n = 1 << 14
    expansion = 4
    fri = Fri(FieldElement.generator(), FieldElement.primitive_nth_root(n), n, expansion, 8)
    coeffs = _values(n // expansion, 0)
    idx_host, ps_host = _host_transcript(n, expansion, 8, coeffs)
    core = ShardedProverCore(n, GENERATOR, cpu_mesh(8))
    ps_dev = ProofStream()
    idx_dev = fri.prove(core.extend_codeword(coeffs), ps_dev)
    assert fri.last_fused_rounds == 0
    assert idx_dev == idx_host
    assert ps_dev.serialize() == ps_host.serialize()
    assert fri.verify(ProofStream(list(ps_dev.objects)), [])


def test_sharded_extension_matches_host():
    n = 1 << 11
    fri = Fri(FieldElement.generator(), FieldElement.primitive_nth_root(n), n, 4, 4)
    coeffs = _values(n // 4, 1)
    core = ShardedProverCore(n, GENERATOR, cpu_mesh(4))
    want = JaxNTT(n).coset_evaluate(coeffs + [0] * (n - len(coeffs)), GENERATOR)
    cw = core.extend_codeword(coeffs)
    assert _codeword(cw) == want
    # the degree probe and the is-zero bitmap read the coefficients back
    bitmap = core.restrict_iszero(cw.mont)
    assert bitmap.shape == (n,) and bitmap[len(coeffs):].all() and not bitmap[len(coeffs) - 1]
    assert core.degree_probe([cw.mont, core.extend([]), core.extend([5])]) == [len(coeffs) - 1, 0, 0]


def test_sharded_core_fri_long_cascade():
    """More FRI rounds than the sharded codeword lasts: the host tail takes
    over and the transcript still matches the host prover."""
    n = 1 << 12
    fri = Fri(FieldElement.generator(), FieldElement.primitive_nth_root(n), n, 4, 2)
    assert fri.num_rounds() == 9
    coeffs = _values(n // 4, 5)
    _, ps_host = _host_transcript(n, 4, 2, coeffs)
    core = ShardedProverCore(n, GENERATOR, cpu_mesh(8))
    ps_dev = ProofStream()
    fri._prove_device(core.extend_codeword(coeffs), ps_dev)
    assert ps_dev.serialize() == ps_host.serialize()


# -- whole proves --------------------------------------------------------------


@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_stark_proof_byte_identical(shards):
    seed, steps = 21, 120
    a, b = FieldElement(1), FieldElement(1)
    host = JaxFibonacciStark(steps, rng=JaxRandom(seed))
    domain = host.stark.fri_domain_length
    assert domain == 1 << 11
    result, host_proof = host.prove(JaxFieldElement(1), JaxFieldElement(1))
    backend = ShardedBackend(cpu_mesh(shards), device_prover_min=1024)
    sharded = FibonacciStark(steps, backend=backend, rng=DeterministicRandom(seed))
    assert sharded.stark._use_device_pipeline()
    result2, proof = sharded.prove(a, b)
    assert result2.value == result.value and proof == host_proof
    assert sharded.verify(a, b, result2, proof)
    core = sharded.stark._device_core_cache
    assert isinstance(core, ShardedProverCore) and core.R * core.C == domain and core.d == shards


def test_sharded_chain_proof_byte_identical():
    """Distinct per-constraint zeroifiers and the chain's grouped program
    through one K11 launch a shard with the next-row operand."""
    seed = 9
    x = FieldElement(31337)
    out, host_proof = JaxRescueChainStark(4, rng=JaxRandom(seed)).prove(JaxFieldElement(x.value))
    backend = ShardedBackend(cpu_mesh(8), device_prover_min=1024)
    sharded = RescueChainStark(4, backend=backend, rng=DeterministicRandom(seed))
    assert sharded.stark._use_device_pipeline()
    out2, proof = sharded.prove(x)
    assert out2.value == out.value and proof == host_proof
    assert sharded.verify(out2, proof)


# -- the capability checks of Stark and Fri -------------------------------------


class _Without:
    """A one-device prover core that lacks the methods ``hidden``; with
    ``plain_codewords`` its extend_codeword returns codewords that lack
    ``gather_values_async``."""

    def __init__(self, core, hidden, plain_codewords=False):
        self._core, self._hidden, self._plain = core, set(hidden), plain_codewords

    def __getattr__(self, name):
        if name in self._hidden:
            raise AttributeError(name)
        return getattr(self._core, name)

    def extend_codeword(self, coeffs):
        cw = self._core.extend_codeword(coeffs)
        return _NoGather(cw) if self._plain else cw


class _NoGather:
    """A device codeword without ``gather_values_async``."""

    def __init__(self, dcw):
        self._dcw = dcw
        self.mont = dcw.mont

    def __len__(self):
        return len(self._dcw)

    @property
    def digits(self):
        return self._dcw.digits

    @property
    def _digits(self):
        return self._dcw._digits

    def value(self, i):
        return self._dcw.value(i)


@pytest.mark.parametrize("case", ["extend_mont", "fri_cascade", "gather_values_async"])
def test_stark_proves_through_a_core_that_lacks_a_capability(monkeypatch, case):
    """fib-300 (4096 points) on the CPU's one-device core, with the method
    the check tests for taken away: the prove takes the other arm and its
    bytes stay the JAX host prover's."""
    monkeypatch.setattr(device_merkle, "DEVICE_TREE_MIN", 1024)
    a = b = FieldElement(1)
    host_result, host_proof = JaxFibonacciStark(300, rng=JaxRandom(5)).prove(JaxFieldElement(1), JaxFieldElement(1))
    model = FibonacciStark(300, device="cpu", rng=DeterministicRandom(5))
    model.stark.backend.device_prover_min = 1024
    real = model.stark._device_core()
    hidden = {"extend_mont": ["extend_mont"], "fri_cascade": ["fri_cascade"],
              "gather_values_async": ["extend_mont", "extend_codeword_be17"]}[case]
    model.stark._device_core_cache = _Without(real, hidden, plain_codewords=case == "gather_values_async")
    interpolated = []
    original = model.stark._interpolate_trace
    monkeypatch.setattr(model.stark, "_interpolate_trace", lambda *a: interpolated.append(1) or original(*a))
    result, proof = model.prove(a, b)
    assert result.value == host_result.value and proof == host_proof
    assert bool(interpolated) == (case != "fri_cascade")  # the host arm of the trace interpolation
    assert model.stark.fri.last_fused_rounds == (0 if case == "fri_cascade" else 2)


def test_device_air_group_values_skip_a_sharded_layout():
    """The verifier's device fast path declines group codewords that are
    not (8, n) (the sharded layout) and the host path answers."""
    model = RescueChainStark(4, backend=ShardedBackend(cpu_mesh(4), device_prover_min=1024))
    stark = model.stark
    big = [True] * len(model.constraints)
    assert stark._device_air_group_values(model.constraints, big, [0, 5]) is None
    groups, _ = stark._device_air_groups(stark._device_core(), model.constraints)
    assert all(g.ndim == 3 for g in groups)
