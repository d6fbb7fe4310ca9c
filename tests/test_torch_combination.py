"""The combination (K11) and the digit conversion of the port, on the CPU.

* K11's plain version (``cuda_combination.combination_plain``, the
  interpreter of the encoded program) against the JAX package's jitted
  ``DeviceProverCore.combination_fn``, on the same numpy-seeded canonical
  Montgomery codewords: Fibonacci's structure (2 constraints, 5 groups, one
  exemption set) and a structure with one group of each tail shape the
  Rescue chain has (no state, exponents 1, 2 and 3, two nonzero exponents;
  3 constraints in 2 exemption sets), expansion 4, at 2^10 and 2^12
  points; the prover core's ``combination_fn`` is the same function;
* the encoder: the powers it builds, and its refusal of every structure
  beyond the kernel's limits;
* the Montgomery-input leaves (K4's plain version) and the gather digits
  (``mont_digits``' plain version) against the JAX package's
  ``_plain_digits`` and the tree of ``test_torch_merkle.py``; the gather
  form (``mont_digits(codewords, indices)``) against ``_value_gather``, on
  one codeword and several (concatenated codeword by codeword), the
  packing of its launches past the kernel's caps, its refusals, and the
  prover's gather through it;
* the conversions on K10's plain version (``cuda_field.to_mont`` /
  ``from_mont``; the randomizer's ``be17_mont`` is in
  ``test_torch_fs.py``), the four-step plan at
  the small sizes it now takes on the card, the guard that counts plain
  arithmetic, and the combination's profile regions in a prove.

Tolerance: none (field arithmetic and hashes are exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.merkle import MerkleTree
from stark_tpu.ops import device_prover as jdp
from stark_tpu.ops.limbs import pack
from stark_tpu.params import GENERATOR, P, R_MOD_P
from stark_tpu_torch.ops import cuda_combination as cc
from stark_tpu_torch.ops import cuda_field, cuda_merkle, guard
from stark_tpu_torch.ops import device_merkle as tdm
from stark_tpu_torch.ops import field_ops as tfo
from stark_tpu_torch.ops.limbs import from_numpy, seeded_mont, to_numpy

# The suite runs several pytest-xdist workers side by side; more than one
# torch thread per worker oversubscribes the cores, and the threads'
# OpenMP spin-waits then slow the plain versions tens of times.
torch.set_num_threads(1)

# FibonacciStark's AIR: per constraint, (tail over (a, b, a', b'), group)
FIB = ((((0, 0, 1, 0), 0), ((1, 0, 0, 0), 1), ((0, 1, 0, 0), 2)),
       (((0, 0, 0, 1), 3), ((1, 0, 0, 0), 4)))
# one group of each tail shape of RescueChainStark's AIR: no state, a column
# to the 1st, 2nd and 3rd power, two nonzero exponents
CHAIN_SHAPES = ((((), 0), ((3, 0, 0, 0), 1), ((0, 0, 2, 1), 2), ((0, 0, 0, 2), 3)),
                (((0, 0, 1, 2), 4), ((0, 0, 1, 0), 5)),
                (((0, 0, 0, 1), 6), ((1, 0, 0, 0), 7)))
STRUCTURES = {"fib": (FIB, (0, 0)), "chain_shapes": (CHAIN_SHAPES, (0, 0, 1))}  # constraint -> exemption set
EXPANSION = 4
NUM_BQ = 2


def _operands(structure, exemption_sets, n: int, seed: int):
    """numpy (8, n) uint32 Montgomery codewords: trace (2 columns), groups,
    a zeroifier inverse an exemption set, randomizer, boundary quotients,
    weights, shift tables (one a quotient)."""
    groups = 1 + max(gi for constraint in structure for _, gi in constraint)
    k = len(structure)

    def cws(count, off):
        return tuple(seeded_mont(n, seed + off + j) for j in range(count))

    tz_sets = cws(max(exemption_sets) + 1, 300)
    return (cws(2, 0), cws(groups, 100), tuple(tz_sets[e] for e in exemption_sets), seeded_mont(n, seed + 400),
            cws(NUM_BQ, 500), seeded_mont(1 + 2 * (k + NUM_BQ), seed + 600), cws(k, 700), cws(NUM_BQ, 800))


def _as(convert, ops):
    return tuple(tuple(convert(a) for a in op) if isinstance(op, tuple) else convert(op) for op in ops)


@pytest.mark.parametrize("n", [1 << 10, 1 << 12])
@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_combination_plain_matches_jax(name, n):
    structure, exemption_sets = STRUCTURES[name]
    ops = _operands(structure, exemption_sets, n, n + len(name))
    jax_fn = jdp.get_core(n, GENERATOR).combination_fn(structure, NUM_BQ, EXPANSION)
    with jax.disable_jit():  # the same function op by op: XLA's compile of the whole takes longer than the test
        want_comb, want_tqs = jax_fn(*_as(jnp.asarray, ops))
    program = cc.encode(structure, NUM_BQ, EXPANSION)
    comb, tqs = cc.combination_plain(program, *_as(lambda a: from_numpy(a, "cpu"), ops))
    assert np.array_equal(to_numpy(comb), np.asarray(want_comb))
    assert np.array_equal(to_numpy(tqs), np.asarray(want_tqs))


def test_core_combination_fn_runs_the_program():
    """The port's core caches one encoded program a key and runs K11's
    wrapper, which takes the plain interpreter for CPU tensors."""
    from stark_tpu_torch.ops.device_prover import get_core

    n = 1 << 10
    structure, exemption_sets = STRUCTURES["chain_shapes"]
    ops = _as(lambda a: from_numpy(a, "cpu"), _operands(structure, exemption_sets, n, 7))
    core = get_core(n, GENERATOR, "cpu")
    fn = core.combination_fn(structure, NUM_BQ, EXPANSION)
    assert core.combination_fn(structure, NUM_BQ, EXPANSION) is fn
    assert fn.func is cc.combination and fn.args == (cc.encode(structure, NUM_BQ, EXPANSION),)
    comb, tqs = fn(*ops)
    want = cc.combination_plain(cc.encode(structure, NUM_BQ, EXPANSION), *ops)
    assert torch.equal(comb, want[0]) and torch.equal(tqs, want[1])


def test_encoder_builds_each_power_once():
    program = cc.encode(CHAIN_SHAPES, NUM_BQ, EXPANSION)
    # state columns 0, 2, 3 loaded once; x0^3 = (x0)^2 * x0, x2^2 and x3^2
    # built once and shared by the terms that need them; the three
    # constraints end after 4, 6 and 8 terms
    loaded = {mul for base, mul in program.powers if base < 0}
    assert loaded == {0, 2, 3}
    assert len(program.powers) == 6
    assert program.constraint_end == (4, 6, 8)
    assert program.terms[0] == (0, ())
    assert [len(f) for _, f in program.terms] == [0, 1, 2, 1, 2, 1, 1, 1]
    for s, (base, mul) in enumerate(program.powers):
        assert base < 0 or (base < s and mul < s)  # a column, or built from earlier slots
    assert (program.n_state, program.n_groups, program.n_bq, program.expansion) == (4, 8, NUM_BQ, EXPANSION)


@pytest.mark.parametrize("case", ["constraints", "group_index", "tail_length", "factors", "terms", "powers",
                                  "boundary_quotients", "expansion"])
def test_encoder_refuses_structures_beyond_the_limits(case):
    one = (((1,), 0),)
    structure, num_bq, expansion = {
        "constraints": ((one,) * (cc.MAX_CONSTRAINTS + 1), 0, 4),
        "group_index": (((((1,), cc.MAX_GROUPS),),), 0, 4),
        "tail_length": (((((0,) * 2 * cc.MAX_TRACE + (1,), 0),),), 0, 4),
        "factors": (((((1,) * (cc.MAX_FACTORS + 1), 0),),), 0, 4),
        "terms": ((tuple(((1,), 0) for _ in range(cc.MAX_TERMS + 1)),), 0, 4),
        # 9 columns to the 63rd power: 6 slots each
        "powers": (((tuple(((0,) * i + (63,), i) for i in range(9))),), 0, 4),
        "boundary_quotients": ((one,), cc.MAX_BQ + 1, 4),
        "expansion": ((one,), 0, -1),
    }[case]
    with pytest.raises(ValueError):
        cc.encode(structure, num_bq, expansion)


def test_combination_refuses_operands_that_do_not_fit_the_program():
    n = 64
    structure, exemption_sets = STRUCTURES["fib"]
    ops = list(_as(lambda a: from_numpy(a, "cpu"), _operands(structure, exemption_sets, n, 3)))
    program = cc.encode(structure, NUM_BQ, EXPANSION)
    cc.combination(program, *ops)
    for index, bad in ((0, ops[0][:1]),  # one trace codeword for four state columns
                       (1, ops[1][:4]),  # a group codeword missing
                       (2, ops[2][:1]),  # a zeroifier inverse missing
                       (5, ops[5][:, :3].contiguous()),  # weights
                       (3, ops[3][:, :32].contiguous())):  # randomizer of another length
        with pytest.raises(ValueError):
            cc.combination(program, *(bad if i == index else op for i, op in enumerate(ops)))
    with pytest.raises(ValueError):
        cc.combination(cc.encode(structure, NUM_BQ, n), *ops)  # expansion >= n


# -- the digit conversion -------------------------------------------------------

N_LEAVES = 2048


@pytest.fixture(scope="module")
def vals():
    """test_torch_merkle.py's values: a numpy seed, the digit-count edge cases first."""
    rng = np.random.default_rng(2048)
    out = [(int(v) << 64 | int(w)) % P for v, w in zip(rng.integers(0, 1 << 63, N_LEAVES),
                                                         rng.integers(0, 1 << 63, N_LEAVES))]
    out[:6] = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 96) + 5]
    return out


@pytest.fixture(scope="module")
def mont(vals):
    return pack([v * R_MOD_P % P for v in vals])


@pytest.mark.parametrize("k", [1, 3, 2047])
def test_mont_digits_plain_matches_jax_plain_digits(mont, k):
    cols = np.ascontiguousarray(mont[:, -k:])
    got = cuda_merkle.mont_digits(from_numpy(cols, "cpu"))
    assert got.shape == (4, k)
    assert np.array_equal(to_numpy(got), np.asarray(jdp._plain_digits(jnp.asarray(cols))))


def _gather_indices(k):
    """k sorted columns of the 2048-value codeword, its first and last among them from two on."""
    if k == 1:
        return [N_LEAVES - 1]
    inner = np.random.default_rng(k).choice(np.arange(1, N_LEAVES - 1), k - 2, replace=False)
    return [0] + sorted(int(i) for i in inner) + [N_LEAVES - 1]


@pytest.mark.parametrize("k", [1, 4, 37])
def test_mont_digits_gather_matches_jax_value_gather(mont, k):
    idx = _gather_indices(k)
    got = cuda_merkle.mont_digits(from_numpy(mont, "cpu"), idx)
    assert got.shape == (4, k)
    want = np.asarray(jdp._value_gather(jnp.asarray(mont), jnp.asarray(idx, dtype=jnp.int32)))
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("g", [2, 27])
def test_mont_digits_gather_of_several_codewords_is_group_major(mont, g):
    """Codeword j is the values' codeword rolled by j columns; the gather
    equals JAX's gathers of each, concatenated codeword by codeword."""
    cws = [np.ascontiguousarray(np.roll(mont, j, axis=1)) for j in range(g)]
    idx = _gather_indices(4)
    got = cuda_merkle.mont_digits([from_numpy(cw, "cpu") for cw in cws], idx)
    want = np.concatenate([np.asarray(jdp._value_gather(jnp.asarray(cw), jnp.asarray(idx, dtype=jnp.int32)))
                           for cw in cws], axis=1)
    assert got.shape == (4, g * 4)
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("case", ["no_indices", "index_past_the_end", "negative_index", "different_lengths",
                                  "no_codewords", "digits_not_limbs"])
def test_mont_digits_gather_refuses(mont, case):
    cw = from_numpy(mont, "cpu")
    args = {"no_indices": ([cw], []), "index_past_the_end": ([cw], [0, N_LEAVES]), "negative_index": ([cw], [-1]),
            "different_lengths": ([cw, cw[:, :-1].contiguous()], [0]), "no_codewords": ([], [0]),
            "digits_not_limbs": ([cw[:4].contiguous()], [0])}[case]
    with pytest.raises(ValueError):
        cuda_merkle.mont_digits(*args)


def test_mont_digits_gather_launches_split_at_the_caps(mont):
    """Past the kernel's caps the wrapper packs several launches: 65
    codewords by 257 indices are 2 x 2 blocks, each at its offset in the
    (4, G K) output."""
    cw = from_numpy(mont, "cpu")
    g, k = cuda_merkle.GATHER_MAX_CODEWORDS + 1, cuda_merkle.GATHER_MAX_INDICES + 1
    out = torch.empty((4, g * k), dtype=torch.int32)
    idx = list(range(k))
    launches = cuda_merkle.gather_launches([cw] * g, idx, out)
    assert [(p.first, p.n_codewords, p.n_indices) for p in launches] == [
        (0, 64, 256), (256, 64, 1), (64 * k, 1, 256), (64 * k + 256, 1, 1)]
    assert all(p.n == N_LEAVES and p.stride == g * k and p.group_stride == k for p in launches)
    assert list(launches[1].indices[:1]) == [256] and launches[0].codewords[63] == cw.data_ptr()


def test_device_codeword_gathers_through_the_gather_form(mont, monkeypatch):
    """The prover's opening gather hands the codeword and its uncached
    sorted indices to mont_digits' gather form, whose digits equal JAX's
    _value_gather."""
    from stark_tpu_torch.ops import device_prover as tdp

    seen = []

    def spy(m, indices=None):
        seen.append(indices)
        return cuda_merkle.mont_digits(m, indices)

    monkeypatch.setattr(tdp, "mont_digits", spy)
    dcw = tdp.DeviceCodeword(from_numpy(mont, "cpu"), core=None)
    idx, arr = dcw.gather_values_async([N_LEAVES - 1, 5, 0, 5])
    assert idx == [0, 5, N_LEAVES - 1] and seen == [idx]
    want = np.asarray(jdp._value_gather(jnp.asarray(mont), jnp.asarray(idx, dtype=jnp.int32)))
    assert np.array_equal(to_numpy(arr), want)


def test_mont_leaves_plain_matches_the_digit_leaves(mont):
    digits = np.asarray(jdp._plain_digits(jnp.asarray(mont)))
    got = cuda_merkle.merkle_leaves_mont(from_numpy(mont, "cpu"))
    assert torch.equal(got, cuda_merkle.merkle_leaves(from_numpy(digits, "cpu")))
    with pytest.raises(ValueError):
        cuda_merkle.merkle_leaves_mont(from_numpy(digits, "cpu"))  # four rows: digits, not limbs


def test_mont_tree_matches_the_digit_tree_and_host_tree(vals, mont):
    """The Montgomery-input tree equals the digit tree of test_torch_merkle.py
    (checked there against the JAX package's trees) on JAX's digits, and
    the host tree."""
    levels, root = cuda_merkle.tree_levels(from_numpy(mont, "cpu"), tdm.TAIL_WIDTH, mont=True)
    digits = np.asarray(jdp._plain_digits(jnp.asarray(mont)))
    want_levels, want_root = cuda_merkle.tree_levels(from_numpy(digits, "cpu"), tdm.TAIL_WIDTH)
    assert len(levels) == len(want_levels) == 2
    for got, want in zip(levels, want_levels):
        assert torch.equal(got, want)
    assert torch.equal(root, want_root)
    host = MerkleTree.from_codeword(vals)
    assert tdm._digest_bytes(to_numpy(root)) == host.root
    assert [tdm._level_bytes(to_numpy(lv)) for lv in levels] == host.levels[:2]
    # the prover's path: tree_arrays_with_root hands the codeword to K4 as it is
    levels2, root2 = tdm.tree_arrays_with_root(from_numpy(mont, "cpu"), N_LEAVES)
    assert torch.equal(root2, root) and all(torch.equal(a, b) for a, b in zip(levels2, levels))


# -- K10 conversions, the randomizer, small transforms, the guard -------------------


def test_k10_conversions_equal_field_ops(vals):
    a = from_numpy(pack(vals[:257]), "cpu")
    m = cuda_field.to_mont(a)
    assert torch.equal(m, tfo.to_mont(a))
    assert torch.equal(cuda_field.from_mont(m), a)
    wide = from_numpy(pack([(1 << 128) - 1, P, P + 7]), "cpu")  # to_mont takes any value < 2^128
    assert unpack_ints(cuda_field.from_mont(cuda_field.to_mont(wide))) == [((1 << 128) - 1) % P, 0, 7]


def unpack_ints(t):
    from stark_tpu_torch.ops.limbs import unpack

    return unpack(to_numpy(t))


@pytest.mark.parametrize("logn", [6, 9, 12])
def test_four_step_plan_at_the_small_sizes_equals_the_stage_plan(logn):
    """The four-step plan the card now runs from 64 points (R, C >= 8),
    through its passes' plain versions, against the stage-by-stage plan."""
    from stark_tpu_torch.ops import backend, cuda_ntt
    from stark_tpu_torch.ops.ntt import NTTPlan

    n = 1 << logn
    four, stage = cuda_ntt.CudaNTT(n, "cpu"), NTTPlan(n, "cpu")
    assert isinstance(backend.best_plan(n, "cpu"), NTTPlan)  # the CPU keeps the stage plan below 2^13
    a = from_numpy(seeded_mont(n, logn), "cpu")
    assert torch.equal(four.forward(a), stage.forward(a))
    assert torch.equal(four.inverse(a), stage.inverse(a))
    assert torch.equal(four.coset_forward(a, GENERATOR), stage.coset_forward(a, GENERATOR))
    assert torch.equal(four.coset_inverse(a, GENERATOR), stage.coset_inverse(a, GENERATOR))


def test_guard_counts_device_ops_but_not_kernel_launches():
    a = from_numpy(seeded_mont(16, 1), "cpu")
    with guard.count_device_ops("cpu") as counts:
        torch.cat([a[:, [1, 3]], a[:, :2]], dim=1)
        torch.empty(3)
    # the index list goes to the tensors' device first (lift_fresh), as an
    # index tensor made from a list would go to the card
    assert dict(counts) == {"aten.lift_fresh.default": 1, "aten.index.Tensor": 1, "aten.slice.Tensor": 1,
                            "aten.cat.default": 1, "aten.empty.memory_format": 1}
    with guard.count_device_ops("cuda") as counts:
        cuda_merkle.mont_digits(a, [0, 2])  # the plain gather on the CPU: nothing on a card
    assert sum(counts.values()) == 0


def test_guard_counts_plain_arithmetic_on_the_device_type():
    a = from_numpy(seeded_mont(16, 1), "cpu")
    with guard.count_plain_calls("cpu") as counts:
        tfo.to_mont(a)  # and the mont_mul it calls
        tfo.add(a, a)
        tfo.is_zero(a)  # a comparison: not counted
    assert dict(counts) == {"to_mont": 1, "mont_mul": 1, "add": 1}
    with guard.count_plain_calls("cuda") as counts:
        tfo.mont_mul(a, a)
    assert sum(counts.values()) == 0
    assert not any(hasattr(getattr(tfo, name), "__wrapped__") for name in guard.ARITHMETIC)  # restored


def test_prove_records_the_combination_regions():
    """A small Fibonacci prove through the device pipeline on CPU tensors
    (its floor lowered): byte-identical to the host prover, with the
    combination's sub-regions in its profile."""
    from stark_tpu_torch.field import FieldElement
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.rng import DeterministicRandom

    host = FibonacciStark(60, device=None, rng=DeterministicRandom(3))
    port = FibonacciStark(60, device="cpu", rng=DeterministicRandom(3))
    port.stark.backend.device_prover_min = 512
    assert port.stark._use_device_pipeline()
    a, b = FieldElement(2), FieldElement(9)
    assert port.prove(a, b) == host.prove(a, b)
    totals = port.stark.last_profile.totals
    for sub in ("air_groups", "tz_inv", "shift_tables", "trace_extend", "kernel", "degree_probe"):
        assert f"combination/{sub}" in totals
