"""The CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA device: the ``cuda`` fixture skips without
one (decided at run time, so every pytest-xdist worker collects the same
tests).  Run them on a machine with a card, where JAX (which
tests/conftest.py imports) need not be installed:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py

The host references are the port's own host prover and host FRI (no
backend), so these tests import nothing of JAX or the JAX package.

Tolerance: none (kernels and plain versions must agree bit for bit).
"""

import hashlib

import numpy as np
import pytest
import torch

from stark_tpu_torch.field import FieldElement
from stark_tpu_torch.ops.limbs import pack
from stark_tpu_torch.params import GENERATOR, P, R_MOD_P
from stark_tpu_torch.rng import DeterministicRandom

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mont(n: int, seed: int, device):
    """n seeded canonical Montgomery values as (8, n) limbs, the forms of
    0, 1 and p - 1 first."""
    from stark_tpu_torch.ops.limbs import from_numpy, seeded_mont

    return from_numpy(seeded_mont(n, seed), device)


@pytest.mark.parametrize("logn", [13, 14, 16, 17, 18, 19, 20, 23])
@pytest.mark.parametrize("inverse, offset", [(False, 1), (True, 1), (False, GENERATOR), (True, GENERATOR)])
def test_ntt_passes_match_plain(cuda, logn, inverse, offset):
    from stark_tpu_torch.ops import cuda_ntt, kernels

    plan = cuda_ntt.get_cuda_plan(1 << logn, cuda)
    w, tw_r, tw_c, row, col = plan.op_tables(inverse, offset)
    pro = not inverse and row is not None
    x = _mont(1 << logn, logn, cuda).reshape(8, plan.R, plan.C)
    before = dict(kernels.LAUNCHES)
    before_n = dict(kernels.LAUNCHES_BY_SIZE.get(1 << logn, {}))
    y = cuda_ntt.ntt_pass1(x, tw_r, w, row if pro else None, col if pro else None)
    assert torch.equal(y, cuda_ntt.ntt_pass1_plain(x, tw_r, w, row if pro else None, col if pro else None))
    z = cuda_ntt.ntt_pass2(y, tw_c, row if inverse else None, col if inverse else None)
    assert torch.equal(z, cuda_ntt.ntt_pass2_plain(y, tw_c, row if inverse else None, col if inverse else None))
    assert kernels.LAUNCHES["ntt_pass1"] == before["ntt_pass1"] + 1
    assert kernels.LAUNCHES["ntt_pass2"] == before["ntt_pass2"] + 1
    for name in ("ntt_pass1", "ntt_pass2"):
        assert kernels.LAUNCHES_BY_SIZE[1 << logn][name] == before_n.get(name, 0) + 1


def test_ntt_kernels_refuse_small_transforms(cuda):
    from stark_tpu_torch.ops import cuda_ntt

    x = torch.zeros((8, 1, 8), dtype=torch.int32, device=cuda)  # R = 1: a pass of one point
    tw = torch.zeros((8, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_pass1(x, tw, x)
    with pytest.raises(ValueError):
        cuda_ntt.CudaNTT(1 << 5, cuda)  # the one-device plan starts at R = C = 8


@pytest.mark.parametrize("logn", [6, 8, 10])
def test_sharded_ntt_with_shards_narrower_than_a_cluster_matches_the_one_device_plan(cuda, logn):
    """2^6, 2^8 and 2^10 over 8 shards on one card give shards 1, 2 and 4
    wide, whose K2/K3 run in clusters of as many blocks: forward, inverse,
    and the inverse from the four-step layout with a coset, limb for limb
    against the one-device plan (8-wide clusters)."""
    from stark_tpu_torch.ops import cuda_ntt, kernels
    from stark_tpu_torch.parallel import ShardedNTT, make_mesh

    n = 1 << logn
    sntt = ShardedNTT(n, make_mesh(8, [cuda]))
    width = sntt.C // 8
    assert width == sntt.R // 8 == 1 << (logn // 2 - 3)
    assert cuda_ntt.launch_shape(sntt.R.bit_length() - 1, width.bit_length() - 1).cluster == width
    plan = cuda_ntt.get_cuda_plan(n, cuda)
    x = _mont(n, logn, cuda)
    mat = sntt.shard_input(sntt.to_matrix(x))
    kernels.reset_launch_counts()
    assert torch.equal(sntt.from_output_matrix(sntt.forward(mat)), plan.forward(x))
    passes = {k: v for k, v in kernels.LAUNCHES_BY_SIZE[n // 8].items() if k.startswith("ntt_pass")}
    assert passes == {"ntt_pass1": 8, "ntt_pass2": 8}  # a launch a shard and pass
    assert torch.equal(sntt.from_output_matrix(sntt.inverse(mat)), plan.inverse(x))
    coset = sntt.forward(mat, GENERATOR)
    assert torch.equal(sntt.from_output_matrix(coset), plan.coset_forward(x, GENERATOR))
    back = sntt.inverse_from_fourstep(coset, GENERATOR)
    assert torch.equal(back.gather().reshape(8, n), x)
    assert torch.equal(back.gather().reshape(8, n), plan.coset_inverse(plan.coset_forward(x, GENERATOR), GENERATOR))


@pytest.mark.parametrize("w", [2, 6, 4096, 1 << 16])
def test_merkle_kernels_match_plain(cuda, w):
    from stark_tpu_torch.ops import cuda_merkle
    from stark_tpu_torch.ops import device_merkle as dm

    rng = np.random.default_rng(w)
    digits = torch.tensor(rng.integers(0, 1 << 32, (4, w), dtype=np.uint64).astype(np.uint32).view(np.int32),
                          device=cuda)
    digits[2:, : w // 2] = 0  # short leaves: fewer nonzero digits
    digits[:, 0] = 0
    leaves = cuda_merkle.merkle_leaves(digits)
    assert torch.equal(leaves, dm.leaf_digests_from_digits(digits))
    assert torch.equal(cuda_merkle.merkle_level(leaves), dm.level_hash(leaves))


@pytest.mark.parametrize("log_w", range(1, 14))
def test_merkle_top_matches_plain(cuda, log_w):
    from stark_tpu_torch.ops import cuda_merkle, kernels
    from stark_tpu_torch.ops import device_merkle as dm

    w = 1 << log_w
    level = torch.tensor(np.random.default_rng(w).integers(0, 1 << 32, (8, w), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32), device=cuda)
    before = kernels.LAUNCHES["merkle_top"]
    got = cuda_merkle.merkle_top(level)
    assert kernels.LAUNCHES["merkle_top"] == before + 1
    assert torch.equal(got, dm.merkle_top_plain(level))


@pytest.mark.parametrize("w", [128, 256, 8192])
def test_merkle_top_matches_the_level_kernel(cuda, w):
    """Where the top kernel's lanes a hash change (64 parents and fewer: a
    quad of lanes a parent; 128 and more: a thread) and at its widest, its
    slabs equal the chain of level launches (K5), another kernel's hashes."""
    from stark_tpu_torch.ops import cuda_merkle
    from stark_tpu_torch.ops import device_merkle as dm

    level = torch.tensor(np.random.default_rng(w + 1).integers(0, 1 << 32, (8, w), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32), device=cuda)
    got = dm.top_slabs(cuda_merkle.merkle_top(level), w)
    chain = [cuda_merkle.merkle_level(level)]
    while chain[-1].shape[1] > 1:
        chain.append(cuda_merkle.merkle_level(chain[-1]))
    assert len(got) == len(chain) and all(torch.equal(a, b) for a, b in zip(got, chain))


# the subtrees kernel at every width a tree hands it, down to TOP_WIDTH, and
# at small and full depths
SUBTREE_CASES = [(1 << k, k - 9) for k in range(10, 20)] + [(2, 1), (64, 3), (1024, 1), (8192, 4), (1024, 10),
                                                            (8192, 13)]


@pytest.mark.parametrize("w, depth", SUBTREE_CASES)
def test_merkle_subtrees_matches_plain(cuda, w, depth):
    from stark_tpu_torch.ops import cuda_merkle, kernels
    from stark_tpu_torch.ops import device_merkle as dm

    level = torch.tensor(np.random.default_rng(w + depth).integers(0, 1 << 32, (8, w), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32), device=cuda)
    before = kernels.LAUNCHES["merkle_subtrees"]
    before_w = kernels.LAUNCHES_BY_SIZE.get(w, {}).get("merkle_subtrees", 0)
    got = cuda_merkle.merkle_subtrees(level, depth)
    assert kernels.LAUNCHES["merkle_subtrees"] == before + 1
    assert kernels.LAUNCHES_BY_SIZE[w]["merkle_subtrees"] == before_w + 1
    assert torch.equal(got, dm.merkle_subtrees_plain(level, depth))


@pytest.mark.parametrize("logn", [13, 17, 20])
def test_device_tree_levels_match_the_host_tree(cuda, logn):
    """K4, K5 above SUBTREE_WIDTH, one subtrees launch down to TOP_WIDTH
    and one top launch: every kept level and the root equal the port's
    host tree's."""
    from stark_tpu_torch.merkle import MerkleTree
    from stark_tpu_torch.ops import cuda_merkle, field_ops, kernels
    from stark_tpu_torch.ops import device_merkle as dm
    from stark_tpu_torch.ops.limbs import from_numpy, to_numpy

    n = 1 << logn
    rng = np.random.default_rng(n)
    vals = [(int(a) << 64 | int(b)) % P for a, b in zip(rng.integers(0, 1 << 63, n), rng.integers(0, 1 << 63, n))]
    vals[:3] = [0, 1, P - 1]
    kernels.reset_launch_counts()
    levels, root = dm.tree_arrays_with_root(field_ops.to_mont(from_numpy(pack(vals), cuda)), n)
    wide = max(0, logn - cuda_merkle.SUBTREE_WIDTH.bit_length() + 1)
    assert (kernels.LAUNCHES["merkle_level"], kernels.LAUNCHES["merkle_subtrees"],
            kernels.LAUNCHES["merkle_top"]) == (wide, 1, 1)
    host = MerkleTree.from_codeword(vals)
    assert [lv.shape[1] for lv in levels] == [n >> k for k in range(logn - 9)]
    for lvl, arr in enumerate(levels):
        assert dm._level_bytes(to_numpy(arr)) == host.levels[lvl], lvl
    assert dm._digest_bytes(to_numpy(root)) == host.root


@pytest.mark.parametrize("logn", [13, 20])
def test_fold_kernel_matches_plain(cuda, logn):
    from stark_tpu_torch.ops import cuda_fold, kernels
    from stark_tpu_torch.ops.fold import fold_mont
    from stark_tpu_torch.ops.limbs import _fold_tables, from_numpy

    n = 1 << logn
    cw = _mont(n, logn + 100, cuda)
    table = from_numpy(_fold_tables(GENERATOR, FieldElement.primitive_nth_root(n).value, n // 2), cuda)
    for alpha_value in (0, 1, P - 1, 98765):
        alpha = from_numpy(pack([alpha_value * R_MOD_P % P]), cuda)
        before = kernels.LAUNCHES["fri_fold"]
        got = cuda_fold.fri_fold(cw, alpha, table)
        assert kernels.LAUNCHES["fri_fold"] == before + 1
        assert torch.equal(got, fold_mont(cw, alpha, table))


def test_fs_round_matches_plain_and_hashlib(cuda):
    """Bodies of 0-1000 bytes: the hashed message (8 + body + 72 bytes)
    crosses the 136-byte rate several times; and the 8 bodies of a
    fib-2^16 prove's cascade."""
    from stark_tpu_torch.ops import cuda_fs, field_ops, kernels
    from stark_tpu_torch.ops.device_fs import fs_round_plain
    from stark_tpu_torch.ops.limbs import from_numpy, to_numpy, unpack

    rng = np.random.default_rng(7)
    cascade = [216 + 72 * r for r in range(8)]
    for body_len in [0, 1, 55, 56, 57, 63, 64, 65, 135, 136, 137, 199, 200, 201, 407, 408, 409, 1000] + cascade:
        body = torch.from_numpy(rng.integers(0, 256, body_len + 72, dtype=np.uint8)).to(cuda)
        body_plain = body.clone()
        root = from_numpy(rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype(np.uint32), cuda)
        count = int(rng.integers(0, 1 << 62))
        before = kernels.LAUNCHES["fs_round"]
        alpha = cuda_fs.fs_round(body, body_len, count, root)
        assert kernels.LAUNCHES["fs_round"] == before + 1
        assert torch.equal(alpha, fs_round_plain(body_plain, body_len, count, root)), body_len
        assert torch.equal(body, body_plain), body_len
        msg = count.to_bytes(8, "little") + bytes(body[: body_len + 72].cpu().numpy())
        want = FieldElement.sample(hashlib.shake_256(msg).digest(32)).value
        assert unpack(to_numpy(field_ops.from_mont(alpha)))[0] == want, body_len


def test_fri_cascade_transcript_on_the_card_equals_host_fri(cuda):
    from stark_tpu_torch.fri import Fri
    from stark_tpu_torch.ops import kernels
    from stark_tpu_torch.ops.device_prover import DeviceProverCore
    from stark_tpu_torch.poly import Polynomial
    from stark_tpu_torch.proof_stream import ProofStream

    n = 1 << 14
    fri = Fri(FieldElement.generator(), FieldElement.primitive_nth_root(n), n, 4, 2)
    poly = Polynomial([i * 7919 % P for i in range(1, n // 4)])
    ps_host = ProofStream()
    idx_host = fri.prove([fe.value for fe in poly.eval_domain(fri.eval_domain())], ps_host)

    core = DeviceProverCore(n, fri.offset.value, cuda)
    ps_dev = ProofStream()
    kernels.reset_launch_counts()
    idx_dev = fri.prove(core.extend_codeword(poly.coeffs), ps_dev)
    assert fri.last_fused_rounds >= 2
    assert idx_dev == idx_host
    assert ps_dev.objects == ps_host.objects
    assert kernels.LAUNCHES["fs_round"] >= 2 and kernels.LAUNCHES["fri_fold"] >= 2


def test_fibonacci_proof_on_the_card_equals_host(cuda):
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.ops import device_merkle, kernels

    a, b = FieldElement(3), FieldElement(7)
    _, host_proof = FibonacciStark(1000, device=None, rng=DeterministicRandom(11)).prove(a, b)
    floor = device_merkle.DEVICE_TREE_MIN
    device_merkle.DEVICE_TREE_MIN = 2048  # the 8192-point domain then runs 3 fused FRI rounds
    try:
        kernels.reset_launch_counts()
        model = FibonacciStark(1000, device=cuda, rng=DeterministicRandom(11))
        result, proof = model.prove(a, b)
    finally:
        device_merkle.DEVICE_TREE_MIN = floor
    assert proof == host_proof
    assert model.stark.fri.last_fused_rounds == 3
    # every tree (8192 leaves at most) is narrower than SUBTREE_WIDTH, so
    # the level kernel's levels go to the subtrees kernel; the Rescue
    # permutation, the timing probes and the sharded path's kernel variants
    # are not on a one-device prove's path
    off_path = ("rescue_permutation",) + kernels.PROBES + kernels.MESH_VARIANTS
    assert kernels.LAUNCHES["merkle_level"] == 0 and all(kernels.LAUNCHES[k] == 0 for k in off_path), kernels.LAUNCHES
    assert all(v > 0 for k, v in kernels.LAUNCHES.items() if k not in ("merkle_level",) + off_path), \
        kernels.LAUNCHES
    assert FibonacciStark(1000, device=None).verify(a, b, result, proof)


# the field vector kernels (K7-K10): edge sizes (of a 256-thread block, of
# K7's 2048-element block and of 2^20), and the fib-2^16 prove's 65,545
# trace rows, 2n - 1 = 131,089 and its 2^20-point FRI domain
FIELD_SIZES = [1, 2, 255, 256, 257, 1025, 2047, 2048, 2049, 65545, 131089, (1 << 20) - 1, 1 << 20, (1 << 20) + 1]
INV_CHUNK = 2048  # elements one K7 block inverts (csrc/fieldvec.cu kInvChunk)


def _field_mont(n: int, seed: int, device):
    from stark_tpu_torch.ops.limbs import from_numpy, seeded_mont

    return from_numpy(seeded_mont(max(n, 3), seed)[:, :n], device)


def _nonzero_mont(n: int, seed: int, device):
    """n seeded Montgomery values without the leading zero of
    ``seeded_mont`` (the forms of 1 and p - 1 first), so that no prefix
    product is zero unless a test puts a zero in."""
    from stark_tpu_torch.ops.limbs import from_numpy, seeded_mont

    return from_numpy(seeded_mont(max(n + 1, 3), seed)[:, 1 : n + 1], device)


def _launched(name: str, call):
    """call(), which must launch kernel ``name`` once."""
    from stark_tpu_torch.ops import kernels

    before = kernels.LAUNCHES[name]
    out = call()
    assert kernels.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("n", FIELD_SIZES)
def test_mont_inv_kernel_matches_plain(cuda, n):
    from stark_tpu_torch.ops import cuda_field, field_ops

    a = _field_mont(n, n, cuda)
    a[:, ::3] = 0  # zeros mixed in: they map to zero
    got = _launched("mont_inv", lambda: cuda_field.mont_inv(a))
    assert torch.equal(got, field_ops.mont_inv(a))


@pytest.mark.parametrize("n", [INV_CHUNK + 1, 3 * INV_CHUNK + 5, (1 << 20) + 1])
@pytest.mark.parametrize("pattern", ["block_edges", "zero_block", "all_zero"])
def test_mont_inv_kernel_zero_patterns(cuda, n, pattern):
    """Zeros at the first and last element of K7's blocks and of the
    input, a whole block of zeros, and an input of zeros only."""
    from stark_tpu_torch.ops import cuda_field, field_ops

    a = _field_mont(n, n, cuda)
    if pattern == "block_edges":
        a[:, [0, INV_CHUNK - 1, INV_CHUNK, min(2 * INV_CHUNK - 1, n - 1), n - 1]] = 0
    elif pattern == "zero_block":
        a[:, INV_CHUNK : 2 * INV_CHUNK] = 0
    else:
        a.zero_()
    got = _launched("mont_inv", lambda: cuda_field.mont_inv(a))
    assert torch.equal(got, field_ops.mont_inv(a))


# K8 also past the tiles the card holds at once (2^21 + 1: 2049 tiles; 2^23: 8192)
PREFIX_SIZES = FIELD_SIZES + [(1 << 21) + 1, 1 << 23]
PREFIX_TILE = 1024  # elements a K8 block scans (csrc/fieldvec.cu kScanChunk)


@pytest.mark.parametrize("n", PREFIX_SIZES)
def test_prefix_mul_kernel_matches_plain(cuda, n):
    from stark_tpu_torch.ops import cuda_field, field_ops

    assert cuda_field.PREFIX_TILE == PREFIX_TILE
    a = _nonzero_mont(n, n + 1, cuda)
    got = _launched("prefix_mul", lambda: cuda_field.prefix_mul(a))
    want = field_ops.prefix_mul(a)
    assert bool((want != 0).any(0).all())  # no prefix is zero: every tile's look-back counts
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [3 * PREFIX_TILE + 5, (1 << 20) + 1])
@pytest.mark.parametrize("pattern", ["tile_edges", "zero_tile", "all_zero"])
def test_prefix_mul_kernel_zero_patterns(cuda, n, pattern):
    """Zeros at the first and last element of K8's second tile, a whole
    tile of zeros, and zeros only: every prefix from the first zero on is
    zero."""
    from stark_tpu_torch.ops import cuda_field, field_ops

    a = _nonzero_mont(n, n + 2, cuda)
    if pattern == "tile_edges":
        a[:, [PREFIX_TILE, 2 * PREFIX_TILE - 1]] = 0
    elif pattern == "zero_tile":
        a[:, PREFIX_TILE : 2 * PREFIX_TILE] = 0
    else:
        a.zero_()
    got = _launched("prefix_mul", lambda: cuda_field.prefix_mul(a))
    assert torch.equal(got, field_ops.prefix_mul(a))


def test_prefix_mul_kernel_back_to_back(cuda):
    """50 calls queued back to back on different inputs and sizes, each a
    new epoch of the one status buffer: flags of earlier calls must read
    as nothing published."""
    from stark_tpu_torch.ops import cuda_field, field_ops

    sizes = [1 + (k * 7919) % (40 * PREFIX_TILE) for k in range(50)]
    inputs = [_nonzero_mont(n, 1000 + k, cuda) for k, n in enumerate(sizes)]
    outs = [_launched("prefix_mul", lambda a=a: cuda_field.prefix_mul(a)) for a in inputs]
    for a, got in zip(inputs, outs):
        assert torch.equal(got, field_ops.prefix_mul(a)), a.shape[1]


def test_prefix_mul_kernel_after_the_status_buffer_grows(cuda):
    """A call on a fresh one-tile buffer, then one that grows it."""
    from stark_tpu_torch.ops import cuda_field, field_ops

    small, large = _nonzero_mont(100, 1, cuda), _nonzero_mont(50 * PREFIX_TILE + 3, 2, cuda)
    cuda_field._STATUS.pop(small.device, None)
    got_small = _launched("prefix_mul", lambda: cuda_field.prefix_mul(small))
    assert cuda_field._STATUS[small.device].capacity == 1
    got_large = _launched("prefix_mul", lambda: cuda_field.prefix_mul(large))
    assert cuda_field._STATUS[large.device].capacity == 64
    assert torch.equal(got_small, field_ops.prefix_mul(small))
    assert torch.equal(got_large, field_ops.prefix_mul(large))


@pytest.mark.parametrize("n", FIELD_SIZES)
def test_geometric_table_kernel_matches_plain(cuda, n):
    from stark_tpu_torch.ops import cuda_field
    from stark_tpu_torch.ops.limbs import mont_tensor

    base = FieldElement.primitive_nth_root(1 << 21).value
    bits = (n - 1).bit_length()
    bases = mont_tensor([pow(base, 1 << b, P) for b in range(bits)], cuda)
    start = mont_tensor([GENERATOR], cuda)
    got = _launched("geometric_table", lambda: cuda_field.geometric_table(start, bases, n))
    assert torch.equal(got, cuda_field.geometric_table_plain(start, bases, n))


@pytest.mark.parametrize("n", [(1 << 15) + 1, 1 << 16])
def test_geometric_table_kernel_steps_by_its_last_bit_base(cuda, n):
    """Tables whose grid steps by base^(2^m) with m = bits - 1, the last
    bit base the wrapper passes (a step of two elements a thread, the
    second past n for all but one thread at 2^15 + 1)."""
    from stark_tpu_torch.ops import cuda_field
    from stark_tpu_torch.ops.limbs import mont_tensor

    base = FieldElement.primitive_nth_root(1 << 21).value
    bits = (n - 1).bit_length()
    assert cuda_field.geometric_step_bits(n) == bits - 1
    assert cuda_field.geometric_step_bits(1 << 15) == 15  # one element a thread up to 2^15
    bases = mont_tensor([pow(base, 1 << b, P) for b in range(bits)], cuda)
    start = mont_tensor([GENERATOR], cuda)
    got = _launched("geometric_table", lambda: cuda_field.geometric_table(start, bases, n))
    assert torch.equal(got, cuda_field.geometric_table_plain(start, bases, n))


@pytest.mark.parametrize("n", FIELD_SIZES)
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_mont_binary_kernel_matches_plain(cuda, n, op):
    """Both operands full, and an (8, 1) column on either side."""
    from stark_tpu_torch.ops import cuda_field

    code = {"mul": cuda_field.MUL, "add": cuda_field.ADD, "sub": cuda_field.SUB}[op]
    a, b = _field_mont(n, 2 * n, cuda), _field_mont(n, 2 * n + 1, cuda)
    column = _field_mont(4, 5, cuda)[:, 3:4].contiguous()
    for x, y in ((a, b), (column, b), (a, column), (column, column)):
        got = _launched("mont_binary", lambda: cuda_field.mont_binary(code, x, y))
        assert torch.equal(got, cuda_field._PLAIN[code](x, y))


def test_device_geometric_interpolate_on_the_card_equals_host(cuda):
    """The fib-2^16 prove's interpolation size, 65,545 points of a
    geometric progression, against the port's host chirp interpolation."""
    from stark_tpu_torch.geometric import geometric_interpolate
    from stark_tpu_torch.ops import kernels
    from stark_tpu_torch.ops.geometric_device import device_geometric_interpolate
    from stark_tpu_torch.ops.limbs import mont_tensor, to_numpy, unpack

    n = 65545
    q = FieldElement.primitive_nth_root(1 << 17).value
    rng = np.random.default_rng(n)
    ys = [int(v) % P for v in rng.integers(0, 1 << 62, n)]
    ys[0] = 0
    kernels.reset_launch_counts()
    got = device_geometric_interpolate(mont_tensor(ys, cuda), 1, q)
    assert all(kernels.LAUNCHES[k] > 0 for k in ("mont_inv", "prefix_mul", "geometric_table", "mont_binary"))
    r_inv = pow(R_MOD_P, -1, P)
    want = geometric_interpolate([pow(q, i, P) for i in range(n)], ys, q)
    assert [v * r_inv % P for v in unpack(to_numpy(got))] == want


# the Rescue permutation kernel (R1): one instance a thread, 64 a block;
# batches around a warp and a block, the 8 of prove_batch in chip_smoke.py,
# the 4096 of a benchmark batch and more than 2^16 instances
RESCUE_BATCHES = [1, 8, 31, 32, 33, 63, 64, 65, 255, 4096, (1 << 16) + 1]


def _rescue_state(b: int, seed: int, device):
    from stark_tpu_torch.ops.limbs import from_numpy, seeded_mont

    return from_numpy(seeded_mont(2 * b + 1, seed)[:, 1:], device).reshape(8, 2, b).contiguous()


@pytest.mark.parametrize("b", RESCUE_BATCHES)
@pytest.mark.parametrize("trace", [False, True])
def test_rescue_permutation_kernel_matches_plain(cuda, b, trace):
    from stark_tpu_torch.ops import rescue
    from stark_tpu_torch.ops.cuda_rescue import rescue_permutation

    state = _rescue_state(b, b, cuda)
    got = _launched("rescue_permutation", lambda: rescue_permutation(state, trace=trace))
    want = rescue.trace_mont(state) if trace else rescue.permutation_mont(state)
    assert got.shape == ((28,) if trace else ()) + (8, 2, b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("trace", [False, True])
def test_rescue_permutation_kernel_on_edge_states(cuda, trace):
    """R1 on every pair of 0, 1, p - 1, R mod p and words whose Montgomery
    square is negative before fe_redc's last correction."""
    import chip_smoke
    from stark_tpu_torch import params
    from stark_tpu_torch.ops import limbs, rescue
    from stark_tpu_torch.ops.cuda_rescue import rescue_permutation

    state = chip_smoke.rescue_edge_state(limbs, params, cuda)
    got = _launched("rescue_permutation", lambda: rescue_permutation(state, trace=trace))
    want = rescue.trace_mont(state) if trace else rescue.permutation_mont(state)
    assert torch.equal(got, want)


def test_rescue_permutation_runs_its_plain_version_on_cpu_tensors(cuda):
    from stark_tpu_torch.ops import kernels, rescue
    from stark_tpu_torch.ops.cuda_rescue import rescue_permutation

    state = _rescue_state(3, 7, cuda)
    before = kernels.LAUNCHES["rescue_permutation"]
    on_cpu = rescue_permutation(state.cpu(), trace=True)
    assert kernels.LAUNCHES["rescue_permutation"] == before
    assert torch.equal(on_cpu, rescue.trace_mont(state.cpu()))
    assert torch.equal(_launched("rescue_permutation", lambda: rescue_permutation(state, trace=True)).cpu(), on_cpu)


def test_rescue_batches_on_the_card_equal_the_host_model(cuda):
    from stark_tpu_torch import RescuePrime
    from stark_tpu_torch.ops import rescue

    rng = np.random.default_rng(64)
    inputs = [int(v) % P for v in rng.integers(0, 1 << 62, 64)]
    rp = RescuePrime()
    hashes = _launched("rescue_permutation", lambda: rescue.hash_batch(inputs, cuda))
    assert hashes == [rp.hash(FieldElement(x)).value for x in inputs]
    traces = _launched("rescue_permutation", lambda: rescue.trace_batch(inputs, cuda))
    assert [traces[i].tolist() for i in range(64)] == [
        [[v.value for v in row] for row in rp.trace(FieldElement(x))] for x in inputs
    ]


def test_rescue_prove_batch_on_the_card_equals_host(cuda):
    from stark_tpu_torch.models.rescue_stark import RescueStark
    from stark_tpu_torch.ops import kernels

    inputs = [FieldElement(x) for x in (3, 5, 7, 11)]
    want = RescueStark(device=None, rng=DeterministicRandom(9)).prove_batch(inputs)
    kernels.reset_launch_counts()
    got = RescueStark(device=cuda, rng=DeterministicRandom(9)).prove_batch(inputs)
    assert kernels.LAUNCHES["rescue_permutation"] == 1
    assert [(o.value, p) for o, p in got] == [(o.value, p) for o, p in want]


@pytest.mark.parametrize("model", ["mimc", "rescue-chain"])
def test_small_models_through_the_device_pipeline_on_the_card_equal_host(cuda, model):
    from stark_tpu_torch.models.mimc import MimcStark
    from stark_tpu_torch.models.rescue_chain import RescueChainStark

    def build(device):
        if model == "mimc":
            return MimcStark(30, device=device, rng=DeterministicRandom(8))
        return RescueChainStark(4, device=device, rng=DeterministicRandom(21))

    x = FieldElement(77)
    host = build(None)
    card = build(cuda)
    card.stark.backend.device_prover_min = 512
    assert card.stark._use_device_pipeline()
    if model == "mimc":
        assert card.prove(x) == host.prove(x)
    else:
        out, proof = card.prove(x)
        assert (out, proof) == host.prove(x)
        assert host.verify(out, proof) and not host.verify(out + FieldElement(1), proof)


# the timing probes B1-B4 (csrc/probes.cu): a small shape, a ragged one (a
# row not a multiple of the 256-thread block, t's 128 columns reused past
# it) and the probes' 2^20, each against its plain version
PROBE_SHAPES = [(2, 256), (3, 200), (1024, 1024)]


def _probe_operands(rows: int, cols: int, limbs: int, bits: int, seed: int, device):
    """x (limbs, rows, cols) below p and t (limbs, rows, 128), its limbs
    over their full width."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << bits, (limbs, rows, cols), dtype=np.uint32)
    x[limbs - 1] = rng.integers(0, P >> (bits * (limbs - 1)), (rows, cols), dtype=np.uint32)
    t = rng.integers(0, 1 << bits, (limbs, rows, 128), dtype=np.uint32)
    return (torch.from_numpy(x.view(np.int32)).to(device), torch.from_numpy(t.view(np.int32)).to(device))


@pytest.mark.parametrize("rows, cols", PROBE_SHAPES)
def test_probe_mont13_chain_matches_plain(cuda, rows, cols):
    from stark_tpu_torch.ops import cuda_probes

    x, t = _probe_operands(rows, cols, 10, 13, rows * cols, cuda)
    got = _launched("probe_mont13_chain", lambda: cuda_probes.mont13_chain(x, t))
    assert torch.equal(got, cuda_probes.mont13_chain_plain(x, t))


@pytest.mark.parametrize("rows, cols", PROBE_SHAPES)
def test_probe_mont_chain_matches_plain(cuda, rows, cols):
    from stark_tpu_torch.ops import cuda_probes

    x, t = _probe_operands(rows, cols, 8, 16, rows * cols, cuda)
    got = _launched("probe_mont_chain", lambda: cuda_probes.mont_chain(x, t))
    assert torch.equal(got, cuda_probes.mont_chain_plain(x, t))


@pytest.mark.parametrize("mode", ["base", "hint16", "xor"])
@pytest.mark.parametrize("rows, cols", PROBE_SHAPES)
def test_probe_mont16_chain_matches_plain(cuda, rows, cols, mode):
    from stark_tpu_torch.ops import cuda_probes

    x, t = _probe_operands(rows, cols, 8, 16, rows * cols, cuda)
    got = _launched(f"probe_mont16_chain/{mode}", lambda: cuda_probes.mont16_chain(x, t, mode))
    assert torch.equal(got, cuda_probes.mont16_chain_plain(x, t, mode))
    if mode != "xor":  # the TPU's product is the field product
        assert torch.equal(got, cuda_probes.mont_chain(x, t))


@pytest.mark.parametrize("w", [2, 2002, 1 << 20])
def test_probe_level_kernels_match_plain(cuda, w):
    from stark_tpu_torch.ops import cuda_merkle, cuda_probes

    level = torch.from_numpy(np.random.default_rng(w).integers(0, 1 << 32, (8, w), dtype=np.uint32).view(np.int32))
    level = level.to(cuda)
    stub = _launched("probe_level_stub", lambda: cuda_probes.level_stub(level))
    assert torch.equal(stub, cuda_probes.level_stub_plain(level))
    for r in cuda_probes.ROUNDS:  # 12 rounds: the level kernel itself
        kernel = f"probe_level_rounds/{r}" if r in cuda_probes.PROBE_ROUNDS else "merkle_level"
        got = _launched(kernel, lambda: cuda_probes.level_rounds(level, r))
        assert torch.equal(got, cuda_probes.level_rounds_plain(level, r))
    assert torch.equal(got, cuda_merkle.merkle_level(level))


# -- the combination (K11), the Montgomery-input leaves, the digit conversion,
# the small four-step transforms, and no plain arithmetic on a prove's path

FIB_STRUCTURE = ((((0, 0, 1, 0), 0), ((1, 0, 0, 0), 1), ((0, 1, 0, 0), 2)),
                 (((0, 0, 0, 1), 3), ((1, 0, 0, 0), 4)))
# one group of each tail shape of the Rescue chain's AIR, 3 constraints
CHAIN_SHAPES = ((((), 0), ((3, 0, 0, 0), 1), ((0, 0, 2, 1), 2), ((0, 0, 0, 2), 3)),
                (((0, 0, 1, 2), 4), ((0, 0, 1, 0), 5)),
                (((0, 0, 0, 1), 6), ((1, 0, 0, 0), 7)))


@pytest.mark.parametrize("logn", [13, 20])
@pytest.mark.parametrize("name", ["fib", "chain_shapes"])
def test_combination_kernel_matches_plain(cuda, name, logn):
    from stark_tpu_torch.ops import cuda_combination as cc

    structure = FIB_STRUCTURE if name == "fib" else CHAIN_SHAPES
    n, k, groups = 1 << logn, len(structure), 1 + max(gi for c in structure for _, gi in c)
    cws = iter(range(1000))
    col = lambda: _mont(n, logn * 1000 + next(cws), cuda)  # noqa: E731
    trace, group_cws, tz = [col(), col()], [col() for _ in range(groups)], col()
    args = (trace, group_cws, [tz] * k, col(), [col(), col()], _mont(1 + 2 * (k + 2), logn, cuda),
            [col() for _ in range(k)], [col(), col()])
    program = cc.encode(structure, 2, 4)
    comb, tqs = _launched("combination", lambda: cc.combination(program, *args))
    want_comb, want_tqs = cc.combination_plain(program, *args)
    assert torch.equal(comb, want_comb) and torch.equal(tqs, want_tqs)


@pytest.mark.parametrize("n", [1, 7, 2047, 65545, 1 << 20])
def test_mont_leaves_and_mont_digits_match_plain(cuda, n):
    from stark_tpu_torch.ops import cuda_merkle
    from stark_tpu_torch.ops import device_merkle as dm

    mont = _field_mont(n, n, cuda)
    leaves = _launched("merkle_leaves", lambda: cuda_merkle.merkle_leaves_mont(mont))
    assert torch.equal(leaves, cuda_merkle.merkle_leaves_mont_plain(mont))
    digits = _launched("mont_digits", lambda: cuda_merkle.mont_digits(mont))
    assert torch.equal(digits, dm.plain_digits(mont))
    assert torch.equal(leaves, cuda_merkle.merkle_leaves(digits))


@pytest.mark.parametrize("k", [1, 4, 37, 257])
@pytest.mark.parametrize("g", [1, 27])
def test_mont_digits_gather_matches_plain(cuda, g, k):
    """The gather form on g codewords at k indices (first and last columns
    among them): the plain gather's digits, one launch under the kernel's
    caps (two at 257 indices), and nothing else on the card but the
    output's allocation."""
    import random

    from stark_tpu_torch.ops import cuda_merkle, guard, kernels
    from stark_tpu_torch.ops import device_merkle as dm

    n = 65545
    cws = [_field_mont(n, 300 + j, cuda) for j in range(g)]
    idx = [n - 1] if k == 1 else [0] + sorted(random.Random(k).sample(range(1, n - 1), k - 2)) + [n - 1]
    before = kernels.LAUNCHES["mont_digits_gather"]
    with guard.count_device_ops() as ops:
        got = cuda_merkle.mont_digits(cws, idx)
    assert kernels.LAUNCHES["mont_digits_gather"] - before == (1 if k <= cuda_merkle.GATHER_MAX_INDICES else 2)
    assert set(ops) <= guard.ALLOCATION, dict(ops)
    assert torch.equal(got, torch.cat([dm.plain_digits(cw[:, idx]) for cw in cws], dim=1))


def test_opening_gathers_on_the_card_are_one_launch(cuda, monkeypatch):
    """fib-1000 on the card: every opening gather of values launches the
    gather kernel once and runs nothing else on the card."""
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.ops import device_prover, guard, kernels

    calls = []
    gather = device_prover.DeviceCodeword.gather_values_async

    def watched(self, indices):
        before = kernels.LAUNCHES["mont_digits_gather"]
        with guard.count_device_ops() as ops:
            idx, arr = gather(self, indices)
        calls.append((len(idx), kernels.LAUNCHES["mont_digits_gather"] - before, dict(ops)))
        return idx, arr

    monkeypatch.setattr(device_prover.DeviceCodeword, "gather_values_async", watched)
    FibonacciStark(1000, device=cuda, rng=DeterministicRandom(11)).prove(FieldElement(3), FieldElement(7))
    assert any(k for k, _, _ in calls)
    assert all(launched == (1 if k else 0) and set(ops) <= guard.ALLOCATION for k, launched, ops in calls), calls


@pytest.mark.parametrize("logn", range(6, 13))
@pytest.mark.parametrize("inverse, offset", [(False, 1), (True, 1), (False, GENERATOR), (True, GENERATOR)])
def test_small_four_step_transforms_match_plain(cuda, logn, inverse, offset):
    """The sizes the device trace interpolation now runs on the passes
    (64 to 4096 points), whole transforms against the stage-by-stage plan."""
    from stark_tpu_torch.ops import backend
    from stark_tpu_torch.ops.ntt import NTTPlan

    n = 1 << logn
    plan = backend.best_plan(n, cuda)
    a = _mont(n, logn, cuda)
    got = plan.apply(a, plan.op_tables(inverse, offset), inverse)
    stage = NTTPlan(n, "cpu")
    want = stage.apply(a.cpu(), stage.op_tables(inverse, offset), inverse)
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError):
        backend.best_plan(32, cuda)


@pytest.mark.parametrize("entry", ["rs_extend", "rs_restrict", "poly_multiply", "fri_fold"])
def test_backend_host_list_entry_points_match_the_host(cuda, entry):
    """TorchBackend's host-list entry points convert and multiply on K10
    (no plain arithmetic on the card), against the host NTT at 2^13."""
    from stark_tpu_torch.fri import Fri
    from stark_tpu_torch.ntt import NTT, poly_multiply
    from stark_tpu_torch.ops import guard, kernels
    from stark_tpu_torch.ops.backend import TorchBackend

    n = 1 << 13
    rng = np.random.default_rng(n)
    vals = [int(v) % P for v in rng.integers(0, 1 << 62, n)]
    backend = TorchBackend(cuda)
    omega = FieldElement.primitive_nth_root(n).value
    want = {"rs_extend": lambda: NTT(n).coset_evaluate(vals, GENERATOR),
            "rs_restrict": lambda: NTT(n).coset_interpolate(vals, GENERATOR),
            "poly_multiply": lambda: poly_multiply(vals[: n // 2], vals[n // 2 :]),
            "fri_fold": lambda: Fri._fold_host(vals, 12345, GENERATOR, omega)}[entry]()
    before = kernels.LAUNCHES["mont_binary"]
    with guard.count_plain_calls() as plain:
        got = {"rs_extend": lambda: backend.rs_extend(vals, n, GENERATOR),
               "rs_restrict": lambda: backend.rs_restrict(vals, GENERATOR),
               "poly_multiply": lambda: backend.poly_multiply(vals[: n // 2], vals[n // 2 :]),
               "fri_fold": lambda: backend.fri_fold(vals, 12345, GENERATOR, omega)}[entry]()
    assert got == want
    assert sum(plain.values()) == 0, dict(plain)
    assert kernels.LAUNCHES["mont_binary"] >= before + 2


@pytest.mark.parametrize("model", ["fib-1000", "rescue-chain-4"])
def test_proves_on_the_card_call_no_plain_arithmetic(cuda, model):
    """No function of field_ops runs on a CUDA tensor in a prove (cold: the
    core and plans built inside it), K11 launched once, the proof the host
    prover's bytes."""
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.models.rescue_chain import RescueChainStark
    from stark_tpu_torch.ops import cuda_ntt, device_prover, guard, kernels

    def build(device):
        if model == "fib-1000":
            return FibonacciStark(1000, device=device, rng=DeterministicRandom(11))
        return RescueChainStark(4, device=device, rng=DeterministicRandom(21))

    def prove(m):
        return m.prove(FieldElement(3), FieldElement(7)) if model == "fib-1000" else m.prove(FieldElement(77))

    want = prove(build(None))
    device_prover._CORE_CACHE.clear()
    cuda_ntt._cuda_plan.cache_clear()
    card = build(cuda)
    card.stark.backend.device_prover_min = 512
    assert card.stark._use_device_pipeline()
    kernels.reset_launch_counts()
    with guard.count_plain_calls() as plain:
        got = prove(card)
    assert sum(plain.values()) == 0, dict(plain)
    assert got == want
    assert kernels.LAUNCHES["combination"] == 1
    assert kernels.LAUNCHES["mont_digits"] > 0


# -- the sharded path's kernel variants, a sharded prove and the service ----------


@pytest.mark.parametrize("logn", [13, 17, 20])
@pytest.mark.parametrize("name", ["fib", "chain_shapes"])
def test_combination_next_rows_match_plain(cuda, name, logn):
    """K11's next-row form (the sharded core's) against its plain version,
    and against the one-device form given the rolled planes."""
    from stark_tpu_torch.ops import cuda_combination as cc

    structure = FIB_STRUCTURE if name == "fib" else CHAIN_SHAPES
    n, k, groups = 1 << logn, len(structure), 1 + max(gi for c in structure for _, gi in c)
    cws = iter(range(1000))
    col = lambda: _mont(n, logn * 2000 + next(cws), cuda)  # noqa: E731
    trace = [col(), col()]
    args = (trace, [col() for _ in range(groups)], [col()] * k, col(), [col(), col()],
            _mont(1 + 2 * (k + 2), logn, cuda), [col() for _ in range(k)], [col(), col()])
    program = cc.encode(structure, 2, 4)
    nexts = [col(), col()]
    comb, tqs = _launched("combination_next", lambda: cc.combination(program, *args, next_cws=nexts))
    want_comb, want_tqs = cc.combination_plain(program, *args, nexts)
    assert torch.equal(comb, want_comb) and torch.equal(tqs, want_tqs)
    rolled = [torch.roll(t, -4, dims=1).contiguous() for t in trace]
    assert torch.equal(cc.combination(program, *args, next_cws=rolled)[0], cc.combination(program, *args)[0])


@pytest.mark.parametrize("rows, cols", [(1, 1), (3, 5), (1000, 7), (8, 128), (1024, 128), (1 << 14, 64)])
def test_mont_outer_matches_plain(cuda, rows, cols):
    from stark_tpu_torch.ops import cuda_field

    a = _mont(max(rows, 3), rows, cuda)[:, :rows].contiguous()
    b = _mont(max(cols, 3), cols + 1, cuda)[:, :cols].contiguous()
    got = _launched("mont_outer", lambda: cuda_field.mont_outer(a, b))
    assert torch.equal(got, cuda_field.mont_outer_plain(a, b))


def test_sharded_fib_1000_on_an_8_shard_mesh_equals_the_one_device_proof(cuda):
    """fib-1000 (8192 points) over 8 shards on one card: the proof the
    one-device prover's bytes, no plain arithmetic, every per-shard step
    a kernel (K11's next-row form once a shard)."""
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.ops import guard, kernels
    from stark_tpu_torch.parallel import ShardedBackend, make_mesh

    mesh = make_mesh(8, [cuda])
    assert len(mesh) == 8 and len(set(mesh)) == 1 and mesh[0].index is not None
    a, b = FieldElement(3), FieldElement(7)
    want = FibonacciStark(1000, device=cuda, rng=DeterministicRandom(11)).prove(a, b)
    model = FibonacciStark(1000, backend=ShardedBackend(mesh), rng=DeterministicRandom(11))
    assert model.stark._use_device_pipeline()
    kernels.reset_launch_counts()
    with guard.count_plain_calls() as plain:
        got = model.prove(a, b)
    assert sum(plain.values()) == 0, dict(plain)
    assert got == want
    assert kernels.LAUNCHES["combination_next"] == 8 and kernels.LAUNCHES["combination"] == 0
    # blocks of 1024 leaves are hashed on the host from their digits
    # (mont_digits a block), which then serve the openings: no gather
    for name in ("ntt_pass1", "ntt_pass2", "fri_fold", "mont_outer", "mont_inv", "mont_digits"):
        assert kernels.LAUNCHES[name] > 0, name
    assert model.verify(a, b, got[0], got[1])


def test_sharded_chain_4_on_an_8_shard_mesh_equals_the_host_proof(cuda):
    """chain-4's 1024-point domain over 8 shards on one card: shards 4
    columns wide (K2/K3 in clusters of 4), the proof the host prover's
    bytes, K11's next-row form once a shard."""
    from stark_tpu_torch.models.rescue_chain import RescueChainStark
    from stark_tpu_torch.ops import guard, kernels
    from stark_tpu_torch.parallel import ShardedBackend, make_mesh

    x = FieldElement(77)
    want = RescueChainStark(4, device=None, rng=DeterministicRandom(21)).prove(x)
    model = RescueChainStark(4, backend=ShardedBackend(make_mesh(8, [cuda]), device_prover_min=1024),
                             rng=DeterministicRandom(21))
    assert model.stark._use_device_pipeline() and model.stark.fri_domain_length == 1024
    kernels.reset_launch_counts()
    with guard.count_plain_calls() as plain:
        got = model.prove(x)
    assert sum(plain.values()) == 0, dict(plain)
    assert got == want
    assert kernels.LAUNCHES["combination_next"] == 8 and kernels.LAUNCHES["combination"] == 0
    assert kernels.LAUNCHES_BY_SIZE[1024 // 8]["ntt_pass1"] >= 16


def test_precompile_launches_every_kernel_of_the_prove_and_the_prove_fills_no_cache(cuda, monkeypatch):
    """fib-1000 (8192 points) on the card: after ``precompile()`` on fresh
    caches the prove launches no kernel the warm-up did not, at no NTT size
    it did not run, adds no entry to any cache of the statement, the core
    or a plan, misses no plan lookup, and proves the host prover's bytes."""
    from stark_tpu_torch import stark as port_stark
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.ops import cuda_field, cuda_ntt, device_prover, kernels

    monkeypatch.setattr(port_stark, "_SHARED_TABLES", {})
    monkeypatch.setattr(device_prover, "_CORE_CACHE", {})
    monkeypatch.setattr(device_prover, "_B0_TABLES", {})
    monkeypatch.setattr(cuda_field, "_COLUMNS", {})
    a, b = FieldElement(3), FieldElement(7)
    want = FibonacciStark(1000, device=None, rng=DeterministicRandom(11)).prove(a, b)
    model = FibonacciStark(1000, device=cuda, rng=DeterministicRandom(11))
    kernels.reset_launch_counts()
    jobs = model.precompile()
    assert jobs and all(v >= 0 for v in jobs.values())
    warmed = {k for k, v in kernels.LAUNCHES.items() if v}
    warmed_ntt = {n for n, v in kernels.LAUNCHES_BY_SIZE.items() if "ntt_pass1" in v}
    core = model.stark._device_core()

    def caches():
        import gc

        plans = {id(p): set(p._row_col_cache) for p in gc.get_objects() if type(p) is cuda_ntt.CudaNTT}
        return ({shape: {name: set(t) for name, t in entry.items()}
                 for shape, entry in port_stark._SHARED_TABLES.items()},
                set(device_prover._CORE_CACHE), set(device_prover._B0_TABLES), set(cuda_field._COLUMNS),
                set(core._inv_tables), set(core._shift_tables), set(core._comb_cache), plans,
                cuda_ntt._cuda_plan.cache_info().misses)

    before = caches()
    kernels.reset_launch_counts()
    got = model.prove(a, b)
    proved = {k for k, v in kernels.LAUNCHES.items() if v}
    proved_ntt = {n for n, v in kernels.LAUNCHES_BY_SIZE.items() if "ntt_pass1" in v}
    assert got == want
    assert proved <= warmed, proved - warmed
    assert proved_ntt <= warmed_ntt, proved_ntt - warmed_ntt
    assert caches() == before


def test_service_round_trip_on_the_card(cuda):
    import json
    import threading
    import urllib.request

    from stark_tpu_torch.serve import ProverService, make_server

    server = make_server(ProverService(device="cuda"), "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(url + path, data=json.dumps(payload).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["backend"] == "cuda"
        fib = {"model": "fibonacci", "steps": 1000, "a": "1", "b": "1"}
        proved = post("/prove", fib)
        assert post("/verify", dict(fib, proof=proved["proof"], output=proved["output"]))["valid"] is True
    finally:
        server.shutdown()
        server.server_close()


def _multiprocess_fib_2000(cuda, tmp_path, *options):
    """The multi-controller launcher at fib-2000 (16,384 points, committed
    through device subtrees of 2048 leaves spanning the ranks once
    DEVICE_TREE_MIN is 2048) and an NTT of 2^14, 2 ranks x 4 shards; every
    rank's proof must be the one-device prover's bytes (the workers check
    the digest and raise otherwise)."""
    from stark_tpu_torch.benches import multiprocess_mesh
    from stark_tpu_torch.models.fibonacci import FibonacciStark

    _, proof = FibonacciStark(2000, device=cuda, rng=DeterministicRandom(11)).prove(FieldElement(3), FieldElement(7))
    digest = hashlib.sha256(proof).hexdigest()
    ranks = multiprocess_mesh.run(
        ["--device", "cuda", "--ranks", "2", "--shards-per-rank", "4", "--log-n", "14", "--steps", "2000",
         "--device-tree-min", "2048", "--inputs", "3", "7", "--seed", "11", "--device-prover-min", "4096",
         "--expect-digest", digest,
         "--rendezvous", str(tmp_path / "rendezvous"), "--timeout", "300", *options])
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        (fib,) = r["fib"]
        assert (fib["sha256"], fib["verified"], fib["plain_field_ops_on_cuda"]) == (digest, True, 0)
        assert fib["commitments"].get("ShardedMerkleTree", 0) > 0
        assert fib["exchanges"]["remote_bytes"] > 0
        assert fib["launches"]["combination_next"] == 4 and "combination" not in fib["launches"]
        assert r["ntt"]["identical_to_one_device"] and r["ntt"]["round_trip"] and r["tree"]["identical_to_one_device"]
    return ranks


def test_multiprocess_mesh_of_two_ranks_on_one_card(cuda, tmp_path):
    """Two ranks share cuda:0 over gloo: every crossing staged through host
    buffers."""
    ranks = _multiprocess_fib_2000(cuda, tmp_path, "--backend", "gloo")
    assert all(r["staged"] and r["device"] == "cuda:0" for r in ranks)
    # every byte that crossed went down to the host on one rank and up on the other
    staged, remote = (sum(r["fib"][0]["exchanges"][k] for r in ranks) for k in ("staged_bytes", "remote_bytes"))
    assert staged == 2 * remote > 0


def test_multiprocess_mesh_over_nccl(cuda, tmp_path):
    """One rank a card over NCCL, crossings on device buffers."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL runs one rank a card: needs 2 cards")
    ranks = _multiprocess_fib_2000(cuda, tmp_path, "--backend", "nccl", "--cards", "2")
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:1"]
    for r in ranks:
        assert not r["staged"] and r["fib"][0]["exchanges"]["staged_bytes"] == 0
