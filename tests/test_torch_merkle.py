"""The torch port's device Merkle tree against the JAX package and the host.

At 2048 leaves (values from a numpy seed, with the digit-count edge
cases 0, 1, p - 1, 2^32 - 1, 2^32 and 2^96 + 5):

* the plain versions of the CUDA leaf/level kernels (K4/K5), as
  ``cuda_merkle.tree_levels`` runs them on the CPU, against
  ``stark_tpu.ops.device_merkle.tree_arrays_with_root`` (XLA) and
  ``stark_tpu.ops.pallas_merkle.tree_levels(..., interpret=True)``;
* ``DeviceMerkleTree`` against the host ``MerkleTree``: root and every
  auth path; at 2^13 leaves against the port's own host ``MerkleTree``
  (root and four auth paths), no JAX;
* the top kernel's plain version: its flat buffer cut by ``top_slabs``
  equals the chain of ``level_hash`` at every width from 2 to 2^12;
* the subtrees kernel's plain version likewise, at (w, depth) from (2, 1)
  to (2^13, 4) and at full depth; ``tree_levels`` with ``SUBTREE_WIDTH``
  lowered to 2^11, against the port's host tree at 2^13 and 2^14 leaves,
  with the widths each kernel was called at;
* the wrappers' refusals of bad widths, depths, dtypes and shapes.

Tolerance: none (hashes are compared byte for byte).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.merkle import MerkleTree
from stark_tpu.ops import device_merkle as jdm
from stark_tpu.ops import field_ops as jfo
from stark_tpu.ops.limbs import pack
from stark_tpu.params import P
from stark_tpu_torch.merkle import MerkleTree as PortMerkleTree
from stark_tpu_torch.ops import cuda_merkle
from stark_tpu_torch.ops import device_merkle as tdm
from stark_tpu_torch.ops import field_ops as tfo
from stark_tpu_torch.ops.device_prover import fetch_absorb
from stark_tpu_torch.ops.limbs import from_numpy, to_numpy

# The suite runs several pytest-xdist workers side by side; more than one
# torch thread per worker oversubscribes the cores, and the threads'
# OpenMP spin-waits then slow the plain versions tens of times.
torch.set_num_threads(1)

N = 2048


@pytest.fixture(scope="module")
def vals():
    rng = np.random.default_rng(2048)
    out = [(int(v) << 64 | int(w)) % P for v, w in zip(rng.integers(0, 1 << 63, N), rng.integers(0, 1 << 63, N))]
    out[:6] = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 96) + 5]
    return out


@pytest.fixture(scope="module")
def digits(vals):
    rows = np.zeros((4, N), dtype=np.uint32)
    for i, v in enumerate(vals):
        for j in range(4):
            rows[j, i] = (v >> (32 * j)) & 0xFFFFFFFF
    return rows


@pytest.fixture(scope="module")
def torch_tree(digits):
    levels, root = cuda_merkle.tree_levels(from_numpy(digits, "cpu"), tdm.TAIL_WIDTH)
    return [to_numpy(lv) for lv in levels], to_numpy(root)


def test_tree_matches_jax_xla_tree(vals, torch_tree):
    mont = jfo.to_mont(jnp.asarray(pack(vals)))
    levels, root = jax.jit(lambda m: jdm.tree_arrays_with_root(m, N))(mont)
    got_levels, got_root = torch_tree
    assert len(got_levels) == len(levels) == 2  # widths 2048 and 1024
    for got, want in zip(got_levels, levels):
        assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got_root, np.asarray(root))


def test_tree_matches_pallas_interpret_tree(digits, torch_tree):
    from stark_tpu.ops.pallas_merkle import tree_levels

    levels, root = tree_levels(jnp.asarray(digits), tdm.TAIL_WIDTH, interpret=True)
    got_levels, got_root = torch_tree
    for got, want in zip(got_levels, levels):
        assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got_root, np.asarray(root))


def test_tree_matches_host_tree(vals, digits, torch_tree):
    host = MerkleTree.from_codeword(vals)
    got_levels, got_root = torch_tree
    assert tdm._digest_bytes(got_root) == host.root
    assert tdm._level_bytes(got_levels[0]) == host.levels[0]
    assert tdm._level_bytes(got_levels[1]) == host.levels[1]


@pytest.fixture(scope="module")
def device_tree(vals):
    return tdm.DeviceMerkleTree(tfo.to_mont(from_numpy(pack(vals), "cpu")))


def test_device_tree_root_and_every_auth_path(vals, device_tree):
    host = MerkleTree.from_codeword(vals)
    # the batched hooks the prover uses: one fetch for root words, then
    # one for every sibling and the tail
    assert tdm.roots_batch([device_tree]) == [host.root]
    device_tree.prefetch(range(N))
    assert device_tree.tail_async() is None
    for i in range(N):
        assert device_tree.open(i) == host.open(i)
    assert device_tree.root == host.root


def test_gathered_siblings_equal_lazy_opens(vals, device_tree):
    """gather_siblings_async + fetch_absorb fill the cache with the same
    bytes a fresh tree's one-by-one opens read."""
    fresh = tdm.DeviceMerkleTree(tfo.to_mont(from_numpy(pack(vals), "cpu")))
    want = {i: fresh.open(i) for i in (0, 5, 1023, 2047)}
    other = tdm.DeviceMerkleTree(tfo.to_mont(from_numpy(pack(vals), "cpu")))
    keys, arr = other.gather_siblings_async(list(want))
    assert arr.shape == (8, len(keys))
    fetch_absorb([(arr, lambda s: other.absorb_siblings(keys, s)), (other.tail_async(), other.absorb_tail)])
    assert other.gather_siblings_async(list(want)) == ([], None)
    for i, path in want.items():
        assert other.open(i) == path


def test_device_tree_at_2e13_matches_the_ports_host_tree():
    n = 1 << 13
    rng = np.random.default_rng(n)
    vals = [(int(a) << 64 | int(b)) % P for a, b in zip(rng.integers(0, 1 << 63, n), rng.integers(0, 1 << 63, n))]
    vals[:3] = [0, 1, P - 1]
    tree = tdm.DeviceMerkleTree(tfo.to_mont(from_numpy(pack(vals), "cpu")))
    host = PortMerkleTree.from_codeword(vals)
    assert tree.root == host.root
    for i in (0, 1, 4097, n - 1):
        assert tree.open(i) == host.open(i)


@pytest.mark.parametrize("log_w", range(1, 13))
def test_top_slabs_of_merkle_top_are_the_level_chain(log_w):
    w = 1 << log_w
    level = torch.from_numpy(np.random.default_rng(w).integers(0, 1 << 32, (8, w), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    flat = cuda_merkle.merkle_top(level)  # the plain version on the CPU
    assert flat.shape == (8 * (w - 1),)
    slabs = tdm.top_slabs(flat, w)
    assert [s.shape[1] for s in slabs] == [w >> k for k in range(1, log_w + 1)]
    for slab in slabs:
        level = tdm.level_hash(level)
        assert slab.is_contiguous() and torch.equal(slab, level)
    assert slabs[-1].data_ptr() == flat[-8:].data_ptr()  # the root is the last slab


@pytest.mark.parametrize("w, depth", [(2, 1), (4, 1), (4, 2), (64, 3), (512, 1), (1024, 2), (2048, 2), (4096, 3),
                                      (8192, 4), (1024, 10)])
def test_merkle_subtrees_slabs_are_the_level_chain(w, depth):
    level = torch.from_numpy(np.random.default_rng(w + depth).integers(0, 1 << 32, (8, w), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    flat = cuda_merkle.merkle_subtrees(level, depth)  # the plain version on the CPU
    assert flat.shape == (8 * (w - (w >> depth)),)
    slabs = tdm.top_slabs(flat, w)
    assert [s.shape[1] for s in slabs] == [w >> k for k in range(1, depth + 1)]
    for slab in slabs:
        level = tdm.level_hash(level)
        assert slab.is_contiguous() and torch.equal(slab, level)


@pytest.mark.parametrize("n", [1 << 13, 1 << 14])
def test_tree_levels_split_at_a_lowered_subtree_width_match_the_ports_host_tree(n, monkeypatch):
    """The level kernel runs only on levels wider than SUBTREE_WIDTH, the
    subtrees kernel once from SUBTREE_WIDTH down to TOP_WIDTH, the top
    kernel once from there; the kept levels and the root are the host
    tree's."""
    monkeypatch.setattr(cuda_merkle, "SUBTREE_WIDTH", 1 << 11)
    calls = []
    for name in ("merkle_level", "merkle_subtrees", "merkle_top"):
        def spy(level, *args, _name=name, _fn=getattr(cuda_merkle, name)):
            calls.append((_name, int(level.shape[1])) + args)
            return _fn(level, *args)
        monkeypatch.setattr(cuda_merkle, name, spy)
    rng = np.random.default_rng(n + 1)
    vals = [(int(a) << 64 | int(b)) % P for a, b in zip(rng.integers(0, 1 << 63, n), rng.integers(0, 1 << 63, n))]
    digits = np.array([[(v >> (32 * j)) & 0xFFFFFFFF for v in vals] for j in range(4)], dtype=np.uint32)
    kept, root = cuda_merkle.tree_levels(from_numpy(digits, "cpu"), tdm.TAIL_WIDTH)
    wide = [("merkle_level", w) for w in (n, n // 2, n // 4) if w > 1 << 11]
    assert calls == wide + [("merkle_subtrees", 1 << 11, 2), ("merkle_top", 512)]
    host = PortMerkleTree.from_codeword(vals)
    assert [lv.shape[1] for lv in kept] == [w for w in (n, n // 2, n // 4, n // 8, n // 16) if w >= tdm.TAIL_WIDTH]
    for lvl, arr in enumerate(kept):
        assert tdm._level_bytes(to_numpy(arr)) == host.levels[lvl]
    assert tdm._digest_bytes(to_numpy(root)) == host.root


@pytest.mark.parametrize("w, depth, error", [
    (6, 1, ValueError),  # not a power of two
    (12, 2, ValueError),
    (8, 4, ValueError),  # 2^depth wider than the level
    (8, 0, ValueError),
    (1 << 14, 14, ValueError),  # a subtree wider than a block takes
    ("int64", 1, TypeError),
    ("rows", 1, ValueError),
    ("strided", 1, ValueError),
])
def test_merkle_subtrees_refuses_bad_inputs(w, depth, error):
    if w == "int64":
        level = torch.zeros((8, 16), dtype=torch.int64)
    elif w == "rows":
        level = torch.zeros((7, 16), dtype=torch.int32)
    elif w == "strided":
        level = torch.zeros((8, 32), dtype=torch.int32)[:, ::2]
    else:
        level = torch.zeros((8, w), dtype=torch.int32)
    with pytest.raises(error):
        cuda_merkle.merkle_subtrees(level, depth)


def test_kernel_wrappers_validate_inputs(digits):
    d = from_numpy(digits, "cpu")
    with pytest.raises(ValueError):
        cuda_merkle.merkle_leaves(d[:3])  # three digit rows
    with pytest.raises(TypeError):
        cuda_merkle.merkle_leaves(d.to(torch.int64))
    leaves = cuda_merkle.merkle_leaves(d)
    with pytest.raises(ValueError):
        cuda_merkle.merkle_level(leaves[:, :5])  # odd width, not contiguous
    for w in (1, 6, 1 << 14):  # the top kernel takes powers of two from 2 to 2^13
        with pytest.raises(ValueError):
            cuda_merkle.merkle_top(torch.zeros((8, w), dtype=torch.int32))
    with pytest.raises(ValueError):
        tdm.DeviceMerkleTree(tfo.to_mont(from_numpy(pack([1] * 1024), "cpu")))  # below 2 * TAIL_WIDTH
