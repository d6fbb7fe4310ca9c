"""The torch port's device Merkle tree against the JAX package and the host.

At 2048 leaves (values from a numpy seed, with the digit-count edge
cases 0, 1, p - 1, 2^32 - 1, 2^32 and 2^96 + 5):

* the plain versions of the CUDA leaf/level kernels (K4/K5), as
  ``cuda_merkle.tree_levels`` runs them on the CPU, against
  ``stark_tpu.ops.device_merkle.tree_arrays_with_root`` (XLA) and
  ``stark_tpu.ops.pallas_merkle.tree_levels(..., interpret=True)``;
* ``DeviceMerkleTree`` against the host ``MerkleTree``: root and every
  auth path.

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
from stark_tpu_torch.ops import cuda_merkle
from stark_tpu_torch.ops import device_merkle as tdm
from stark_tpu_torch.ops import field_ops as tfo
from stark_tpu_torch.ops.device_prover import fetch_absorb
from stark_tpu_torch.ops.limbs import from_numpy, to_numpy

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


def test_kernel_wrappers_validate_inputs(digits):
    d = from_numpy(digits, "cpu")
    with pytest.raises(ValueError):
        cuda_merkle.merkle_leaves(d[:3])  # three digit rows
    with pytest.raises(TypeError):
        cuda_merkle.merkle_leaves(d.to(torch.int64))
    leaves = cuda_merkle.merkle_leaves(d)
    with pytest.raises(ValueError):
        cuda_merkle.merkle_level(leaves[:, :5])  # odd width, not contiguous
    with pytest.raises(ValueError):
        tdm.DeviceMerkleTree(tfo.to_mont(from_numpy(pack([1] * 1024), "cpu")))  # below 2 * TAIL_WIDTH
