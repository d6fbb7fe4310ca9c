"""The CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA device: the ``cuda`` fixture skips without
one (decided at run time, so every pytest-xdist worker collects the same
tests).  Run them on a machine with a card, where JAX (which
tests/conftest.py imports) need not be installed:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py

Tolerance: none (kernels and plain versions must agree bit for bit).
"""

import numpy as np
import pytest
import torch

from stark_tpu.field import FieldElement
from stark_tpu.models.fibonacci import FibonacciStark as HostFibonacciStark
from stark_tpu.ops.limbs import pack
from stark_tpu.params import GENERATOR, P, R_MOD_P
from stark_tpu.rng import DeterministicRandom

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mont(n: int, seed: int, device):
    from stark_tpu_torch.ops.limbs import from_numpy

    rng = np.random.default_rng(seed)
    vals = [(int(v) << 64 | int(w)) % P for v, w in zip(rng.integers(0, 1 << 63, n), rng.integers(0, 1 << 63, n))]
    vals[:3] = [0, 1, P - 1]
    return from_numpy(pack([v * R_MOD_P % P for v in vals]), device)


@pytest.mark.parametrize("logn", [13, 14, 17])
@pytest.mark.parametrize("inverse, offset", [(False, 1), (True, 1), (False, GENERATOR), (True, GENERATOR)])
def test_ntt_passes_match_plain(cuda, logn, inverse, offset):
    from stark_tpu_torch.ops import cuda_ntt, kernels

    plan = cuda_ntt.get_cuda_plan(1 << logn, cuda)
    w, tw_r, tw_c, row, col = plan.op_tables(inverse, offset)
    pro = not inverse and row is not None
    x = _mont(1 << logn, logn, cuda).reshape(8, plan.R, plan.C)
    before = dict(kernels.LAUNCHES)
    y = cuda_ntt.ntt_pass1(x, tw_r, w, row if pro else None, col if pro else None)
    assert torch.equal(y, cuda_ntt.ntt_pass1_plain(x, tw_r, w, row if pro else None, col if pro else None))
    z = cuda_ntt.ntt_pass2(y, tw_c, row if inverse else None, col if inverse else None)
    assert torch.equal(z, cuda_ntt.ntt_pass2_plain(y, tw_c, row if inverse else None, col if inverse else None))
    assert kernels.LAUNCHES["ntt_pass1"] == before["ntt_pass1"] + 1
    assert kernels.LAUNCHES["ntt_pass2"] == before["ntt_pass2"] + 1


def test_ntt_kernels_refuse_small_transforms(cuda):
    from stark_tpu_torch.ops import cuda_ntt

    x = torch.zeros((8, 32, 64), dtype=torch.int32, device=cuda)
    tw = torch.zeros((8, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_pass1(x, tw, x)


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


def test_fibonacci_proof_on_the_card_equals_host(cuda):
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.ops import kernels

    a, b = FieldElement(3), FieldElement(7)
    _, host_proof = HostFibonacciStark(1000, rng=DeterministicRandom(11)).prove(a, b)
    kernels.reset_launch_counts()
    result, proof = FibonacciStark(1000, device=cuda, rng=DeterministicRandom(11)).prove(a, b)
    assert proof == host_proof
    assert all(v > 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    assert HostFibonacciStark(1000).verify(a, b, result, proof)
