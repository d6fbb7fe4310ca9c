"""The torch port's NTTs against the JAX package and the host NTT.

* the plain stage-by-stage plan (``stark_tpu_torch.ops.ntt``) and the
  four-step plan whose passes are the plain versions of the CUDA kernels
  K2/K3 (``stark_tpu_torch.ops.cuda_ntt``, run on the CPU), at 2^13,
  against ``stark_tpu.ops.ntt.get_plan`` and ``stark_tpu.ntt.NTT``;
* the pass functions against the Pallas passes themselves
  (``PallasNTT._pass1`` / ``_pass2``) in interpret mode at 2^12, with the
  Pallas plan's own tables;
* the four-step table builders against the Pallas plan's at 2^13.

Tolerance: none (exact integer arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.ntt import NTT
from stark_tpu.ops import field_ops as jfo
from stark_tpu.ops.limbs import pack, unpack
from stark_tpu.ops.ntt import get_plan as jax_get_plan
from stark_tpu.params import GENERATOR, P, R_MOD_P
from stark_tpu_torch.ops import cuda_ntt
from stark_tpu_torch.ops import field_ops as tfo
from stark_tpu_torch.ops.limbs import _bit_reverse_indices, from_numpy, seeded_mont, to_numpy
from stark_tpu_torch.ops.ntt import get_plan

# The suite runs several pytest-xdist workers side by side; more than one
# torch thread per worker oversubscribes the cores, and the threads'
# OpenMP spin-waits then slow the plain versions tens of times.
torch.set_num_threads(1)

N = 1 << 13
TRANSFORMS = ["forward", "inverse", "coset_forward", "coset_inverse"]


def _values(n: int, seed: int):
    rng = np.random.default_rng(seed)
    vals = [(int(v) << 64 | int(w)) % P for v, w in zip(rng.integers(0, 1 << 63, n), rng.integers(0, 1 << 63, n))]
    vals[:3] = [0, 1, P - 1]
    return vals


@pytest.fixture(scope="module")
def data():
    vals = _values(N, 13)
    mont = pack([v * R_MOD_P % P for v in vals])
    host = NTT(N)
    want = {
        "forward": host.forward(vals),
        "inverse": host.inverse(vals),
        "coset_forward": host.coset_evaluate(vals, GENERATOR),
        "coset_inverse": host.coset_interpolate(vals, GENERATOR),
    }
    return mont, want


def _run(plan, name, a):
    if name.startswith("coset"):
        return getattr(plan, name)(a, GENERATOR)
    return getattr(plan, name)(a)


def _torch_out(plan, name, mont):
    return to_numpy(tfo.from_mont(_run(plan, name, from_numpy(mont, "cpu"))))


#: the transforms the prover runs (RS extension, restriction) are also held
#: against the JAX plan; every transform is held against the host NTT
JAX_CHECKED = ("coset_forward", "coset_inverse")


@pytest.fixture(scope="module")
def jax_out(data):
    mont = jnp.asarray(data[0])
    return {name: np.asarray(jax.device_get(jfo.from_mont(_run(jax_get_plan(N), name, mont)))) for name in JAX_CHECKED}


@pytest.mark.parametrize("plan_kind", ["plain", "four_step"])
@pytest.mark.parametrize("name", TRANSFORMS)
def test_plans_match_jax_and_host(data, jax_out, plan_kind, name):
    mont, want = data
    if plan_kind == "plain":
        plan = get_plan(N, "cpu")
    else:
        plan = cuda_ntt.get_cuda_plan(N, "cpu")
        assert (plan.R, plan.C) == (64, 128)
    got = _torch_out(plan, name, mont)
    assert unpack(got) == want[name]
    if name in jax_out:
        assert np.array_equal(got, jax_out[name])


def test_four_step_tables_match_pallas_plan():
    from stark_tpu.ops.pallas_ntt import PallasNTT, _pack_stage_twiddles

    ref = PallasNTT(N)
    plan = cuda_ntt.get_cuda_plan(N, "cpu")
    for inv in (False, True):
        assert np.array_equal(to_numpy(plan._W[inv]), np.asarray(ref._W[inv]))
        assert np.array_equal(to_numpy(plan._tw_R[inv]), _pack_stage_twiddles(ref.R, inv))
        assert np.array_equal(to_numpy(plan._tw_C[inv]), _pack_stage_twiddles(ref.C, inv))
        for got, want in zip(plan._row_col_tables(GENERATOR, inv), ref._row_col_tables(GENERATOR, inv)):
            assert np.array_equal(to_numpy(got), np.asarray(want))


@pytest.fixture()
def _interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    import stark_tpu.ops.pallas_ntt as pntt

    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pntt.pl, "pallas_call", patched)
    return pntt


def test_pass_functions_match_pallas_passes(_interpret_pallas):
    """K2/K3's plain versions against the Pallas passes (interpret mode,
    2^12, lane_block=64 as tests/test_pallas_kernels.py runs them): pass 1
    with the forward coset prologue, pass 2 with the inverse epilogue
    (1/n and the coset undo), each with the Pallas plan's own tables."""
    pntt = _interpret_pallas
    n = 1 << 12
    ref = pntt.PallasNTT(n, lane_block=64)
    R, C = ref.R, ref.C
    x = pack([v * R_MOD_P % P for v in _values(n, 12)]).reshape(8, R, C)
    row, col = ref._row_col_tables(GENERATOR, False)
    erow, ecol = ref._row_col_tables(GENERATOR, True)
    W = np.asarray(ref._W[False])
    t = lambda a: from_numpy(np.asarray(a), "cpu")  # noqa: E731
    # the Pallas pass 1 takes bit-reversed rows; the port's takes natural ones
    x_br = jnp.asarray(x)[:, ref._bitrev_R, :]
    y_ref = ref._pass1(x_br, ref._tw_R[False], ref._tiled_R[False], jnp.asarray(W), row, col, True)
    y = cuda_ntt.ntt_pass1(t(x), t(ref._tw_R[False]), t(W), t(row), t(col))
    assert np.array_equal(to_numpy(y), np.asarray(y_ref))
    # the Pallas pass 2 takes the transposed, bit-reversed pass-1 output
    y2 = jnp.transpose(y_ref, (0, 2, 1))[:, ref._bitrev_C, :]
    out_ref = ref._pass2(y2, ref._tw_C[True], ref._tiled_C[True], erow, ecol, True)
    out = cuda_ntt.ntt_pass2(y, t(ref._tw_C[True]), t(erow), t(ecol))
    assert np.array_equal(to_numpy(out), np.asarray(out_ref))


def test_pass_wrappers_validate_inputs():
    plan = cuda_ntt.get_cuda_plan(N, "cpu")
    W, tw_r, tw_c, row, col = plan.op_tables(False, GENERATOR)
    x = from_numpy(np.zeros((8, plan.R, plan.C), np.uint32), "cpu")
    with pytest.raises(TypeError):
        cuda_ntt.ntt_pass1(x.to(torch.int64), tw_r, W)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_pass1(x, tw_c, W)  # stage twiddles of the wrong length
    with pytest.raises(ValueError):
        cuda_ntt.ntt_pass1(x, tw_r, W, row, None)  # row without col
    with pytest.raises(ValueError):
        cuda_ntt.ntt_pass2(x.transpose(1, 2), tw_c)  # not contiguous
    with pytest.raises(ValueError):
        cuda_ntt.CudaNTT(1 << 5, "cpu")  # below the kernels' minimum (R = C = 8)


@pytest.mark.parametrize("logn", range(13, 24))
@pytest.mark.parametrize("which", ["pass1", "pass2"])
def test_launch_shape_fills_the_card(logn, which):
    """Every pass of every size from 2^13 to 2^23 (R = 2^floor(logn / 2),
    as in ``CudaNTT``): one block per transform, in whole warps within the
    kernel's bound and the card's 232,448 bytes of shared memory a block,
    at least 256 blocks from 2^17 up, never fewer than the first design's
    rule (tile = min(32, 8192 / L, batch)), and whole clusters of 8 blocks
    that each hold a share of the rows."""
    log_r = logn // 2
    log_l, log_b = (log_r, logn - log_r) if which == "pass1" else (logn - log_r, log_r)
    L, batch = 1 << log_l, 1 << log_b
    threads, smem, cluster, rows = cuda_ntt.launch_shape(log_l, log_b)
    blocks = batch
    assert threads % 32 == 0 and 32 <= threads <= min(1024, cuda_ntt._MAX_THREADS)
    assert smem in (L * 16, 2 * L * 16) and smem <= 232_448
    if logn >= 17:
        assert blocks >= 256
    assert blocks >= batch // min(32, 8192 // L, batch)
    assert cluster == cuda_ntt.CLUSTER_BLOCKS and rows * cluster == L
    assert blocks % cuda_ntt.CLUSTER_BLOCKS == 0 and L % cuda_ntt.CLUSTER_BLOCKS == 0


def test_seeded_mont_is_canonical_montgomery():
    vals = unpack(seeded_mont(4096, 7))
    assert vals[:3] == [0, R_MOD_P, P - R_MOD_P]
    assert all(0 <= v < P for v in vals) and len(set(vals)) == 4096


def test_bit_reverse_indices_copy_matches_jax_package():
    from stark_tpu.ops.ntt import _bit_reverse_indices as jax_bitrev

    for n in (2, 64, 1024):
        assert np.array_equal(_bit_reverse_indices(n), jax_bitrev(n))
