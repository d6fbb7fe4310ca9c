"""The port's timing probes B1-B4 against the JAX package's probe bodies.

* B1: the plain 13-bit lazy-limb product (``cuda_probes.mont_mul13_plain``)
  against ``benches/lazy_limb_experiment.py``'s ``mont_mul13`` and Python
  ints, and its 10-chain at (10, 8, 256) against ``mont_mul13`` chained;
* B2: the 10-chain of ``field_ops.mont_mul`` against
  ``stark_tpu.ops.pallas_fold._k_mont_mul`` chained, t's top limb also
  above p's;
* B3: the plain ``_mont_mul_variant`` in its three modes against
  ``benches/mont_mul_experiments.py``'s, and base = hint16 = the field
  product for canonical and non-canonical t;
* B4: the plain Blake2b cut to 1, 6 and 12 rounds against
  ``stark_tpu.ops.device_merkle.blake2b256_single_block(..., rounds=)``
  on a 256-wide level (12 rounds: the port's ``level_hash``), and the
  XOR stub;
* the wrappers' plain versions on CPU tensors and their refusals, the
  ``benches`` modules' checks on CPU tensors at small shapes, their
  ``run`` refusing to time anything but a card, and ``chip_smoke.py``'s
  probe tables against the kernels' counters and the JAX probes' lines.

The JAX bodies run eagerly (an unrolled compress is slow to compile on
XLA:CPU).  ``benches/`` is not a package, so its two files are loaded by
path; on import they point JAX's persistent compilation cache at a
directory of their own, which the fixture puts back at once.  Inputs come
from numpy seeds.  Tolerance: none (integers are compared exactly).
"""

import importlib
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.ops import device_merkle as jax_dm
from stark_tpu.ops.pallas_fold import _k_mont_mul
from stark_tpu_torch.ops import cuda_probes, kernels
from stark_tpu_torch.ops import field_ops as fo
from stark_tpu_torch.ops.device_merkle import level_hash
from stark_tpu_torch.ops.limbs import from_numpy, to_numpy
from stark_tpu_torch.params import P, P_TOP

# one torch thread a pytest-xdist worker (see tests/test_torch_rescue.py)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHES = ("lazy_limb_experiment", "quick_timing", "mont_mul_experiments", "merkle_roofline")


@pytest.fixture(scope="module")
def probes():
    """The JAX probe files B1 and B3, loaded by path; the compilation-cache
    setting and ``sys.path`` entry they make on import are undone at once."""
    saved_dir = jax.config.jax_compilation_cache_dir
    saved_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    saved_path = list(sys.path)
    mods = {}
    try:
        for name in ("lazy_limb_experiment", "mont_mul_experiments"):
            spec = importlib.util.spec_from_file_location(f"_jax_probe_{name}", os.path.join(REPO, "benches", f"{name}.py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        jax.config.update("jax_compilation_cache_dir", saved_dir)
        if saved_env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = saved_env
        sys.path[:] = saved_path
    return mods


def _jax_chain(product, x: np.ndarray, t: np.ndarray, *args) -> np.ndarray:
    """10 chained ``product(o, t)`` on uint32 arrays, t at column c mod its width."""
    o = jnp.asarray(x)
    tt = jnp.asarray(t[:, :, np.arange(x.shape[2]) % t.shape[2]])
    for _ in range(cuda_probes.N_MULS):
        o = product(o, tt, *args)
    return np.asarray(o)


def _operands16(non_canonical_top: bool):
    """B2/B3's (8, 8, 256) x below p and (8, 8, 128) t, from the probes'
    own seed; t's top limb optionally forced above p's."""
    from stark_tpu_torch.benches import quick_timing

    x, t = quick_timing.inputs("cpu", 11, 8)
    if non_canonical_top:
        t[7, :, ::3] = 0xFFFF
        t[7, :, 1::3] = P_TOP + 1
    return x, t


# -- B1 ---------------------------------------------------------------------------


def test_p_limb9_and_the_13_bit_packing_match_the_jax_probe(probes):
    jax_b1 = probes["lazy_limb_experiment"]
    assert cuda_probes.P_LIMB9 == jax_b1.P_LIMB9 == 1628 and P == 1 + (cuda_probes.P_LIMB9 << (13 * 9))
    vals = [0, 1, P - 1, 12345678901234567890123456789, (1 << 130) - 1]
    assert np.array_equal(cuda_probes.pack13(vals), jax_b1.pack13(vals))
    assert cuda_probes.unpack13(cuda_probes.pack13(vals)) == jax_b1.unpack13(jax_b1.pack13(vals)) == vals


def test_mont_mul13_plain_matches_the_jax_body_and_python_ints(probes):
    jax_b1 = probes["lazy_limb_experiment"]
    rng = np.random.default_rng(5)  # the JAX probe's correctness() inputs
    vals_a = [pow(int(x) % P, 3, P) for x in rng.integers(0, 1 << 63, 64)]
    vals_b = [pow(v + 1, 5, P) for v in vals_a]
    a, b = jax_b1.pack13(vals_a), jax_b1.pack13(vals_b)
    got = to_numpy(cuda_probes.mont_mul13_plain(from_numpy(a, "cpu"), from_numpy(b, "cpu")))
    assert np.array_equal(got, np.asarray(jax_b1.mont_mul13(jnp.asarray(a), jnp.asarray(b))))
    rinv = pow(1 << 130, -1, P)
    assert cuda_probes.unpack13(got) == [x * y * rinv % P for x, y in zip(vals_a, vals_b)]


def test_mont13_chain_plain_matches_the_jax_body_chained(probes):
    from stark_tpu_torch.benches import lazy_limb_experiment

    x, t = lazy_limb_experiment.inputs("cpu", 11, 8)  # (10, 8, 256), t (10, 8, 128)
    want = _jax_chain(probes["lazy_limb_experiment"].mont_mul13, to_numpy(x), to_numpy(t))
    assert np.array_equal(to_numpy(cuda_probes.mont13_chain_plain(x, t)), want)
    assert np.array_equal(to_numpy(cuda_probes.mont13_chain(x, t)), want)


# -- B2 ---------------------------------------------------------------------------


@pytest.mark.parametrize("non_canonical_top", [False, True])
def test_mont_chain_plain_matches_k_mont_mul_chained(non_canonical_top):
    x, t = _operands16(non_canonical_top)
    want = _jax_chain(_k_mont_mul, to_numpy(x), to_numpy(t))
    assert np.array_equal(to_numpy(cuda_probes.mont_chain_plain(x, t)), want)
    assert np.array_equal(to_numpy(cuda_probes.mont_chain(x, t)), want)


# -- B3 ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["base", "hint16", "xor"])
def test_mont16_chain_plain_matches_the_jax_variant_chained(probes, mode):
    x, t = _operands16(True)
    want = _jax_chain(probes["mont_mul_experiments"]._mont_mul_variant, to_numpy(x), to_numpy(t), mode)
    assert np.array_equal(to_numpy(cuda_probes.mont16_chain_plain(x, t, mode)), want)
    assert np.array_equal(to_numpy(cuda_probes.mont16_chain(x, t, mode)), want)


@pytest.mark.parametrize("non_canonical_top", [False, True])
def test_base_and_hint16_equal_the_field_product(non_canonical_top):
    x, t = _operands16(non_canonical_top)
    tt = t[:, :, :128].repeat(1, 1, 2)
    base = cuda_probes.mont_mul_variant_plain(x, tt, "base")
    assert torch.equal(base, cuda_probes.mont_mul_variant_plain(x, tt, "hint16"))
    assert torch.equal(base, fo.mont_mul(x, tt))
    chain = cuda_probes.mont_chain_plain(x, t)
    assert torch.equal(cuda_probes.mont16_chain_plain(x, t, "base"), chain)
    assert torch.equal(cuda_probes.mont16_chain_plain(x, t, "hint16"), chain)


# -- B4 ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def level():
    return np.random.default_rng(4).integers(0, 1 << 32, (8, 256), dtype=np.uint32)


@pytest.mark.parametrize("rounds", [1, 6, 12])
def test_level_rounds_plain_matches_the_jax_compress(level, rounds):
    left, right = level[:, 0::2], level[:, 1::2]
    m = [(jnp.asarray(left[2 * j]), jnp.asarray(left[2 * j + 1])) for j in range(4)]
    m += [(jnp.asarray(right[2 * j]), jnp.asarray(right[2 * j + 1])) for j in range(4)]
    want = np.stack([np.asarray(w) for w in jax_dm.blake2b256_single_block(m + [jax_dm._ZERO] * 8, 64, unroll=True,
                                                                             rounds=rounds)])
    lv = from_numpy(level, "cpu")
    got = cuda_probes.level_rounds_plain(lv, rounds)
    assert np.array_equal(to_numpy(got), want)
    assert torch.equal(cuda_probes.level_rounds(lv, rounds), got)
    assert torch.equal(got, level_hash(lv)) == (rounds == 12)


def test_level_stub_plain_xors_each_parents_children(level):
    lv = from_numpy(level, "cpu")
    want = level[:, 0::2] ^ level[:, 1::2]
    assert np.array_equal(to_numpy(cuda_probes.level_stub_plain(lv)), want)
    assert np.array_equal(to_numpy(cuda_probes.level_stub(lv)), want)


def test_blake2b_default_is_twelve_rounds_and_refuses_others():
    from stark_tpu_torch.ops import device_merkle

    lv = from_numpy(np.random.default_rng(9).integers(0, 1 << 32, (8, 16), dtype=np.uint32), "cpu")
    assert torch.equal(level_hash(lv), level_hash(lv, 12))
    with pytest.raises(ValueError):
        device_merkle.blake2b256_single_block([lv[0].to(torch.int64)] + [0] * 15, 64, rounds=13)


# -- wrappers ---------------------------------------------------------------------


def test_probe_wrappers_run_their_plain_versions_on_cpu_tensors():
    x, t = _operands16(False)
    lv = from_numpy(np.random.default_rng(5).integers(0, 1 << 32, (8, 64), dtype=np.uint32), "cpu")
    before = dict(kernels.LAUNCHES)
    assert torch.equal(cuda_probes.mont_chain(x, t), cuda_probes.mont_chain_plain(x, t))
    assert torch.equal(cuda_probes.mont16_chain(x, t, "xor"), cuda_probes.mont16_chain_plain(x, t, "xor"))
    assert torch.equal(cuda_probes.level_rounds(lv, 1), cuda_probes.level_rounds_plain(lv, 1))
    assert kernels.LAUNCHES == before
    assert set(kernels.PROBES) <= set(kernels.LAUNCHES)


def _bad_chain_operands(limbs: int, case: str):
    """(x, t) for a chain of ``limbs`` limbs, wrong in one way."""
    x = torch.zeros((limbs, 8, 256), dtype=torch.int32)
    t = torch.zeros((limbs, 8, 128), dtype=torch.int32)
    return {
        "dtype": (x.to(torch.int64), t),
        "limbs": (x[:-1].contiguous(), t[:-1].contiguous()),
        "rows": (x, t[:, :4].contiguous()),
        "t columns": (x, t[:, :, :100].contiguous()),
        "contiguity": (x.transpose(1, 2), t),
        "2-d": (x.reshape(limbs, -1), t),
    }[case]


@pytest.mark.parametrize("case", ["dtype", "limbs", "rows", "t columns", "contiguity", "2-d"])
def test_chain_wrappers_refuse_bad_operands(case):
    calls = {10: [cuda_probes.mont13_chain],
             8: [cuda_probes.mont_chain, lambda x, t: cuda_probes.mont16_chain(x, t, "base")]}
    for limbs, wrappers in calls.items():
        x, t = _bad_chain_operands(limbs, case)
        for wrapper in wrappers:
            with pytest.raises((TypeError, ValueError)):
                wrapper(x, t)


def test_probe_wrappers_refuse_bad_modes_rounds_and_levels():
    x, t = _operands16(False)
    lv = torch.zeros((8, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_probes.mont16_chain(x, t, "hint8")
    with pytest.raises(ValueError):
        cuda_probes.level_rounds(lv, 5)
    for bad in (torch.zeros((8, 63), dtype=torch.int32), torch.zeros((7, 64), dtype=torch.int32),
                torch.zeros((8, 64), dtype=torch.int64)):
        with pytest.raises((TypeError, ValueError)):
            cuda_probes.level_stub(bad)
        with pytest.raises((TypeError, ValueError)):
            cuda_probes.level_rounds(bad, 12)


# -- the benches modules ----------------------------------------------------------


@pytest.mark.parametrize("name", BENCHES)
def test_bench_imports_without_cuda_and_run_times_only_a_card(name):
    mod = importlib.import_module(f"stark_tpu_torch.benches.{name}")
    for device in ("cuda", "cpu"):
        if device == "cuda" and torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError):
            mod.run(device)


@pytest.mark.parametrize("name, args", [
    ("lazy_limb_experiment", (11, 8)), ("quick_timing", (11, 8, (13,))), ("mont_mul_experiments", (11, 8)),
    ("merkle_roofline", (9,))])
def test_bench_check_passes_on_cpu_tensors_at_a_small_shape(name, args):
    checked = importlib.import_module(f"stark_tpu_torch.benches.{name}").check("cpu", *args)
    errs = checked["max_abs_err"]
    assert not (any(errs.values()) if isinstance(errs, dict) else errs)


def test_chip_smoke_probe_tables_name_every_probe_kernel_and_its_tpu_call():
    import chip_smoke

    tables = chip_smoke.probe_tables(cuda_probes)
    assert tuple(tables) == kernels.PROBES
    assert set(chip_smoke.PROBE_FIELD_PRODUCT) <= set(tables)
    for where in {rep for _, rep in tables.values()}:
        path, line = where.split(":")
        with open(os.path.join(REPO, path)) as f:
            assert "pl.pallas_call(" in f.read().splitlines()[int(line) - 1], where
