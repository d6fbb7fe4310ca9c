"""B1: 10 chained Montgomery products on 13-bit lazy limbs, on the card.

Counterpart of the JAX package's TPU probe benches/lazy_limb_experiment.py.
The production product splits every 32-bit partial product of its 16-bit
limbs at once; with 10 limbs of 13 bits (R' = 2^130) a partial is below
2^26, so the column sums of all 10 CIOS steps accumulate unsplit and one
carry sweep ends the product.  In base 2^13, p = 1 + 1628 * 2^(13 * 9) has
two nonzero limbs, so the m * p step is one product a step.  The probe
computes a * t * 2^-130 mod p, not the production a * t * 2^-128: it
measures a limb layout, and is checked against Python ints.

    python -m stark_tpu_torch.benches.lazy_limb_experiment

The kernel is ``stark_probe_mont13_chain`` (``csrc/probes.cu``) over the
probe's (10, 1024, 1024) array, each element times t's column c mod 128.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import cuda_probes
from ..ops.cuda_probes import L13, N_MULS, W13, pack13, unpack13
from ..ops.limbs import from_numpy, to_numpy
from ..ops.timing import call_ms, device_ms
from ..params import P
from . import card, card_line, max_abs_err, synchronize

LOGN = 20
ROWS = 1024
BLOCK = 128  # t's columns: one Pallas block, reused for every block of x
SEED = 1
CORRECTNESS_SEED = 5
CORRECTNESS_PAIRS = 64
#: elements of row 0 whose chains are also checked against Python ints
INT_CHECKED = 64


def correctness(device) -> int:
    """The plain product on the probe's 64 pairs against Python ints
    a * b * 2^-130 mod p; returns the pairs that agree (all, or raises)."""
    rng = np.random.default_rng(CORRECTNESS_SEED)
    vals_a = [int(x) % P for x in rng.integers(0, 1 << 63, CORRECTNESS_PAIRS)]
    vals_a = [pow(v, 3, P) for v in vals_a]  # spread over the field
    vals_b = [pow(v + 1, 5, P) for v in vals_a]
    got = cuda_probes.mont_mul13_plain(from_numpy(pack13(vals_a), device), from_numpy(pack13(vals_b), device))
    rinv = pow(1 << (W13 * L13), -1, P)
    if unpack13(to_numpy(got)) != [x * y * rinv % P for x, y in zip(vals_a, vals_b)]:
        raise AssertionError("mont_mul13 arithmetic mismatch")
    return CORRECTNESS_PAIRS


def inputs(device, logn: int = LOGN, rows: int = ROWS):
    """The probe's x (10, rows, 2^logn / rows), below p, and t (10, rows,
    128), its limbs over their full 13 bits."""
    cols = (1 << logn) // rows
    rng = np.random.default_rng(SEED)
    limbs = rng.integers(0, 1 << W13, (L13, rows, cols), dtype=np.uint32)
    limbs[9] = rng.integers(0, P >> (W13 * 9), (rows, cols), dtype=np.uint32)
    t = rng.integers(0, 1 << W13, (L13, rows, BLOCK), dtype=np.uint32)
    return from_numpy(limbs, device), from_numpy(t, device)


def check(device, logn: int = LOGN, rows: int = ROWS) -> dict:
    """The chain (the kernel on a CUDA device) against its plain version,
    and its first elements against Python ints."""
    dev = torch.device(device)
    pairs = correctness(dev)
    x, t = inputs(dev, logn, rows)
    t0 = time.perf_counter()
    got = cuda_probes.mont13_chain(x, t)
    synchronize(dev)
    first_call_s = time.perf_counter() - t0
    err = max_abs_err(got, cuda_probes.mont13_chain_plain(x, t))
    if err:
        raise AssertionError(f"mont13_chain disagrees with its plain version: max abs err {err}")
    k = min(INT_CHECKED, x.shape[2])
    rinv = pow(1 << (W13 * L13), -N_MULS, P)
    xs = unpack13(to_numpy(x[:, 0, :k]))
    ts = unpack13(to_numpy(t[:, 0, [c % t.shape[2] for c in range(k)]]))
    if unpack13(to_numpy(got[:, 0, :k])) != [a * pow(b, N_MULS, P) * rinv % P for a, b in zip(xs, ts)]:
        raise AssertionError("mont13_chain disagrees with Python ints")
    return {"x": x, "t": t, "pairs_exact": pairs, "int_checked": k, "max_abs_err": err, "first_call_s": first_call_s}


def run(device="cuda") -> dict:
    """Check at the probe's full shape, then time the kernel and its plain
    version on the card."""
    dev = card(device)
    checked = check(dev)
    x, t = checked.pop("x"), checked.pop("t")
    n = x.shape[1] * x.shape[2]
    ms = device_ms(lambda: cuda_probes.mont13_chain(x, t))
    return {"n": n, "muls": N_MULS, "kernel_ms": ms, "plain_ms": call_ms(lambda: cuda_probes.mont13_chain_plain(x, t)),
            "ms_per_mul": ms / N_MULS, "mmul_per_s": n * N_MULS / ms / 1e3, "device": torch.cuda.get_device_name(dev),
            **checked}


def main() -> int:
    print(card_line(), flush=True)
    r = run()
    print(f"mont_mul13 correctness: {r['pairs_exact']}/{CORRECTNESS_PAIRS} exact (a*b*2^-130 mod p)")
    print("devices:", [r["device"]])
    print(f"lazy13   {r['ms_per_mul']:.6f} ms/full-array mul at 2^{LOGN} "
          f"({r['mmul_per_s']:6.0f} M mul/s, first call {r['first_call_s']:.1f}s)")
    print("compare against `python -m stark_tpu_torch.benches.mont_mul_experiments` "
          "base mode (8x16-bit production multiply, same harness shape)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
