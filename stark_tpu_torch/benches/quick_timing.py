"""B2: the chained production Montgomery product and the NTT, on the card.

Counterpart of the JAX package's TPU probe benches/quick_pallas_timing.py:
``mont_mul_microbench`` times a kernel that is only 10 chained full-array
production products at 2^20, to separate the product's cost from the
NTT's butterflies; ``main`` then times the forward, coset and inverse
transforms at 2^20 and 2^22.  On the card the product is ``fe_mul``
(``csrc/field.cuh``: four 32-bit words, 64-bit partial products), in the
kernel ``stark_probe_mont_chain`` (``csrc/probes.cu``); the transforms are
the four-step plan's two passes (``ops/cuda_ntt.CudaNTT``, K2 and K3), each
size checked against the plain stage-by-stage plan (``ops/ntt.NTTPlan``)
before it is timed.

    python -m stark_tpu_torch.benches.quick_timing
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import cuda_probes
from ..ops.cuda_ntt import CudaNTT
from ..ops.cuda_probes import N_MULS
from ..ops.limbs import from_numpy, to_numpy, unpack
from ..ops.ntt import NTTPlan
from ..ops.timing import call_ms, device_ms
from ..params import GENERATOR, LIMB_BITS, NUM_LIMBS, P, R
from . import card, card_line, max_abs_err, synchronize

LOGN = 20
ROWS = 1024
BLOCK = 128  # t's columns: one Pallas block, reused for every block of x
SEED = 1
NTT_LOGNS = (20, 22)
NTT_SEED = 0
#: elements of row 0 whose chains are also checked against Python ints
INT_CHECKED = 64


def inputs(device, logn: int = LOGN, rows: int = ROWS):
    """The probe's x (8, rows, 2^logn / rows), below p, and t (8, rows,
    128), its limbs over their full 16 bits (so t may be >= p)."""
    cols = (1 << logn) // rows
    rng = np.random.default_rng(SEED)
    limbs = rng.integers(0, 1 << LIMB_BITS, (NUM_LIMBS, rows, cols), dtype=np.uint32)
    limbs[NUM_LIMBS - 1] = rng.integers(0, P >> (LIMB_BITS * (NUM_LIMBS - 1)), (rows, cols), dtype=np.uint32)
    t = rng.integers(0, 1 << LIMB_BITS, (NUM_LIMBS, rows, BLOCK), dtype=np.uint32)
    return from_numpy(limbs, device), from_numpy(t, device)


def ntt_input(device, logn: int):
    """(8, 2^logn) canonical residues, the top limb below p's."""
    rng = np.random.default_rng(NTT_SEED)
    limbs = rng.integers(0, 1 << LIMB_BITS, (NUM_LIMBS, 1 << logn), dtype=np.uint32)
    limbs[NUM_LIMBS - 1] = rng.integers(0, P >> (LIMB_BITS * (NUM_LIMBS - 1)), 1 << logn, dtype=np.uint32)
    return from_numpy(limbs, device)


def transforms(plan, a: torch.Tensor) -> dict:
    """name -> the call of one transform of ``a`` by ``plan``."""
    return {"forward": lambda: plan.forward(a), "coset": lambda: plan.coset_forward(a, GENERATOR),
            "inverse": lambda: plan.inverse(a)}


def chain_against_ints(x: torch.Tensor, t: torch.Tensor, got: torch.Tensor, k: int) -> None:
    """got = x * t^10 * 2^(-128 * 10) mod p at row 0's first k elements."""
    rinv = pow(R, -N_MULS, P)
    xs = unpack(to_numpy(x[:, 0, :k]))
    ts = unpack(to_numpy(t[:, 0, [c % t.shape[2] for c in range(k)]]))
    if unpack(to_numpy(got[:, 0, :k])) != [a * pow(b, N_MULS, P) * rinv % P for a, b in zip(xs, ts)]:
        raise AssertionError("the product chain disagrees with Python ints")


def check(device, logn: int = LOGN, rows: int = ROWS, ntt_logns=NTT_LOGNS) -> dict:
    """The chain (the kernel on a CUDA device) against its plain version
    and Python ints; each transform of the four-step plan against the
    plain plan at each of ``ntt_logns``.  Returns the operands and plans
    the timings need."""
    dev = torch.device(device)
    x, t = inputs(dev, logn, rows)
    t0 = time.perf_counter()
    got = cuda_probes.mont_chain(x, t)
    synchronize(dev)
    first_call_s = time.perf_counter() - t0
    err = max_abs_err(got, cuda_probes.mont_chain_plain(x, t))
    if err:
        raise AssertionError(f"mont_chain disagrees with its plain version: max abs err {err}")
    k = min(INT_CHECKED, x.shape[2])
    chain_against_ints(x, t, got, k)
    ntt = {}
    for n_log in ntt_logns:
        a = ntt_input(dev, n_log)
        # built apart from the plans' caches, so the checks leave nothing behind
        plan, plain = CudaNTT(1 << n_log, dev), NTTPlan(1 << n_log, dev)
        plain_calls = transforms(plain, a)
        for name, call in transforms(plan, a).items():
            if not torch.equal(call(), plain_calls[name]()):
                raise AssertionError(f"the 2^{n_log} {name} transform disagrees with the plain plan")
        del plain, plain_calls
        ntt[n_log] = (plan, a)
    return {"x": x, "t": t, "ntt": ntt, "int_checked": k, "max_abs_err": err, "first_call_s": first_call_s}


def run(device="cuda") -> dict:
    """Check at the probe's full shape (the transforms at 2^20 and 2^22),
    then time the chain, its plain version and each transform."""
    dev = card(device)
    checked = check(dev)
    x, t, ntt = checked.pop("x"), checked.pop("t"), checked.pop("ntt")
    n = x.shape[1] * x.shape[2]
    ms = device_ms(lambda: cuda_probes.mont_chain(x, t))
    out = {"n": n, "muls": N_MULS, "kernel_ms": ms, "plain_ms": call_ms(lambda: cuda_probes.mont_chain_plain(x, t)),
           "ms_per_mul": ms / N_MULS, "mmul_per_s": n * N_MULS / ms / 1e3, "device": torch.cuda.get_device_name(dev),
           "ntt_ms": {}, "ntt_parity": {f"2^{k}": True for k in ntt}, **checked}
    for n_log, (plan, a) in ntt.items():
        out["ntt_ms"][f"2^{n_log}"] = {name: device_ms(call) for name, call in transforms(plan, a).items()}
    return out


def main() -> int:
    print(card_line(), flush=True)
    r = run()
    print("devices:", [r["device"]])
    print(f"mont_mul microbench 2^{LOGN}: {N_MULS} muls in {r['kernel_ms']:.6f} ms "
          f"-> {r['ms_per_mul']:.6f} ms/full-array mul ({r['mmul_per_s']:.0f} M mul/s)")
    for size, times in r["ntt_ms"].items():
        n = 1 << int(size[2:])
        for name, ms in times.items():
            print(f"{size} {name:8s} {ms:8.4f} ms  {n / ms / 1e3:9.1f} M coeffs/s")
        print(f"{size} parity vs the plain plan (canonical inputs): {r['ntt_parity'][size]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
