"""B3: what the TPU's Montgomery product costs on the card, in three modes.

Counterpart of the JAX package's TPU probe benches/mont_mul_experiments.py,
which isolates the cost of its 16-bit-limb product.  Each mode is a kernel
of 10 chained "products" over the same (8, 1024, 1024) array as B2
(:mod:`.quick_timing`), t's column c mod 128 for element c:

* ``base``: the TPU's production CIOS on 8 limbs of 16 bits, as written
  there (32-bit partial products, each split at once);
* ``hint16``: the same, every operand masked with ``& 0xFFFF`` first (no
  change to the values: the TPU compiler's hint that a 16 x 16 multiply
  would do);
* ``xor``: every product an XOR, the floor of the non-multiply work (adds,
  masks, shifts, carries); ``base`` less ``xor`` is what the multiplies
  cost.

The kernel is ``stark_probe_mont16_chain<Mode>`` (``csrc/probes.cu``).
``base`` and ``hint16`` agree bit for bit with B2's chain of the card's
``fe_mul``; ``xor`` has no field meaning but a fixed output.

    python -m stark_tpu_torch.benches.mont_mul_experiments
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import cuda_probes
from ..ops import field_ops as fo
from ..ops.cuda_probes import MODES, N_MULS
from ..ops.limbs import from_numpy
from ..ops.timing import call_ms, device_ms
from ..params import LIMB_BITS, NUM_LIMBS, P
from . import card, card_line, max_abs_err, synchronize
from .quick_timing import INT_CHECKED, LOGN, ROWS, chain_against_ints, inputs

HINT_SEED = 3


def single_products(device) -> bool:
    """``base`` and ``hint16`` of one product on the probe's own (8, 8,
    128) canonical operands, against each other and ``field_ops.mont_mul``."""
    rng = np.random.default_rng(HINT_SEED)
    top = P >> (LIMB_BITS * (NUM_LIMBS - 1))
    limbs = rng.integers(0, 1 << LIMB_BITS, (NUM_LIMBS, 8, 128), dtype=np.uint32)
    limbs[NUM_LIMBS - 1] = rng.integers(0, top, (8, 128), dtype=np.uint32)
    t16 = rng.integers(0, 1 << LIMB_BITS, (NUM_LIMBS, 8, 128), dtype=np.uint32)
    t16[NUM_LIMBS - 1] = rng.integers(0, top, (8, 128), dtype=np.uint32)
    a, b = from_numpy(limbs, device), from_numpy(t16, device)
    base = cuda_probes.mont_mul_variant_plain(a, b, "base")
    return bool(torch.equal(base, cuda_probes.mont_mul_variant_plain(a, b, "hint16"))
                and torch.equal(base, fo.mont_mul(a, b)))


def check(device, logn: int = LOGN, rows: int = ROWS) -> dict:
    """Each mode's chain (the kernel on a CUDA device) against its plain
    version; ``base`` and ``hint16`` also against B2's chain of the
    field product and Python ints."""
    dev = torch.device(device)
    if not single_products(dev):
        raise AssertionError("hint16 != base for one product")
    x, t = inputs(dev, logn, rows)
    field = cuda_probes.mont_chain_plain(x, t)
    errs, first_call_s = {}, {}
    for mode in MODES:
        t0 = time.perf_counter()
        got = cuda_probes.mont16_chain(x, t, mode)
        synchronize(dev)
        first_call_s[mode] = time.perf_counter() - t0
        errs[mode] = max_abs_err(got, cuda_probes.mont16_chain_plain(x, t, mode))
        if mode != "xor":
            errs[f"{mode}_vs_field"] = max_abs_err(got, field)
    if any(errs.values()):
        raise AssertionError(f"mont16_chain disagrees with its plain version or the field product: {errs}")
    k = min(INT_CHECKED, x.shape[2])
    chain_against_ints(x, t, field, k)
    return {"x": x, "t": t, "max_abs_err": errs, "hint16_equals_base": True, "int_checked": k,
            "first_call_s": first_call_s}


def run(device="cuda") -> dict:
    """Check at the probe's full shape, then time each mode and its plain
    version on the card."""
    dev = card(device)
    checked = check(dev)
    x, t = checked.pop("x"), checked.pop("t")
    n = x.shape[1] * x.shape[2]
    out = {"n": n, "muls": N_MULS, "device": torch.cuda.get_device_name(dev), "modes": {}, **checked}
    for mode in MODES:
        ms = device_ms(lambda: cuda_probes.mont16_chain(x, t, mode))
        out["modes"][mode] = {"kernel_ms": ms, "plain_ms": call_ms(lambda: cuda_probes.mont16_chain_plain(x, t, mode)),
                              "ms_per_mul": ms / N_MULS, "mmul_per_s": n * N_MULS / ms / 1e3}
    return out


def main() -> int:
    print(card_line(), flush=True)
    r = run()
    print("devices:", [r["device"]])
    for mode, m in r["modes"].items():
        print(f"{mode:8s} {m['ms_per_mul']:.6f} ms/full-array mul at 2^{LOGN} "
              f"({m['mmul_per_s']:6.0f} M mul/s, first call {r['first_call_s'][mode]:.1f}s)")
    print("hint16 == base:", r["hint16_equals_base"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
