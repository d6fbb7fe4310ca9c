"""B4: the Merkle roofline on the card.

Counterpart of the JAX package's TPU probe benches/merkle_roofline.py,
which splits the cost of a Blake2b-256 Merkle tree at 2^20 leaves:

1. the full tree (``ops/cuda_merkle.tree_levels``, the production path);
2. the leaf kernel and one full-width level kernel alone;
3. an XOR stub with the level kernel's grid and I/O and a nearly free
   body (``stark_probe_level_stub``): the launch and memory floor;
4. the level kernel with its compress cut to 1 and 6 rounds
   (``stark_probe_level_rounds``, the level kernel's own template), and
   at 12 rounds, the only valid hash, the level kernel itself: (12 rounds
   - 1 round) / 11 is the marginal cost of a round, and stub + 12 x that
   marginal cost is the kernel's "speed of light".

    python -m stark_tpu_torch.benches.merkle_roofline [--out PATH]

prints the JSON of the JAX script (its keys, in seconds) and writes it to
PATH only when ``--out`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import cuda_merkle, cuda_probes
from ..ops.cuda_probes import ROUNDS
from ..ops.device_merkle import leaf_digests_from_digits, level_hash
from ..ops.limbs import from_numpy
from ..ops.timing import call_ms, device_ms
from . import card, card_line, max_abs_err

LOGN = 20
SEED = 1
TAIL = 1024  # the tree's levels kept down to this width, as the JAX probe's tree_levels(d, 1024)


def inputs(device, logn: int = LOGN):
    """The probe's (4, n) leaf digits and an (8, n) level of digest words."""
    n = 1 << logn
    rng = np.random.default_rng(SEED)
    digits = rng.integers(0, 1 << 32, (4, n), dtype=np.uint32)
    level = rng.integers(0, 1 << 32, (8, n), dtype=np.uint32)
    return from_numpy(digits, device), from_numpy(level, device)


def plain_root(digits: torch.Tensor) -> torch.Tensor:
    """The tree's (8,) root words by the plain leaf and level hashes."""
    level = leaf_digests_from_digits(digits)
    while level.shape[1] > 1:
        level = level_hash(level)
    return level[:, 0]


def check(device, logn: int = LOGN) -> dict:
    """The stub and each round count (the kernels on a CUDA device)
    against their plain versions, and the tree's root against the plain
    tree's."""
    dev = torch.device(device)
    digits, level = inputs(dev, logn)
    errs = {"stub": max_abs_err(cuda_probes.level_stub(level), cuda_probes.level_stub_plain(level))}
    for r in ROUNDS:
        got = cuda_probes.level_rounds(level, r)
        errs[f"rounds_{r}"] = max_abs_err(got, cuda_probes.level_rounds_plain(level, r))
    _, root = cuda_merkle.tree_levels(digits, TAIL)
    errs["tree_root"] = max_abs_err(root, plain_root(digits))
    if any(errs.values()):
        raise AssertionError(f"the roofline kernels disagree with their plain versions: {errs}")
    return {"digits": digits, "level": level, "max_abs_err": errs}


def run(device="cuda") -> dict:
    """Check at the probe's full shape, then time the tree, the leaf and
    level kernels, the stub and the round sweep on the card (ms)."""
    dev = card(device)
    checked = check(dev)
    digits, level = checked.pop("digits"), checked.pop("level")
    n = digits.shape[1]
    sweep = {r: device_ms(lambda: cuda_probes.level_rounds(level, r)) for r in ROUNDS}
    out = {"n_leaves": n, "device": torch.cuda.get_device_name(dev),
           "tree_ms": device_ms(lambda: cuda_merkle.tree_levels(digits, TAIL), 4),
           "leaf_ms": device_ms(lambda: cuda_merkle.merkle_leaves(digits)),
           "level_ms": device_ms(lambda: cuda_merkle.merkle_level(level)),
           "stub_ms": device_ms(lambda: cuda_probes.level_stub(level)),
           "stub_plain_ms": call_ms(lambda: cuda_probes.level_stub_plain(level)),
           "round_sweep_ms": sweep,
           "round_plain_ms": {r: call_ms(lambda: cuda_probes.level_rounds_plain(level, r)) for r in ROUNDS},
           **checked}
    out["marginal_ms_per_round"] = (sweep[12] - sweep[1]) / 11
    # speed of light of the level kernel's structure: the I/O floor and 12
    # rounds at the measured marginal rate (the finalisation folded into 1 round)
    out["kernel_sol_ms"] = out["stub_ms"] + 12 * out["marginal_ms_per_round"]
    out["kernel_vs_sol"] = out["level_ms"] / out["kernel_sol_ms"]
    return out


def roofline_json(r: dict) -> dict:
    """``run``'s numbers under the JAX script's keys, in seconds."""
    n = r["n_leaves"]
    s = {k: r[k] / 1e3 for k in ("tree_ms", "leaf_ms", "level_ms", "stub_ms")}
    pred = s["leaf_ms"] + 2 * s["level_ms"]  # the level widths sum to ~n: leaf + 2 full-width levels
    return {"n_leaves": n, "backend": "cuda", "device": r["device"],
            "tree_s": s["tree_ms"], "tree_ns_per_hash": s["tree_ms"] / (2 * n - 1) * 1e9,
            "leaf_kernel_s": s["leaf_ms"], "leaf_ns_per_hash": s["leaf_ms"] / n * 1e9,
            "level_kernel_s_at_n": s["level_ms"], "level_ns_per_hash": s["level_ms"] / (n // 2) * 1e9,
            "kernel_sum_pred_s": pred, "glue_overhead_s": s["tree_ms"] - pred,
            "stub_kernel_s": s["stub_ms"], "stub_ns_per_hash": s["stub_ms"] / (n // 2) * 1e9,
            "round_sweep_s": {str(k): v / 1e3 for k, v in r["round_sweep_ms"].items()},
            "marginal_s_per_round": r["marginal_ms_per_round"] / 1e3,
            "kernel_sol_s": r["kernel_sol_ms"] / 1e3, "kernel_vs_sol": r["kernel_vs_sol"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON to this path")
    args = parser.parse_args(argv)
    print(card_line(), flush=True)
    out = roofline_json(run())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
