#!/usr/bin/env python3
"""Drive the torch prover's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is non-zero):

1. environment: torch, CUDA, nvcc, the card's name and power limit, the
   committed native host library, and the build of the CUDA kernels;
2. each CUDA kernel against its plain PyTorch version on the card,
   bit-exact: the four-step NTT passes (forward, inverse and coset
   transforms at 2^13 and 2^20 points), the Blake2b-256 leaf and level
   kernels at 2^20, and a 2^13-leaf device tree (root and auth paths)
   against the host Merkle tree; kernel and plain times by CUDA events;
3. FibonacciStark(1000) proved on the card, byte-identical to the host
   prover's proof on the same seeded randomness (the 8192-point domain);
4. FibonacciStark(65536) proved on the card over its 2^20-point FRI
   domain, with every kernel's launch counter > 0 for that prove; the
   proof must verify with the host verifier and a wrong claim must fail;
5. a JSON line of the kernels, then the last line
   {"ok": true, "device": {...}}.

Without a CUDA device, or without the rest of the repository beside it,
the script fails before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
TIMING_REPS = 5


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(torch, fn) -> float:
    """Median of TIMING_REPS CUDA-event timings of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(torch, got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype mismatch: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device: this check needs one card")

    from stark_tpu.field import FieldElement
    from stark_tpu.merkle import MerkleTree
    from stark_tpu.models.fibonacci import FibonacciStark as HostFibonacciStark
    from stark_tpu.ntt import NTT
    from stark_tpu.ops.limbs import pack, unpack
    from stark_tpu.params import GENERATOR, P, R_MOD_P
    from stark_tpu.rng import DeterministicRandom

    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.ops import cuda_merkle, cuda_ntt, kernels
    from stark_tpu_torch.ops import device_merkle as dm
    from stark_tpu_torch.ops import field_ops as fo
    from stark_tpu_torch.ops.limbs import from_numpy, to_numpy

    dev = torch.device("cuda")

    # -- 1. environment ------------------------------------------------------
    nvcc_line = subprocess.run([kernels._nvcc(), "--version"], capture_output=True, text=True, check=True)
    nvcc_release = [ln for ln in nvcc_line.stdout.splitlines() if "release" in ln]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    try:
        from stark_tpu.native import fieldvec, hashing_native  # noqa: F401
    except (ImportError, OSError) as exc:
        raise RuntimeError(f"the committed native/libstark_hash.so does not load here: {exc}") from exc
    say("environment", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc_release[0].strip() if nvcc_release else nvcc_line.stdout.strip(),
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    print(smi, flush=True)
    t0 = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in str(kernels.build_info.get("ptxas", "")).splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    say("build", seconds=round(build_s, 3), nvcc_seconds=kernels.build_info.get("seconds"),
        library=os.path.relpath(str(kernels.build_info["path"]), REPO), ptxas=ptxas)

    # -- 2. kernels against their plain versions on the card ------------------
    rng = np.random.default_rng(SEED)

    def seeded_values(n):
        vals = [int(v) % P for v in rng.integers(0, 1 << 63, n, dtype=np.uint64)]
        vals = [v * (1 + (i % 7) * (1 << 64)) % P for i, v in enumerate(vals)]
        vals[:3] = [0, 1, P - 1]
        return vals

    report = {}
    for logn in (13, 20):
        n = 1 << logn
        vals = seeded_values(n)
        a = from_numpy(pack([v * R_MOD_P % P for v in vals]), dev)
        plan = cuda_ntt.get_cuda_plan(n, dev)
        errs = {}
        for name, inverse, offset in (("forward", False, 1), ("inverse", True, 1),
                                      ("coset_forward", False, GENERATOR), ("coset_inverse", True, GENERATOR)):
            w, tw_r, tw_c, row, col = plan.op_tables(inverse, offset)
            pro = not inverse and row is not None
            x = a.reshape(8, plan.R, plan.C)
            y = cuda_ntt.ntt_pass1(x, tw_r, w, row if pro else None, col if pro else None)
            y_plain = cuda_ntt.ntt_pass1_plain(x, tw_r, w, row if pro else None, col if pro else None)
            z = cuda_ntt.ntt_pass2(y, tw_c, row if inverse else None, col if inverse else None)
            z_plain = cuda_ntt.ntt_pass2_plain(y, tw_c, row if inverse else None, col if inverse else None)
            errs[name] = (max_abs_err(torch, y, y_plain), max_abs_err(torch, z, z_plain))
            if errs[name] != (0, 0):
                raise AssertionError(f"NTT kernels disagree with their plain versions at 2^{logn} {name}: {errs[name]}")
            if logn == 13:  # the whole transform against the host NTT
                host = NTT(n)
                want = {"forward": lambda: host.forward(vals), "inverse": lambda: host.inverse(vals),
                        "coset_forward": lambda: host.coset_evaluate(vals, GENERATOR),
                        "coset_inverse": lambda: host.coset_interpolate(vals, GENERATOR)}[name]()
                if unpack(to_numpy(fo.from_mont(z.reshape(8, n)))) != want:
                    raise AssertionError(f"2^13 {name} transform disagrees with the host NTT")
        # time the coset-forward tables (pass 1 with prologue) and the
        # inverse tables (pass 2 with epilogue): the extend and restrict shapes
        w, tw_r, _, row, col = plan.op_tables(False, GENERATOR)
        x = a.reshape(8, plan.R, plan.C)
        _, _, tw_c, irow, icol = plan.op_tables(True, GENERATOR)
        y = cuda_ntt.ntt_pass1(x, tw_r, w, row, col)
        report[logn] = {
            "ntt_pass1": (cuda_ms(torch, lambda: cuda_ntt.ntt_pass1(x, tw_r, w, row, col)),
                          cuda_ms(torch, lambda: cuda_ntt.ntt_pass1_plain(x, tw_r, w, row, col))),
            "ntt_pass2": (cuda_ms(torch, lambda: cuda_ntt.ntt_pass2(y, tw_c, irow, icol)),
                          cuda_ms(torch, lambda: cuda_ntt.ntt_pass2_plain(y, tw_c, irow, icol))),
        }
        say("ntt_kernels", n=n, R=plan.R, C=plan.C, max_abs_err=errs,
            ms={k: {"kernel": v[0], "plain": v[1]} for k, v in report[logn].items()})

    n = 1 << 20
    vals = seeded_values(n)
    vals[3:6] = [1 << 32, (1 << 32) - 1, (1 << 96) + 5]
    digits = np.array([[(v >> (32 * k)) & 0xFFFFFFFF for v in vals] for k in range(4)], dtype=np.uint32)
    d = from_numpy(digits, dev)
    leaves = cuda_merkle.merkle_leaves(d)
    leaf_err = max_abs_err(torch, leaves, dm.leaf_digests_from_digits(d))
    parents = cuda_merkle.merkle_level(leaves)
    level_err = max_abs_err(torch, parents, dm.level_hash(leaves))
    if leaf_err or level_err:
        raise AssertionError(f"Merkle kernels disagree with their plain versions: leaf {leaf_err}, level {level_err}")
    report[20]["merkle_leaves"] = (cuda_ms(torch, lambda: cuda_merkle.merkle_leaves(d)),
                                   cuda_ms(torch, lambda: dm.leaf_digests_from_digits(d)))
    report[20]["merkle_level"] = (cuda_ms(torch, lambda: cuda_merkle.merkle_level(leaves)),
                                  cuda_ms(torch, lambda: dm.level_hash(leaves)))
    errs = {"ntt_pass1": 0, "ntt_pass2": 0, "merkle_leaves": leaf_err, "merkle_level": level_err}

    n_tree = 1 << 13
    tree_vals = seeded_values(n_tree)
    tree = dm.DeviceMerkleTree(fo.to_mont(from_numpy(pack(tree_vals), dev)))
    host_tree = MerkleTree.from_codeword(tree_vals)
    if tree.root != host_tree.root:
        raise AssertionError("2^13 device tree root differs from the host tree")
    opened = [0, 1, 4097, n_tree - 1]
    for i in opened:
        if tree.open(i) != host_tree.open(i):
            raise AssertionError(f"2^13 device tree auth path {i} differs from the host tree")
    say("merkle_kernels", n=n, max_abs_err={"leaves": leaf_err, "level": level_err},
        ms={k: {"kernel": report[20][k][0], "plain": report[20][k][1]} for k in ("merkle_leaves", "merkle_level")},
        tree_2e13_root=tree.root.hex(), auth_paths_checked=opened)

    # -- 3. small prove: byte-identical to the host prover --------------------
    a, b = FieldElement(3), FieldElement(7)
    host_result, host_proof = HostFibonacciStark(1000, rng=DeterministicRandom(11)).prove(a, b)
    small = FibonacciStark(1000, device=dev, rng=DeterministicRandom(11))
    if small.stark.fri_domain_length != 8192 or not small.stark._use_device_pipeline():
        raise AssertionError("fib-1000 did not take the device pipeline on its 8192-point domain")
    result, proof = small.prove(a, b)
    if result != host_result or proof != host_proof:
        raise AssertionError("fib-1000 proof on the card differs from the host prover's")
    say("small_prove", steps=1000, fri_domain=8192, proof_bytes=len(proof), identical_to_host=True)

    # -- 4. the real prove ------------------------------------------------------
    steps = 65536
    model = FibonacciStark(steps, device=dev, rng=DeterministicRandom(SEED))
    if model.stark.fri_domain_length != 1 << 20:
        raise AssertionError(f"unexpected FRI domain {model.stark.fri_domain_length}")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, proof = model.prove(a, b)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stages = {k: round(v, 4) for k, v in sorted(model.stark.last_profile.totals.items(), key=lambda kv: -kv[1])}
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"the 2^16-step prove never launched {missing}: {launches}")
    verifier = HostFibonacciStark(steps)
    t0 = time.perf_counter()
    ok = verifier.verify(a, b, result, proof)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the host verifier rejects the card's 2^16-step proof")
    if verifier.verify(a, b, result + FieldElement(1), proof):
        raise AssertionError("the host verifier accepts a wrong claimed result")
    t0 = time.perf_counter()
    model.prove(a, b)
    torch.cuda.synchronize()
    warm_prove_s = time.perf_counter() - t0
    say("prove", steps=steps, fri_domain=model.stark.fri_domain_length, prove_seconds=prove_s, warm_prove_seconds=warm_prove_s,
        verify_seconds=verify_s, proof_bytes=len(proof), launches=launches, stages_seconds=stages,
        peak_device_mib=torch.cuda.max_memory_allocated() / 2**20)

    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    or (m.startswith("stark_tpu.ops.") and m != "stark_tpu.ops.limbs")
                    or m.startswith("stark_tpu.parallel"))
    if leaked:
        raise AssertionError(f"JAX-coupled modules were imported: {leaked[:5]}")

    # -- 5. result ------------------------------------------------------------
    sources = {
        "ntt_pass1": ("stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_ntt.py:234"),
        "ntt_pass2": ("stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_ntt.py:311"),
        "merkle_leaves": ("stark_tpu_torch/csrc/merkle.cu", "stark_tpu/ops/pallas_merkle.py:156"),
        "merkle_level": ("stark_tpu_torch/csrc/merkle.cu", "stark_tpu/ops/pallas_merkle.py:185"),
    }
    rows = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         "max_abs_err": errs[name], "ms": report[20][name][0], "plain_ms": report[20][name][1]}
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
