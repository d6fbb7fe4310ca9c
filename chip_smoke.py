#!/usr/bin/env python3
"""Drive the torch prover's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is non-zero):

1. environment: torch, CUDA, nvcc, the card's name and power limit, the
   build of the port's host C library and of the CUDA kernels (one nvcc
   per source, all started together);
2. each CUDA kernel against its plain PyTorch version on the card,
   bit-exact: the four-step NTT passes (forward, inverse and coset
   transforms at 2^13 and 2^20 points), the Blake2b-256 leaf and level
   kernels at 2^20, a 2^13-leaf device tree (root and auth paths) against
   the host Merkle tree, the FRI fold at 2^13 and 2^20, and the
   Fiat-Shamir round at transcript bodies of 0 to 1000 bytes (also
   against hashlib); kernel and plain times by CUDA events;
3. FibonacciStark(1000) proved on the card, byte-identical to the port's
   host prover (no backend) on the same seeded randomness;
4. FibonacciStark(65536) proved on the card over its 2^20-point FRI
   domain, with every kernel's launch counter > 0 for that prove and at
   least 2 FRI rounds fused into the device cascade; the proof must
   verify with the port's host verifier and a wrong claim must fail;
5. a JSON line of the kernels, then the last line
   {"ok": true, "device": {...}}.

The script imports nothing of JAX or of the ``stark_tpu`` package.
Without a CUDA device, or without the rest of the repository beside it,
it fails before printing any result.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
TIMING_REPS = 5

# Least-time model of the card (NVIDIA H100 SXM, 700 W): HBM3 at 3.35 TB/s
# (data sheet) and 32-bit integer issue at 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost (Hopper architecture white paper).
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer operations per primitive, counted from the kernels' code
# with the card's fused forms (IADD3 / LOP3 take three inputs, a 32x32->64
# product counts 2): a Montgomery product is 20 wide products and ~40
# carry adds; an add or sub with its conditional correction ~10; a
# Blake2b-256 compression is 12 rounds x 8 G x 22; a Keccak-f[1600]
# permutation 24 rounds x ~190 (64-bit lanes as 32-bit halves).
FE_MUL_OPS, FE_ADD_OPS = 80, 10
BLAKE2B_OPS = 12 * 8 * 22
KECCAK_OPS = 24 * 190
LIMB_BYTES = 32  # one field element: 8 int32 limbs
# the transcript body the first fused FRI round of a FibonacciStark prove
# extends: two boundary-quotient roots and the randomizer root, each a
# bincode string of 72 bytes
FS_BODY_BYTES = 3 * 72


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


def bound(bytes_moved: float, int_ops: float):
    """(bound_ms, bound_by): the larger of the memory and integer times."""
    mem_ms = bytes_moved / MEM_BYTES_PER_S * 1e3
    ops_ms = int_ops / INT32_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device: this check needs one card")

    from stark_tpu_torch import native
    from stark_tpu_torch.field import FieldElement
    from stark_tpu_torch.merkle import MerkleTree
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.ntt import NTT
    from stark_tpu_torch.ops import cuda_fold, cuda_fs, cuda_merkle, cuda_ntt, kernels
    from stark_tpu_torch.ops import device_merkle as dm
    from stark_tpu_torch.ops import field_ops as fo
    from stark_tpu_torch.ops.device_fs import fs_round_plain
    from stark_tpu_torch.ops.fold import fold_mont
    from stark_tpu_torch.ops.limbs import _fold_tables, from_numpy, pack, to_numpy, unpack
    from stark_tpu_torch.params import GENERATOR, P, R_MOD_P
    from stark_tpu_torch.rng import DeterministicRandom

    dev = torch.device("cuda")

    # -- 1. environment ------------------------------------------------------
    nvcc_line = subprocess.run([kernels._nvcc(), "--version"], capture_output=True, text=True, check=True)
    nvcc_release = [ln for ln in nvcc_line.stdout.splitlines() if "release" in ln]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    native.library()  # the port's host C library: raises if it does not build or load
    host_build_s = time.perf_counter() - t0
    say("environment", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc_release[0].strip() if nvcc_release else nvcc_line.stdout.strip(),
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        host_library=os.path.relpath(str(native.build_info["path"]), REPO), host_build_seconds=host_build_s)
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

    report = {}  # kernel -> (kernel ms, plain ms, bound ms, bound by) at the main path's shape
    errs = {}
    for logn in (13, 20):
        n = 1 << logn
        vals = seeded_values(n)
        a = from_numpy(pack([v * R_MOD_P % P for v in vals]), dev)
        plan = cuda_ntt.get_cuda_plan(n, dev)
        ntt_errs = {}
        for name, inverse, offset in (("forward", False, 1), ("inverse", True, 1),
                                      ("coset_forward", False, GENERATOR), ("coset_inverse", True, GENERATOR)):
            w, tw_r, tw_c, row, col = plan.op_tables(inverse, offset)
            pro = not inverse and row is not None
            x = a.reshape(8, plan.R, plan.C)
            y = cuda_ntt.ntt_pass1(x, tw_r, w, row if pro else None, col if pro else None)
            y_plain = cuda_ntt.ntt_pass1_plain(x, tw_r, w, row if pro else None, col if pro else None)
            z = cuda_ntt.ntt_pass2(y, tw_c, row if inverse else None, col if inverse else None)
            z_plain = cuda_ntt.ntt_pass2_plain(y, tw_c, row if inverse else None, col if inverse else None)
            ntt_errs[name] = (max_abs_err(torch, y, y_plain), max_abs_err(torch, z, z_plain))
            if ntt_errs[name] != (0, 0):
                raise AssertionError(f"NTT kernels disagree with their plain versions at 2^{logn} {name}: {ntt_errs[name]}")
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
        R, C = plan.R, plan.C
        times = {
            "ntt_pass1": (cuda_ms(torch, lambda: cuda_ntt.ntt_pass1(x, tw_r, w, row, col)),
                          cuda_ms(torch, lambda: cuda_ntt.ntt_pass1_plain(x, tw_r, w, row, col)),
                          *bound(LIMB_BYTES * (3 * n + 2 * R + C),
                                 3 * n * FE_MUL_OPS + n // 2 * (R.bit_length() - 1) * (FE_MUL_OPS + 2 * FE_ADD_OPS))),
            "ntt_pass2": (cuda_ms(torch, lambda: cuda_ntt.ntt_pass2(y, tw_c, irow, icol)),
                          cuda_ms(torch, lambda: cuda_ntt.ntt_pass2_plain(y, tw_c, irow, icol)),
                          *bound(LIMB_BYTES * (2 * n + 2 * C + R),
                                 2 * n * FE_MUL_OPS + n // 2 * (C.bit_length() - 1) * (FE_MUL_OPS + 2 * FE_ADD_OPS))),
        }
        if logn == 20:
            report.update(times)
            errs.update(ntt_pass1=0, ntt_pass2=0)
        say("ntt_kernels", n=n, R=R, C=C, max_abs_err=ntt_errs,
            ms={k: {"kernel": v[0], "plain": v[1], "bound": v[2], "bound_by": v[3]} for k, v in times.items()})

    n = 1 << 20
    vals = seeded_values(n)
    vals[3:6] = [1 << 32, (1 << 32) - 1, (1 << 96) + 5]
    digits = np.array([[(v >> (32 * k)) & 0xFFFFFFFF for v in vals] for k in range(4)], dtype=np.uint32)
    d = from_numpy(digits, dev)
    leaves = cuda_merkle.merkle_leaves(d)
    errs["merkle_leaves"] = max_abs_err(torch, leaves, dm.leaf_digests_from_digits(d))
    parents = cuda_merkle.merkle_level(leaves)
    errs["merkle_level"] = max_abs_err(torch, parents, dm.level_hash(leaves))
    if errs["merkle_leaves"] or errs["merkle_level"]:
        raise AssertionError(f"Merkle kernels disagree with their plain versions: {errs}")
    report["merkle_leaves"] = (cuda_ms(torch, lambda: cuda_merkle.merkle_leaves(d)),
                               cuda_ms(torch, lambda: dm.leaf_digests_from_digits(d)),
                               *bound(16 * n + 32 * n, n * BLAKE2B_OPS))
    report["merkle_level"] = (cuda_ms(torch, lambda: cuda_merkle.merkle_level(leaves)),
                              cuda_ms(torch, lambda: dm.level_hash(leaves)),
                              *bound(32 * n + 32 * (n // 2), n // 2 * BLAKE2B_OPS))

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
    say("merkle_kernels", n=n, max_abs_err={"leaves": errs["merkle_leaves"], "level": errs["merkle_level"]},
        ms={k: {"kernel": report[k][0], "plain": report[k][1], "bound": report[k][2], "bound_by": report[k][3]}
            for k in ("merkle_leaves", "merkle_level")},
        tree_2e13_root=tree.root.hex(), auth_paths_checked=opened)

    fold_errs = {}
    for logn in (13, 20):
        n = 1 << logn
        cw = from_numpy(pack([v * R_MOD_P % P for v in seeded_values(n)]), dev)
        omega = FieldElement.primitive_nth_root(n).value
        table = from_numpy(_fold_tables(GENERATOR, omega, n // 2), dev)
        worst = 0
        for alpha_value in (0, 1, P - 1, int(rng.integers(0, 1 << 62)) * 7919 % P):
            alpha = from_numpy(pack([alpha_value * R_MOD_P % P]), dev)
            worst = max(worst, max_abs_err(torch, cuda_fold.fri_fold(cw, alpha, table), fold_mont(cw, alpha, table)))
        fold_errs[n] = worst
        if worst:
            raise AssertionError(f"fold kernel disagrees with its plain version at 2^{logn}: {worst}")
    report["fri_fold"] = (cuda_ms(torch, lambda: cuda_fold.fri_fold(cw, alpha, table)),
                          cuda_ms(torch, lambda: fold_mont(cw, alpha, table)),
                          *bound(LIMB_BYTES * (n + n // 2 + 1 + n // 2),
                                 n // 2 * (4 * FE_MUL_OPS + 3 * FE_ADD_OPS)))
    errs["fri_fold"] = 0
    say("fold_kernel", n=n, max_abs_err=fold_errs,
        ms={"kernel": report["fri_fold"][0], "plain": report["fri_fold"][1], "bound": report["fri_fold"][2],
            "bound_by": report["fri_fold"][3]})

    fs_lengths = [0, 1, 55, 56, 57, 63, 64, 65, 127, 128, 135, 136, 137, FS_BODY_BYTES, 271, 272, 273, 500, 1000]
    for body_len in fs_lengths:
        body = torch.from_numpy(rng.integers(0, 256, body_len + 72, dtype=np.uint8)).to(dev)
        body_plain = body.clone()
        root = from_numpy(rng.integers(0, 1 << 32, 8, dtype=np.uint64).astype(np.uint32), dev)
        count = int(rng.integers(1, 1 << 40))
        got = cuda_fs.fs_round(body, body_len, count, root)
        want = fs_round_plain(body_plain, body_len, count, root)
        if max_abs_err(torch, got, want) or not torch.equal(body, body_plain):
            raise AssertionError(f"fs_round disagrees with its plain version at a {body_len}-byte body")
        msg = count.to_bytes(8, "little") + bytes(body[: body_len + 72].cpu().numpy())
        sampled = FieldElement.sample(hashlib.shake_256(msg).digest(32)).value
        if unpack(to_numpy(fo.from_mont(got)))[0] != sampled:
            raise AssertionError(f"fs_round's alpha differs from hashlib's Shake256 at a {body_len}-byte body")
    errs["fs_round"] = 0
    body = torch.zeros(FS_BODY_BYTES + 72, dtype=torch.uint8, device=dev)
    fs_blocks = (8 + FS_BODY_BYTES + 72) // 136 + 1
    report["fs_round"] = (cuda_ms(torch, lambda: cuda_fs.fs_round(body, FS_BODY_BYTES, 4, root)),
                          cuda_ms(torch, lambda: fs_round_plain(body, FS_BODY_BYTES, 4, root)),
                          *bound(FS_BODY_BYTES + 32 + 72 + 32, fs_blocks * KECCAK_OPS + 3 * FE_MUL_OPS))
    say("fs_kernel", body_lengths_checked=fs_lengths, against=["plain", "hashlib"], timed_body_bytes=FS_BODY_BYTES,
        ms={"kernel": report["fs_round"][0], "plain": report["fs_round"][1], "bound": report["fs_round"][2],
            "bound_by": report["fs_round"][3]})

    # -- 3. small prove: byte-identical to the port's host prover --------------
    a, b = FieldElement(3), FieldElement(7)
    host_result, host_proof = FibonacciStark(1000, device=None, rng=DeterministicRandom(11)).prove(a, b)
    small = FibonacciStark(1000, device=dev, rng=DeterministicRandom(11))
    if small.stark.fri_domain_length != 8192 or not small.stark._use_device_pipeline():
        raise AssertionError("fib-1000 did not take the device pipeline on its 8192-point domain")
    result, proof = small.prove(a, b)
    if result != host_result or proof != host_proof:
        raise AssertionError("fib-1000 proof on the card differs from the host prover's")
    say("small_prove", steps=1000, fri_domain=8192, proof_bytes=len(proof), identical_to_host=True)

    # -- 4. the real prove ------------------------------------------------------
    steps = 65536
    model = FibonacciStark(steps, rng=DeterministicRandom(SEED))  # the card is the default device
    if model.stark.fri_domain_length != 1 << 20:
        raise AssertionError(f"unexpected FRI domain {model.stark.fri_domain_length}")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, proof = model.prove(a, b)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    fused = model.stark.fri.last_fused_rounds
    stages = {k: round(v, 4) for k, v in sorted(model.stark.last_profile.totals.items(), key=lambda kv: -kv[1])}
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"the 2^16-step prove never launched {missing}: {launches}")
    if fused < 2:
        raise AssertionError(f"the 2^16-step prove fused {fused} FRI rounds, expected >= 2")
    verifier = FibonacciStark(steps, device=None)  # the port's host verifier
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
    warm_stages = {k: round(v, 4) for k, v in sorted(model.stark.last_profile.totals.items(), key=lambda kv: -kv[1])}
    say("prove", steps=steps, fri_domain=model.stark.fri_domain_length, prove_seconds=prove_s,
        warm_prove_seconds=warm_prove_s, verify_seconds=verify_s, proof_bytes=len(proof), fused_fri_rounds=fused,
        launches=launches, stages_seconds=stages, warm_stages_seconds=warm_stages,
        peak_device_mib=torch.cuda.max_memory_allocated() / 2**20)
    print(f"fused FRI rounds: {fused}", flush=True)

    leaked = sorted(m for m in sys.modules if m in ("jax", "stark_tpu") or m.startswith(("jax.", "stark_tpu.")))
    if leaked:
        raise AssertionError(f"modules of JAX or of the JAX package were imported: {leaked[:5]}")

    # -- 5. result ------------------------------------------------------------
    sources = {
        "ntt_pass1": ("stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_ntt.py:234"),
        "ntt_pass2": ("stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_ntt.py:311"),
        "merkle_leaves": ("stark_tpu_torch/csrc/merkle.cu", "stark_tpu/ops/pallas_merkle.py:156"),
        "merkle_level": ("stark_tpu_torch/csrc/merkle.cu", "stark_tpu/ops/pallas_merkle.py:185"),
        "fri_fold": ("stark_tpu_torch/csrc/fold.cu", "stark_tpu/ops/pallas_fold.py:145"),
        "fs_round": ("stark_tpu_torch/csrc/fs.cu", "stark_tpu/ops/device_keccak.py:132"),
    }
    rows = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         "max_abs_err": errs[name], "ms": report[name][0], "plain_ms": report[name][1],
         "bound_ms": report[name][2], "bound_by": report[name][3], "library_ms": None}
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
