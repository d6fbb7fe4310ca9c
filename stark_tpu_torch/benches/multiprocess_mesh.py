"""Several controllers over ``torch.distributed``: one mesh of shards
driven by W processes, each on its own shards.

Counterpart of the JAX package's benches/multiprocess_mesh.py (2
processes x 4 devices over ``jax.distributed``).  The launcher starts W
worker processes (fresh interpreters, never forked), which join one
process group (:func:`~stark_tpu_torch.parallel.mesh.init_distributed`,
a ``file://`` rendezvous) and build a
:class:`~stark_tpu_torch.parallel.mesh.SpanningMesh` of W x L shards,
rank r owning shards [r L, (r + 1) L) on its device.  Each worker runs
the JAX bench's four checks and prints one JSON line:

1. the sharded NTT at 2^``--log-n`` over the spanning mesh (the seeded
   values of the JAX bench), equal limb for limb to the one-device
   four-step plan (``CudaNTT.forward``), with the sha256 of its plain
   outputs; the coset transform against ``CudaNTT.coset_forward``;
2. the four-step round trip (the coset transform, then
   ``inverse_from_fourstep``) back to the input; then the coset codeword
   of seeded coefficients (:func:`tree_coefficients`) and its tree over
   the spanning mesh (a device subtree a block of ``DEVICE_TREE_MIN``
   leaves, 2 x ``TAIL_WIDTH`` on the CPU, a ``RemoteBlock`` for each of
   the other ranks' blocks), its root and auth paths against the
   one-device tree's, the tree of its gathered digit blocks
   (``natural_digit_blocks``) and its coefficients' is-zero bitmap
   (``restrict_iszero``); the root, the paths, the blocks' sha256 and the
   bitmap go into the result line;
3. a per-rank data-parallel ``RescueStark`` prove of 1000 + rank with
   ``DeterministicRandom(7 + rank)``, verified;
4. a ``FibonacciStark(S)`` prove over a ``ShardedBackend`` on the
   spanning mesh for each S of ``--steps``, the proof's sha256 equal on
   every rank (an all-gather), equal to the matching ``--expect-digest``
   where given, accepted by the host verifier; with the prove's kernel
   launches, chunk exchanges (``parallel.mesh.EXCHANGES``:
   ``remote_bytes``, ``staged_bytes``), its commitments by kind
   (``ShardedMerkleTree``: device subtrees spanning the ranks;
   ``MerkleTree``: the host tree), ``field_ops`` calls on CUDA tensors
   (``ops/guard.py``), cold and warm seconds and peak device MiB.
   ``--device-tree-min`` lowers ``ops/device_merkle.DEVICE_TREE_MIN`` for
   these proves, so that a small prove commits through spanning trees.

A check that fails raises, so the worker exits non-zero; the launcher
then kills every worker (one rank alone would wait in a collective until
its group's timeout) and raises, as it does when a worker outlives
``--timeout``.  ``--device cuda`` (the default) puts rank r on
``cuda:(r % --cards)`` and raises without a card.  Ranks that share a
card take ``--backend gloo`` (NCCL refuses two ranks on one device):
their crossings go through host buffers, counted as ``staged_bytes``.

    python -m stark_tpu_torch.benches.multiprocess_mesh --device cpu    # 2 ranks x 4 CPU shards, gloo
    python -m stark_tpu_torch.benches.multiprocess_mesh --log-n 20 --steps 65536 \\
        --device-prover-min 4096 --warm 1                               # 2 ranks on cuda:0, host-staged

The launcher prints one JSON line a rank and writes no file of its own
(the rendezvous file, and each worker's output, live in a temporary
directory removed at the end unless ``--rendezvous`` names the
rendezvous file).  Importing the module starts nothing.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the JAX bench's seeds: the NTT's values, the Rescue proves' rng (7 +
#: rank) and inputs (1000 + rank)
NTT_SEED = 42
RESCUE_RNG = 7
RESCUE_INPUT = 1000
#: the spanning tree's coefficients (:func:`tree_coefficients`)
TREE_SEED = 43


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m stark_tpu_torch.benches.multiprocess_mesh",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--shards-per-rank", type=int, default=4)
    ap.add_argument("--cards", type=int, default=1, help="with --device cuda: rank r on cuda:(r %% CARDS)")
    ap.add_argument("--log-n", type=int, default=12, help="the NTT checks' size, 2^LOG_N")
    ap.add_argument("--steps", type=int, nargs="+", default=[120], help="a FibonacciStark prove for each")
    ap.add_argument("--inputs", type=int, nargs=2, default=(1, 1), metavar=("A", "B"),
                    help="the Fibonacci statement's first two values")
    ap.add_argument("--seed", type=int, default=9, help="the Fibonacci prove's DeterministicRandom seed")
    ap.add_argument("--device-prover-min", type=int, default=2048,
                    help="ShardedBackend's smallest FRI domain for the device pipeline")
    ap.add_argument("--warm", type=int, default=0, help="warm Fibonacci proves after the cold one")
    ap.add_argument("--device-tree-min", type=int, default=None,
                    help="ops/device_merkle.DEVICE_TREE_MIN for the Fibonacci proves")
    ap.add_argument("--expect-digest", nargs="+", default=None,
                    help="the sha256 (hex) every rank's proof must have, one for each of --steps")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds before the launcher kills the workers")
    ap.add_argument("--pg-timeout", type=float, default=120.0, help="seconds before a collective fails")
    ap.add_argument("--rendezvous", default=None, help="the file:// rendezvous file (must not exist)")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ranks < 1 or args.shards_per_rank < 1 or args.cards < 1:
        ap.error("--ranks, --shards-per-rank and --cards must be positive")
    if args.expect_digest is not None and len(args.expect_digest) != len(args.steps):
        ap.error("--expect-digest takes one digest for each of --steps")
    return args


def rank_devices(args: argparse.Namespace) -> List[str]:
    """Every rank's device, in rank order."""
    if args.device == "cpu":
        return ["cpu"] * args.ranks
    return [f"cuda:{r % args.cards}" for r in range(args.ranks)]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


def _sha256(t) -> str:
    from ..ops.limbs import to_numpy

    return hashlib.sha256(to_numpy(t).tobytes()).hexdigest()


def ntt_input(n: int, device):
    """The JAX bench's n values (``default_rng(42).integers(0, 2^62, n)``)
    in Montgomery form, (8, n) on ``device``."""
    import numpy as np

    from ..ops import cuda_field as cf
    from ..ops.limbs import from_numpy
    from ..params import LIMB_BITS, NUM_LIMBS

    vals = np.random.default_rng(NTT_SEED).integers(0, 1 << 62, n).astype(np.uint64)
    limbs = np.zeros((NUM_LIMBS, n), np.uint32)
    for k in range(4):  # values below 2^62: four 16-bit limbs
        limbs[k] = (vals >> np.uint64(LIMB_BITS * k)) & np.uint64(0xFFFF)
    return cf.to_mont(from_numpy(limbs, device))


def tree_coefficients(n: int) -> List[int]:
    """The spanning tree's codeword's coefficients: n / 4 seeded values
    below 2^62, every seventh zero (the rest of the n are zero)."""
    import numpy as np

    vals = np.random.default_rng(TREE_SEED).integers(0, 1 << 62, n // 4).astype(np.uint64)
    vals[::7] = 0
    return [int(v) for v in vals]


def tree_picks(n: int, blocks: int) -> List[int]:
    """The leaves the spanning tree of n leaves in ``blocks`` blocks
    opens: the first, the first block's last, one in the second block,
    one in the second half (another rank's), the last."""
    b = n // blocks
    return [0, b - 1, b + 5, n // 2 + 7, n - 1]


def worker(args: argparse.Namespace, rank: int) -> dict:
    """One rank's four checks (see the module docstring); raises on any
    failure."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..field import FieldElement
    from ..models.rescue_stark import RescueStark
    from ..ops import cuda_field as cf
    from ..ops import device_merkle
    from ..ops.cuda_ntt import get_cuda_plan
    from ..ops.device_prover import get_core
    from ..params import GENERATOR
    from ..parallel import ShardedNTT
    from ..parallel.merkle_sharded import ShardedMerkleTree, tree_from_blocks
    from ..parallel.mesh import init_distributed, spanning_mesh
    from ..parallel.stark_sharded import ShardedProverCore
    from ..rng import DeterministicRandom

    devices = rank_devices(args)
    device = init_distributed(f"file://{args.rendezvous}", args.ranks, rank, args.backend, devices,
                              timeout=args.pg_timeout)
    try:
        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        mesh = spanning_mesh(args.ranks * args.shards_per_rank, device)
        out = {"rank": rank, "ranks": args.ranks, "shards": len(mesh), "device": str(device),
               "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
               "backend": args.backend, "staged": mesh.staged}

        # 1-2. the transform over the spanning mesh, against one device's plan
        n = 1 << args.log_n
        x = ntt_input(n, device)
        plan = get_cuda_plan(n, device)
        sntt = ShardedNTT(n, mesh)
        xs = sntt.shard_input(sntt.to_matrix(x))
        sync()
        t0 = time.perf_counter()
        fwd = sntt.from_output_matrix(sntt.forward(xs))
        sync()
        forward_s = time.perf_counter() - t0
        cw = sntt.forward(xs, GENERATOR)
        ntt = {"n": n, "forward_seconds": forward_s, "digest": _sha256(cf.from_mont(fwd)),
               "identical_to_one_device": torch.equal(fwd, plan.forward(x)),
               "coset_identical_to_one_device": torch.equal(sntt.from_output_matrix(cw),
                                                            plan.coset_forward(x, GENERATOR)),
               "round_trip": torch.equal(sntt.inverse_from_fourstep(cw, GENERATOR).gather().reshape(8, n), x)}
        del x, xs, fwd, cw
        failed = [k for k in ("identical_to_one_device", "coset_identical_to_one_device", "round_trip") if not ntt[k]]
        if failed:
            raise AssertionError(f"rank {rank}: the spanning mesh's transform failed {failed}")
        out["ntt"] = ntt

        # a tree over the spanning mesh against the one-device tree
        # blocks of the smallest device tree a prove builds on the card; on
        # the CPU (plain Blake2b) of the smallest any device tree takes
        block = device_merkle.DEVICE_TREE_MIN if device.type == "cuda" else 2 * device_merkle.TAIL_WIDTH
        t = block * len(mesh)
        coeffs = tree_coefficients(t)
        core = ShardedProverCore(t, GENERATOR, mesh)
        tree_min = device_merkle.DEVICE_TREE_MIN
        device_merkle.DEVICE_TREE_MIN = block
        try:
            cw = core.extend_codeword(coeffs)
            tree = core.merkle_tree(cw)
        finally:
            device_merkle.DEVICE_TREE_MIN = tree_min
        one = device_merkle.DeviceMerkleTree(get_core(t, GENERATOR, device).extend(coeffs))
        picks = tree_picks(t, len(mesh))
        root = tree.root
        tree.prefetch(picks[:2])  # the batched hooks; open fetches the rest itself
        paths = [tree.open(i) for i in picks]
        zero = core.restrict_iszero(cw.mont)  # the JAX module's two host crossings, gathered from every rank
        blocks = [np.ascontiguousarray(b).astype("<u4") for b in core.natural_digit_blocks(cw.mont)]
        checks = {"sharded": isinstance(tree, ShardedMerkleTree), "root": root == one.root,
                  "paths": paths == [one.open(i) for i in picks],
                  "digit_blocks": tree_from_blocks(blocks).root == root,
                  "iszero": zero.tolist() == [c == 0 for c in coeffs] + [True] * (t - len(coeffs))}
        if not all(checks.values()):
            raise AssertionError(f"rank {rank}: the spanning mesh's tree failed {checks}")
        out["tree"] = {"leaves": t, "block": block, "root": root.hex(), "picks": picks,
                       "paths": [[h.hex() for h in path] for path in paths],
                       "digit_blocks_sha256": [hashlib.sha256(b.tobytes()).hexdigest() for b in blocks],
                       "iszero": np.packbits(zero).tobytes().hex(), "identical_to_one_device": True}

        # 3. data-parallel: each rank proves its own statement
        rescue = RescueStark(device=device, rng=DeterministicRandom(RESCUE_RNG + rank))
        element = FieldElement(RESCUE_INPUT + rank)
        claim, proof = rescue.prove(element)
        if not rescue.verify(claim, proof):
            raise AssertionError(f"rank {rank}: its Rescue proof does not verify")
        out["rescue"] = {"input": RESCUE_INPUT + rank, "rng_seed": RESCUE_RNG + rank, "proof_bytes": len(proof),
                         "sha256": hashlib.sha256(proof).hexdigest(), "verified": True}

        # 4. Fibonacci proves over the spanning mesh, in lockstep
        expect = args.expect_digest or [None] * len(args.steps)
        if args.device_tree_min is not None:
            device_merkle.DEVICE_TREE_MIN = args.device_tree_min
        try:
            out["fib"] = [fib_prove(args, steps, digest, mesh, sync) for steps, digest in zip(args.steps, expect)]
        finally:
            device_merkle.DEVICE_TREE_MIN = tree_min
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def fib_prove(args: argparse.Namespace, steps: int, expect: Optional[str], mesh, sync) -> dict:
    """Check 4 for one ``FibonacciStark(steps)`` (see the module
    docstring); raises on any failure."""
    import torch
    import torch.distributed as dist

    from ..field import FieldElement
    from ..models.fibonacci import FibonacciStark
    from ..ops import guard, kernels
    from ..parallel import ShardedBackend
    from ..parallel.mesh import EXCHANGES, reset_exchange_counts
    from ..parallel.stark_sharded import ShardedProverCore
    from ..rng import DeterministicRandom

    rank, device = mesh.rank, mesh.device
    a, b = (FieldElement(v) for v in args.inputs)
    model = FibonacciStark(steps, backend=ShardedBackend(mesh, device_prover_min=args.device_prover_min),
                           rng=DeterministicRandom(args.seed))
    if not model.stark._use_device_pipeline():
        raise AssertionError(f"rank {rank}: fib-{steps} ({model.stark.fri_domain_length} points) does not "
                             f"take the device pipeline at device_prover_min {args.device_prover_min}")
    commitments: Dict[str, int] = {}
    commit = ShardedProverCore.merkle_tree

    def counted(core, dcw):
        tree = commit(core, dcw)
        commitments[type(tree).__name__] = commitments.get(type(tree).__name__, 0) + 1
        return tree

    kernels.reset_launch_counts()
    reset_exchange_counts()
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ShardedProverCore.merkle_tree = counted
    try:
        t0 = time.perf_counter()
        with guard.count_plain_calls("cuda") as plain:
            result, proof = model.prove(a, b)
            sync()
        cold_s = time.perf_counter() - t0
    finally:
        ShardedProverCore.merkle_tree = commit
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    exchanges = dict(EXCHANGES)
    peak_mib = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else None
    warm_s = []
    for _ in range(args.warm):
        t0 = time.perf_counter()
        model.prove(a, b)
        sync()
        warm_s.append(time.perf_counter() - t0)
    digest = hashlib.sha256(proof).hexdigest()
    digests = [None] * mesh.world_size
    dist.all_gather_object(digests, digest)
    if len(set(digests)) != 1:
        raise AssertionError(f"the ranks' fib-{steps} proofs differ: {digests}")
    if expect is not None and digest != expect:
        raise AssertionError(f"rank {rank}: the fib-{steps} proof's sha256 {digest} is not {expect}")
    if sum(plain.values()):
        raise AssertionError(f"rank {rank}: the prove called field_ops on CUDA tensors: {dict(plain)}")
    t0 = time.perf_counter()
    if not FibonacciStark(steps, device=None).verify(a, b, result, proof):
        raise AssertionError(f"rank {rank}: the host verifier rejects the fib-{steps} proof")
    return {"steps": steps, "fri_domain": model.stark.fri_domain_length, "inputs": list(args.inputs),
            "rng_seed": args.seed, "result": result.value, "proof_bytes": len(proof), "sha256": digest,
            "ranks_agree": True, "expected_digest": expect is not None, "verified": True,
            "verify_seconds": time.perf_counter() - t0, "prove_seconds": cold_s, "warm_prove_seconds": warm_s,
            "peak_device_mib": peak_mib, "launches": launches, "exchanges": exchanges, "commitments": commitments,
            "plain_field_ops_on_cuda": sum(plain.values())}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def wait_all(procs: Sequence[subprocess.Popen], timeout: float) -> None:
    """Wait for every process to exit 0; the first that fails, or the
    timeout, raises, and every process still running is killed."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                raise RuntimeError(f"a worker failed: exit codes {codes} (None: still running, killed)")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"workers still running after {timeout} s: exit codes {codes}; killed")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _result_line(path: str, rank: int) -> dict:
    with open(path) as f:
        lines = [line for line in f.read().splitlines() if line.startswith("{")]
    if not lines:
        raise RuntimeError(f"rank {rank} printed no result")
    result = json.loads(lines[-1])
    if result.get("rank") != rank:
        raise RuntimeError(f"rank {rank} printed {lines[-1][:200]}")
    return result


def run(argv: Sequence[str] = ()) -> List[dict]:
    """Launch the workers (the module docstring's options), wait for them,
    and return every rank's result in rank order; raises if a worker
    fails or outlives ``--timeout``."""
    from ..parallel.mesh import check_backend

    argv = list(argv)
    args = parse_args(argv)
    check_backend(args.backend, rank_devices(args))  # refuse NCCL on a shared card before starting anyone
    with tempfile.TemporaryDirectory(prefix="stark_mp_") as tmp:
        rendezvous = os.path.abspath(args.rendezvous or os.path.join(tmp, "rendezvous"))
        if os.path.exists(rendezvous):
            raise FileExistsError(f"the rendezvous file {rendezvous} exists: a fresh path a run")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        outs = [os.path.join(tmp, f"rank{r}.out") for r in range(args.ranks)]
        procs: List[subprocess.Popen] = []
        try:
            for r in range(args.ranks):
                with open(outs[r], "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "stark_tpu_torch.benches.multiprocess_mesh", "--worker", str(r),
                         *argv, "--rendezvous", rendezvous], stdout=f, cwd=REPO, env=env))
        except BaseException:
            wait_all(procs, 0)  # kills those started
            raise
        wait_all(procs, args.timeout)
        results = [_result_line(outs[r], r) for r in range(args.ranks)]
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args, args.worker)), flush=True)
        return 0
    for result in run(argv):
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
