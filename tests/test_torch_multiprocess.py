"""The port's multi-controller mode (``stark_tpu_torch.parallel`` over
``torch.distributed``) on the CPU.

Counterpart of ``tests/test_multiprocess.py``: the launcher
(``stark_tpu_torch.benches.multiprocess_mesh``) runs once, in a
subprocess, 2 ranks x 4 CPU shards over gloo with a ``file://``
rendezvous under pytest's temporary directory (no TCP port: the suite
runs in several workers at once), at the JAX test's sizes: the NTT at
2^12 and fib-120 on its 2048-point domain with ``device_prover_min``
2048; beside them fib-2000 (16,384 points) with ``DEVICE_TREE_MIN``
lowered to 2048, so that its commitments are device subtrees spanning the
ranks (``RemoteBlock``, the roots', siblings' and tails' gathers,
``open``'s collective prefetch).  Each rank's JSON line is held against
the JAX package's host code in this process: the NTT against
``stark_tpu.ntt.NTT(4096).forward`` on the same seeded values; the
spanning tree's root, auth paths, digit blocks and is-zero bitmap against
``stark_tpu.merkle.MerkleTree`` over the JAX host NTT's coset codeword of
the same seeded coefficients (16,384 leaves); each rank's Rescue proof
against the JAX host ``RescueStark(rng=DeterministicRandom(7 + rank))``;
the fib-120 and fib-2000 proofs against the JAX host
``FibonacciStark(S, rng=DeterministicRandom(9))``; both ranks' bytes
against each other; the exchanges against a one-process ``cpu_mesh(8)``
prove of the same statement.  Beside them, with no process group: a
spanning mesh's ownership arithmetic, the refusal of NCCL for ranks that
share a card and of a CUDA rank without a card, and the launcher killing
its workers when one fails or hangs.

Tolerance: none (limbs, digests and proof bytes compared exactly).
"""

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from stark_tpu.field import FieldElement as JaxFieldElement
from stark_tpu.merkle import MerkleTree as JaxMerkleTree
from stark_tpu.models.fibonacci import FibonacciStark as JaxFibonacciStark
from stark_tpu.models.rescue_stark import RescueStark as JaxRescueStark
from stark_tpu.ntt import NTT as JaxNTT
from stark_tpu.rng import DeterministicRandom as JaxRandom
from stark_tpu_torch.benches import multiprocess_mesh as mp
from stark_tpu_torch.field import FieldElement
from stark_tpu_torch.models.fibonacci import FibonacciStark
from stark_tpu_torch.ops.limbs import pack
from stark_tpu_torch.parallel import ShardedBackend, cpu_mesh
from stark_tpu_torch.parallel.mesh import (EXCHANGES, ShardedArray, SpanningMesh, check_backend, init_distributed,
                                           owned, reset_exchange_counts)
from stark_tpu_torch.rng import DeterministicRandom

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, PER_RANK, LOG_N, STEPS, SEED, PROVER_MIN = 2, 4, 12, 120, 9, 2048
#: a prove whose 2048-leaf blocks take device subtrees once DEVICE_TREE_MIN is 2048
SPANNING_STEPS, TREE_MIN = 2000, 2048


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's result line, from one launcher run."""
    rendezvous = tmp_path_factory.mktemp("multiprocess") / "rendezvous"
    out = subprocess.run(
        [sys.executable, "-m", "stark_tpu_torch.benches.multiprocess_mesh", "--device", "cpu", "--backend", "gloo",
         "--ranks", str(RANKS), "--shards-per-rank", str(PER_RANK), "--log-n", str(LOG_N),
         "--steps", str(STEPS), str(SPANNING_STEPS), "--device-tree-min", str(TREE_MIN), "--seed", str(SEED),
         "--device-prover-min", str(PROVER_MIN), "--rendezvous", str(rendezvous),
         "--timeout", "240", "--pg-timeout", "60"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    results = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [r["rank"] for r in results] == list(range(RANKS))
    return results


@pytest.fixture(scope="module")
def jax_fib_proofs():
    """The JAX host prover's proof for each of the launcher's steps."""
    return {steps: JaxFibonacciStark(steps, rng=JaxRandom(SEED)).prove(JaxFieldElement(1), JaxFieldElement(1))[1]
            for steps in (STEPS, SPANNING_STEPS)}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("rank", range(RANKS))
def test_ntt_equals_the_jax_host_ntt(ranks, rank):
    import numpy as np

    n = 1 << LOG_N
    vals = [int(v) for v in np.random.default_rng(mp.NTT_SEED).integers(0, 1 << 62, n)]
    assert ranks[rank]["ntt"]["n"] == n
    assert ranks[rank]["ntt"]["digest"] == _sha(pack(JaxNTT(n).forward(vals)).tobytes())


@pytest.mark.parametrize("rank", range(RANKS))
def test_ntt_matches_one_device_and_round_trips(ranks, rank):
    ntt = ranks[rank]["ntt"]
    assert ntt["identical_to_one_device"] and ntt["coset_identical_to_one_device"] and ntt["round_trip"]


@pytest.mark.parametrize("rank", range(RANKS))
def test_rescue_proof_equals_the_jax_host_proof(ranks, rank):
    rescue = ranks[rank]["rescue"]
    _, proof = JaxRescueStark(rng=JaxRandom(7 + rank)).prove(JaxFieldElement(1000 + rank))
    assert (rescue["input"], rescue["rng_seed"], rescue["verified"]) == (1000 + rank, 7 + rank, True)
    assert (rescue["proof_bytes"], rescue["sha256"]) == (len(proof), _sha(proof))


@pytest.mark.parametrize("rank", range(RANKS))
def test_fib_proof_equals_the_jax_host_proof(ranks, jax_fib_proofs, rank):
    fib = ranks[rank]["fib"][0]
    proof = jax_fib_proofs[STEPS]
    assert (fib["steps"], fib["fri_domain"], fib["verified"], fib["plain_field_ops_on_cuda"]) == (STEPS, 2048, True, 0)
    assert (fib["proof_bytes"], fib["sha256"]) == (len(proof), _sha(proof))


@pytest.mark.parametrize("rank", range(RANKS))
def test_spanning_tree_prove_equals_the_jax_host_proof(ranks, jax_fib_proofs, rank):
    """fib-2000 commits its 16,384-point codewords through device subtrees
    of 2048 leaves, four a rank, gathered across ranks."""
    fib = ranks[rank]["fib"][1]
    proof = jax_fib_proofs[SPANNING_STEPS]
    assert (fib["steps"], fib["fri_domain"], fib["verified"]) == (SPANNING_STEPS, 16384, True)
    assert fib["commitments"].get("ShardedMerkleTree", 0) > 0
    assert fib["exchanges"]["remote_bytes"] > 0
    assert (fib["proof_bytes"], fib["sha256"]) == (len(proof), _sha(proof))


def test_ranks_agree(ranks):
    for key in (("ntt", "digest"), ("tree", "root"), ("tree", "paths"), ("tree", "iszero")):
        assert len({json.dumps(r[key[0]][key[1]]) for r in ranks}) == 1, key
    assert len({tuple(f["sha256"] for f in r["fib"]) for r in ranks}) == 1
    assert ranks[0]["rescue"]["sha256"] != ranks[1]["rescue"]["sha256"]  # data parallel: each its own statement


@pytest.fixture(scope="module")
def one_controller_exchanges():
    """The exchanges of the same prove over ``cpu_mesh(8)`` in one process."""
    model = FibonacciStark(STEPS, backend=ShardedBackend(cpu_mesh(RANKS * PER_RANK), device_prover_min=PROVER_MIN),
                           rng=DeterministicRandom(SEED))
    reset_exchange_counts()
    model.prove(FieldElement(1), FieldElement(1))
    return dict(EXCHANGES)


@pytest.mark.parametrize("rank", range(RANKS))
def test_exchanges_cross_ranks_as_one_controller_exchanges(ranks, one_controller_exchanges, rank):
    """Each rank makes the one-process prove's exchanges, moves its half of
    their bytes and receives a part of them from the other rank."""
    one = one_controller_exchanges
    got = ranks[rank]["fib"][0]["exchanges"]
    assert got["calls"] == one["calls"] > 0
    assert (got["bytes"] * RANKS, got["chunks"] * RANKS) == (one["bytes"], one["chunks"])
    assert got["remote_bytes"] > 0 and got["staged_bytes"] == 0 == got["peer_bytes"]  # CPU shards: nothing staged


@pytest.mark.parametrize("rank", range(RANKS))
def test_spanning_tree_matches_one_device(ranks, rank):
    tree = ranks[rank]["tree"]
    assert tree["identical_to_one_device"] and tree["leaves"] == tree["block"] * RANKS * PER_RANK


@pytest.fixture(scope="module")
def jax_tree(ranks):
    """The JAX host NTT's coset codeword of the spanning tree's seeded
    coefficients, its digits and ``stark_tpu.merkle.MerkleTree``."""
    n = ranks[0]["tree"]["leaves"]
    coeffs = mp.tree_coefficients(n)
    coeffs += [0] * (n - len(coeffs))
    codeword = JaxNTT(n).coset_evaluate(coeffs, JaxFieldElement.generator().value)
    digits = np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(4)] for v in codeword], dtype="<u4")
    return coeffs, digits, JaxMerkleTree.from_codeword(codeword)


@pytest.mark.parametrize("part", ["root", "paths", "digit_blocks", "iszero"])
@pytest.mark.parametrize("rank", range(RANKS))
def test_spanning_tree_equals_the_jax_host_tree(ranks, jax_tree, rank, part):
    """The tree over 8 blocks of 2048 leaves, a RemoteBlock for each of the
    other rank's, held against the JAX package's host tree."""
    tree = ranks[rank]["tree"]
    coeffs, digits, host = jax_tree
    assert tree["leaves"] == 16384 and tree["picks"] == mp.tree_picks(16384, RANKS * PER_RANK)
    if part == "root":
        assert tree["root"] == host.root.hex()
    elif part == "paths":
        assert tree["paths"] == [[h.hex() for h in host.open(i)] for i in tree["picks"]]
    elif part == "digit_blocks":
        w = len(digits) // (RANKS * PER_RANK)
        assert tree["digit_blocks_sha256"] == [_sha(digits[b * w:(b + 1) * w].tobytes())
                                              for b in range(RANKS * PER_RANK)]
    else:
        assert tree["iszero"] == np.packbits(np.array(coeffs) == 0).tobytes().hex()
        assert 0 < sum(c == 0 for c in coeffs[:len(coeffs) // 4]) < len(coeffs) // 4


# -- no process group ---------------------------------------------------------


def test_spanning_mesh_ownership():
    mesh = SpanningMesh(8, 2, 1, "cpu")
    assert (len(mesh), mesh.per_rank, mesh.staged) == (8, 4, False)
    assert [mesh.owner(s) for s in range(8)] == [0] * 4 + [1] * 4
    assert mesh.shards_of(0) == range(0, 4) and [s for s, _ in owned(mesh)] == [4, 5, 6, 7]
    assert mesh[5] == torch.device("cpu")
    with pytest.raises(IndexError):
        mesh[3]
    with pytest.raises(TypeError, match="owned"):  # never a silent stop at rank 0's last shard
        list(mesh)
    with pytest.raises(TypeError):
        set(SpanningMesh(8, 2, 0, "cpu"))
    with pytest.raises(ValueError):
        SpanningMesh(6, 4, 0, "cpu")
    arr = ShardedArray([torch.zeros(8, 2, 3, dtype=torch.int32) for _ in range(4)], mesh)
    assert arr.shape == (8, 2, 24) and [s for s, _ in arr.owned()] == [4, 5, 6, 7]
    assert arr.shard(6) is arr.shards[2]
    with pytest.raises(IndexError):
        arr.shard(1)
    with pytest.raises(ValueError):
        ShardedArray(arr.shards[:3], mesh)


def test_the_launcher_runs_on_the_card_unless_told():
    assert mp.parse_args([]).device == "cuda"
    assert mp.parse_args(["--device", "cpu"]).device == "cpu"
    assert mp.rank_devices(mp.parse_args(["--ranks", "2"])) == ["cuda:0", "cuda:0"]


def test_init_distributed_refuses_nccl_on_a_shared_card(tmp_path):
    with pytest.raises(ValueError, match="one rank a card"):
        init_distributed(f"file://{tmp_path / 'rendezvous'}", 2, 0, "nccl", ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        check_backend("nccl", ["cpu", "cpu"])
    check_backend("nccl", ["cuda:0", "cuda:1"])
    check_backend("gloo", ["cuda:0", "cuda:0"])  # ranks that share a card: gloo, through host buffers
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "rendezvous").exists()


def test_a_cuda_rank_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, "gloo", ["cuda:0"])
    assert not torch.distributed.is_initialized()


def _sleeper(seconds: float) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", f"import time; time.sleep({seconds})"])


def test_the_launcher_kills_a_hung_worker():
    procs = [_sleeper(60), _sleeper(60)]
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        mp.wait_all(procs, 0.5)
    assert time.monotonic() - t0 < 10 and all(p.poll() is not None for p in procs)


def test_the_launcher_kills_the_rest_when_a_worker_fails():
    procs = [subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"]), _sleeper(60)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="a worker failed"):
        mp.wait_all(procs, 60)
    assert time.monotonic() - t0 < 10 and [p.poll() is not None for p in procs] == [True, True]
    assert procs[0].returncode == 3
