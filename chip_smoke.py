#!/usr/bin/env python3
"""Drive the torch prover's main path once on one CUDA card.

    python3 chip_smoke.py               # the whole check, below
    python3 chip_smoke.py --times DIR   # NTT, Fiat-Shamir, Merkle, K7, K8 and K9 times of the checkout at DIR
    python3 chip_smoke.py --proves DIR  # warm fib-2^16 proves of the checkout at DIR, the collector paused
    python3 chip_smoke.py --precompile THREADS MODELS FIB_SHA CHAIN_SHA  # phase 9's child, alone

Phases (one line each; any failure raises and the exit code is non-zero):

1. environment: torch, CUDA, nvcc, the card's name and power limit, the
   build of the port's host C library and of the CUDA kernels (one nvcc
   per source, all started together), and the kernels' instructions read
   from the library's SASS (``ops/sass.py``) for the operation bounds,
   with each kernel's local-memory loads and stores;
2. each CUDA kernel against its plain PyTorch version on the card,
   bit-exact: the four-step NTT passes (forward, inverse and coset
   transforms at every size from 2^13 to 2^20 points, each timed, and
   a line of their launch shape, registers and resident blocks per SM
   at 2^17 and 2^20; untimed, the forward and coset-inverse transforms
   from 2^6 to 2^12, which a short trace's device interpolation runs on
   the card; K2 and K3 in clusters of 1, 2 and 4 blocks, at the shapes of
   a shard 1, 2 and 4 wide of 2^6, 2^8 and 2^10 points over
   ``MESH_SHARDS`` shards, with row/col multipliers, each timed), the Blake2b-256 leaf and level kernels at 2^20 (the leaf
   kernel on digits and on Montgomery limbs, as a prove runs it; the level
   kernel timed at every width of a 2^20 tree), the digit conversion
   (``mont_digits``) at ``DIGIT_SIZES`` against its plain version and the
   digits, each timed, and its gather form (``mont_digits_gather``) on 1
   and 27 codewords at ``gather_sizes`` indices (one launch a call under
   the struct's cap, two past it; no other operation on the card), timed
   at the fib and chain gathers' shapes, the launch floor (an empty
   kernel, ``timing.launch_floor_ms``), the top kernel at every width
   from 2 to 2^13 (0 local-memory instructions in its SASS; timed at
   every width against the chain of level launches it replaces, the
   split at ``TOP_WIDTH`` among them, with the marginal ms of each
   level), the subtrees kernel from every width 2^10 to 2^19 down to
   512 (timed against the chain of level launches it replaces; the
   prove's 11 trees split at each candidate ``SUBTREE_WIDTH``, failing if
   the constant's split takes more than 5 % longer than the cheapest), a
   2^13-leaf device tree (root and auth paths) against
   the host Merkle tree, the FRI fold at 2^13 and 2^20, and the
   Fiat-Shamir round at transcript bodies of 0 to 1000 bytes and at the 8
   bodies the fib-2^16 cascade extends (also against hashlib, those 8
   timed), and the field vector kernels (inversion with zeros mixed in,
   prefix product, power table, and the elementwise product, sum and
   difference with an (8, 1) column on either side) at the sizes of the
   fib-2^16 prove's trace interpolation and boundary quotients, each timed,
   and untimed on either side of one 2048-element inversion block and of
   2^20, the prefix product also at 2^21 + 1 and 2^23 (more tiles than
   the card holds at once; one launch a call, on inputs without a zero
   prefix), the inversion also with zeros at its blocks' first and last
   elements, a block of zeros and all zeros; the inversion's fixed work
   a block timed at one element and at one block; kernel times by CUDA
   events around launches queued back to back (``ops/timing.device_ms``),
   plain times around one call;
   the Rescue permutation kernel (R1) in both modes (the final state, all
   28 states) on edge states (every pair of ``rescue_edge_values``: 0, 1,
   p - 1, R mod p and words whose square is negative before fe_redc's
   correction) and at batches of 1 to 2^18 + 1 (``RESCUE_BATCHES``), 64
   instances also against the host ``RescuePrime.hash`` / ``trace``, every
   inverse S-box output of a 4096-instance trace cubed back to its input,
   each mode timed at 4096 and 2^18 instances (``RESCUE_TIMED``), with its
   registers, its products as run at its SASS prices (``as_run_ms``) and
   the clocks of one product on a round's dependent path at 4096;
   the combination kernel (K11) with fib's AIR structure at 2^13 and 2^20
   against its plain version (the program's interpreter), timed at 2^20,
   its bound from the distinct codewords it reads and the products a point
   its program needs; its next-row form (``combination_next``) at 2^13 and
   at a shard's 2^20 / ``MESH_SHARDS`` points, and K10's row-by-column form
   (``mont_outer``) at the sharded prove's table shapes, each against its
   plain version, timed at the mesh prove's largest shape;
2b. the TPU timing probes B1-B4 through their entry points
   (``stark_tpu_torch.benches``: ``lazy_limb_experiment``, ``quick_timing``,
   ``mont_mul_experiments``, ``merkle_roofline``, each ``run``), launch
   counts set to 0 just before and read just after, every probe kernel
   launched: each kernel bit-exact against its plain version at the
   probe's full shape (2^20 elements; a 2^20-wide level), B1-B3's chains
   also against Python ints, B3's base and hint16 against B2's chain of
   the field product, the 1- and 6-round kernels (the level kernel's
   template; at 12 rounds B4 runs the level kernel), B2's four-step
   transforms at 2^20 and 2^22 against the plain plan; the stub's
   function also as one library call (``torch.bitwise_xor``), checked
   and timed; a line a probe with its kernel, plain and bound ms (B2 and
   B3's base and hint16 also B2's bound): B1-B3 ms a full-array
   product and M products a second, B2 the forward, coset and inverse
   transforms, B3 whether hint16's SASS is base's, B4 the tree, leaf,
   level and stub ms, the 1, 6 and 12-round sweep, the marginal ms a
   round and the level kernel's "speed of light"; then the phase's
   seconds and launches;
3. FibonacciStark(1000) proved on the card, byte-identical to the port's
   host prover (no backend) on the same seeded randomness, its trace
   interpolated on the card (the host interpolation raises while the card
   proves); ``RescueStark.prove_batch`` of 8 inputs on the card (its
   witnesses from R1, whose counter must move in that run), and
   MimcStark(30) and RescueChainStark(4) through the device pipeline (its
   floor lowered to 512 points), each byte-identical to the
   host prover's; during each of these proves every arithmetic function
   of ``ops/field_ops.py`` counts its calls on CUDA tensors
   (``ops/guard.py``), and any such call fails the phase;
4. FibonacciStark(65536) proved on the card over its 2^20-point FRI
   domain, its trace interpolated on the card, with every launch counter
   but R1's and the probes' > 0 for that prove (theirs 0), ``merkle_top``
   once a tree, every opening gather of values one ``mont_digits_gather``
   launch and no other operation on the card (``watch_gathers``), the level
   kernel launched only on levels wider than ``SUBTREE_WIDTH`` and the
   subtrees kernel once a tree, the
   prefix product once a call at the sizes of ``PROVE_PREFIX_CALLS``, every
   NTT size it ran among those phase 2 checked (a line gives each size's
   launches beside its phase-2 times), and at least 2 FRI rounds fused
   into the device cascade; the proof must verify with the port's host
   verifier and a wrong claim must fail; then each kernel's device time
   in that prove: its launches at each size times its time at that size
   (timed in phase 2, or now for sizes phase 2 did not time), the level
   kernel's split into wide and middle levels, and the middle levels as
   the chain of level launches the subtrees kernel replaces; the cold and
   warm proves call no ``field_ops`` arithmetic on a CUDA tensor (the
   guard of phase 3), launch the combination once each and print its
   sub-regions (wall seconds, device ms), and the prove's AIR structure is
   the one phase 2 checked;
5. RescueChainStark(4096) on the card (114,688 rows, 2^20-point FRI
   domain): its AIR built once (the time on a line of its own), the host
   library's hash chain asserted as the witness's source, a cold and a
   warm prove with their stages, every kernel but R1 and the probes
   launched (counts set to 0 just before the cold prove, read just
   after; the probes' 0), its K8 calls and NTT sizes checked as in
   phase 4, peak device memory, the
   proof accepted by the port's host verifier and a wrong claim rejected,
   and by the card's model (its AIR values at the queries one gather
   launch from the prove's group codewords, watched as in phase 4),
   the guard and the one combination launch as in phase 4, the
   combination's cold and warm split, K11 with the chain's own structure
   and group codewords at 2^13 and 2^20 against its plain version (timed at
   2^20), and each kernel's device time in that prove;
6. the service (``stark_tpu_torch.serve``): ``make_server(ProverService(
   device="cuda"))`` on a free localhost port in a thread, then in order
   ``GET /healthz``; a fib-2^16 ``POST /prove`` (cold: the model built
   under the gate; then warm) that verifies through ``POST /verify``; a
   Rescue prove that verifies; a second prove while a first holds the gate
   (``queue_timeout_s`` lowered): 503 with Retry-After; ``steps`` = 2^17
   rejected with 4xx and no model built (``_build`` counted); hostile
   bodies (malformed JSON, not an object, unknown model, bad hex, a body
   over 64 MB) each 4xx; the request seconds;
7. the mesh (``stark_tpu_torch.parallel``): ``MESH_SHARDS`` shards on
   ``cuda:0``, or laid over every card where there are several; first the
   counterpart of the JAX package's multichip dryrun: ``ShardedNTT`` at
   n = 4096 (forward, inverse, the inverse from the four-step layout with
   a coset) against the one-device ``CudaNTT`` limb for limb, two
   shard-local folds against K6 on the whole codeword, a sharded tree's
   root and auth paths against the one-device tree's, and a batch of 32
   Rescue states split over the shards (one R1 launch a shard) against
   one R1 launch over the batch; the coset transform at 2^20 against
   ``CudaNTT``'s, and the device ms of the coset transform, a fold and a
   tree over the mesh beside one device's, and of a chunk exchange and
   the next-row operand, at 2^20; then FibonacciStark(65536) over the mesh
   with phase 4's seed and statement, byte-identical to phase 4's proof
   and verified by the host verifier, cold and warm (beside phase 4's
   seconds), with its launches of each kernel (every kernel of the
   sharded path > 0, K11's one-device form 0 and its next-row form once
   a shard), ``count_plain_calls`` 0, peak device MiB and the chunk
   exchanges' calls and bytes; then RescueChainStark(4) over
   ``MESH_SHARDS`` shards (its 1024-point domain gives a shard 4 columns
   and 4 rows: K2 and K3 in clusters of 4) with ``device_prover_min``
   1024, byte-identical to the host prover, its combination the next-row
   form, its NTT launches by size;
8. the mesh over two processes (``stark_tpu_torch.benches.multiprocess_mesh``,
   the multi-controller mode over ``torch.distributed``): 2 ranks of
   ``MESH_SHARDS`` / 2 shards each, both on ``cuda:0`` over gloo (NCCL
   refuses two ranks on one card), every crossing staged through host
   buffers; each rank checks the spanning mesh's transform at 2^20 (and its
   coset transform) against ``CudaNTT`` limb for limb, the round trip, a
   tree of 2^16 leaves against the one-device tree, proves and verifies
   its own Rescue statement, then proves FibonacciStark(65536) over the
   spanning mesh with phase 4's seed and statement, cold and warm: the
   proof byte-identical to phase 4's (its digest passed to the workers)
   and to the other rank's, accepted by the host verifier, committed
   through device subtrees spanning the ranks (``ShardedMerkleTree``), 0
   ``field_ops`` calls on CUDA tensors; a line with each rank's launches,
   exchanges (calls, bytes, ``remote_bytes``, ``staged_bytes``), cold and
   warm seconds and peak device MiB beside phase 7's, and the phase's
   seconds; a worker that fails or outlives ``MP_TIMEOUT_S`` is killed
   and the phase raises;
9. ``precompile`` in fresh child processes (``--precompile``), so that
   nothing the phases before cached is warm: with 6 threads,
   FibonacciStark(65536) with phase 4's seed, then RescueChainStark(4096)
   with phase 5's input (its AIR built first, timed apart), each the
   warm-up's job seconds, then the first and a warm prove (the collector
   paused in each, the allocator's reserved MiB after each), the first
   proof's SHA-256 equal to phase 4's or 5's and every kernel it launches
   launched by the warm-up; then fib-2^16 with one thread; a child that
   fails or outlives ``PRECOMPILE_TIMEOUT_S`` fails the phase; one line
   with both children's results beside phases 4 and 5's cold and warm
   seconds;
10. a JSON line of the kernels, K11 (``combination``), ``mont_digits`` and
   ``mont_digits_gather`` among them, and the variants of the sharded path,
   K11's next-row form (``combination_next``) and K10's row-by-column
   form (``mont_outer``), checked and timed in phase 2 at a shard's shape
   of the mesh prove (``launches``: the fib-2^16 prove's, the variants'
   in the mesh prove, R1's in prove_batch, the probes' in phase 2b;
   ``mesh_launches``: the mesh prove's; ``prove_ms`` and
   ``prove_bound_ms``: the fib-2^16 prove's, the variants' the mesh
   prove's (their launches at each size times their time and bound there);
   ``chain_launches`` and ``chain_prove_ms``: the chain prove's;
   ``multiprocess_launches``: phase 8's cold prove's, both ranks'; the
   probes' prove times null;
   ``library_ms`` the stub's library call, else null; K2 and K3 also
   ``cluster_widths``: phase 2's checks and times at each narrower
   cluster, with its launches in phase 7's chain-4;
   ``function_bound_ms`` B2's bound for the three chains of the field
   product, else null; ``launch_floor_ms`` the empty kernel's time beside
   the latency-bound kernels, else null),
   then the last line {"ok": true, "device": {...}}.

A kernel's bound is the larger of its bytes over the memory rate and its
warp instructions (counted in the SASS for this run's shapes) over the
issue and pipe rates of the card's SMs at their top clock.  K7-K10 and
R1 count field products, each priced at the instructions of one product
in K7's SASS: the fewest an element needs for K7-K10; for K11 the products
a point of its program (``program_products``).  R1's bound counts the
fewest products a permutation needs (131 an inverse S-box, Schoenhage's
lower bound for x^``RESCUE_ALPHA_INV``; 7,398 a permutation:
``rescue_products``), those of the S-boxes and the cube's x^2 at one
squaring of R1's own SASS (its innermost loop), the rest at the cheapest
general product in the library (``rescue_bound_split``, ``rescue_prices``);
R1 runs the chain of ``csrc/rescue.cu``'s tables (``sbox_chain``: 149
products, 128 squarings).  The probe kernels are straight-line
code: each is bound by its whole SASS a thread times its warps; B3's base
and hint16, which compute B2's function, also by B2's.

``--times DIR`` times the NTT passes at every size, the Fiat-Shamir round
at the cascade's 8 bodies, the middle levels of the prove's trees (2^13
to 2^17 wide, down to 512, as DIR routes them) and, where it has them, the
top Merkle kernel at every width from 2 to 2^13, the inversion (K7) and power table (K9)
at 1 (K7's fixed work a block), 65,545 and 2^20 elements, and the prefix
product (K8) at the prove's sizes, with the prove's sums, of the checkout at DIR (for
paired runs against another commit unpacked with ``git archive``) on
this checkout's inputs, timers and plain versions, one JSON line each,
after a line of the local-memory instructions, the Keccak round loop and
the price of a field product in DIR's library.

``--proves DIR`` proves FibonacciStark(65536) once cold and ``PROVE_RUNS``
times warm with the checkout at DIR, each warm prove after
``gc.collect()`` with Python's collector paused while it runs (otherwise
a collection of the whole heap, 0.2-0.3 s, lands in one prove or
another), and prints the wall seconds of each and the median of each
stage; for paired runs of two trees in one call.

The script imports nothing of JAX or of the ``stark_tpu`` package.
Without a CUDA device, or without the rest of the repository beside it,
it fails before printing any result.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import random
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
# every NTT size the fib-2^16 prove may run (2^13 up to its 2^20 FRI
# domain): each is checked and timed in phase 2, and phase 4 fails if the
# prove ran a size outside it
NTT_LOGNS = tuple(range(13, 21))

# HBM3 of the card (NVIDIA H100 SXM, 700 W) at 3.35 TB/s (data sheet)
MEM_BYTES_PER_S = 3.35e12
LIMB_BYTES = 32  # one field element: 8 int32 limbs
KECCAK_ROUNDS = 24
# the transcript body the first fused FRI round of a FibonacciStark prove
# extends: two boundary-quotient roots and the randomizer root, each a
# bincode string of 72 bytes; each later round appends its own root
FS_BODY_BYTES = 3 * 72
FS_CASCADE_BODIES = tuple(FS_BODY_BYTES + 72 * r for r in range(8))
# level widths the top kernel is checked and timed at, against the level
# launches it replaces: every width it takes, so that each level's
# marginal time is on record
TOP_SWEEP = tuple(1 << k for k in range(1, 14))
# the leaves of the fib-2^16 prove's 11 Merkle trees: 3 commitments on the
# 2^20-point FRI domain, then a tree a FRI round from 2^20 down to 2^13
PROVE_TREES = (1 << 20,) * 4 + tuple(1 << k for k in range(19, 12, -1))
# widths the subtrees kernel is timed at, from each down to TOP_WIDTH (512),
# against the chain of level launches it replaces: the candidate splits
SUBTREE_SWEEP = tuple(1 << k for k in range(10, 20))
# the field vector kernels' sizes in the fib-2^16 prove: its n = 65,537 + 8
# trace rows, n + 1 (q-factorials), 2n - 1 (the chirp convolution's table)
# and the 2^20-point FRI domain (boundary quotients); each kernel's row of
# the kernels line is at the size it runs longest in that prove
TRACE_ROWS = 65537 + 8
FIELD_SIZES = (TRACE_ROWS, TRACE_ROWS + 1, 2 * TRACE_ROWS - 1, 1 << 20)
FIELD_MAIN = {"mont_inv": 1 << 20, "prefix_mul": 2 * TRACE_ROWS - 1, "geometric_table": 1 << 20,
              "mont_binary": 1 << 20}
# K8's calls a fib-2^16 prove makes, by size: each of the two columns'
# interpolations scans its n q-factorial terms and four chirp tables
# (three of n, one of 2n - 1 elements; one of n + 1)
PROVE_PREFIX_CALLS = {TRACE_ROWS: 8, TRACE_ROWS + 1: 2, 2 * TRACE_ROWS - 1: 2}
# K8 is also checked (untimed) past the tiles the card holds at once
PREFIX_LARGE = ((1 << 21) + 1, 1 << 23)
# the chain prove's trace interpolation: RescueChainStark(4096)'s 28 * 4096
# rows + 8 randomizers, n + 1 and 2n - 1; checked (and its K8 calls
# counted) like the fib-2^16 prove's sizes
CHAIN_HASHES = 4096
CHAIN_INPUT = 123456789
CHAIN_ROWS = 28 * CHAIN_HASHES + 8
CHAIN_FIELD_SIZES = (CHAIN_ROWS, CHAIN_ROWS + 1, 2 * CHAIN_ROWS - 1)
CHAIN_PREFIX_CALLS = {CHAIN_ROWS: 8, CHAIN_ROWS + 1: 2, 2 * CHAIN_ROWS - 1: 2}
# R1's batches: one instance, prove_batch's 8, around a warp and a block of
# 64, a benchmark batch of 4096 (bench.py _bench_rescue) and past 2^18;
# timed at 4096 and 2^18; the kernels line's row is 4096 in trace mode
RESCUE_BATCHES = (1, 8, 31, 32, 33, 255, 4096, (1 << 18) + 1)
RESCUE_TIMED = (4096, 1 << 18)
RESCUE_MAIN = 4096
RESCUE_SOURCE = os.path.join(REPO, "stark_tpu_torch", "csrc", "rescue.cu")
# elements one K7 block inverts (csrc/fieldvec.cu kInvChunk); the field
# kernels are also checked, untimed, on either side of one such block and
# of the 2^20 domain, and K7 at zero patterns around its blocks
INV_CHUNK = 2048
FIELD_EDGES = (INV_CHUNK - 1, INV_CHUNK, INV_CHUNK + 1, (1 << 20) - 1, (1 << 20) + 1)
ZERO_SIZES = (INV_CHUNK + 1, (1 << 20) + 1)
# the four-step transforms the device trace interpolation of a short trace
# runs on the card (fib-1000, chain-4, MiMC-30): checked, untimed, in phase 2
SMALL_NTT_LOGNS = tuple(range(6, 13))
# FibonacciStark's AIR structure (per constraint: (tail over a, b, a', b';
# group codeword)), the combination kernel's program in phase 2 (phase 4
# asserts it is the prove's)
FIB_STRUCTURE = ((((0, 0, 1, 0), 0), ((1, 0, 0, 0), 1), ((0, 1, 0, 0), 2)),
                 (((0, 0, 0, 1), 3), ((1, 0, 0, 0), 4)))
# the digit conversion's sizes checked in phase 2: one value, a gather, odd
# and even around the FRI domain
DIGIT_SIZES = (1, 37, (1 << 20) - 1, 1 << 20)
# its gather form: the codewords of the checked gathers, and the
# (codewords, indices) of the two timed, fib's openings (a codeword's 4
# values) and the chain's AIR values (27 group codewords at 4 points)
GATHER_CODEWORDS = (1, 27)
GATHER_TIMED = {"fib": (1, 4), "chain": (27, 4)}
# the kernels bound by their latency at the main path's shape, beside which
# the kernels line sets the launch floor (an empty kernel's time)
# the mesh of phase 7: its shards
MESH_SHARDS = 8
# the widths of the NTT passes' clusters below 8 blocks, the shards of 2^6,
# 2^8 and 2^10 points over MESH_SHARDS shards (chain-4's 1024-point domain
# gives the 4-wide one), checked and timed in phase 2
NARROW_WIDTHS = (1, 2, 4)
# the kernels every per-shard step of the mesh prove runs (no cascade: no
# fs_round; host trace interpolation: no prefix_mul; blocks of 2^17: no
# level kernel)
MESH_PATH = ("ntt_pass1", "ntt_pass2", "mont_binary", "mont_inv", "geometric_table", "mont_outer", "merkle_leaves",
             "merkle_subtrees", "merkle_top", "fri_fold", "combination_next", "mont_digits", "mont_digits_gather")
# mont_outer's checked shapes (rows x columns): edges, then the fib-2^16
# mesh prove's tables (fold: C/2 x R/D as C halves; shift: C x R/D), the
# largest last
MESH_OUTER_SHAPES = ((1, 1), (3, 5), (1000, 7), (8, 128), (64, 128), (512, 128), (1024, 128))
LATENCY_BOUND = ("merkle_top", "fs_round", "mont_digits_gather")
# the mesh over processes (phase 8): its ranks, all on cuda:0, and the
# seconds after which the launcher kills them
MP_RANKS = 2
MP_TIMEOUT_S = 600
# the seconds after which a precompile child (phase 9) is killed
PRECOMPILE_TIMEOUT_S = 600
# the chain probes that compute the field product a * t^10 * 2^-1280: B2
# (``fe_mul``) and B3's base and hint16 (the TPU's 16-bit CIOS)
PROBE_FIELD_PRODUCT = ("probe_mont_chain", "probe_mont16_chain/base", "probe_mont16_chain/hint16")


def probe_tables(cuda_probes) -> dict:
    """Probe kernel (``kernels.PROBES``) -> (the part of its mangled name
    in the SASS, the TPU probe it replaces), B3's modes and B4's rounds
    numbered as ``cuda_probes`` numbers them."""
    mode = {f"probe_mont16_chain/{m}": (f"probe_mont16_chainILi{i}E", "benches/mont_mul_experiments.py:115")
            for m, i in cuda_probes.MODES.items()}
    rounds = {f"probe_level_rounds/{r}": (f"level_kernelILi{r}E", "benches/merkle_roofline.py:97")
              for r in cuda_probes.PROBE_ROUNDS}
    return {"probe_mont13_chain": ("probe_mont13_chain", "benches/lazy_limb_experiment.py:144"),
            "probe_mont_chain": ("probe_mont_chain", "benches/quick_pallas_timing.py:64"), **mode,
            "probe_level_stub": ("probe_level_stub", "benches/merkle_roofline.py:97"), **rounds}


def field_operands(limbs, field, params, n: int, dev):
    """The field kernels' seeded operands at n, made with the given
    modules of the port: a (zeros mixed in), b (no zero), and the power
    table's start and bit bases (of a primitive 2^21-th root)."""
    a = limbs.from_numpy(limbs.seeded_mont(max(n, 3), n)[:, :n], dev)
    a[:, 3::11] = 0
    # without seeded_mont's leading zero, so that b's prefix products are not all zero
    b = limbs.from_numpy(limbs.seeded_mont(max(n + 1, 3), n + 1)[:, 1 : n + 1], dev)
    root = field.FieldElement.primitive_nth_root(1 << 21).value
    bases = limbs.mont_tensor([pow(root, 1 << k, params.P) for k in range((n - 1).bit_length())], dev)
    return a, b, limbs.mont_tensor([params.GENERATOR], dev), bases


def combination_operands(limbs, structure, groups, n: int, seed: int, dev, num_bq: int = 2):
    """Seeded (8, n) Montgomery operands of the combination kernel, in the
    order of ``cuda_combination.combination`` after the program: 2 trace
    codewords, ``groups`` (a count: seeded; else the codewords), one
    zeroifier inverse and one shift table shared by every constraint (as a
    prove's one exemption set and one degree bound share them), randomizer,
    ``num_bq`` boundary quotients sharing one shift table, weights."""
    cws = iter(range(seed, seed + 10_000))

    def col():
        return limbs.from_numpy(limbs.seeded_mont(n, next(cws)), dev)

    k = len(structure)
    group_cws = [col() for _ in range(groups)] if isinstance(groups, int) else list(groups)
    tz, tq_tab, bq_tab = col(), col(), col()
    weights = limbs.from_numpy(limbs.seeded_mont(1 + 2 * (k + num_bq), seed), dev)
    return ([col(), col()], group_cws, [tz] * k, col(), [col() for _ in range(num_bq)], weights, [tq_tab] * k,
            [bq_tab] * num_bq)


def program_products(program) -> int:
    """Field products a point of an encoded combination: the powers (a
    square, and a product where the exponent is odd), each term's factors,
    and per quotient its zeroifier inverse (transition quotients only), its
    weight, its shift and that shift's weight; the randomizer's weight."""
    powers = sum(1 + (mul >= 0) for base, mul in program.powers if base >= 0)
    return (powers + sum(len(f) for _, f in program.terms) + 4 * program.n_constraints + 3 * program.n_bq + 1)


def combination_bytes(args) -> int:
    """Bytes the combination must move: each distinct input codeword read
    once, the weights, the combination and each transition quotient
    written once."""
    trace, groups, tz, rand, bq, weights, tq_tabs, bq_tabs = args
    inputs = {t.data_ptr(): t for t in [*trace, *groups, *tz, rand, *bq, *tq_tabs, *bq_tabs]}
    n = int(rand.shape[1])
    return LIMB_BYTES * (n * (len(inputs) + 1 + len(tz)) + int(weights.shape[1]))


def combination_split(profile) -> dict:
    """The combination stage of a prove and its sub-regions
    (``Stark._combination_device``), wall seconds each.  Their device time
    is read from a ``torch.profiler`` trace of the prove, in which a prove
    opens the ranges ``stark.protocol.combination/<sub-region>``
    (``stark_tpu_torch.utils.profiling``)."""
    split = {"stage_s": profile.totals.get("combination")}
    for name, wall in profile.totals.items():
        if name.startswith("combination/"):
            split[name.split("/", 1)[1]] = {"wall_s": wall}
    return split


def zero_patterns(a) -> dict:
    """K7's inputs with zeros where its blocks begin and end: the first
    and last element of the first two blocks and of the whole input, a
    whole block of zeros (where there are three blocks), and all zeros."""
    n = a.shape[1]
    edges = a.clone()
    edges[:, [0, INV_CHUNK - 1, INV_CHUNK, min(2 * INV_CHUNK - 1, n - 1), n - 1]] = 0
    out = {"block_edges": edges, "all_zero": a.new_zeros(a.shape)}
    if n > 2 * INV_CHUNK:
        out["zero_block"] = a.clone()
        out["zero_block"][:, INV_CHUNK : 2 * INV_CHUNK] = 0
    return out


def middle_levels(cuda_merkle, level):
    """The levels from ``level`` down to 512 wide as ``cuda_merkle``'s tree
    hashes them: the level kernel a level, where the module has the
    subtrees kernel only while wider than its SUBTREE_WIDTH, then one
    subtrees launch."""
    split = getattr(cuda_merkle, "SUBTREE_WIDTH", 512)
    while level.shape[1] > max(split, 512):
        level = cuda_merkle.merkle_level(level)
    if level.shape[1] > 512:
        level = cuda_merkle.merkle_subtrees(level, (level.shape[1] // 512).bit_length() - 1)[-8 * 512 :].view(8, 512)
    return level


def gather_sizes(cuda_merkle) -> tuple:
    """Indices a checked gather takes: one, fib's 4, 37, and one past the
    gather kernel's cap (two launches)."""
    return 1, 4, 37, cuda_merkle.GATHER_MAX_INDICES + 1


def gather_indices(n: int, k: int, seed: int) -> list:
    """k sorted distinct columns of an n-point codeword, its last (and,
    from two on, its first) among them."""
    if k == 1:
        return [n - 1]
    inner = random.Random(seed).sample(range(1, n - 1), k - 2)
    return [0] + sorted(inner) + [n - 1]


def gather_launches(cuda_merkle, codewords: int, k: int) -> int:
    """Launches of the gather kernel a gather of k indices from the given
    number of codewords takes: one a block of the struct's caps."""
    return -(-codewords // cuda_merkle.GATHER_MAX_CODEWORDS) * -(-k // cuda_merkle.GATHER_MAX_INDICES)


class watch_gathers:
    """Within the block, record every opening gather of values on the
    card: ``DeviceCodeword.gather_values_async`` (the FRI and boundary
    openings) and ``Stark._device_air_group_values`` (the AIR values a
    verify on the card reads): per call, its elements, its launches of the
    gather kernel and the other operations that put a tensor on the card
    (``guard.count_device_ops``; the fetch of the digits to the host puts
    none there).  :meth:`check` fails unless each call launched the kernel
    as often as its caps require and ran nothing else on the card but its
    wrapper's allocation and the fetch's view."""

    def __init__(self, kernels, guard, device_prover, stark_cls, cuda_merkle):
        self.kernels, self.guard, self.cuda_merkle = kernels, guard, cuda_merkle
        self.targets = [(device_prover.DeviceCodeword, "gather_values_async"),
                        (stark_cls, "_device_air_group_values")]
        self.calls = []

    def __enter__(self):
        self.originals = [(cls, name, getattr(cls, name)) for cls, name in self.targets]
        for cls, name, fn in self.originals:
            setattr(cls, name, self._watched(name, fn))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.originals:
            setattr(cls, name, fn)

    def _watched(self, name, fn):
        def call(*args, **kwargs):
            before = self.kernels.LAUNCHES["mont_digits_gather"]
            with self.guard.count_device_ops() as ops:
                out = fn(*args, **kwargs)
            self.calls.append({"site": name, "launches": self.kernels.LAUNCHES["mont_digits_gather"] - before,
                               "ops": dict(ops), "out": out})
            return out

        return call

    def check(self, what: str, sites) -> dict:
        """Each call's launches against its caps; returns a summary by site."""
        summary = {}
        for c in self.calls:
            out = c.pop("out")
            if c["site"] == "gather_values_async":  # (indices gathered, digits), ([], None) if all cached
                want = gather_launches(self.cuda_merkle, 1, len(out[0])) if out[0] else 0
            else:  # every group codeword of the AIR at the queries: under both caps
                want = 1
            other = {op: v for op, v in c["ops"].items()
                     if op not in self.guard.ALLOCATION and op != "aten.detach.default"}  # the fetch's view
            if other:
                raise AssertionError(f"{what}: an opening gather ({c['site']}) ran {other} on the card")
            if c["launches"] != want:
                raise AssertionError(f"{what}: an opening gather ({c['site']}) launched the gather kernel "
                                     f"{c['launches']} times, expected {want}")
            s = summary.setdefault(c["site"], {"calls": 0, "launches": 0})
            s["calls"] += 1
            s["launches"] += c["launches"]
        missing = [site for site in sites if site not in summary]
        if missing:
            raise AssertionError(f"{what}: no opening gather through {missing}")
        return summary


def rescue_state(limbs, b: int, seed: int, dev):
    """(8, 2, b) seeded Montgomery Rescue states."""
    return limbs.from_numpy(limbs.seeded_mont(2 * b + 1, seed)[:, 1:], dev).reshape(8, 2, b).contiguous()


def rescue_bound_split(params) -> tuple:
    """Field products one permutation needs at the least, by the kind R1's
    bound prices them at, (squarings, general products): each round cubes
    the two elements (x^2, then x^2 * x), mixes them twice (4 general
    products each) and takes two inverse S-boxes x^e, e =
    ``RESCUE_ALPHA_INV``.  A product chain for x^e is an addition chain for
    e, and none is shorter than log2 e + log2 popcount(e) - 2.13
    (Schoenhage, 1975): 131 products for this e, where csrc/rescue.cu's
    byte windows run 149 (a 4-bit window chain, 164).  Those 131 and the
    cube's x^2 count as squarings, the cube's x^2 * x and the mixes' as
    general products."""
    e = params.RESCUE_ALPHA_INV
    sbox = math.ceil(math.log2(e) + math.log2(bin(e).count("1")) - 2.13)
    return params.RESCUE_N * (2 * sbox + 2), params.RESCUE_N * (2 + 8)


def rescue_products(params) -> int:
    """:func:`rescue_bound_split`'s total: 7,398 products a permutation."""
    return sum(rescue_bound_split(params))


def sbox_chain(source: str = RESCUE_SOURCE) -> dict:
    """csrc/rescue.cu's inverse S-box chain: ``steps``, its products in order
    as (dst, a, b), v[dst] = v[a] * v[b] on registers v with v[0] = x on
    entry (a squaring when a == b): the ``kSetup`` steps, then each
    ``kWindows`` run ``repeat`` times (``squarings`` squarings of v[kAcc],
    then a product by v[factor]); ``acc``, the register of the result;
    ``unroll``, the squarings of each chain a pass of the windows' inner loop
    (``kSquaringUnroll``)."""
    text = open(source).read()

    def table(name):
        body = re.search(name + r"\[\w+\] = \{(.*?)\n    \};", text, re.S).group(1)
        return [tuple(map(int, m)) for m in re.findall(r"\{(\d+), (\d+), (\d+)\}", body)]

    def constant(name):
        return int(re.search(r"constexpr int " + name + r" = (\d+);", text).group(1))

    acc = constant("kAcc")
    steps = table("kSetup")
    for squarings, factor, repeat in table("kWindows"):
        steps += ([(acc, acc, acc)] * squarings + [(acc, acc, factor)]) * repeat
    return {"steps": steps, "acc": acc, "unroll": constant("kSquaringUnroll")}


def chain_counts(chain: dict) -> dict:
    """The chain's products, squarings, and products on the dependent path
    to its result."""
    steps = chain["steps"]
    depth = {0: 0}
    for dst, a, b in steps:
        depth[dst] = max(depth[a], depth[b]) + 1
    return {"products": len(steps), "squarings": sum(a == b for _, a, b in steps), "dependent": depth[chain["acc"]]}


def rescue_kernel_split(params, chain: dict) -> dict:
    """What R1 runs a permutation: (squarings, general products), each
    round two S-box chains, two cubes (x^2, x^2 * x) and two mixes of 4
    products; and the products on a round's dependent path (cube 2, mix 1,
    the S-box's, mix 1)."""
    c = chain_counts(chain)
    n = params.RESCUE_N
    return {"squarings": n * (2 * c["squarings"] + 2), "general": n * (2 * (c["products"] - c["squarings"]) + 2 + 8),
            "dependent": n * (2 + 1 + c["dependent"] + 1)}


def rescue_prices(sass, funcs, unroll: int):
    """(squaring, general product) in warp instructions of R1's SASS: a
    squaring, a (2 * ``unroll``)-th of its one innermost loop (``unroll``
    squarings of each of the two chains, no memory access); a general
    product, half of what the window loop around it adds (the two products
    by x^170, and that loop's counter)."""
    ins = sass.find(funcs, "rescue_kernel")
    inner = sass.loops(ins)
    if len(inner) != 1 or not inner[0].branch_free or {"LDG", "STG", "LDS", "STS"} & set(inner[0].opcodes):
        raise AssertionError(f"R1's SASS: expected one innermost loop of squarings, got {[dict(b.opcodes) for b in inner]}")
    window = sass.enclosing(ins)
    return inner[0].counts * (1 / (2 * unroll)), (window.counts + inner[0].counts * -1) * 0.5


def ptxas_registers(ptxas: str, kernel: str):
    """Registers a thread of the kernel whose mangled name holds ``kernel``,
    from nvcc's ``-Xptxas -v`` lines; None where they do not name it."""
    lines = ptxas.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for later in lines[k + 1 :]:
                m = re.search(r"Used (\d+) registers", later)
                if m:
                    return int(m.group(1))
    return None


def rescue_edge_values(params, count: int = 4) -> list:
    """Montgomery words that stress R1's products: 0, 1, p - 1, R mod p (the
    form of 1), then the first ``count`` of a seeded sequence whose
    Montgomery square (T - m p) / 2^128, m = T p^-1 mod 2^128, is negative
    before csrc/field.cuh's fe_redc corrects it."""
    p, r = params.P, 1 << 128
    p_inv = pow(p, -1, r)
    draw = random.Random(SEED)
    hits = []
    while len(hits) < count:
        x = draw.randrange(p)
        t = x * x
        if t - (t * p_inv % r) * p < 0:
            hits.append(x)
    return [0, 1, p - 1, params.R_MOD_P] + hits


def rescue_edge_state(limbs, params, dev):
    """(8, 2, n * n): every ordered pair of :func:`rescue_edge_values` as an
    instance's two state elements."""
    vals = rescue_edge_values(params)
    pairs = [(a, b) for a in vals for b in vals]
    flat = [a for a, _ in pairs] + [b for _, b in pairs]
    return limbs.from_numpy(limbs.pack(flat), dev).reshape(8, 2, len(pairs)).contiguous()


def sbox_cubes_back(torch, fo, limbs, params, states, consts) -> bool:
    """Every inverse S-box output of a (28, 8, 2, B) Montgomery trace cubed
    back to its input: with s_r the states and c1_r, c2_r round r's
    constants (columns 4 + 4r .. 7 + 4r of ``consts``), the S-box output
    t_r = MDS^-1 (s_{r+1} - c2_r) cubed must equal its input
    MDS s_r^3 + c1_r, in every round and instance."""
    mds_inv = limbs.mont_tensor([c % params.P for row in params.RESCUE_MDS_INV for c in row], states.device)
    rounds = consts[:, 4:].reshape(8, params.RESCUE_N, 4, 1)

    def mix(m, x):
        col = [m[:, k].reshape(8, 1, 1) for k in range(4)]
        x0, x1 = x[:, :, 0], x[:, :, 1]
        return torch.stack([fo.add(fo.mont_mul(col[0], x0), fo.mont_mul(col[1], x1)),
                            fo.add(fo.mont_mul(col[2], x0), fo.mont_mul(col[3], x1))], dim=2)

    def cube(x):
        return fo.mont_mul(fo.mont_sqr(x), x)

    before = states[:-1].permute(1, 0, 2, 3)  # (8, 27, 2, B)
    after = states[1:].permute(1, 0, 2, 3)
    sbox_in = fo.add(mix(consts[:, :4], cube(before)), rounds[:, :, 0:2])
    sbox_out = mix(mds_inv, fo.sub(after, rounds[:, :, 2:4]))
    return bool(torch.equal(cube(sbox_out), sbox_in))


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def max_abs_err(torch, got, want) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype mismatch: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def ntt_pass_times(torch, cuda_ntt, limbs, generator, dev, device_ms, call_ms) -> dict:
    """Pass 1 with the coset-forward tables (prologue and W) and pass 2
    with the inverse tables (epilogue), the prover's extension and
    restriction, on the (8, n) Montgomery limbs ``limbs``: checked bit for
    bit against their plain versions, then their kernel (device), call
    and plain ms."""
    plan = cuda_ntt.get_cuda_plan(limbs.shape[1], dev)
    x = limbs.reshape(8, plan.R, plan.C)
    w, tw_r, _, row, col = plan.op_tables(False, generator)
    _, _, tw_c, irow, icol = plan.op_tables(True, generator)
    y = cuda_ntt.ntt_pass1(x, tw_r, w, row, col)
    calls = {"ntt_pass1": (lambda: cuda_ntt.ntt_pass1(x, tw_r, w, row, col),
                           lambda: cuda_ntt.ntt_pass1_plain(x, tw_r, w, row, col)),
             "ntt_pass2": (lambda: cuda_ntt.ntt_pass2(y, tw_c, irow, icol),
                           lambda: cuda_ntt.ntt_pass2_plain(y, tw_c, irow, icol))}
    for name, (kernel, plain) in calls.items():
        if not torch.equal(kernel(), plain()):
            raise AssertionError(f"{name} disagrees with its plain version at n = {limbs.shape[1]}")
    return {name: {"kernel": device_ms(kernel), "call": call_ms(kernel), "plain": call_ms(plain)}
            for name, (kernel, plain) in calls.items()}


def keccak_round(sass, funcs):
    """The Fiat-Shamir kernel's Keccak round: its innermost loop with the
    most shuffles (the one-warp kernel), then the most logic instructions
    (the one-thread kernel of older trees, read by ``--times``)."""
    return max(sass.loops(sass.find(funcs, "fs_round_kernel")),
               key=lambda b: (b.opcodes["SHFL"], b.opcodes["LOP3"]))


def product_price(sass, funcs):
    """Warp instructions of one field product: a sixth of the body of the
    Fermat chain's window loop in K7 (5 squarings, a multiply), the one
    loop of K7 that touches no memory and has no barrier."""
    loops = sass.loops(sass.find(funcs, "inv_kernel"))
    chain = [b for b in loops if not {"LDS", "STS", "BAR", "LDG", "STG"} & set(b.opcodes)]
    if len(chain) != 1:
        raise AssertionError(f"K7's SASS has {len(chain)} product-only loops, expected the Fermat chain's one: "
                             f"{[dict(b.opcodes) for b in loops]}")
    return chain[0].counts * (1 / 6)


def local_memory(sass, funcs) -> dict:
    """Kernel name -> its local-memory loads and stores, where it has any."""
    counts = {name: sass.local_accesses(ins) for name, ins in funcs.items()}
    return {name: c for name, c in counts.items() if sum(c.values())}


def times_of(tree: str) -> int:
    """``--times DIR``: :func:`ntt_pass_times` of the checkout at ``tree``
    at every size, its Fiat-Shamir round at the cascade's bodies, its top
    Merkle kernel and its inversion (K7) and power table (K9), with this
    checkout's inputs, timers and plain versions."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device: this check needs one card")
    sys.path.insert(0, REPO)
    from stark_tpu_torch import field, params
    from stark_tpu_torch.ops import limbs as this_limbs
    from stark_tpu_torch.ops import sass
    from stark_tpu_torch.ops.cuda_field import geometric_table_plain
    from stark_tpu_torch.ops.device_fs import fs_round_plain
    from stark_tpu_torch.ops.device_merkle import level_hash
    from stark_tpu_torch.ops.field_ops import mont_inv as mont_inv_plain
    from stark_tpu_torch.ops.field_ops import prefix_mul as prefix_mul_plain
    from stark_tpu_torch.ops.limbs import seeded_mont
    from stark_tpu_torch.ops.timing import call_ms, device_ms

    for name in [m for m in sys.modules if m.split(".")[0] == "stark_tpu_torch"]:
        del sys.modules[name]  # the helpers above keep what they hold; the kernels come from `tree`
    sys.path[0] = os.path.abspath(tree)
    from stark_tpu_torch.ops import cuda_fs, cuda_merkle, cuda_ntt, kernels
    from stark_tpu_torch.params import GENERATOR

    if not os.path.abspath(cuda_ntt.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {cuda_ntt.__file__}, not the checkout at {tree}")
    dev = torch.device("cuda")
    kernels.library()
    funcs = sass.functions(sass.disassemble(str(kernels.build_info["path"]), kernels._nvcc()))
    say("sass_of", tree=tree, local_memory=local_memory(sass, funcs),
        keccak_round=dict(keccak_round(sass, funcs).opcodes),
        warp_instructions_per_product=product_price(sass, funcs)._asdict()
        if any("inv_kernel" in f for f in funcs) else None)
    for logn in NTT_LOGNS:
        limbs = torch.from_numpy(seeded_mont(1 << logn, logn).view(np.int32)).to(dev)
        say("ntt_times", tree=tree, n=1 << logn,
            **ntt_pass_times(torch, cuda_ntt, limbs, GENERATOR, dev, device_ms, call_ms))
    root = torch.arange(8, dtype=torch.int32, device=dev) * 0x1234567
    for body_len in FS_CASCADE_BODIES:
        body = torch.zeros(body_len + 72, dtype=torch.uint8, device=dev)
        if not torch.equal(cuda_fs.fs_round(body, body_len, 4, root), fs_round_plain(body.clone(), body_len, 4, root)):
            raise AssertionError(f"fs_round of {tree} disagrees with the plain version at a {body_len}-byte body")
        say("fs_times", tree=tree, body_bytes=body_len,
            kernel=device_ms(lambda: cuda_fs.fs_round(body, body_len, 4, root)))
    if hasattr(cuda_merkle, "merkle_top"):  # the trees since the top kernel
        for w in TOP_SWEEP:
            level = torch.from_numpy(np.ascontiguousarray(seeded_mont(max(w, 3), w)[:, :w]).view(np.int32)).to(dev)
            say("top_times", tree=tree, width=w, kernel=device_ms(lambda: cuda_merkle.merkle_top(level)))
    try:
        from stark_tpu_torch.ops import cuda_field  # the trees since the field kernels
    except ImportError:
        cuda_field = None
    # K7 at one element is one block's fixed work (a Fermat chain in every tree)
    for n in (1, TRACE_ROWS, 1 << 20) if cuda_field else ():
        a, _, start, bases = field_operands(this_limbs, field, params, n, dev)
        calls = {"mont_inv": (lambda: cuda_field.mont_inv(a), lambda: mont_inv_plain(a)),
                 "geometric_table": (lambda: cuda_field.geometric_table(start, bases, n),
                                     lambda: geometric_table_plain(start, bases, n))}
        for name, (kernel, plain) in calls.items():
            if not torch.equal(kernel(), plain()):
                raise AssertionError(f"{name} of {tree} disagrees with the plain version at n = {n}")
        say("field_times", tree=tree, n=n, **{name: device_ms(kernel) for name, (kernel, _) in calls.items()})
    # the middle levels of every tree of the prove, as DIR routes them, and
    # K8 at the prove's sizes, each summed over the prove's calls
    middle = {}
    for w in sorted({min(n, 1 << 17) for n in PROVE_TREES}):
        level = torch.from_numpy(seeded_mont(w, w).view(np.int32)).to(dev)
        want = level
        while want.shape[1] > 512:
            want = level_hash(want)
        if not torch.equal(middle_levels(cuda_merkle, level), want):
            raise AssertionError(f"the middle levels of {tree} disagree with the plain chain at width {w}")
        middle[w] = device_ms(lambda: middle_levels(cuda_merkle, level), 4)
    prefix = {}
    for n in PROVE_PREFIX_CALLS if cuda_field else ():
        b = field_operands(this_limbs, field, params, n, dev)[1]
        if not torch.equal(cuda_field.prefix_mul(b), prefix_mul_plain(b)):
            raise AssertionError(f"prefix_mul of {tree} disagrees with the plain version at n = {n}")
        prefix[n] = device_ms(lambda: cuda_field.prefix_mul(b))
    say("middle_and_prefix_times", tree=tree, middle_levels_ms=middle,
        middle_levels_prove_ms=sum(middle[min(n, 1 << 17)] for n in PROVE_TREES), prefix_mul_ms=prefix,
        prefix_mul_prove_ms=sum(c * prefix[n] for n, c in PROVE_PREFIX_CALLS.items()) if prefix else None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


# warm proves a --proves run times
PROVE_RUNS = 5


def proves_of(tree: str) -> int:
    """``--proves DIR``: the cold and ``PROVE_RUNS`` warm FibonacciStark(65536)
    proves of the checkout at ``tree``, on the card, the collector paused
    in each warm prove (see the module docstring)."""
    import gc
    import statistics

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device: this check needs one card")
    sys.path.insert(0, os.path.abspath(tree))
    from stark_tpu_torch.field import FieldElement
    from stark_tpu_torch.models import fibonacci
    from stark_tpu_torch.rng import DeterministicRandom

    if not os.path.abspath(fibonacci.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {fibonacci.__file__}, not the checkout at {tree}")
    model = fibonacci.FibonacciStark(65536, rng=DeterministicRandom(SEED))
    a, b = FieldElement(3), FieldElement(7)
    t0 = time.perf_counter()
    model.prove(a, b)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    walls, stages = [], []
    for _ in range(PROVE_RUNS):
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            model.prove(a, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        finally:
            gc.enable()
        stages.append(dict(model.stark.last_profile.totals))
    names = [k for k in stages[0] if "/" not in k or k.startswith("combination/")]
    medians = {k: statistics.median(s.get(k, 0.0) for s in stages) for k in names}
    say("warm_proves", tree=tree, cold_seconds=cold_s, warm_seconds=walls, warm_median=statistics.median(walls),
        stages_median=medians,
        unstaged_median=statistics.median(w - sum(v for k, v in s.items() if "/" not in k)
                                          for w, s in zip(walls, stages)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


def http(url: str, path: str, payload=None, body: bytes = None, headers=None):
    """(status, JSON body, headers) of one request to the service."""
    import urllib.error
    import urllib.request

    data = body if body is not None else None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def service_phase(fib_steps: int, fib_bytes: int) -> dict:
    """Phase 6: the service on the card, in a thread of this process; every
    failure raises."""
    import threading

    from stark_tpu_torch import serve

    service = serve.ProverService(device="cuda")
    built = []
    build = service._build
    service._build = lambda kind, key: built.append(key) or build(kind, key)
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    out = {}
    try:
        code, health, _ = http(url, "/healthz")
        if code != 200 or health != {"ok": True, "backend": "cuda", "models": serve.MODELS}:
            raise AssertionError(f"healthz: {code} {health}")
        fib = {"model": "fibonacci", "steps": fib_steps, "a": "3", "b": "7"}
        seconds = []
        for _ in range(2):  # cold (the model built under the gate), then warm
            t0 = time.perf_counter()
            code, proved, _ = http(url, "/prove", fib)
            seconds.append(time.perf_counter() - t0)
            if code != 200:
                raise AssertionError(f"the fib-{fib_steps} prove answered {code}: {proved}")
        code, verdict, _ = http(url, "/verify", dict(fib, proof=proved["proof"], output=proved["output"]))
        if code != 200 or verdict["valid"] is not True:
            raise AssertionError(f"the service's fib-{fib_steps} proof does not verify: {code} {verdict}")
        # a proof's length moves with the decimal lengths of the field
        # elements it holds (the service draws its randomness from the OS)
        if abs(proved["proof_bytes"] - fib_bytes) > 2048:
            raise AssertionError(f"the service's fib proof has {proved['proof_bytes']} bytes, phase 4's {fib_bytes}")
        code, wrong, _ = http(url, "/verify", dict(fib, proof=proved["proof"], output=["12345"]))
        if code != 200 or wrong["valid"] is not False:
            raise AssertionError(f"the service accepts a wrong fib output: {code} {wrong}")
        t0 = time.perf_counter()
        code, rescue, _ = http(url, "/prove", {"model": "rescue", "input": "12345"})
        rescue_s = time.perf_counter() - t0
        code_v, rescue_ok, _ = http(url, "/verify", {"model": "rescue", "proof": rescue.get("proof", ""),
                                                     "output": rescue.get("output")})
        if code != 200 or code_v != 200 or rescue_ok["valid"] is not True:
            raise AssertionError(f"the rescue prove / verify answered {code} / {code_v}: {rescue_ok}")
        # a prove holding the gate, and a second request that cannot wait
        held = {}
        first = threading.Thread(target=lambda: held.update(zip(("code", "body", "headers"), http(url, "/prove", fib))))
        service.queue_timeout_s = 0.2
        first.start()
        deadline = time.perf_counter() + 60
        while not service._work_gate.locked() and time.perf_counter() < deadline:
            time.sleep(0.001)
        code, busy, headers = http(url, "/prove", {"model": "rescue", "input": "1"})
        first.join()
        service.queue_timeout_s = 30.0
        if code != 503 or not headers.get("Retry-After") or held.get("code") != 200:
            raise AssertionError(f"the second prove under a held gate answered {code} ({busy}, Retry-After "
                                 f"{headers.get('Retry-After')}); the first {held.get('code')}")
        before = list(built)
        code, big, _ = http(url, "/prove", {"model": "fibonacci", "steps": 1 << 17})
        if not 400 <= code < 500 or built != before:
            raise AssertionError(f"steps = 2^17 answered {code} {big}, models built {built[len(before):]}")
        hostile = {"malformed": http(url, "/prove", body=b"{not json")[0],
                   "not_an_object": http(url, "/prove", body=b"[1]")[0],
                   "unknown_model": http(url, "/prove", {"model": "nope"})[0],
                   "bad_hex": http(url, "/verify", {"model": "rescue", "proof": "zz", "output": ["1"]})[0],
                   "too_large": http(url, "/prove", body=b"{}",
                                     headers={"Content-Length": str(serve.MAX_BODY_BYTES + 1)})[0]}
        if not all(400 <= c < 500 for c in hostile.values()):
            raise AssertionError(f"hostile bodies: {hostile}")
        out = {"healthz": health, "fib_steps": fib_steps, "cold_request_seconds": seconds[0],
               "warm_request_seconds": seconds[1], "prove_s": proved["prove_s"],
               "proof_bytes": proved["proof_bytes"], "verify_s": verdict["verify_s"],
               "rescue_request_seconds": rescue_s, "busy": {"status": 503, "retry_after": headers.get("Retry-After")},
               "oversized": {"status": code, "models_built": built}, "hostile": hostile}
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    return out


def mesh_phase(torch, dev, fib_steps: int, fib_claim, fib_proof: bytes, one_device: dict) -> dict:
    """Phase 7: the counterpart of the JAX package's multichip dryrun, then
    the fib-2^16 prove over the mesh against phase 4's proof (``fib_claim``:
    (a, b, result) of that prove; ``one_device``: its seconds and MiB),
    then chain-4 over a mesh of 4 against the host prover.  Every failure
    raises."""
    from stark_tpu_torch.field import FieldElement
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.models.rescue_chain import RescueChainStark
    from stark_tpu_torch.ops import cuda_ntt, cuda_rescue, guard, kernels, limbs
    from stark_tpu_torch.ops.device_merkle import DeviceMerkleTree
    from stark_tpu_torch.ops.device_prover import DeviceCodeword, get_core
    from stark_tpu_torch.ops.timing import device_ms
    from stark_tpu_torch.parallel import ShardedBackend, ShardedNTT, make_mesh
    from stark_tpu_torch.parallel.mesh import EXCHANGES, exchange, reset_exchange_counts
    from stark_tpu_torch.parallel.merkle_sharded import ShardedMerkleTree
    from stark_tpu_torch.parallel.stark_sharded import ShardedProverCore
    from stark_tpu_torch.params import GENERATOR, P
    from stark_tpu_torch.rng import DeterministicRandom

    mesh = make_mesh(MESH_SHARDS)  # round-robin over every card: all on cuda:0 where there is one
    out = {"mesh": [str(d) for d in mesh]}
    # 1. the sharded transform against the one-device plan, limb for limb
    n = 4096
    x = limbs.from_numpy(limbs.seeded_mont(n, 41), dev)
    plan = cuda_ntt.get_cuda_plan(n, dev)
    sntt = ShardedNTT(n, mesh)
    mat = sntt.shard_input(sntt.to_matrix(x))
    fwd = sntt.forward(mat)
    checks = {"forward": torch.equal(sntt.from_output_matrix(fwd), plan.forward(x)),
              "inverse": torch.equal(sntt.from_output_matrix(sntt.inverse(mat)), plan.inverse(x)),
              "coset_round_trip": torch.equal(
                  sntt.inverse_from_fourstep(sntt.forward(mat, GENERATOR), GENERATOR).gather().reshape(8, n), x)}
    # 2. two shard-local folds against K6 on the whole codeword
    m = 1 << 14
    core = ShardedProverCore(m, GENERATOR, mesh)
    whole_core = get_core(m, GENERATOR, dev)
    coeffs = [int(v) for v in limbs.unpack(limbs.seeded_mont(m // 4, 43))]
    cw, whole = core.extend_codeword(coeffs), whole_core.extend_codeword(coeffs)
    checks["extend"] = torch.equal(core.sntt.from_output_matrix(cw.mont), whole.mont)
    omega, offset = FieldElement.primitive_nth_root(m).value, GENERATOR
    for r, alpha in enumerate((1234567, 7654321)):
        cw, whole = core.fold(cw, alpha, offset, omega), whole_core.fold(whole, alpha, offset, omega)
        checks[f"fold_{r}"] = torch.equal(cw.mont.gather().reshape(8, -1), whole.mont)
        omega, offset = omega * omega % P, offset * offset % P
    # 3. a sharded tree (a device subtree a block) against the one-device tree
    t = 1 << 17
    tree_core = ShardedProverCore(t, GENERATOR, mesh)
    tcw = tree_core.extend_codeword(coeffs)
    tree = tree_core.merkle_tree(tcw)
    one = DeviceMerkleTree(get_core(t, GENERATOR, dev).extend(coeffs))
    picks = [0, 12345, t // 2 + 7, t - 1]
    checks["tree_is_sharded"] = isinstance(tree, ShardedMerkleTree)
    checks["tree_root"] = tree.root == one.root
    checks["tree_paths"] = all(tree.open(i) == one.open(i) for i in picks)
    # 4. the dryrun's batched Rescue: 32 states over the shards, one R1
    # launch a shard, against one launch over the batch
    states = limbs.from_numpy(limbs.seeded_mont(65, 47)[:, 1:], dev).reshape(8, 2, 32).contiguous()
    per = 32 // MESH_SHARDS
    for trace in (False, True):
        before = kernels.LAUNCHES["rescue_permutation"]
        parts = [cuda_rescue.rescue_permutation(states[:, :, s * per:(s + 1) * per].contiguous().to(d), trace)
                 .to(dev) for s, d in enumerate(mesh)]
        launched = kernels.LAUNCHES["rescue_permutation"] - before
        checks[f"rescue_{'trace' if trace else 'final'}"] = (
            launched == MESH_SHARDS and torch.equal(torch.cat(parts, dim=-1),
                                                    cuda_rescue.rescue_permutation(states, trace)))
    # each step over the mesh against one device at the prove's 2^20 points:
    # device time, a step's launches and copies queued twice behind a sleep
    n20 = 1 << 20
    big, one = ShardedProverCore(n20, GENERATOR, mesh), get_core(n20, GENERATOR, dev)
    x20 = limbs.from_numpy(limbs.seeded_mont(n20, 53), dev)
    s20 = big.sntt.shard_input(big.sntt.to_matrix(x20))
    plan20 = cuda_ntt.get_cuda_plan(n20, dev)
    cw20, whole20 = big.sntt.forward(s20, GENERATOR), plan20.coset_forward(x20, GENERATOR)
    checks["coset_forward_2e20"] = torch.equal(big.sntt.from_output_matrix(cw20), whole20)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"the mesh dryrun failed {failed}")
    out["dryrun"] = checks
    omega20 = FieldElement.primitive_nth_root(n20).value
    dcw_mesh, dcw_one = DeviceCodeword(cw20, big), DeviceCodeword(whole20, one)
    steps = {"coset_transform": (lambda: big.sntt.forward(s20, GENERATOR),
                                 lambda: plan20.coset_forward(x20, GENERATOR)),
             "exchange": (lambda: exchange(cw20), None),
             "next_rows": (lambda: big.next_rows(cw20, 4), None),
             "fold": (lambda: big.fold(dcw_mesh, 12345, GENERATOR, omega20),
                      lambda: one.fold(dcw_one, 12345, GENERATOR, omega20)),
             "tree": (lambda: big.merkle_tree(DeviceCodeword(cw20, big)), lambda: DeviceMerkleTree(whole20))}
    out["step_ms_2e20"] = {name: {"mesh": device_ms(on_mesh, 2), "one_device": device_ms(alone, 2) if alone else None}
                           for name, (on_mesh, alone) in steps.items()}
    del big, x20, s20, cw20, whole20, dcw_mesh, dcw_one, steps

    # the fib-2^16 prove over the mesh, phase 4's seed and statement
    a, b, result = fib_claim
    backend = ShardedBackend(mesh)
    model = FibonacciStark(fib_steps, backend=backend, rng=DeterministicRandom(SEED))
    if model.stark.fri_domain_length != 1 << 20 or not model.stark._use_device_pipeline():
        raise AssertionError("the mesh prove did not take the device pipeline on its 2^20-point domain")
    kernels.reset_launch_counts()
    reset_exchange_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with guard.count_plain_calls() as plain_cold:
        got_result, proof = model.prove(a, b)
        torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if k not in kernels.PROBES}
    variants_by_size = {size: {k: c for k, c in v.items() if k in kernels.MESH_VARIANTS}
                        for size, v in sorted(kernels.LAUNCHES_BY_SIZE.items())}
    variants_by_size = {size: v for size, v in variants_by_size.items() if v}
    exchanges = dict(EXCHANGES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    stages = {k: round(v, 4) for k, v in sorted(model.stark.last_profile.totals.items(), key=lambda kv: -kv[1])}
    if got_result != result or proof != fib_proof:
        raise AssertionError("the mesh's fib-2^16 proof differs from phase 4's one-device proof")
    if sum(plain_cold.values()):
        raise AssertionError(f"the mesh prove called field_ops on CUDA tensors: {dict(plain_cold)}")
    missing = [k for k in MESH_PATH if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the mesh prove never launched {missing}: {launches}")
    if launches["combination"] or launches["combination_next"] != MESH_SHARDS or launches["fs_round"]:
        raise AssertionError(f"the mesh prove's combination and cascade launches: {launches}")
    if model.stark.fri.last_fused_rounds:
        raise AssertionError("the mesh prove fused FRI rounds on a core without a cascade")
    t0 = time.perf_counter()
    ok = FibonacciStark(fib_steps, device=None).verify(a, b, result, proof)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the host verifier rejects the mesh's proof")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with guard.count_plain_calls() as plain_warm:
        model.prove(a, b)
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if sum(plain_warm.values()):
        raise AssertionError(f"the warm mesh prove called field_ops on CUDA tensors: {dict(plain_warm)}")
    out["fib"] = {"steps": fib_steps, "shards": MESH_SHARDS, "identical_to_one_device": True,
                  "proof_bytes": len(proof), "prove_seconds": cold_s, "warm_prove_seconds": warm_s,
                  "one_device": one_device, "verify_seconds": verify_s, "peak_device_mib": peak_mib,
                  "launches": launches, "variants_by_size": variants_by_size, "plain_field_ops_on_cuda": {"cold": sum(plain_cold.values()),
                                                                    "warm": sum(plain_warm.values())},
                  "exchanges": exchanges, "stages_seconds": stages}
    del model, backend

    # chain-4 over MESH_SHARDS shards: its 1024-point domain gives a shard 4
    # columns and 4 rows, so its K2/K3 run in clusters of 4
    chain_mesh = make_mesh(MESH_SHARDS)
    x = FieldElement(77)
    host = RescueChainStark(4, device=None, rng=DeterministicRandom(SEED))
    chain = RescueChainStark(4, backend=ShardedBackend(chain_mesh, device_prover_min=1024),
                             rng=DeterministicRandom(SEED))
    if not chain.stark._use_device_pipeline():
        raise AssertionError("chain-4 did not take the device pipeline over the mesh")
    kernels.reset_launch_counts()
    with guard.count_plain_calls() as plain_chain:
        chain_out = chain.prove(x)
    chain_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    shard_points = chain.stark.fri_domain_length // len(chain_mesh)
    chain_ntt_by_size = {n: {k: c for k, c in v.items() if k.startswith("ntt_")}
                         for n, v in sorted(kernels.LAUNCHES_BY_SIZE.items())}
    if chain_out != host.prove(x) or sum(plain_chain.values()):
        raise AssertionError(f"chain-4 over the mesh differs from the host prover (plain calls {dict(plain_chain)})")
    if chain_launches.get("combination_next") != len(chain_mesh) or chain_launches.get("combination"):
        raise AssertionError(f"chain-4 over the mesh launched {chain_launches}")
    if not chain_ntt_by_size.get(shard_points):
        raise AssertionError(f"chain-4 over the mesh ran no NTT pass on a shard's {shard_points} points")
    out["chain"] = {"hashes": 4, "shards": len(chain_mesh), "fri_domain": chain.stark.fri_domain_length,
                    "identical_to_host": True, "proof_bytes": len(chain_out[1]), "launches": chain_launches,
                    "shard_points": shard_points,
                    "ntt_launches_by_size": {n: v for n, v in chain_ntt_by_size.items() if v}}
    return out


def multiprocess_phase(fib_steps: int, fib_claim, fib_proof: bytes, mesh_fib: dict) -> dict:
    """Phase 8: the multi-controller launcher on the card, ``MP_RANKS``
    ranks on ``cuda:0`` over gloo; the workers prove phase 4's statement
    (``fib_claim``: (a, b, result)) and raise unless their proof's digest
    is phase 4's (``fib_proof``); ``mesh_fib``: phase 7's prove, printed
    beside.  Every failure raises."""
    from stark_tpu_torch.benches import multiprocess_mesh

    a, b, result = fib_claim
    digest = hashlib.sha256(fib_proof).hexdigest()
    ranks = multiprocess_mesh.run(
        ["--device", "cuda", "--backend", "gloo", "--ranks", str(MP_RANKS),
         "--shards-per-rank", str(MESH_SHARDS // MP_RANKS), "--log-n", "20", "--steps", str(fib_steps),
         "--inputs", str(a.value), str(b.value), "--seed", str(SEED), "--device-prover-min", str(1 << 12),
         "--warm", "1", "--expect-digest", digest, "--timeout", str(MP_TIMEOUT_S)])
    if [r["rank"] for r in ranks] != list(range(MP_RANKS)):
        raise AssertionError(f"the launcher returned ranks {[r['rank'] for r in ranks]}")
    per_rank = []
    for r in ranks:
        (fib,), ntt = r["fib"], r["ntt"]
        if not (ntt["n"] == 1 << 20 and ntt["identical_to_one_device"] and ntt["coset_identical_to_one_device"]
                and ntt["round_trip"] and r["tree"]["identical_to_one_device"]):
            raise AssertionError(f"rank {r['rank']}: the spanning transform or tree: {ntt}, {r['tree']}")
        if (fib["sha256"], fib["result"], fib["fri_domain"]) != (digest, result.value, 1 << 20):
            raise AssertionError(f"rank {r['rank']}'s fib proof is not phase 4's")
        if not (fib["verified"] and fib["ranks_agree"] and fib["plain_field_ops_on_cuda"] == 0 and r["staged"]
                and r["rescue"]["verified"] and fib["commitments"].get("ShardedMerkleTree", 0) > 0):
            raise AssertionError(f"rank {r['rank']}: {fib}")
        launches = fib["launches"]
        missing = [k for k in MESH_PATH if k != "mont_digits_gather" and launches.get(k, 0) <= 0]
        if missing or launches.get("combination") or launches.get("fs_round") or \
                launches.get("combination_next") != MESH_SHARDS // MP_RANKS:
            raise AssertionError(f"rank {r['rank']} launched {launches} (never {missing})")
        ex = fib["exchanges"]
        if ex["remote_bytes"] <= 0 or ex["staged_bytes"] <= 0:
            raise AssertionError(f"rank {r['rank']}: nothing crossed ranks: {ex}")
        per_rank.append({"rank": r["rank"], "device": r["device"], "card": r["card"], "launches": launches,
                         "exchanges": ex, "commitments": fib["commitments"], "prove_seconds": fib["prove_seconds"],
                         "warm_prove_seconds": fib["warm_prove_seconds"], "peak_device_mib": fib["peak_device_mib"],
                         "verify_seconds": fib["verify_seconds"], "ntt_forward_seconds_2e20": ntt["forward_seconds"],
                         "rescue_proof_bytes": r["rescue"]["proof_bytes"]})
    gathers = sum(r["launches"].get("mont_digits_gather", 0) for r in per_rank)
    if gathers <= 0:
        raise AssertionError("no rank launched the opening gather")
    staged, remote = (sum(r["exchanges"][k] for r in per_rank) for k in ("staged_bytes", "remote_bytes"))
    if staged != 2 * remote:
        raise AssertionError(f"staged {staged} bytes for {remote} that crossed ranks")
    return {"ranks": MP_RANKS, "shards": MESH_SHARDS, "backend": "gloo", "identical_to_one_device": True,
            "proof_bytes": ranks[0]["fib"][0]["proof_bytes"], "per_rank": per_rank,
            "mesh_one_process": {k: mesh_fib[k] for k in ("prove_seconds", "warm_prove_seconds", "peak_device_mib")}}


def precompile_of(threads: int, models: str, fib_digest: str, chain_digest: str) -> int:
    """``--precompile THREADS MODELS FIB_SHA256 CHAIN_SHA256``, in a fresh
    process: for each of MODELS ("fib", "chain", comma-separated) the
    model of phase 4 (fib-2^16) or phase 5 (chain-4096, its AIR built
    first) on the card, ``precompile(threads=THREADS)``, then its first
    and a warm prove, with phase 4's and phase 5's seeds and inputs.  The
    first proof's SHA-256 must be the given one ("-": not checked), and
    every kernel the first prove launches must have been launched by the
    precompile; both proves run with the collector paused.  Prints one
    JSON line, and raises on any failure."""
    import gc

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device: this check needs one card")
    sys.path.insert(0, REPO)
    from stark_tpu_torch.field import FieldElement
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.models.rescue_chain import RescueChainStark
    from stark_tpu_torch.ops import kernels
    from stark_tpu_torch.rng import DeterministicRandom

    def measure(model, prove, digest: str) -> dict:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        jobs = model.precompile(threads=threads)
        torch.cuda.synchronize()
        precompile_s = time.perf_counter() - t0
        warmed = {k for k, v in kernels.LAUNCHES.items() if v}
        kernels.reset_launch_counts()

        def timed():
            """(proof, seconds, stages, reserved MiB after) of one prove, the
            collector paused (a collection of the AIR's heap lands in one
            prove or another, as in --proves)."""
            gc.collect()
            gc.disable()
            try:
                t0 = time.perf_counter()
                proof = prove()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            finally:
                gc.enable()
            totals = model.stark.last_profile.totals
            stages = {k: v for k, v in sorted(totals.items(), key=lambda kv: -kv[1])
                      if "/" not in k or k.startswith("combination/")}
            return proof, seconds, stages, torch.cuda.memory_reserved() / 2**20

        reserved_mib = torch.cuda.memory_reserved() / 2**20
        proof, first_s, first_stages, first_reserved = timed()
        unwarmed = sorted(k for k, v in kernels.LAUNCHES.items() if v and k not in warmed)
        _, warm_s, warm_stages, warm_reserved = timed()
        sha = hashlib.sha256(proof).hexdigest()
        if digest != "-" and sha != digest:
            raise AssertionError(f"the proof after precompile is not the one of the phase it repeats ({sha})")
        if unwarmed:
            raise AssertionError(f"the first prove after precompile launched kernels precompile did not: {unwarmed}")
        return {"precompile_seconds": precompile_s, "jobs_seconds": jobs, "first_prove_seconds": first_s,
                "warm_prove_seconds": warm_s, "proof_bytes": len(proof), "sha256": sha,
                "first_stages_seconds": first_stages, "warm_stages_seconds": warm_stages,
                "reserved_mib": {"after_precompile": reserved_mib, "after_first": first_reserved,
                                 "after_warm": warm_reserved}}

    out = {"threads": threads}
    for name in models.split(","):
        if name == "fib":
            fib = FibonacciStark(65536, rng=DeterministicRandom(SEED))
            a, b = FieldElement(3), FieldElement(7)
            out["fib"] = measure(fib, lambda: fib.prove(a, b)[1], fib_digest)
        elif name == "chain":
            chain = RescueChainStark(CHAIN_HASHES, rng=DeterministicRandom(SEED))
            t0 = time.perf_counter()
            chain.constraints  # the AIR, built on the host before the warm-up
            air_s = time.perf_counter() - t0
            x = FieldElement(CHAIN_INPUT)
            out["chain"] = dict(measure(chain, lambda: chain.prove(x)[1], chain_digest), air_seconds=air_s)
        else:
            raise ValueError(f"unknown model {name!r}")
    print(json.dumps(out), flush=True)
    return 0


def precompile_phase(fib_digest: str, chain_digest: str) -> dict:
    """Phase 9: :func:`precompile_of` in fresh child processes, so that
    nothing the phases before cached is warm: the pool's ``threads`` = 6
    on fib-2^16 and chain-4096, then one thread on fib-2^16.  A child
    that fails or outlives ``PRECOMPILE_TIMEOUT_S`` fails the phase."""
    out = {}
    for threads, models in ((6, "fib,chain"), (1, "fib")):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--precompile", str(threads), models,
                               fib_digest, chain_digest], capture_output=True, text=True,
                              timeout=PRECOMPILE_TIMEOUT_S, cwd=REPO)
        if proc.returncode != 0:
            raise AssertionError(f"the precompile child ({threads} threads, {models}) failed with "
                                 f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        out[f"threads_{threads}"] = json.loads(proc.stdout.strip().splitlines()[-1])
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA device: this check needs one card")

    from stark_tpu_torch import native
    from stark_tpu_torch.field import FieldElement
    from stark_tpu_torch.merkle import MerkleTree
    from stark_tpu_torch import RescuePrime
    from stark_tpu_torch.models import rescue_chain
    from stark_tpu_torch.models.fibonacci import FibonacciStark
    from stark_tpu_torch.models.mimc import MimcStark
    from stark_tpu_torch.models.rescue_chain import RescueChainStark
    from stark_tpu_torch.models.rescue_stark import RescueStark
    from stark_tpu_torch.ntt import NTT
    from stark_tpu_torch.ops import (cuda_combination, cuda_field, cuda_fold, cuda_fs, cuda_merkle, cuda_ntt,
                                     cuda_rescue, guard, kernels)
    from stark_tpu_torch.ops import device_merkle as dm
    from stark_tpu_torch.ops import field_ops as fo
    from stark_tpu_torch.ops.device_fs import fs_round_plain
    from stark_tpu_torch.ops.fold import fold_mont
    from stark_tpu_torch.ops import sass
    from stark_tpu_torch.ops.limbs import _fold_tables, from_numpy, pack, seeded_mont, to_numpy, unpack
    from stark_tpu_torch.ops import device_prover
    from stark_tpu_torch.ops.timing import call_ms, device_ms, launch_floor_ms
    from stark_tpu_torch.params import GENERATOR, P, R_MOD_P
    from stark_tpu_torch.rng import DeterministicRandom
    from stark_tpu_torch.stark import Stark

    dev = torch.device("cuda")
    # the kernels of the proving pipeline (the fib and chain paths); R1 runs
    # on prove_batch's, the probes on their own (phase 2b)
    pipeline = [k for k in kernels.LAUNCHES
                 if k != "rescue_permutation" and k not in kernels.PROBES and k not in kernels.MESH_VARIANTS]

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

    # the operation side of each kernel's bound: its warp instructions in
    # the library's SASS, over the card's SMs at their top clock
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    funcs = sass.functions(sass.disassemble(str(kernels.build_info["path"]), kernels._nvcc()))

    def bound(bytes_moved: float, counts):
        """(bound_ms, bound_by): the larger of the memory and instruction times."""
        mem_ms = bytes_moved / MEM_BYTES_PER_S * 1e3
        ops_ms = counts.seconds(sms, clock_hz) * 1e3
        return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")

    def ntt_counts(pass1: bool, log_l: int, log_b: int):
        """Warp instructions of one pass (the kernel with row/col
        multipliers, in clusters as wide as ``launch_shape`` picks): each
        loop's body times the iterations of its 2^log_b blocks, 32 threads
        a warp; the code around the loops is not counted."""
        L = 1 << log_l
        shape = cuda_ntt.launch_shape(log_l, log_b)
        tw_shared = shape.smem_bytes == 2 * 16 * L
        log_cluster = shape.cluster.bit_length() - 1
        body = sass.loops(sass.find(
            funcs, f"ntt_pass_kernelILb{int(pass1)}ELb{int(tw_shared)}ELb1ELi{log_cluster}EE"))
        # [twiddle load], load, radix-4 step, radix-2 stage, store
        if (len(body) != 4 + tw_shared or not all(b.branch_free for b in body)
                or (body[-3].opcodes["STS"], body[-2].opcodes["STS"], body[-1].opcodes["STG"]) != (4, 2, 8)):
            raise AssertionError(f"unexpected loops in the NTT pass kernel's SASS: {[dict(b.opcodes) for b in body]}")
        iterations = [L] * tw_shared + [L, log_l // 2 * L // 4, log_l % 2 * L // 2, L]
        return sum((b.counts * (i * (1 << log_b) / 32) for b, i in zip(body, iterations)), sass.Counts())

    def per_thread(kernel: str, *iterations: int):
        """Warp instructions a warp of ``kernel`` runs when its innermost
        loops, in address order, run ``iterations`` times: every
        instruction once, each loop's body its iterations - 1 times more."""
        ins = sass.find(funcs, kernel)
        body = sass.loops(ins)
        if len(body) != len(iterations):
            raise AssertionError(f"{kernel}: {len(body)} innermost loops in its SASS, expected {len(iterations)}")
        return sass.count(ins) + sum((b.counts * (i - 1) for b, i in zip(body, iterations)), sass.Counts())

    product = product_price(sass, funcs)
    round_loop = keccak_round(sass, funcs)
    # K4 as the prove runs it, on Montgomery limbs (the reduction in its
    # loads); its digit form, and the conversion alone (mont_digits)
    per_unit = {"merkle_leaves": sass.straight_line(sass.find(funcs, "leaf_kernelILb1E")),
                "merkle_leaves_digits": sass.straight_line(sass.find(funcs, "leaf_kernelILb0E")),
                "mont_digits": sass.straight_line(sass.find(funcs, "mont_digits_kernel")),
                "mont_digits_gather": sass.straight_line(sass.find(funcs, "mont_digits_gather_kernel")),
                "merkle_level": sass.straight_line(sass.find(funcs, "level_kernelILi12E")),
                "fri_fold": sass.straight_line(sass.find(funcs, "fold_kernel")),
                "keccak_round": round_loop.counts}

    def subtree_bound(w: int, depth: int):
        """The level in, each of its w - w / 2^depth parents out once; K5's
        instructions a compress."""
        parents = w - (w >> depth)
        return bound(32 * w + 32 * parents, per_unit["merkle_level"] * (parents / 32))

    def bound_at(name: str, size: int):
        """(bound_ms, bound_by) of one call of a Merkle, fold, Fiat-Shamir
        or field kernel at its launch size (leaves, level width, codeword
        length, body bytes, elements); the NTT passes' are computed in
        phase 2."""
        if name == "merkle_leaves":  # 8 Montgomery limbs in, 8 digest words out a leaf
            return bound(64 * size, per_unit[name] * (size / 32))
        if name == "merkle_leaves_digits":  # 4 digit words in, 8 digest words out a leaf
            return bound(48 * size, per_unit[name] * (size / 32))
        if name in ("mont_digits", "mont_digits_gather"):  # 8 Montgomery limbs in, 4 digit words out
            return bound(48 * size, per_unit[name] * (size / 32))
        if name == "merkle_level":  # two children in, one parent out
            return bound(48 * size, per_unit[name] * (size / 2 / 32))
        if name == "merkle_subtrees":  # the prove's launches: down to TOP_WIDTH
            return subtree_bound(size, (size // cuda_merkle.TOP_WIDTH).bit_length() - 1)
        if name == "merkle_top":  # the level in, every parent out, once each; K5's instructions a compress
            return bound(32 * size + 32 * (size - 1), per_unit["merkle_level"] * ((size - 1) / 32))
        if name == "fri_fold":  # codeword, table, alpha in; half the codeword out
            return bound(LIMB_BYTES * (size + size // 2 + 1 + size // 2), per_unit[name] * (size / 2 / 32))
        if name == "fs_round":  # body, root, 72 appended bytes, alpha; one warp runs the round loop
            blocks = (8 + size + 72) // 136 + 1
            return bound(size + 32 + 72 + 32, per_unit["keccak_round"] * (blocks * KECCAK_ROUNDS))
        # the field functions: each input read once, each output written
        # once, and the fewest products the function needs, not the ones the
        # kernel runs: ~3 an element for an inversion (Montgomery's batch
        # inversion), 1 for a prefix product, a power table or a product
        warps = size / 32
        if name == "mont_inv":
            return bound(2 * LIMB_BYTES * size, product * (3 * warps))
        if name == "prefix_mul":
            return bound(2 * LIMB_BYTES * size, product * warps)
        if name == "geometric_table":  # start and bit bases in, the table out
            return bound(LIMB_BYTES * (size + (size - 1).bit_length() + 1), product * warps)
        if name == "mont_binary":  # the product of two full operands
            return bound(3 * LIMB_BYTES * size, product * warps)
        if name == "mont_outer":  # a row and a column table in, their product out
            cols = MESH_OUTER_SHAPES[-1][1]
            return bound(LIMB_BYTES * (size + size // cols + cols), product * warps)
        raise AssertionError(f"no bound for {name}")

    # the top kernel: its one innermost loop is a thread a parent (the wide
    # levels); the quad compress of the narrow levels is straight-line code
    # in the level loop around it
    top_ins = sass.find(funcs, "top_kernel")
    top_loops = sass.loops(top_ins)
    lmem = local_memory(sass, funcs)
    spilled = [k for k in lmem if "top_kernel" in k or "mont_digits_gather_kernel" in k]
    if spilled:
        raise AssertionError(f"local-memory instructions in the top or gather kernel: {[lmem[k] for k in spilled]}")
    say("sass", sms=sms, clock_mhz=clock_hz / 1e6, local_memory=lmem,
        keccak_round_opcodes=dict(round_loop.opcodes), branch_free={"keccak_round": round_loop.branch_free},
        top_kernel={"all": sass.count(top_ins)._asdict(), "local_memory": sass.local_accesses(top_ins),
                    "shuffles": sum(sass.opcode(i) == "SHFL" for _, i in top_ins),
                    "innermost_loops": [dict(b.counts._asdict(), **b.opcodes) for b in top_loops]},
        warp_instructions_per_thread={k: v._asdict() for k, v in per_unit.items()},
        warp_instructions_2e20={"ntt_pass1": ntt_counts(True, 10, 10)._asdict(),
                                "ntt_pass2": ntt_counts(False, 10, 10)._asdict()})

    # -- 2. kernels against their plain versions on the card ------------------
    rng = np.random.default_rng(SEED)

    def seeded_values(n):
        vals = [int(v) % P for v in rng.integers(0, 1 << 63, n, dtype=np.uint64)]
        vals = [v * (1 + (i % 7) * (1 << 64)) % P for i, v in enumerate(vals)]
        vals[:3] = [0, 1, P - 1]
        return vals

    report = {}  # kernel -> (kernel ms, plain ms, bound ms, bound by) at the main path's shape
    errs = {}
    ntt_sizes = {}  # n -> pass -> blocks, kernel/call/plain/bound ms at that size
    for logn in NTT_LOGNS:
        n = 1 << logn
        vals = seeded_values(n) if logn == 13 else None
        a = from_numpy(pack([v * R_MOD_P % P for v in vals]) if vals else seeded_mont(n, logn), dev)
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
        # time the extend and restrict shapes; one block a transform
        R, C = plan.R, plan.C
        log_r, log_c = R.bit_length() - 1, C.bit_length() - 1
        ntt_sizes[n] = ntt_pass_times(torch, cuda_ntt, a, GENERATOR, dev, device_ms, call_ms)
        for name, blocks, bytes_moved, counts in (
                ("ntt_pass1", C, LIMB_BYTES * (3 * n + 2 * R + C), ntt_counts(True, log_r, log_c)),
                ("ntt_pass2", R, LIMB_BYTES * (2 * n + 2 * C + R), ntt_counts(False, log_c, log_r))):
            ntt_sizes[n][name].update(zip(("blocks", "bound", "bound_by"), (blocks, *bound(bytes_moved, counts))))
        if logn == 20:
            report.update({k: (v["kernel"], v["plain"], v["bound"], v["bound_by"]) for k, v in ntt_sizes[n].items()})
            errs.update(ntt_pass1=0, ntt_pass2=0)
        say("ntt_kernels", n=n, R=R, C=C, max_abs_err=ntt_errs, ms=ntt_sizes[n])
    # the small transforms of a short trace's device interpolation (64 to
    # 4096 points, R and C down to one cluster of 8), untimed
    small_ntt_errs = {}
    for logn in SMALL_NTT_LOGNS:
        n = 1 << logn
        plan = cuda_ntt.get_cuda_plan(n, dev)
        x = from_numpy(seeded_mont(n, logn), dev).reshape(8, plan.R, plan.C)
        for name, inverse, offset in (("forward", False, 1), ("coset_inverse", True, GENERATOR)):
            w, tw_r, tw_c, row, col = plan.op_tables(inverse, offset)
            pro = not inverse and row is not None
            y = cuda_ntt.ntt_pass1(x, tw_r, w, row if pro else None, col if pro else None)
            z = cuda_ntt.ntt_pass2(y, tw_c, row if inverse else None, col if inverse else None)
            small_ntt_errs[f"2^{logn} {name}"] = (
                max_abs_err(torch, y, cuda_ntt.ntt_pass1_plain(x, tw_r, w, row if pro else None, col if pro else None)),
                max_abs_err(torch, z, cuda_ntt.ntt_pass2_plain(y, tw_c, row if inverse else None,
                                                               col if inverse else None)))
    if any(v != (0, 0) for v in small_ntt_errs.values()):
        raise AssertionError(f"NTT kernels disagree with their plain versions at the small sizes: {small_ntt_errs}")
    say("ntt_small_sizes", max_abs_err=small_ntt_errs)
    # K2/K3 in clusters narrower than 8 blocks: a shard of n = 64 w^2
    # points over MESH_SHARDS shards is w columns (K2: (8, R, w)) and w
    # rows (K3: (8, w, C)) wide, R = C = 8 w; each width against its plain
    # version with row/col multipliers, timed (launches: phase 7's)
    ntt_widths = {}
    for width in NARROW_WIDTHS:
        L = 8 * width
        log_l, log_w = L.bit_length() - 1, width.bit_length() - 1

        def operand(*shape, seed):
            size = math.prod(shape)
            return from_numpy(np.ascontiguousarray(seeded_mont(max(size, 3), seed)[:, :size]), dev).reshape(8, *shape)

        tw = from_numpy(cuda_ntt._pack_stage_twiddles(L, False), dev)
        x1, w1 = operand(L, width, seed=width), operand(L, width, seed=width + 10)
        y2 = operand(width, L, seed=width + 20)
        row, col = operand(L, seed=width + 30), operand(width, seed=width + 40)
        calls = {"ntt_pass1": (lambda: cuda_ntt.ntt_pass1(x1, tw, w1, row, col),
                               lambda: cuda_ntt.ntt_pass1_plain(x1, tw, w1, row, col)),
                 "ntt_pass2": (lambda: cuda_ntt.ntt_pass2(y2, tw, row, col),
                               lambda: cuda_ntt.ntt_pass2_plain(y2, tw, row, col))}
        n_shard = L * width
        bytes_moved = {"ntt_pass1": LIMB_BYTES * (3 * n_shard + 2 * L + width),
                       "ntt_pass2": LIMB_BYTES * (2 * n_shard + 2 * L + width)}
        for name, (kernel, plain) in calls.items():
            if cuda_ntt.launch_shape(log_l, log_w).cluster != width:
                raise AssertionError(f"{name} of a {width}-wide shard does not run in clusters of {width}")
            err = max_abs_err(torch, kernel(), plain())
            if err:
                raise AssertionError(f"{name} in clusters of {width} disagrees with its plain version: {err}")
            ntt_widths.setdefault(name, {})[width] = dict(
                zip(("bound_ms", "bound_by"), bound(bytes_moved[name], ntt_counts(name == "ntt_pass1", log_l, log_w))),
                max_abs_err=err, ms=device_ms(kernel), plain_ms=call_ms(plain), shard_points=n_shard)
    say("ntt_cluster_widths", **ntt_widths)
    say("ntt_occupancy", **{f"2^{logn}": {
        "ntt_pass1": cuda_ntt.occupancy(logn // 2, logn - logn // 2, True, device=dev),
        "ntt_pass2": cuda_ntt.occupancy(logn - logn // 2, logn // 2, False, device=dev)} for logn in (17, 20)})

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
    # K4 on the Montgomery codeword of the same values, as a prove's trees
    # run it, and the digit conversion alone (mont_digits), at one value, a
    # gather's size and around 2^20
    mont = from_numpy(pack([v * R_MOD_P % P for v in vals]), dev)
    leaves_mont = cuda_merkle.merkle_leaves_mont(mont)
    errs["merkle_leaves"] = max(errs["merkle_leaves"], max_abs_err(torch, leaves_mont, leaves),
                                max_abs_err(torch, leaves_mont, cuda_merkle.merkle_leaves_mont_plain(mont)))
    digit_errs = {}
    for k in DIGIT_SIZES:
        cols = mont[:, -k:].contiguous()
        got = cuda_merkle.mont_digits(cols)
        digit_errs[k] = max(max_abs_err(torch, got, dm.plain_digits(cols)), max_abs_err(torch, got, d[:, -k:]))
    errs["mont_digits"] = max(digit_errs.values())
    if errs["merkle_leaves"] or errs["mont_digits"]:
        raise AssertionError(f"K4 on Montgomery limbs or mont_digits disagrees with its plain version: "
                             f"{errs['merkle_leaves']}, {digit_errs}")
    leaves_digits_ms = device_ms(lambda: cuda_merkle.merkle_leaves(d))
    report["merkle_leaves"] = (device_ms(lambda: cuda_merkle.merkle_leaves_mont(mont)),
                               call_ms(lambda: cuda_merkle.merkle_leaves_mont_plain(mont)),
                               *bound_at("merkle_leaves", n))
    digit_cols = {k: mont[:, -k:].contiguous() for k in DIGIT_SIZES}  # copied outside the timed calls
    digits_ms = {k: device_ms(lambda: cuda_merkle.mont_digits(digit_cols[k])) for k in DIGIT_SIZES}
    del digit_cols
    # the gather form on 1 and 27 codewords (the 2^20 codeword and its
    # rotations) at gather_sizes indices, first and last columns among
    # them, against the plain gather (and the digits of the first
    # codeword): one launch a call under the caps, two past the index cap,
    # and nothing else on the card but the output's allocation
    timed = {}  # (kernel, launch size) -> device ms, for the prove's per-kernel sums (phase 4)
    gather_cws = [mont] + [torch.roll(mont, g, 1) for g in range(1, max(GATHER_CODEWORDS))]
    gather_errs, gather_counts = {}, {}
    for g in GATHER_CODEWORDS:
        for k in gather_sizes(cuda_merkle):
            idx, cws = gather_indices(n, k, 100 * g + k), gather_cws[:g]
            before = kernels.LAUNCHES["mont_digits_gather"]
            with guard.count_device_ops() as ops:
                got = cuda_merkle.mont_digits(cws, idx)
            gather_counts[f"{g}x{k}"] = {"launches": kernels.LAUNCHES["mont_digits_gather"] - before,
                                         "other_ops": dict(ops)}
            err = max_abs_err(torch, got, torch.cat([dm.plain_digits(cw[:, idx]) for cw in cws], dim=1))
            gather_errs[f"{g}x{k}"] = max(err, max_abs_err(torch, got[:, :k], d[:, idx]))
            if (gather_counts[f"{g}x{k}"]["launches"] != gather_launches(cuda_merkle, g, k)
                    or set(ops) - guard.ALLOCATION):
                raise AssertionError(f"the gather of {k} indices from {g} codewords launched "
                                     f"{gather_counts[f'{g}x{k}']} (expected {gather_launches(cuda_merkle, g, k)} "
                                     f"launches and only the allocation)")
    errs["mont_digits_gather"] = max(gather_errs.values())
    if errs["mont_digits_gather"]:
        raise AssertionError(f"the gather kernel disagrees with its plain version: {gather_errs}")
    gather_ms = {}
    for name, (g, k) in GATHER_TIMED.items():
        cws, idx = gather_cws[:g], gather_indices(n, k, 7)
        timed["mont_digits_gather", g * k] = device_ms(lambda: cuda_merkle.mont_digits(cws, idx))
        gather_ms[name] = {"codewords": g, "indices": k, "kernel": timed["mont_digits_gather", g * k],
                           "plain": call_ms(lambda: torch.cat([dm.plain_digits(cw[:, idx]) for cw in cws], dim=1)),
                           "bound": bound_at("mont_digits_gather", g * k)[0]}
    del gather_cws, cws
    floor_ms = launch_floor_ms(dev)
    report["merkle_level"] = (device_ms(lambda: cuda_merkle.merkle_level(leaves)),
                              call_ms(lambda: dm.level_hash(leaves)),
                              *bound_at("merkle_level", n))

    # the level kernel at every width of a 2^20 tree; the top kernel against
    # its plain version at every width to 2^13, and timed from 2^9 to 2^13
    # against the chain of level launches it replaces
    def level_chain(level):
        while level.shape[1] > 1:
            level = cuda_merkle.merkle_level(level)
        return level

    level_in = {1 << k: leaves[:, : 1 << k].contiguous() for k in range(1, 21)}
    for w, level in level_in.items():
        timed["merkle_level", w] = device_ms(lambda: cuda_merkle.merkle_level(level))
    top_errs = {w: max_abs_err(torch, cuda_merkle.merkle_top(level_in[w]), dm.merkle_top_plain(level_in[w]))
                for w in (1 << k for k in range(1, 14))}
    if any(top_errs.values()):
        raise AssertionError(f"the top kernel disagrees with its plain version: {top_errs}")
    if cuda_merkle.TOP_WIDTH not in TOP_SWEEP:
        raise AssertionError(f"TOP_WIDTH {cuda_merkle.TOP_WIDTH} is outside the timed widths {TOP_SWEEP}")
    top_sweep = {}
    for w in TOP_SWEEP:
        level = level_in[w]
        timed["merkle_top", w] = device_ms(lambda: cuda_merkle.merkle_top(level))
        top_sweep[w] = {"top": timed["merkle_top", w], "level_chain": device_ms(lambda: level_chain(level), 4),
                        "bound": bound_at("merkle_top", w)[0]}
        if w // 2 in top_sweep:  # the time of the level of w / 2 parents, the widest of the w-wide top
            top_sweep[w]["marginal"] = timed["merkle_top", w] - timed["merkle_top", w // 2]
    # a tree split at w: the top kernel from w, a level launch at each wider width to 2^13
    split_ms = {w: timed["merkle_top", w] + sum(timed["merkle_level", v] for v in TOP_SWEEP if v > w)
                for w in TOP_SWEEP}
    top = cuda_merkle.TOP_WIDTH
    report["merkle_top"] = (timed["merkle_top", top], call_ms(lambda: dm.merkle_top_plain(level_in[top])),
                            *bound_at("merkle_top", top))
    errs["merkle_top"] = 0
    say("merkle_top", max_abs_err=top_errs, top_width=top, launch_floor_ms=floor_ms, sweep=top_sweep, split_ms=split_ms,
        cheapest_split=min(split_ms, key=split_ms.get), level_ms={w: timed["merkle_level", w] for w in level_in},
        ms={"kernel": report["merkle_top"][0], "plain": report["merkle_top"][1], "bound": report["merkle_top"][2],
            "bound_by": report["merkle_top"][3]})

    # the subtrees kernel at every width from 2^10 to 2^19 down to 512 wide
    # (every width and depth the prove runs among them), against its plain
    # version and timed against the chain of level launches it replaces;
    # the split of the prove's 11 trees at each candidate SUBTREE_WIDTH
    sub_errs, sub_sweep = {}, {}
    for w in SUBTREE_SWEEP:
        level, depth = level_in[w], (w // cuda_merkle.TOP_WIDTH).bit_length() - 1
        before = kernels.LAUNCHES["merkle_subtrees"]
        sub_errs[w] = max_abs_err(torch, cuda_merkle.merkle_subtrees(level, depth), dm.merkle_subtrees_plain(level, depth))
        if kernels.LAUNCHES["merkle_subtrees"] != before + 1:
            raise AssertionError(f"merkle_subtrees at width {w} did not count one launch")
        timed["merkle_subtrees", w] = device_ms(lambda: cuda_merkle.merkle_subtrees(level, depth))
        sub_sweep[w] = {"depth": depth, "subtrees": timed["merkle_subtrees", w],
                        "level_chain": sum(timed["merkle_level", v] for v in level_in if 512 < v <= w),
                        "bound": subtree_bound(w, depth)[0]}
    if any(sub_errs.values()):
        raise AssertionError(f"the subtrees kernel disagrees with its plain version: {sub_errs}")

    def tree_middle_ms(n: int, split: int) -> float:
        """Levels of an n-leaf tree from n down to 512 wide, the level
        kernel above ``split`` and the subtrees kernel from there."""
        top = min(n, split)
        return (sum(timed["merkle_level", v] for v in level_in if top < v <= n)
                + (timed["merkle_subtrees", top] if top > cuda_merkle.TOP_WIDTH else 0.0))

    split_sub = {w: sum(tree_middle_ms(n, w) for n in PROVE_TREES) for w in (512,) + SUBTREE_SWEEP}
    cheapest_sub = min(split_sub, key=split_sub.get)
    sub_width = cuda_merkle.SUBTREE_WIDTH
    if sub_width not in SUBTREE_SWEEP:
        raise AssertionError(f"SUBTREE_WIDTH {sub_width} is outside the timed widths {SUBTREE_SWEEP}")
    say("merkle_subtrees", max_abs_err=sub_errs, subtree_width=sub_width, sweep=sub_sweep,
        prove_split_ms=split_sub, cheapest_split=cheapest_sub)
    if split_sub[sub_width] > 1.05 * split_sub[cheapest_sub]:
        raise AssertionError(f"SUBTREE_WIDTH {sub_width} takes {split_sub[sub_width]:.4f} ms a prove, more than 5 % "
                             f"above the cheapest split {cheapest_sub} ({split_sub[cheapest_sub]:.4f} ms)")
    sub_depth = (sub_width // cuda_merkle.TOP_WIDTH).bit_length() - 1
    report["merkle_subtrees"] = (timed["merkle_subtrees", sub_width],
                                 call_ms(lambda: dm.merkle_subtrees_plain(level_in[sub_width], sub_depth)),
                                 *bound_at("merkle_subtrees", sub_width))
    errs["merkle_subtrees"] = 0

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
        leaves_from_digits_ms={"kernel": leaves_digits_ms,
                               "bound": bound_at("merkle_leaves_digits", n)[0]},
        tree_2e13_root=tree.root.hex(), auth_paths_checked=opened)
    say("mont_digits", sizes=list(DIGIT_SIZES), max_abs_err=digit_errs, ms=digits_ms,
        bound_ms={k: bound_at("mont_digits", k)[0] for k in DIGIT_SIZES})
    say("mont_digits_gather", max_abs_err=gather_errs, calls=gather_counts, ms=gather_ms, launch_floor_ms=floor_ms)

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
    report["fri_fold"] = (device_ms(lambda: cuda_fold.fri_fold(cw, alpha, table)),
                          call_ms(lambda: fold_mont(cw, alpha, table)),
                          *bound_at("fri_fold", n))
    errs["fri_fold"] = 0
    say("fold_kernel", n=n, max_abs_err=fold_errs,
        ms={"kernel": report["fri_fold"][0], "plain": report["fri_fold"][1], "bound": report["fri_fold"][2],
            "bound_by": report["fri_fold"][3]})

    fs_lengths = [0, 1, 55, 56, 57, 63, 64, 65, 127, 128, 135, 136, 137, FS_BODY_BYTES, 271, 272, 273, 500, 1000]
    for body_len in fs_lengths + list(FS_CASCADE_BODIES):
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
    for body_len in FS_CASCADE_BODIES:
        body = torch.zeros(body_len + 72, dtype=torch.uint8, device=dev)
        timed["fs_round", body_len] = device_ms(lambda: cuda_fs.fs_round(body, body_len, 4, root))
    body = torch.zeros(FS_BODY_BYTES + 72, dtype=torch.uint8, device=dev)
    report["fs_round"] = (timed["fs_round", FS_BODY_BYTES],
                          call_ms(lambda: fs_round_plain(body, FS_BODY_BYTES, 4, root)),
                          *bound_at("fs_round", FS_BODY_BYTES))
    say("fs_kernel", body_lengths_checked=fs_lengths + list(FS_CASCADE_BODIES), against=["plain", "hashlib"],
        launch_floor_ms=floor_ms,
        timed_body_bytes=FS_BODY_BYTES, cascade_ms={n: timed["fs_round", n] for n in FS_CASCADE_BODIES},
        ms={"kernel": report["fs_round"][0], "plain": report["fs_round"][1], "bound": report["fs_round"][2],
            "bound_by": report["fs_round"][3]})

    # the field vector kernels at the prove's sizes and at block and domain
    # edges, each against its plain version
    from stark_tpu_torch import field, params
    from stark_tpu_torch.ops import limbs
    from stark_tpu_torch.ops.limbs import mont_tensor

    column = mont_tensor([int(rng.integers(1, 1 << 62)) * 7919 % P], dev)

    def field_calls(n):
        """kernel name -> (kernel call, plain call) at n, the product first."""
        a, b, start, bases = field_operands(limbs, field, params, n, dev)
        calls = {"mont_inv": (lambda: cuda_field.mont_inv(a), lambda: fo.mont_inv(a)),
                 "prefix_mul": (lambda: cuda_field.prefix_mul(b), lambda: fo.prefix_mul(b)),
                 "geometric_table": (lambda: cuda_field.geometric_table(start, bases, n),
                                     lambda: cuda_field.geometric_table_plain(start, bases, n))}
        for op, op_name in ((cuda_field.MUL, "mul"), (cuda_field.ADD, "add"), (cuda_field.SUB, "sub")):
            for side, (x, y) in (("", (a, b)), ("_column_a", (column, b)), ("_column_b", (a, column))):
                calls[f"mont_binary/{op_name}{side}"] = (lambda op=op, x=x, y=y: cuda_field.mont_binary(op, x, y),
                                                         lambda op=op, x=x, y=y: cuda_field._PLAIN[op](x, y))
        return calls

    def prefix_err(b) -> int:
        """K8 against its plain version on b, in one launch."""
        before = kernels.LAUNCHES["prefix_mul"]
        got = cuda_field.prefix_mul(b)
        if kernels.LAUNCHES["prefix_mul"] != before + 1:
            raise AssertionError(f"prefix_mul at n = {b.shape[1]} did not launch once")
        want = fo.prefix_mul(b)
        if not bool((want != 0).any(0).all()):
            raise AssertionError(f"prefix_mul's check input at n = {b.shape[1]} has a zero prefix")
        return max_abs_err(torch, got, want)

    field_errs = {}
    for n in PREFIX_LARGE:  # K8 alone past the tiles the card holds at once, untimed
        field_errs[n] = {"prefix_mul": prefix_err(field_operands(limbs, field, params, n, dev)[1])}
        if field_errs[n]["prefix_mul"]:
            raise AssertionError(f"prefix_mul disagrees with its plain version at n = {n}")
    # the prove's sizes last: the operands still alive while phase 4 proves are 2^20's
    for n in FIELD_EDGES + CHAIN_FIELD_SIZES + FIELD_SIZES:
        calls = field_calls(n)
        field_errs[n] = {name: max_abs_err(torch, kernel(), plain()) for name, (kernel, plain) in calls.items()
                         if name != "prefix_mul"}
        field_errs[n]["prefix_mul"] = prefix_err(field_operands(limbs, field, params, n, dev)[1])
        if any(field_errs[n].values()):
            raise AssertionError(f"field kernels disagree with their plain versions at n = {n}: {field_errs[n]}")
        if n not in FIELD_SIZES:
            continue
        for name in ("mont_inv", "prefix_mul", "geometric_table", "mont_binary/mul"):
            timed[name.split("/")[0], n] = device_ms(calls[name][0])
        for name, main in FIELD_MAIN.items():
            if main == n:
                plain = calls["mont_binary/mul" if name == "mont_binary" else name][1]
                report[name] = (timed[name, n], call_ms(plain), *bound_at(name, n))
                errs[name] = 0
    zero_errs = {f"{name} @ {n}": max_abs_err(torch, cuda_field.mont_inv(x), fo.mont_inv(x))
                 for n in ZERO_SIZES
                 for name, x in zero_patterns(field_operands(limbs, field, params, n, dev)[0]).items()}
    if any(zero_errs.values()):
        raise AssertionError(f"K7 disagrees with its plain version at zeros around its blocks: {zero_errs}")
    # K7's fixed work a block, its Fermat chains (8 lanes of one warp) the
    # longest part of it: one block at one element and at a whole block,
    # beside an elementwise launch of one element (the floor of a launch)
    one = field_calls(1)
    inv_block = {"mont_inv @ 1": device_ms(one["mont_inv"][0]),
                 f"mont_inv @ {INV_CHUNK}": device_ms(field_calls(INV_CHUNK)["mont_inv"][0]),
                 "mont_binary/mul @ 1": device_ms(one["mont_binary/mul"][0])}
    # K9 at 2^20: its grid's 2^m threads each run m products of the bit
    # bases, then step through the rest of their elements
    step_bits = cuda_field.geometric_step_bits(1 << 20)
    steps = -(-(1 << 20) // (1 << step_bits))
    say("field_kernels", sizes=list(FIELD_SIZES), edge_sizes=list(FIELD_EDGES), prefix_sizes=list(PREFIX_LARGE),
        chain_sizes=list(CHAIN_FIELD_SIZES),
        max_abs_err=field_errs,
        k7_zero_patterns=zero_errs, k7_one_block_ms=inv_block, k9_split_2e20={"m": step_bits, "per_thread": steps},
        warp_instructions_per_product=product._asdict(),
        warp_instructions_per_thread={k: per_thread(k, *i)._asdict() for k, i in (
            # K7: warp 0 of a block, which runs the chain's 23 windows; K9: a
            # thread's bit base loaded, at most m bits, then its steps
            ("inv_kernel", (23,)),
            ("geometric_kernel", (1, step_bits, steps - 1)),
            ("binary_kernelILi0E", ()), ("binary_kernelILi1E", ()), ("binary_kernelILi2E", ()))},
        ms={f"{name} @ {n}": timed[name, n] for name in FIELD_MAIN for n in FIELD_SIZES},
        main={name: {"n": FIELD_MAIN[name], "kernel": report[name][0], "plain": report[name][1],
                     "bound": report[name][2], "bound_by": report[name][3]} for name in FIELD_MAIN})

    # K11, the combination, with fib's structure at 2^13 and 2^20 against its
    # plain version (the program's interpreter), timed at 2^20
    fib_program = cuda_combination.encode(FIB_STRUCTURE, 2, 4)
    comb_errs = {}
    for logn in (13, 20):
        comb_args = combination_operands(limbs, FIB_STRUCTURE, 5, 1 << logn, 1000 * logn, dev)
        before = kernels.LAUNCHES["combination"]
        got = cuda_combination.combination(fib_program, *comb_args)
        if kernels.LAUNCHES["combination"] != before + 1:
            raise AssertionError(f"the combination at 2^{logn} did not count one launch")
        want = cuda_combination.combination_plain(fib_program, *comb_args)
        comb_errs[1 << logn] = max(max_abs_err(torch, got[0], want[0]), max_abs_err(torch, got[1], want[1]))
        del got, want
    if any(comb_errs.values()):
        raise AssertionError(f"the combination kernel disagrees with its plain version: {comb_errs}")
    n = 1 << 20
    fib_comb = {"kernel": device_ms(lambda: cuda_combination.combination(fib_program, *comb_args)),
                "plain": call_ms(lambda: cuda_combination.combination_plain(fib_program, *comb_args), reps=2),
                "bytes": combination_bytes(comb_args), "products_per_point": program_products(fib_program)}
    fib_comb["bound"], fib_comb["bound_by"] = bound(fib_comb["bytes"], product * (fib_comb["products_per_point"] * n
                                                                                   / 32))
    report["combination"] = (fib_comb["kernel"], fib_comb["plain"], fib_comb["bound"], fib_comb["bound_by"])
    errs["combination"] = 0
    del comb_args
    say("combination_kernel", structure="fib", max_abs_err=comb_errs, powers=len(fib_program.powers),
        terms=len(fib_program.terms), ms=fib_comb,
        warp_instructions_per_thread_without_loops=sass.count(sass.find(funcs, "combination_kernelILb0E"))._asdict())

    # the sharded path's kernel variants at a shard's shape of the mesh prove
    # (phase 7): K11's next-row form, the next rows read from planes of their
    # own, and K10's row-by-column form, each against its plain version
    shard_n = (1 << 20) // MESH_SHARDS
    next_errs = {}
    for m in (1 << 13, shard_n):
        next_args = combination_operands(limbs, FIB_STRUCTURE, 5, m, 3000 + m.bit_length(), dev)
        nexts = [limbs.from_numpy(limbs.seeded_mont(m, 5000 + j), dev) for j in range(2)]
        before = kernels.LAUNCHES["combination_next"]
        got = cuda_combination.combination(fib_program, *next_args, next_cws=nexts)
        if kernels.LAUNCHES["combination_next"] != before + 1:
            raise AssertionError(f"the next-row combination at {m} did not count one launch")
        want = cuda_combination.combination_plain(fib_program, *next_args, nexts)
        next_errs[m] = max(max_abs_err(torch, got[0], want[0]), max_abs_err(torch, got[1], want[1]))
        del got, want
    if any(next_errs.values()):
        raise AssertionError(f"the next-row combination disagrees with its plain version: {next_errs}")
    next_comb = {"kernel": device_ms(lambda: cuda_combination.combination(fib_program, *next_args, next_cws=nexts)),
                 "one_device_form": device_ms(lambda: cuda_combination.combination(fib_program, *next_args)),
                 "plain": call_ms(lambda: cuda_combination.combination_plain(fib_program, *next_args, nexts), reps=2),
                 "bytes": combination_bytes(next_args) + LIMB_BYTES * shard_n * len(nexts),
                 "products_per_point": program_products(fib_program)}
    next_comb["bound"], next_comb["bound_by"] = bound(next_comb["bytes"],
                                                      product * (next_comb["products_per_point"] * shard_n / 32))
    report["combination_next"] = (next_comb["kernel"], next_comb["plain"], next_comb["bound"], next_comb["bound_by"])
    errs["combination_next"] = 0
    del next_args, nexts
    outer_errs = {}
    for rows_, cols_ in MESH_OUTER_SHAPES:
        ta = limbs.from_numpy(limbs.seeded_mont(max(rows_, 3), 100 + rows_)[:, :rows_], dev)
        tb = limbs.from_numpy(limbs.seeded_mont(max(cols_, 3), 200 + cols_)[:, :cols_], dev)
        before = kernels.LAUNCHES["mont_outer"]
        got = cuda_field.mont_outer(ta, tb)
        if kernels.LAUNCHES["mont_outer"] != before + 1:
            raise AssertionError(f"mont_outer at {rows_} x {cols_} did not count one launch")
        outer_errs[f"{rows_}x{cols_}"] = max_abs_err(torch, got, cuda_field.mont_outer_plain(ta, tb))
    if any(outer_errs.values()):
        raise AssertionError(f"mont_outer disagrees with its plain version: {outer_errs}")
    rows_, cols_ = MESH_OUTER_SHAPES[-1]  # the shift tables' C x R/D, the largest of the prove
    outer_n = rows_ * cols_
    outer = {"shape": [rows_, cols_], "kernel": device_ms(lambda: cuda_field.mont_outer(ta, tb)),
             "plain": call_ms(lambda: cuda_field.mont_outer_plain(ta, tb))}
    outer["bound"], outer["bound_by"] = bound(LIMB_BYTES * (outer_n + rows_ + cols_), product * (outer_n / 32))
    report["mont_outer"] = (outer["kernel"], outer["plain"], outer["bound"], outer["bound_by"])
    errs["mont_outer"] = 0
    say("mesh_variants", combination_next={"max_abs_err": next_errs, "ms": next_comb,
                                           "warp_instructions_per_thread_without_loops": sass.count(
                                               sass.find(funcs, "combination_kernelILb1E"))._asdict()},
        mont_outer={"max_abs_err": outer_errs, "ms": outer})

    # R1, the Rescue permutation, in both modes against its plain version;
    # 64 instances against the host model; the S-boxes of a trace inverted
    from stark_tpu_torch.ops import rescue

    perm_products = rescue_products(params)
    rescue_errs, rescue_plain_ms = {}, {}
    edge_state = rescue_edge_state(limbs, params, dev)
    for b in ("edge",) + RESCUE_BATCHES:
        state = edge_state if b == "edge" else rescue_state(limbs, b, b, dev)
        for trace in (False, True):
            plain = rescue.trace_mont if trace else rescue.permutation_mont
            got = cuda_rescue.rescue_permutation(state, trace=trace)
            # one timed call after a warm-up; the last call's output is checked
            last = {}
            rescue_plain_ms[b, trace] = call_ms(lambda: last.update(want=plain(state)), reps=1)
            want = last.pop("want")
            rescue_errs[f"{b}/{'trace' if trace else 'final'}"] = max_abs_err(torch, got, want)
            if b == RESCUE_MAIN and trace and not sbox_cubes_back(torch, fo, limbs, params, got,
                                                                   rescue.constants(dev)):
                raise AssertionError(f"an inverse S-box output of R1's trace at {b} does not cube back to its input")
            del got, want
    if any(rescue_errs.values()):
        raise AssertionError(f"R1 disagrees with its plain version: {rescue_errs}")
    host_inputs = [int(v) % P for v in rng.integers(0, 1 << 62, 64)]
    rp = RescuePrime()
    host_traces = [[[v.value for v in row] for row in rp.trace(FieldElement(x))] for x in host_inputs]
    if rescue.hash_batch(host_inputs, dev) != [t[-1][0] for t in host_traces]:
        raise AssertionError("R1's hashes differ from the host RescuePrime.hash")
    card_traces = rescue.trace_batch(host_inputs, dev)
    if [card_traces[i].tolist() for i in range(64)] != host_traces:
        raise AssertionError("R1's traces differ from the host RescuePrime.trace")
    # the bound: the fewest products a permutation needs, each S-box product
    # and the cube's x^2 at R1's squaring, the rest at the cheapest general
    # product in the library (R1's or K7's fe_mul); beside it R1's own
    # products at the same prices (as_run), and the clocks of one product on
    # a round's dependent path
    chain = sbox_chain()
    r1_sqr, r1_mul = rescue_prices(sass, funcs, chain["unroll"])
    general = min(r1_mul, product, key=lambda c: c.seconds(sms, clock_hz))
    bound_sqr, bound_mul = rescue_bound_split(params)
    runs = rescue_kernel_split(params, chain)
    rescue_ms, rescue_bound, rescue_as_run = {}, {}, {}
    for b in RESCUE_TIMED:
        state = rescue_state(limbs, b, 3, dev)
        for trace in (False, True):
            rescue_ms[b, trace] = device_ms(lambda: cuda_rescue.rescue_permutation(state, trace=trace))
            # 64 bytes in, 64 (28 * 64 in trace mode) out an instance
            rescue_bound[b, trace] = bound(64 * b * (1 + (28 if trace else 1)),
                                           r1_sqr * (bound_sqr * b / 32) + general * (bound_mul * b / 32))
            rescue_as_run[b] = (r1_sqr * (runs["squarings"] * b / 32)
                                + r1_mul * (runs["general"] * b / 32)).seconds(sms, clock_hz) * 1e3
    report["rescue_permutation"] = (rescue_ms[RESCUE_MAIN, True], rescue_plain_ms[RESCUE_MAIN, True],
                                    *rescue_bound[RESCUE_MAIN, True])
    errs["rescue_permutation"] = 0
    mode = {False: "final", True: "trace"}
    registers = ptxas_registers(str(kernels.build_info.get("ptxas", "")), "rescue_kernel")
    say("rescue_kernel", batches=["edge"] + list(RESCUE_BATCHES), edge_values=len(rescue_edge_values(params)),
        max_abs_err=rescue_errs, host_checked=64, sbox_cubes_back_at=RESCUE_MAIN,
        products_per_permutation=perm_products, bound_squarings=bound_sqr, bound_general=bound_mul,
        kernel_squarings=runs["squarings"], kernel_general=runs["general"], chain=chain_counts(chain),
        warp_instructions_per_squaring=r1_sqr._asdict(), per_general_product=r1_mul._asdict(),
        general_priced=general._asdict(), registers=registers,
        resident_warps_per_sm=None if registers is None else min(64, 65536 // (32 * -(-registers // 8) * 8) // 2 * 2),
        ms={f"{b}/{mode[t]}": v for (b, t), v in rescue_ms.items()},
        hashes_per_s={f"{b}/{mode[t]}": b / v * 1e3 for (b, t), v in rescue_ms.items()},
        bound_ms={f"{b}/{mode[t]}": v for (b, t), v in rescue_bound.items()},
        time_over_bound={f"{b}/{mode[t]}": v / rescue_bound[b, t][0] for (b, t), v in rescue_ms.items()},
        as_run_ms=rescue_as_run,
        clocks_per_dependent_product={f"{RESCUE_MAIN}/{mode[t]}": rescue_ms[RESCUE_MAIN, t] * 1e-3 * clock_hz
                                      / runs["dependent"] for t in (False, True)},
        plain_ms={f"{b}/{mode[t]}": v for (b, t), v in rescue_plain_ms.items()})

    # -- 2b. the TPU timing probes B1-B4 through their entry points ------------
    from stark_tpu_torch.benches import lazy_limb_experiment, merkle_roofline, mont_mul_experiments, quick_timing
    from stark_tpu_torch.ops import cuda_probes

    kernels.reset_launch_counts()
    runs, probe_s = {}, {}
    for name, bench in (("b1", lazy_limb_experiment), ("b2", quick_timing), ("b3", mont_mul_experiments),
                        ("b4", merkle_roofline)):
        t0 = time.perf_counter()
        runs[name] = bench.run(dev)
        probe_s[name] = time.perf_counter() - t0
    probe_launches = {k: kernels.LAUNCHES[k] for k in kernels.PROBES}
    b1, b2, b3, b4 = runs.values()
    unlaunched = [k for k, c in probe_launches.items() if c <= 0]
    if unlaunched:
        raise AssertionError(f"the probes' entry points never launched {unlaunched}: {probe_launches}")
    # each probe kernel's whole SASS a thread, times its warps
    probes = probe_tables(cuda_probes)
    probe_ins = {k: sass.find(funcs, part) for k, (part, _) in probes.items()}
    probe_counts = {k: sass.straight_line(ins) for k, ins in probe_ins.items()}
    hint16_same = ([sass.opcode(i) for _, i in probe_ins["probe_mont16_chain/base"]]
                   == [sass.opcode(i) for _, i in probe_ins["probe_mont16_chain/hint16"]])
    # elements; the bytes of one limb plane of t, (rows, 128) int32
    n_el, t_bytes = b1["n"], 4 * lazy_limb_experiment.ROWS * lazy_limb_experiment.BLOCK
    w = b4["n_leaves"]
    chain_runs = {"probe_mont13_chain": (b1["kernel_ms"], b1["plain_ms"], 10),
                  "probe_mont_chain": (b2["kernel_ms"], b2["plain_ms"], 8),
                  **{f"probe_mont16_chain/{m}": (v["kernel_ms"], v["plain_ms"], 8) for m, v in b3["modes"].items()}}
    for name, (ms, plain_ms, planes) in chain_runs.items():  # x read, the result written, t read once
        report[name] = (ms, plain_ms, *bound(planes * (8 * n_el + t_bytes), probe_counts[name] * (n_el / 32)))
    level_runs = {"probe_level_stub": (b4["stub_ms"], b4["stub_plain_ms"]),
                  **{f"probe_level_rounds/{r}": (b4["round_sweep_ms"][r], b4["round_plain_ms"][r])
                     for r in cuda_probes.PROBE_ROUNDS}}
    for name, (ms, plain_ms) in level_runs.items():  # the level in, its parents out
        report[name] = (ms, plain_ms, *bound(48 * w, probe_counts[name] * (w / 2 / 32)))
    # the three chains of the field product are one function: each is also
    # bound by B2's SASS, the fewest instructions it is known to take here
    function_bound = {k: report["probe_mont_chain"][2] for k in PROBE_FIELD_PRODUCT}
    errs.update({"probe_mont13_chain": b1["max_abs_err"], "probe_mont_chain": b2["max_abs_err"],
                 **{f"probe_mont16_chain/{m}": b3["max_abs_err"][m] for m in b3["modes"]},
                 "probe_level_stub": b4["max_abs_err"]["stub"],
                 **{f"probe_level_rounds/{r}": b4["max_abs_err"][f"rounds_{r}"] for r in cuda_probes.PROBE_ROUNDS}})
    # the stub's function in one library call, timed here alone (the port never calls it)
    _, stub_level = merkle_roofline.inputs(dev)
    library_stub = torch.bitwise_xor(stub_level[:, 0::2], stub_level[:, 1::2])
    if not torch.equal(library_stub, cuda_probes.level_stub(stub_level)):
        raise AssertionError("the library's XOR of each parent's children disagrees with the stub kernel")
    library_ms = {"probe_level_stub": device_ms(lambda: torch.bitwise_xor(stub_level[:, 0::2], stub_level[:, 1::2]))}
    del stub_level, library_stub

    def probe_ms(name: str) -> dict:
        ms = dict(zip(("kernel", "plain", "bound", "bound_by"), report[name]))
        if name in function_bound:
            ms["function_bound"] = function_bound[name]
        if name in library_ms:
            ms["library"] = library_ms[name]
        return ms

    say("probe_b1_lazy13", n=n_el, muls=b1["muls"], ms=probe_ms("probe_mont13_chain"),
        ms_per_mul=b1["ms_per_mul"], mmul_per_s=b1["mmul_per_s"], pairs_exact=b1["pairs_exact"],
        int_checked=b1["int_checked"], warp_instructions_per_thread=probe_counts["probe_mont13_chain"]._asdict())
    say("probe_b2_product", n=n_el, muls=b2["muls"], ms=probe_ms("probe_mont_chain"), ms_per_mul=b2["ms_per_mul"],
        mmul_per_s=b2["mmul_per_s"], int_checked=b2["int_checked"], ntt_ms=b2["ntt_ms"], ntt_parity=b2["ntt_parity"],
        warp_instructions_per_thread=probe_counts["probe_mont_chain"]._asdict(),
        warp_instructions_per_product_in_k7=product._asdict())
    say("probe_b3_variants", n=n_el, muls=b3["muls"], hint16_equals_base=b3["hint16_equals_base"],
        hint16_same_sass_as_base=hint16_same, max_abs_err=b3["max_abs_err"],
        modes={m: {**probe_ms(f"probe_mont16_chain/{m}"), "ms_per_mul": v["ms_per_mul"], "mmul_per_s": v["mmul_per_s"],
                   "warp_instructions_per_thread": probe_counts[f"probe_mont16_chain/{m}"]._asdict()}
               for m, v in b3["modes"].items()})
    say("probe_b4_merkle_roofline", n_leaves=w, max_abs_err=b4["max_abs_err"], tree_ms=b4["tree_ms"],
        leaf_ms=b4["leaf_ms"], level_ms=b4["level_ms"], stub=probe_ms("probe_level_stub"),
        rounds={r: probe_ms(f"probe_level_rounds/{r}") for r in cuda_probes.PROBE_ROUNDS},
        round_sweep_ms=b4["round_sweep_ms"], marginal_ms_per_round=b4["marginal_ms_per_round"],
        kernel_sol_ms=b4["kernel_sol_ms"], kernel_vs_sol=b4["kernel_vs_sol"],
        warp_instructions_per_thread={**{r: probe_counts[f"probe_level_rounds/{r}"]._asdict()
                                         for r in cuda_probes.PROBE_ROUNDS},
                                      12: per_unit["merkle_level"]._asdict()})
    say("probes", seconds=probe_s, launches=probe_launches)

    # the device proves must interpolate their traces on the card: the host
    # interpolation raises while they run
    host_interpolation = Stark._interpolate_trace

    def refuse_host_interpolation(*args, **kwargs):
        raise AssertionError("a prove on the card called the host trace interpolation")

    # -- 3. small prove: byte-identical to the port's host prover --------------
    a, b = FieldElement(3), FieldElement(7)
    host_result, host_proof = FibonacciStark(1000, device=None, rng=DeterministicRandom(11)).prove(a, b)
    small = FibonacciStark(1000, device=dev, rng=DeterministicRandom(11))
    if small.stark.fri_domain_length != 8192 or not small.stark._use_device_pipeline():
        raise AssertionError("fib-1000 did not take the device pipeline on its 8192-point domain")
    before = {k: kernels.LAUNCHES[k] for k in FIELD_MAIN}
    Stark._interpolate_trace = refuse_host_interpolation
    try:
        with guard.count_plain_calls() as plain_small:
            result, proof = small.prove(a, b)
    finally:
        Stark._interpolate_trace = host_interpolation
    if sum(plain_small.values()):
        raise AssertionError(f"fib-1000 on the card called field_ops on CUDA tensors: {dict(plain_small)}")
    if result != host_result or proof != host_proof:
        raise AssertionError("fib-1000 proof on the card differs from the host prover's")
    small_field = {k: kernels.LAUNCHES[k] - before[k] for k in FIELD_MAIN}
    if not all(small_field.values()):
        raise AssertionError(f"fib-1000 on the card did not launch every field kernel: {small_field}")
    say("small_prove", steps=1000, fri_domain=8192, proof_bytes=len(proof), identical_to_host=True,
        field_kernel_launches=small_field, plain_field_ops_on_cuda=sum(plain_small.values()))

    # RescueStark.prove_batch of 8 on the card, its witnesses from R1; then
    # MiMC-30 and chain-4 through the device pipeline, its floor lowered to 512 points
    batch_inputs = [FieldElement(int(x)) for x in rng.integers(1, 1 << 62, 8)]
    want = RescueStark(device=None, rng=DeterministicRandom(SEED)).prove_batch(batch_inputs)
    batch_model = RescueStark(rng=DeterministicRandom(SEED))  # the card is the default device
    kernels.reset_launch_counts()
    got = batch_model.prove_batch(batch_inputs)
    batch_launches = dict(kernels.LAUNCHES)
    if got != want:
        raise AssertionError("RescueStark.prove_batch on the card differs from the host prover's proofs")
    if batch_launches["rescue_permutation"] < 1:
        raise AssertionError(f"RescueStark.prove_batch on the card did not launch R1: {batch_launches}")
    small_models = {"mimc_30": lambda d: MimcStark(30, device=d, rng=DeterministicRandom(SEED)),
                    "rescue_chain_4": lambda d: RescueChainStark(4, device=d, rng=DeterministicRandom(SEED))}
    small_bytes = {}
    for name, build in small_models.items():
        host, card = build(None), build(dev)
        card.stark.backend.device_prover_min = 512
        if not card.stark._use_device_pipeline():
            raise AssertionError(f"{name} did not take the device pipeline on its "
                                 f"{card.stark.fri_domain_length}-point domain")
        x = FieldElement(77)
        with guard.count_plain_calls() as plain_small:
            output, proof = card.prove(x)
        if sum(plain_small.values()):
            raise AssertionError(f"{name} on the card called field_ops on CUDA tensors: {dict(plain_small)}")
        if (output, proof) != host.prove(x):
            raise AssertionError(f"{name} proved through the device pipeline on the card differs from the host's")
        small_bytes[name] = len(proof)
    say("rescue_models", prove_batch=len(batch_inputs), prove_batch_launches=batch_launches,
        proof_bytes={"rescue": len(got[0][1]), **small_bytes}, identical_to_host=True)

    # -- 4. the real prove ------------------------------------------------------
    steps = 65536
    model = FibonacciStark(steps, rng=DeterministicRandom(SEED))  # the card is the default device
    if model.stark.fri_domain_length != 1 << 20:
        raise AssertionError(f"unexpected FRI domain {model.stark.fri_domain_length}")
    Stark._interpolate_trace = refuse_host_interpolation
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with (guard.count_plain_calls() as plain_cold,
          watch_gathers(kernels, guard, device_prover, Stark, cuda_merkle) as fib_gathers):
        result, proof = model.prove(a, b)
        torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    fib_gather_calls = fib_gathers.check("the 2^16-step prove", ["gather_values_async"])
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    cold_split = combination_split(model.stark.last_profile)
    launches = dict(kernels.LAUNCHES)
    by_size = {n: dict(v) for n, v in sorted(kernels.LAUNCHES_BY_SIZE.items())}
    ntt_launches = {n: {k: c for k, c in v.items() if k.startswith("ntt_")} for n, v in by_size.items()}
    ntt_launches = {n: v for n, v in ntt_launches.items() if v}
    fused = model.stark.fri.last_fused_rounds
    stages = {k: round(v, 4) for k, v in sorted(model.stark.last_profile.totals.items(), key=lambda kv: -kv[1])}
    missing = [k for k in pipeline if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the 2^16-step prove never launched {missing}: {launches}")
    if any(launches[k] for k in kernels.PROBES):
        raise AssertionError(f"the 2^16-step prove launched a probe kernel: {launches}")
    if fused < 2:
        raise AssertionError(f"the 2^16-step prove fused {fused} FRI rounds, expected >= 2")
    if sum(plain_cold.values()):
        raise AssertionError(f"the 2^16-step prove called field_ops on CUDA tensors: {dict(plain_cold)}")
    if launches["combination"] != 1:
        raise AssertionError(f"the 2^16-step prove launched the combination {launches['combination']} times")
    if launches["merkle_top"] != len(PROVE_TREES):
        raise AssertionError(f"the 2^16-step prove launched merkle_top {launches['merkle_top']} times, "
                             f"expected one a tree ({len(PROVE_TREES)})")
    if model.stark._device_air_groups(model.stark._device_core(), model._constraints)[1] != FIB_STRUCTURE:
        raise AssertionError("the 2^16-step prove's AIR structure is not the one phase 2 checked")
    unchecked = sorted(set(ntt_launches) - set(ntt_sizes))
    if unchecked:
        raise AssertionError(f"the 2^16-step prove ran NTT passes at sizes phase 2 did not check: {unchecked}")
    # the trees' routing: the level kernel only above SUBTREE_WIDTH, one
    # subtrees launch a tree at min(n, SUBTREE_WIDTH); K8 once a call
    want_level = {}
    for n in PROVE_TREES:
        for w in (v for v in level_in if sub_width < v <= n):
            want_level[w] = want_level.get(w, 0) + 1
    want_sub = {}
    for n in PROVE_TREES:
        want_sub[min(n, sub_width)] = want_sub.get(min(n, sub_width), 0) + 1
    routing = {"merkle_level": want_level, "merkle_subtrees": want_sub, "prefix_mul": PROVE_PREFIX_CALLS}
    for name, want in routing.items():
        got = {size: v[name] for size, v in by_size.items() if name in v}
        if got != want:
            raise AssertionError(f"the 2^16-step prove launched {name} {got} by size, expected {want}")
    verifier = FibonacciStark(steps, device=None)  # the port's host verifier
    t0 = time.perf_counter()
    ok = verifier.verify(a, b, result, proof)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the host verifier rejects the card's 2^16-step proof")
    if verifier.verify(a, b, result + FieldElement(1), proof):
        raise AssertionError("the host verifier accepts a wrong claimed result")
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with guard.count_plain_calls() as plain_warm:
        model.prove(a, b)
        torch.cuda.synchronize()
    warm_prove_s = time.perf_counter() - t0
    Stark._interpolate_trace = host_interpolation
    warm_launches = dict(kernels.LAUNCHES)
    warm_split = combination_split(model.stark.last_profile)
    if sum(plain_warm.values()) or warm_launches["combination"] != 1:
        raise AssertionError(f"the warm 2^16-step prove called field_ops on CUDA tensors ({dict(plain_warm)}) or "
                             f"launched the combination {warm_launches['combination']} times")
    warm_stages = {k: round(v, 4) for k, v in sorted(model.stark.last_profile.totals.items(), key=lambda kv: -kv[1])}
    # the part of the warm prove outside the prover's stages, and the host
    # trace build (FibonacciAir.trace_limbs, before Stark.prove) it holds
    unstaged_s = warm_prove_s - sum(v for k, v in model.stark.last_profile.totals.items() if "/" not in k)
    t0 = time.perf_counter()
    model.air.trace_limbs(a, b)
    trace_build_s = time.perf_counter() - t0
    say("prove", steps=steps, fri_domain=model.stark.fri_domain_length, prove_seconds=prove_s,
        warm_prove_seconds=warm_prove_s, verify_seconds=verify_s, proof_bytes=len(proof), fused_fri_rounds=fused,
        launches=launches, warm_launches=warm_launches, opening_gathers=fib_gather_calls,
        ntt_launches_by_size=ntt_launches, stages_seconds=stages,
        warm_stages_seconds=warm_stages, warm_unstaged_seconds=unstaged_s, trace_build_seconds=trace_build_s,
        plain_field_ops_on_cuda={"cold": sum(plain_cold.values()), "warm": sum(plain_warm.values())},
        combination_split={"cold": cold_split, "warm": warm_split}, peak_device_mib=peak_mib,
        warm_peak_device_mib=torch.cuda.max_memory_allocated() / 2**20)
    print(f"fused FRI rounds: {fused}", flush=True)
    fib_claim, fib_proof = (a, b, result), proof
    one_device = {"prove_seconds": prove_s, "warm_prove_seconds": warm_prove_s, "peak_device_mib": peak_mib}
    say("ntt_sizes", rows=[{"n": n, "launches": ntt_launches.get(n, {}), **ntt_sizes[n]} for n in sorted(ntt_sizes)])

    # each kernel's device time in that prove: its launches at each size
    # times its time at that size, timed in phase 2 or here on seeded inputs
    for n, passes in ntt_sizes.items():
        for name in ("ntt_pass1", "ntt_pass2"):
            timed[name, n] = passes[name]["kernel"]

    def launch_at(name: str, size: int):
        if name == "merkle_leaves":  # the prove's form: on Montgomery limbs
            x = mont[:, :size].contiguous()
            return lambda: cuda_merkle.merkle_leaves_mont(x)
        if name in ("merkle_level", "merkle_top"):
            x = leaves[:, :size].contiguous()
            return lambda: getattr(cuda_merkle, name)(x)
        if name == "merkle_subtrees":  # down to TOP_WIDTH, as a tree runs it
            x = leaves[:, :size].contiguous()
            return lambda: cuda_merkle.merkle_subtrees(x, (size // cuda_merkle.TOP_WIDTH).bit_length() - 1)
        if name == "fri_fold":
            x, t = cw[:, :size].contiguous(), table[:, : size // 2].contiguous()
            return lambda: cuda_fold.fri_fold(x, alpha, t)
        if name == "fs_round":
            x = torch.zeros(size + 72, dtype=torch.uint8, device=dev)
            return lambda: cuda_fs.fs_round(x, size, 4, root)
        if name in FIELD_MAIN:  # the elementwise kernel as the product of two full operands
            return field_calls(size)["mont_binary/mul" if name == "mont_binary" else name][0]
        if name == "mont_digits":
            x = limbs.from_numpy(limbs.seeded_mont(size, size), dev)
            return lambda: cuda_merkle.mont_digits(x)
        if name == "mont_digits_gather":  # size values: of one codeword, or of the fewest that stay under the cap
            g = -(-size // cuda_merkle.GATHER_MAX_INDICES)
            while size % g:
                g += 1
            idx = gather_indices(1 << 20, size // g, size)
            return lambda: cuda_merkle.mont_digits([mont] * g, idx)
        if name == "mont_outer":  # the mesh prove's tables: rows x R/D, R/D the same for every table
            cols = MESH_OUTER_SHAPES[-1][1]
            rows = size // cols
            ta = limbs.from_numpy(limbs.seeded_mont(max(rows, 3), size)[:, :rows], dev)
            tb = limbs.from_numpy(limbs.seeded_mont(cols, cols), dev)
            return lambda: cuda_field.mont_outer(ta, tb)
        raise AssertionError(f"no timer for {name} at launch size {size}")

    def kernel_sums(by_size, launches, own):
        """Each kernel's device ms and bound ms in one prove: its launches
        at each size times its time (bound) at that size; ``own`` gives
        (ms, bound ms) of the calls whose time depends on the prove's
        operands, not their size alone (the combination's program).  Also
        returns the ms a call at each (name, size)."""
        prove_ms = dict.fromkeys(launches, 0.0)
        prove_bound_ms = dict.fromkeys(launches, 0.0)
        per_call = {}
        for size, counts in by_size.items():
            for name, count in counts.items():
                if (name, size) in own:
                    ms, bound_ms = own[name, size]
                else:
                    if (name, size) not in timed:
                        timed[name, size] = device_ms(launch_at(name, size))
                    ms = timed[name, size]
                    bound_ms = (ntt_sizes[size][name]["bound"] if name.startswith("ntt_")
                                else bound_at(name, size)[0])
                prove_ms[name] += count * ms
                prove_bound_ms[name] += count * bound_ms
                per_call[name, size] = ms
        if any(sum(v.get(name, 0) for v in by_size.values()) != launches[name] for name in launches):
            raise AssertionError(f"launches by size do not add up to the launch counts: {by_size} vs {launches}")
        return prove_ms, prove_bound_ms, per_call

    prove_ms, prove_bound_ms, prove_calls = kernel_sums(by_size, launches,
                                                        own={("combination", 1 << 20): (fib_comb["kernel"],
                                                                                         fib_comb["bound"])})
    # mont_digits' row: the size it spends most of the prove's time at
    digits_sizes = {size: v["mont_digits"] * timed["mont_digits", size]
                    for size, v in by_size.items() if "mont_digits" in v}
    digits_main = max(digits_sizes, key=digits_sizes.get)
    digits_in = limbs.from_numpy(limbs.seeded_mont(digits_main, digits_main), dev)
    report["mont_digits"] = (timed["mont_digits", digits_main], call_ms(lambda: dm.plain_digits(digits_in)),
                             *bound_at("mont_digits", digits_main))
    # the gather's row: the launch size it spends most of the prove's time at
    gather_sizes_ms = {size: v["mont_digits_gather"] * timed["mont_digits_gather", size]
                       for size, v in by_size.items() if "mont_digits_gather" in v}
    gather_main = max(gather_sizes_ms, key=gather_sizes_ms.get)
    gather_idx = gather_indices(1 << 20, gather_main, 11) if gather_main <= cuda_merkle.GATHER_MAX_INDICES else None
    report["mont_digits_gather"] = (
        timed["mont_digits_gather", gather_main],
        call_ms(lambda: dm.plain_digits(mont[:, gather_idx])) if gather_idx else None,
        *bound_at("mont_digits_gather", gather_main))
    # the levels the top kernel hashes, as the chain of level launches it replaces
    small_levels_before = sum(v["merkle_top"] * top_sweep[size]["level_chain"]
                              for size, v in by_size.items() if "merkle_top" in v)
    # K5 split into the wide levels (inputs above SUBTREE_WIDTH) and the
    # middle ones, which the subtrees kernel hashes; those as the chain of
    # level launches they replace (phase 2's times)
    k5_sizes = {size: v["merkle_level"] for size, v in by_size.items() if "merkle_level" in v}
    k5_split = {part: {"launches": sum(c for size, c in k5_sizes.items() if keep(size)),
                       "ms": sum(c * timed["merkle_level", size] for size, c in k5_sizes.items() if keep(size))}
                for part, keep in (("wide", lambda w: w > sub_width), ("middle", lambda w: w <= sub_width))}
    middle_before = sum(sub_sweep[size]["level_chain"] * v["merkle_subtrees"]
                        for size, v in by_size.items() if "merkle_subtrees" in v)
    say("prove_kernels", prove_ms=prove_ms, prove_bound_ms=prove_bound_ms, merkle_level_split=k5_split,
        middle_levels_ms={"level_launches": middle_before, "merkle_subtrees": prove_ms["merkle_subtrees"]},
        small_levels_ms={"level_launches": small_levels_before, "merkle_top": prove_ms["merkle_top"]},
        by_size=[{"size": size, **{k: {"launches": c, "ms": prove_calls[k, size]} for k, c in v.items()}}
                 for size, v in by_size.items()])

    # -- 5. the chain: RescueChainStark(4096) on its 2^20-point FRI domain ----------
    t0 = time.perf_counter()
    chain = RescueChainStark(CHAIN_HASHES, rng=DeterministicRandom(SEED))  # the card is the default device
    chain_setup_s = time.perf_counter() - t0
    if (chain.stark.fri_domain_length != 1 << 20 or chain.air.trace_length != 28 * CHAIN_HASHES
            or not chain.stark._use_device_pipeline()):
        raise AssertionError(f"unexpected chain shape: FRI domain {chain.stark.fri_domain_length}, "
                             f"trace {chain.air.trace_length}")
    t0 = time.perf_counter()
    chain_air = chain.constraints  # built once, on the host
    chain_air_s = time.perf_counter() - t0
    print(f"chain AIR build seconds: {chain_air_s:.3f}", flush=True)
    if rescue_chain._native_rescue() is None:
        raise AssertionError("the chain's witness would come from the Python golden model, not the host library")
    x = FieldElement(CHAIN_INPUT)
    t0 = time.perf_counter()
    chain.air.trace_limbs(x)
    chain_witness_s = time.perf_counter() - t0
    Stark._interpolate_trace = refuse_host_interpolation
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with (guard.count_plain_calls() as chain_plain_cold,
              watch_gathers(kernels, guard, device_prover, Stark, cuda_merkle) as chain_gathers):
            chain_out, chain_proof = chain.prove(x)
            torch.cuda.synchronize()
        chain_cold_s = time.perf_counter() - t0
        chain_gather_calls = chain_gathers.check("the chain prove", ["gather_values_async"])
        chain_cold_split = combination_split(chain.stark.last_profile)
        chain_launches = dict(kernels.LAUNCHES)
        chain_by_size = {n: dict(v) for n, v in sorted(kernels.LAUNCHES_BY_SIZE.items())}
        chain_peak_mib = torch.cuda.max_memory_allocated() / 2**20
        chain_stages = {k: round(v, 4) for k, v in sorted(chain.stark.last_profile.totals.items(),
                                                          key=lambda kv: -kv[1])}
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with guard.count_plain_calls() as chain_plain_warm:
            warm_out, _ = chain.prove(x)
            torch.cuda.synchronize()
        chain_warm_s = time.perf_counter() - t0
        chain_warm_split = combination_split(chain.stark.last_profile)
        chain_warm_launches = dict(kernels.LAUNCHES)
        chain_warm_peak_mib = torch.cuda.max_memory_allocated() / 2**20
        chain_warm_stages = {k: round(v, 4) for k, v in sorted(chain.stark.last_profile.totals.items(),
                                                               key=lambda kv: -kv[1])}
    finally:
        Stark._interpolate_trace = host_interpolation
    chain_ntt = sorted({n for n, v in chain_by_size.items() if any(k.startswith("ntt_") for k in v)})
    chain_prefix = {n: v["prefix_mul"] for n, v in chain_by_size.items() if "prefix_mul" in v}
    say("chain_prove", hashes=CHAIN_HASHES, rows=chain.air.trace_length, fri_domain=chain.stark.fri_domain_length,
        omicron_domain=chain.stark.omicron_domain_length, constraint_terms=[len(c.dict) for c in chain_air],
        setup_seconds=chain_setup_s, air_build_seconds=chain_air_s, witness_seconds=chain_witness_s,
        prove_seconds=chain_cold_s, warm_prove_seconds=chain_warm_s, proof_bytes=len(chain_proof),
        fused_fri_rounds=chain.stark.fri.last_fused_rounds, launches=chain_launches,
        warm_launches=chain_warm_launches, ntt_sizes=chain_ntt, prefix_mul_by_size=chain_prefix,
        stages_seconds=chain_stages, warm_stages_seconds=chain_warm_stages,
        plain_field_ops_on_cuda={"cold": sum(chain_plain_cold.values()), "warm": sum(chain_plain_warm.values())},
        combination_split={"cold": chain_cold_split, "warm": chain_warm_split}, peak_device_mib=chain_peak_mib,
        warm_peak_device_mib=chain_warm_peak_mib)
    if sum(chain_plain_cold.values()) or sum(chain_plain_warm.values()):
        raise AssertionError(f"the chain proves called field_ops on CUDA tensors: cold {dict(chain_plain_cold)}, "
                             f"warm {dict(chain_plain_warm)}")
    if (chain_launches["combination"], chain_warm_launches["combination"]) != (1, 1):
        raise AssertionError(f"the chain proves launched the combination {chain_launches['combination']} and "
                             f"{chain_warm_launches['combination']} times, expected once each")
    missing = [k for k in pipeline if chain_launches[k] <= 0]
    if missing:
        raise AssertionError(f"the chain prove never launched {missing}: {chain_launches}")
    if chain_launches["merkle_top"] != len(PROVE_TREES):
        raise AssertionError(f"the chain prove launched merkle_top {chain_launches['merkle_top']} times")
    if any(chain_launches[k] for k in kernels.PROBES):
        raise AssertionError(f"the chain prove launched a probe kernel: {chain_launches}")
    if sorted(set(chain_ntt) - set(ntt_sizes)):
        raise AssertionError(f"the chain prove ran NTT passes at sizes phase 2 did not check: {chain_ntt}")
    if chain_prefix != CHAIN_PREFIX_CALLS:
        raise AssertionError(f"the chain prove launched prefix_mul {chain_prefix} by size, expected {CHAIN_PREFIX_CALLS}")
    if warm_out != chain_out:
        raise AssertionError("the warm chain prove claims another output than the cold one")
    # the port's host verifier, on the AIR built above (the same Stark shape)
    chain_verifier = RescueChainStark(CHAIN_HASHES, device=None)
    chain_verifier._constraints = chain_air
    t0 = time.perf_counter()
    ok = chain_verifier.verify(chain_out, chain_proof)
    chain_verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the host verifier rejects the card's chain proof")
    if chain_verifier.verify(chain_out + FieldElement(1), chain_proof):
        raise AssertionError("the host verifier accepts a wrong chain output")
    # the card's model verifies too: its AIR values at the queries are one
    # gather launch over the group codewords its prove built
    with watch_gathers(kernels, guard, device_prover, Stark, cuda_merkle) as card_verify:
        t0 = time.perf_counter()
        ok = chain.verify(chain_out, chain_proof)
        chain_card_verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the card's chain model rejects its own proof")
    card_verify_calls = card_verify.check("the chain verify on the card", ["_device_air_group_values"])
    # K11 with the chain's own structure and group codewords (built by its
    # prove, cached), at 2^13 (their first 8192 points) and 2^20, against
    # its plain version; timed at 2^20
    chain_core = chain.stark._device_core()
    chain_groups, chain_structure = chain.stark._device_air_groups(chain_core, chain_air)
    chain_program = cuda_combination.encode(chain_structure, chain.stark.num_registers, chain.stark.expansion_factor)
    chain_comb_errs = {}
    for logn in (13, 20):
        m = 1 << logn
        groups = [g[:, :m].contiguous() for g in chain_groups]
        chain_args = combination_operands(limbs, chain_structure, groups, m, 7000 + logn, dev,
                                          num_bq=chain.stark.num_registers)
        got = cuda_combination.combination(chain_program, *chain_args)
        want = cuda_combination.combination_plain(chain_program, *chain_args)
        chain_comb_errs[m] = max(max_abs_err(torch, got[0], want[0]), max_abs_err(torch, got[1], want[1]))
        del got, want
    if any(chain_comb_errs.values()):
        raise AssertionError(f"the combination kernel disagrees with its plain version on the chain's structure: "
                             f"{chain_comb_errs}")
    chain_comb = {"kernel": device_ms(lambda: cuda_combination.combination(chain_program, *chain_args)),
                  "plain": call_ms(lambda: cuda_combination.combination_plain(chain_program, *chain_args), reps=2),
                  "bytes": combination_bytes(chain_args), "products_per_point": program_products(chain_program)}
    chain_comb["bound"], chain_comb["bound_by"] = bound(
        chain_comb["bytes"], product * (chain_comb["products_per_point"] * (1 << 20) / 32))
    del chain_args
    say("combination_kernel", structure="rescue_chain", constraints=len(chain_structure),
        groups=len(chain_groups), powers=len(chain_program.powers), terms=len(chain_program.terms),
        max_abs_err=chain_comb_errs, ms=chain_comb)
    chain_ms, chain_bound_ms, chain_calls = kernel_sums(
        chain_by_size, chain_launches, own={("combination", 1 << 20): (chain_comb["kernel"], chain_comb["bound"])})
    say("chain_kernels", verify_seconds=chain_verify_s, card_verify_seconds=chain_card_verify_s,
        opening_gathers={"prove": chain_gather_calls, "card_verify": card_verify_calls},
        prove_ms=chain_ms, prove_bound_ms=chain_bound_ms,
        by_size=[{"size": size, **{k: {"launches": c, "ms": chain_calls[k, size]} for k, c in v.items()}}
                 for size, v in chain_by_size.items()])

    # -- 6. the service on the card ---------------------------------------------
    t0 = time.perf_counter()
    say("service", **service_phase(steps, len(fib_proof)), seconds=time.perf_counter() - t0)

    # -- 7. the mesh -------------------------------------------------------------
    t0 = time.perf_counter()
    mesh = mesh_phase(torch, dev, steps, fib_claim, fib_proof, one_device)
    mesh_launches = mesh["fib"]["launches"]
    say("mesh", **mesh, seconds=time.perf_counter() - t0)
    # the variants' device time in the mesh prove: their launches at each
    # size times their time (bound) there, K11's next-row form at phase 2's
    # shard shape with fib's program
    mesh_ms, mesh_bound_ms, _ = kernel_sums(
        mesh["fib"]["variants_by_size"], {name: mesh_launches[name] for name in kernels.MESH_VARIANTS},
        own={("combination_next", shard_n): (next_comb["kernel"], next_comb["bound"])})
    prove_ms.update(mesh_ms)
    prove_bound_ms.update(mesh_bound_ms)

    # -- 8. the mesh over two processes ------------------------------------------
    t0 = time.perf_counter()
    multiprocess = multiprocess_phase(steps, fib_claim, fib_proof, mesh["fib"])
    say("multiprocess", **multiprocess, seconds=time.perf_counter() - t0)
    mp_launches = {}
    for r in multiprocess["per_rank"]:
        for name, count in r["launches"].items():
            mp_launches[name] = mp_launches.get(name, 0) + count

    # -- 9. precompile in fresh processes --------------------------------------
    t0 = time.perf_counter()
    say("precompile", **precompile_phase(hashlib.sha256(fib_proof).hexdigest(),
                                         hashlib.sha256(chain_proof).hexdigest()),
        cold={"fib": one_device["prove_seconds"], "chain": chain_cold_s},
        warm={"fib": one_device["warm_prove_seconds"], "chain": chain_warm_s},
        seconds=time.perf_counter() - t0)

    leaked = sorted(m for m in sys.modules if m in ("jax", "stark_tpu") or m.startswith(("jax.", "stark_tpu.")))
    if leaked:
        raise AssertionError(f"modules of JAX or of the JAX package were imported: {leaked[:5]}")

    # -- 10. result -----------------------------------------------------------
    sources = {
        "ntt_pass1": ("stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_ntt.py:234"),
        "ntt_pass2": ("stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_ntt.py:311"),
        "merkle_leaves": ("stark_tpu_torch/csrc/merkle.cu", "stark_tpu/ops/pallas_merkle.py:156"),
        "merkle_level": ("stark_tpu_torch/csrc/merkle.cu", "stark_tpu/ops/pallas_merkle.py:185"),
        "merkle_subtrees": ("stark_tpu_torch/csrc/merkle.cu", "stark_tpu/ops/pallas_merkle.py:237"),
        "merkle_top": ("stark_tpu_torch/csrc/merkle.cu", "stark_tpu/ops/pallas_merkle.py:215"),
        "fri_fold": ("stark_tpu_torch/csrc/fold.cu", "stark_tpu/ops/pallas_fold.py:145"),
        "fs_round": ("stark_tpu_torch/csrc/fs.cu", "stark_tpu/ops/device_keccak.py:132"),
        "mont_inv": ("stark_tpu_torch/csrc/fieldvec.cu", "stark_tpu/ops/field_ops.py:432"),
        "prefix_mul": ("stark_tpu_torch/csrc/fieldvec.cu", "stark_tpu/ops/geometric_device.py:48"),
        "geometric_table": ("stark_tpu_torch/csrc/fieldvec.cu", "stark_tpu/ops/device_prover.py:226"),
        "mont_binary": ("stark_tpu_torch/csrc/fieldvec.cu", "stark_tpu/ops/field_ops.py:244"),
        "rescue_permutation": ("stark_tpu_torch/csrc/rescue.cu", "stark_tpu/ops/rescue.py:92"),
        "combination": ("stark_tpu_torch/csrc/combination.cu", "stark_tpu/ops/device_prover.py:695"),
        "mont_digits": ("stark_tpu_torch/csrc/merkle.cu", "stark_tpu/ops/device_prover.py:54"),
        "mont_digits_gather": ("stark_tpu_torch/csrc/merkle.cu", "stark_tpu/ops/device_prover.py:64"),
        "combination_next": ("stark_tpu_torch/csrc/combination.cu", "stark_tpu/parallel/stark_sharded.py:368"),
        "mont_outer": ("stark_tpu_torch/csrc/fieldvec.cu", "stark_tpu/parallel/fold_sharded.py:61"),
        **{name: ("stark_tpu_torch/csrc/probes.cu", rep) for name, (_, rep) in probes.items()},
    }
    # launches on each kernel's own path: the fib-2^16 prove, prove_batch's
    # for R1, the probes' entry points (phase 2b) for theirs
    path_launches = dict(launches, rescue_permutation=batch_launches["rescue_permutation"], **probe_launches,
                         **{name: mesh_launches[name] for name in kernels.MESH_VARIANTS})

    def on_prove(name: str, value):
        """A prove's time of a kernel; None for a probe, on no prove's path."""
        return None if name in kernels.PROBES else value

    rows = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": path_launches[name],
         "max_abs_err": errs[name], "ms": report[name][0], "plain_ms": report[name][1],
         "bound_ms": report[name][2], "bound_by": report[name][3], "library_ms": library_ms.get(name),
         "function_bound_ms": function_bound.get(name),
         "launch_floor_ms": floor_ms if name in LATENCY_BOUND else None,
         "prove_ms": on_prove(name, prove_ms[name]), "prove_bound_ms": on_prove(name, prove_bound_ms[name]),
         "mesh_launches": mesh_launches.get(name), "multiprocess_launches": mp_launches.get(name, 0),
         "chain_launches": chain_launches[name], "chain_prove_ms": on_prove(name, chain_ms[name]),
         "chain_prove_bound_ms": on_prove(name, chain_bound_ms[name])}
        for name, (src, rep) in sources.items()
    ]
    # K2/K3's narrower clusters: phase 2's checks and times, launches in
    # phase 7's chain-4 over the mesh (a shard of 8 w^2 points is w wide)
    chain_ntt = mesh["chain"]["ntt_launches_by_size"]
    for row in rows:
        if row["name"] in ntt_widths:
            row["cluster_widths"] = {w: dict(v, launches=chain_ntt.get(8 * w * w, {}).get(row["name"], 0))
                                     for w, v in ntt_widths[row["name"]].items()}
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--times":
        sys.exit(times_of(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--proves":
        sys.exit(proves_of(sys.argv[2]))
    if len(sys.argv) == 6 and sys.argv[1] == "--precompile":
        sys.exit(precompile_of(int(sys.argv[2]), *sys.argv[3:]))
    if len(sys.argv) != 1:
        sys.exit(f"usage: {sys.argv[0]} [--times DIR | --proves DIR | --precompile THREADS MODELS FIB_SHA CHAIN_SHA]")
    sys.exit(main())
