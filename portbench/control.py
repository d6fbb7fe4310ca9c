"""The control of the comparison that decides ``correct``.

The configurations state no precision; they state guarantees
(``configs/<name>.json``).  The control is the reference put in the
program's place with one of them broken: ``one_test`` proves with one
colinearity test where the configuration states two (a weaker soundness,
half the query work), ``no_zk`` with zero randomizer rows and a zero
randomizer polynomial (no zero knowledge, no randomness drawn).  For each
seed it takes the statements a run of the cell would check, proves them
with the control and with the sound reference, and prints the numbers the
check compares.  A control proof must come out as not correct.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 [--device cuda]

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .check import byte_distance
from .reference import prover as R
from .run import ROOT, load_cell
from .statements import Generator, check_indices, rng_seed

CONTROLS = ("one_test", "no_zk")


_PROVERS = {}


def _prover(config: dict, size: int, tests: int, device):
    key = (config["model"], size, tests, str(device))
    if key not in _PROVERS:
        _PROVERS[key] = R.make_prover(config["model"], size, config["expansion_factor"], tests, device)
    return _PROVERS[key]


class _ZeroStream:
    def __init__(self, seed, counter=0) -> None:
        pass

    def draw(self, n: int) -> bytes:
        return bytes(n)


def control_proof(kind: str, config: dict, st, seed: int, counter: int, device):
    if kind == "one_test":
        return _prover(config, st.size, 1, device).prove(st.inputs, rng_seed(seed, 0), counter)
    if kind == "no_zk":
        ref = _prover(config, st.size, config["num_colinearity_tests"], device)
        stream = R.SeededStream
        R.SeededStream = _ZeroStream
        try:
            return ref.prove(st.inputs, rng_seed(seed, 0), counter)
        finally:
            R.SeededStream = stream
    raise ValueError(kind)


def readings(config: dict, traffic: dict, seed: int, device, completed: int = 2, size: int = None) -> dict:
    """Per control, the check's numbers on the statements a run with
    ``seed`` would check (``completed`` proves in its window)."""
    if size is not None:
        config = {**config, "size": size}
    gen = Generator(config, traffic, seed)
    picks = [gen.statement(k) for k in check_indices(seed, completed, int(config["check_sample"]))]
    sound = _prover(config, int(config["size"]), config["num_colinearity_tests"], device)
    out = {kind: {"proof_bytes_differing": 0, "claims_differing": 0} for kind in CONTROLS}
    for st in picks:
        counter = (1 + st.index) * sound.draws_per_prove
        claim, proof = sound.prove(st.inputs, rng_seed(seed, 0), counter)
        for kind in CONTROLS:
            c_claim, c_proof = control_proof(kind, config, st, seed, counter, device)
            out[kind]["proof_bytes_differing"] += byte_distance(c_proof, proof)
            out[kind]["claims_differing"] += int(c_claim != claim)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--completed", type=int, default=20, help="proves a window completes (the sample is drawn among them)")
    a = ap.parse_args(argv)
    _, cell, config, traffic = load_cell(ROOT, a.workload)
    for seed in a.seeds:
        t0 = time.perf_counter()
        got = readings(config, traffic, seed, a.device, a.completed)
        print(json.dumps({"workload": a.workload, "seed": seed, "seconds": time.perf_counter() - t0, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
