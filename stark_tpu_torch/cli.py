"""Command-line interface of the torch prover.

    python -m stark_tpu_torch.cli prove  --model fibonacci --steps 65536 --seed 1 --out fib.bin
    python -m stark_tpu_torch.cli verify --model fibonacci --steps 65536 --output <result> --proof fib.bin
    python -m stark_tpu_torch.cli info

Proof files are the ones ``python -m stark_tpu.cli`` reads and writes.
``--device`` defaults to ``cuda``; finding no CUDA device is an error.
The Fibonacci model is the only one ported so far.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="stark_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    def add_common(p):
        p.add_argument("--model", choices=["fibonacci"], default="fibonacci",
                       help="model family (only fibonacci is ported so far)")
        p.add_argument("--steps", type=int, default=4096, help="trace steps (default 4096)")
        p.add_argument("--seed-a", default="1", help="first sequence seed (default 1)")
        p.add_argument("--seed-b", default="1", help="second sequence seed (default 1)")
        p.add_argument("--expansion-factor", type=int, default=4)
        p.add_argument("--num-colinearity-tests", type=int, default=2)
        p.add_argument("--security-level", type=int, default=2)
        p.add_argument("--device", default="cuda",
                       help="torch device of the prover (default cuda; 'cpu' runs the plain versions)")
        p.add_argument("--seed", type=int, default=None, help="deterministic proof randomness (testing)")

    p = sub.add_parser("prove", help="prove the n-th element of the sequence")
    p.add_argument("--out", required=True, help="output proof file")
    add_common(p)

    p = sub.add_parser("verify", help="verify a proof against a claimed result")
    p.add_argument("--output", required=True, help="claimed sequence result (int)")
    p.add_argument("--proof", required=True, help="proof file")
    add_common(p)

    sub.add_parser("info", help="print field/protocol parameters")

    args = parser.parse_args(argv)

    from stark_tpu.field import FieldElement
    from stark_tpu.params import GENERATOR, P

    if args.command == "info":
        import torch

        info = {
            "prime": str(P),
            "prime_formula": "1 + 407 * 2^119",
            "generator": str(GENERATOR),
            "merkle": "Blake2b-256",
            "fiat_shamir": "Shake256",
            "torch": torch.__version__,
            "cuda_devices": torch.cuda.device_count(),
        }
        print(json.dumps(info, indent=2))
        return 0

    def parse_element(text: str, what: str) -> FieldElement:
        try:
            return FieldElement(int(text, 0))
        except ValueError:
            parser.error(f"{what} must be an integer, got {text!r}")

    from stark_tpu.rng import DeterministicRandom, os_random_bytes

    from .models.fibonacci import FibonacciStark

    rng = DeterministicRandom(args.seed) if args.seed is not None else os_random_bytes
    try:
        model = FibonacciStark(
            args.steps,
            device=args.device,
            expansion_factor=args.expansion_factor,
            num_colinearity_tests=args.num_colinearity_tests,
            security_level=args.security_level,
            rng=rng,
        )
    except RuntimeError as exc:  # no CUDA device behind --device cuda
        parser.error(str(exc))
    seeds = (parse_element(args.seed_a, "--seed-a"), parse_element(args.seed_b, "--seed-b"))

    if args.command == "prove":
        t0 = time.perf_counter()
        output, proof = model.prove(*seeds)
        dt = time.perf_counter() - t0
        with open(args.out, "wb") as f:
            f.write(proof)
        print(json.dumps({
            "output": str(output.value),
            "proof_file": args.out,
            "proof_bytes": len(proof),
            "prove_seconds": round(dt, 3),
            "device": str(model.stark.backend.device),
        }))
        return 0

    with open(args.proof, "rb") as f:
        proof = f.read()
    claimed = parse_element(args.output, "--output")
    t0 = time.perf_counter()
    ok = model.verify(*seeds, claimed, proof)
    dt = time.perf_counter() - t0
    print(json.dumps({"valid": bool(ok), "verify_seconds": round(dt, 3)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
