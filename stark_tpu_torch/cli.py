"""Command-line interface of the torch prover.

    python -m stark_tpu_torch.cli prove  --input 57322816861100832358702415967512842988 --out proof.bin
    python -m stark_tpu_torch.cli verify --output <hash> --proof proof.bin
    python -m stark_tpu_torch.cli prove  --model fibonacci --steps 65536 --seed 1 --out fib.bin
    python -m stark_tpu_torch.cli verify --model fibonacci --steps 65536 --output <result> --proof fib.bin
    python -m stark_tpu_torch.cli prove  --model mimc --steps 1024 --input 3 --out mimc.bin
    python -m stark_tpu_torch.cli verify --model mimc --steps 1024 --input 3 --output <result> --proof mimc.bin
    python -m stark_tpu_torch.cli prove  --model rescue-chain --hashes 4096 --input 1 --out chain.bin
    python -m stark_tpu_torch.cli verify --model rescue-chain --hashes 4096 --output <digest> --proof chain.bin
    python -m stark_tpu_torch.cli hash   --input 1
    python -m stark_tpu_torch.cli inspect --proof proof.bin
    python -m stark_tpu_torch.cli info

Proof files are the ones ``python -m stark_tpu.cli`` reads and writes, and
``hash`` and ``inspect`` print what it prints.  ``--device`` defaults to
``cuda``; finding no CUDA device is an error.  ``--device cpu`` runs the
plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_model(args):
    from .rng import DeterministicRandom, os_random_bytes

    common = dict(
        device=args.device,
        expansion_factor=args.expansion_factor,
        num_colinearity_tests=args.num_colinearity_tests,
        security_level=args.security_level,
        rng=DeterministicRandom(args.seed) if args.seed is not None else os_random_bytes,
    )
    if args.model == "fibonacci":
        from .models.fibonacci import FibonacciStark

        return FibonacciStark(args.steps, **common)
    if args.model == "mimc":
        from .field import FieldElement
        from .models.mimc import DEFAULT_KEY, MimcStark

        key = FieldElement(int(args.key, 0)) if args.key is not None else DEFAULT_KEY
        return MimcStark(args.steps, key=key, **common)
    if args.model == "rescue-chain":
        from .models.rescue_chain import RescueChainStark

        return RescueChainStark(args.hashes, **common)
    from .models.rescue_stark import RescueStark

    return RescueStark(**common)


def _classify(obj: str) -> str:
    if len(obj) == 64 and all(c in "0123456789abcdef" for c in obj):
        return "merkle_root"
    if obj.startswith('{"value"'):
        return "leaf_value"
    if obj.startswith('[{"value"'):
        return "codeword"
    if obj.startswith('["'):
        return "colinearity_points"
    if obj.startswith("[["):
        return "auth_path"
    return "other"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="stark_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    def add_common(p):
        p.add_argument("--model", choices=["rescue", "fibonacci", "mimc", "rescue-chain"], default="rescue",
                       help="model family: Rescue-Prime hash preimage (default), Fibonacci sequence, "
                       "MiMC cubing chain x -> x^3 + k, or a chain of Rescue-Prime hashes in one proof")
        p.add_argument("--steps", type=int, default=None, help="trace steps (fibonacci/mimc models; default 4096)")
        p.add_argument("--hashes", type=int, default=None, help="chain length (rescue-chain model; default 64)")
        p.add_argument("--seed-a", default=None, help="first sequence seed (fibonacci model only; default 1)")
        p.add_argument("--seed-b", default=None, help="second sequence seed (fibonacci model only; default 1)")
        p.add_argument("--key", default=None,
                       help="round key field element (mimc model only; default: a fixed nothing-up-my-sleeve "
                       "constant)")
        p.add_argument("--expansion-factor", type=int, default=4)
        p.add_argument("--num-colinearity-tests", type=int, default=2)
        p.add_argument("--security-level", type=int, default=2)
        p.add_argument("--device", default="cuda",
                       help="torch device of the prover (default cuda; 'cpu' runs the plain versions)")
        p.add_argument("--seed", type=int, default=None, help="deterministic proof randomness (testing)")

    p = sub.add_parser("prove", help="prove a statement (preimage / sequence / chain)")
    p.add_argument("--input", default=None, help="preimage or chain seed field element (rescue, mimc, rescue-chain)")
    p.add_argument("--out", required=True, help="output proof file")
    add_common(p)

    p = sub.add_parser("verify", help="verify a proof against a claimed output")
    p.add_argument("--output", required=True, help="claimed hash output / sequence result (int)")
    p.add_argument("--proof", required=True, help="proof file")
    p.add_argument("--input", default=None, help="public chain seed (mimc model only)")
    add_common(p)

    p = sub.add_parser("hash", help="compute a Rescue-Prime hash")
    p.add_argument("--input", required=True)

    p = sub.add_parser("inspect", help="summarize a proof file's structure")
    p.add_argument("--proof", required=True)

    sub.add_parser("info", help="print field/protocol parameters")

    args = parser.parse_args(argv)

    from .field import FieldElement
    from .params import GENERATOR, P

    def parse_element(text: str, what: str) -> FieldElement:
        try:
            return FieldElement(int(text, 0))
        except ValueError:
            parser.error(f"{what} must be an integer, got {text!r}")

    if args.command == "hash":
        from .rescue_prime import RescuePrime

        print(RescuePrime().hash(parse_element(args.input, "--input")).value)
        return 0

    if args.command == "inspect":
        from .proof_stream import ProofStream

        with open(args.proof, "rb") as f:
            data = f.read()
        try:
            objects = ProofStream.deserialize(data).objects
        except ValueError as exc:
            print(json.dumps({"error": f"malformed proof: {exc}"}))
            return 1
        kinds = {}
        for obj in objects:
            kind = _classify(obj)
            kinds[kind] = kinds.get(kind, 0) + 1
        print(json.dumps({"proof_bytes": len(data), "transcript_objects": len(objects), "object_kinds": kinds},
                         indent=2))
        return 0

    if args.command == "info":
        import torch

        info = {
            "prime": str(P),
            "prime_formula": "1 + 407 * 2^119",
            "generator": str(GENERATOR),
            "hash": "Rescue-Prime (m=2, N=27, alpha=3)",
            "merkle": "Blake2b-256",
            "fiat_shamir": "Shake256",
            "torch": torch.__version__,
            "cuda_devices": torch.cuda.device_count(),
        }
        print(json.dumps(info, indent=2))
        return 0

    fib = args.model == "fibonacci"
    mimc = args.model == "mimc"
    # reject cross-model arguments: silently ignoring them would let a
    # user "prove" a different statement than they asked for
    allowed = {
        "rescue": {"input"},
        "fibonacci": {"steps", "seed_a", "seed_b"},
        "mimc": {"steps", "input", "key"},
        "rescue-chain": {"input", "hashes"},
    }[args.model]
    for flag, attr in (("--input", "input"), ("--steps", "steps"), ("--seed-a", "seed_a"),
                       ("--seed-b", "seed_b"), ("--key", "key"), ("--hashes", "hashes")):
        if getattr(args, attr, None) is not None and attr not in allowed:
            parser.error(f"{flag} is not valid with --model {args.model}")
    if args.steps is None:
        args.steps = 4096
    if args.hashes is None:
        args.hashes = 64
    if mimc and args.key is not None:
        # a canonical decimal string (a clean parser error on garbage)
        args.key = str(parse_element(args.key, "--key").value)
    try:
        model = _build_model(args)
    except RuntimeError as exc:  # no CUDA device behind --device cuda
        parser.error(str(exc))
    if fib:
        seeds = (parse_element(args.seed_a or "1", "--seed-a"), parse_element(args.seed_b or "1", "--seed-b"))

    if args.command == "prove":
        if not fib and args.input is None:
            what = "the chain seed" if mimc else "the hash preimage"
            parser.error(f"--input ({what}) is required for the {args.model} model")
        t0 = time.perf_counter()
        if fib:
            output, proof = model.prove(*seeds)
        else:  # rescue, mimc and rescue-chain all prove from one element
            output, proof = model.prove(parse_element(args.input, "--input"))
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
    if fib:
        ok = model.verify(*seeds, claimed, proof)
    elif mimc:
        if args.input is None:
            parser.error("--input (the chain seed) is required to verify a mimc proof")
        ok = model.verify(parse_element(args.input, "--input"), claimed, proof)
    else:
        if args.input is not None:
            parser.error(f"{args.model} verify takes no --input: the statement is the hash output alone")
        ok = model.verify(claimed, proof)
    dt = time.perf_counter() - t0
    print(json.dumps({"valid": bool(ok), "verify_seconds": round(dt, 3)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
