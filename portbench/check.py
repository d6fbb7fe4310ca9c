"""What decides ``correct``: the reference recomputes a sample of the
window's proofs, drawn by the seed, from their statements and the seeded
randomness stream alone, and each is compared with the program's, byte
for byte, with its claim.  Every number compared has the limit 0: the
protocol fixes the bytes."""

from __future__ import annotations

from typing import Dict, List

from .reference.prover import make_prover
from .statements import rng_seed

LIMITS = {"proof_bytes_differing": 0, "claims_differing": 0, "proves_failed": 0}


def stream_position(traffic: dict, position: int, index: int, warm_proves: int, draws: int):
    """(stream, first draw) of the prove at ``position`` in the window's
    records (the order the program ran them), of statement ``index``: a
    shared model draws every prove from stream 0, the set-up's proves
    first; a model a request draws from its own stream."""
    if traffic["model"] == "shared":
        return 0, (warm_proves + position) * draws
    return index + 1, 0


def byte_distance(a: bytes, b: bytes) -> int:
    """Positions at which two byte strings differ, the length difference
    counted as differing positions."""
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def compare(config: dict, traffic: dict, seed: int, samples: List[tuple], warm_proves: int, failed: int,
            device, position=stream_position) -> Dict[str, int]:
    """The numbers compared, over ``samples``: (position, record) of the
    proofs the reference recomputes, the position in the window's records;
    ``position`` is the loop's :func:`stream_position`."""
    provers = {}
    differing = claims = 0
    for pos, (st, _, claim, proof) in samples:
        ref = provers.get(st.size)
        if ref is None:
            ref = provers[st.size] = make_prover(config["model"], st.size, config["expansion_factor"],
                                                 config["num_colinearity_tests"], device)
        stream, counter = position(traffic, pos, st.index, warm_proves, ref.draws_per_prove)
        ref_claim, ref_proof = ref.prove(st.inputs, rng_seed(seed, stream), counter)
        differing += byte_distance(proof, ref_proof)
        claims += int(claim != ref_claim)
    return {"proof_bytes_differing": differing, "claims_differing": claims, "proves_failed": failed}
