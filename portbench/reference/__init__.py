"""The plain reference the benchmark holds the port's proofs against.

A STARK prover of the same protocol (the "Anatomy of a STARK" transcript,
Blake2b-256 Merkle trees, Shake256 Fiat-Shamir, FRI over the coset of the
2^119 generator), written from the protocol itself in Python integers and
plain PyTorch tensor operations, with no kernel and nothing of the port:
it imports neither ``stark_tpu`` nor ``stark_tpu_torch``, and it takes from
a run only the statement and the seed of the randomness stream.  The field
arithmetic runs on whatever torch device it is given (the card in a run,
the CPU in the tests).
"""
