"""Model families of the torch prover."""
