"""Sharded proving over a mesh of shards (one controller).

Counterpart of :mod:`stark_tpu.parallel`.  A mesh is an ordered tuple of
torch devices, one a shard, repeats allowed (:mod:`.mesh`); a codeword is
a :class:`~.mesh.ShardedArray` in the four-step layout, its NTT the
sharded four-step transform (:mod:`.ntt_sharded`), its FRI folds
shard-local (:mod:`.fold_sharded`), its commitment a subtree a
natural-order block (:mod:`.merkle_sharded`), and :mod:`.stark_sharded`
the prover core and backend a ``Stark`` proves through.  Every per-shard
step is a hand kernel on the card; the JAX module's ``all_to_all`` is a
chunk exchange of slices and copies.
"""

from .mesh import ShardedArray, cpu_mesh, make_mesh
from .ntt_sharded import ShardedNTT


def __getattr__(name):
    # lazy: stark_sharded pulls in the device-prover stack
    if name in ("ShardedProverCore", "ShardedBackend"):
        from . import stark_sharded

        return getattr(stark_sharded, name)
    raise AttributeError(name)


__all__ = [
    "make_mesh",
    "cpu_mesh",
    "ShardedArray",
    "ShardedNTT",
    "ShardedProverCore",
    "ShardedBackend",
]
