"""Sharded proving over a mesh of shards, driven by one process or several.

Counterpart of :mod:`stark_tpu.parallel`.  A mesh is an ordered tuple of
torch devices, one a shard, repeats allowed, or a :class:`~.mesh.SpanningMesh`
whose shards the ranks of a ``torch.distributed`` process group own
(:func:`~.mesh.init_distributed`, :func:`~.mesh.spanning_mesh`; the
multi-controller mode) (:mod:`.mesh`); a codeword is
a :class:`~.mesh.ShardedArray` in the four-step layout, its NTT the
sharded four-step transform (:mod:`.ntt_sharded`), its FRI folds
shard-local (:mod:`.fold_sharded`), its commitment a subtree a
natural-order block (:mod:`.merkle_sharded`), and :mod:`.stark_sharded`
the prover core and backend a ``Stark`` proves through.  Every per-shard
step is a hand kernel on the card; the JAX module's ``all_to_all`` is a
chunk exchange of slices and copies, and one ``all_to_all_single``
between ranks.
"""

from .mesh import ShardedArray, SpanningMesh, cpu_mesh, init_distributed, make_mesh, spanning_mesh
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
    "init_distributed",
    "spanning_mesh",
    "SpanningMesh",
    "ShardedArray",
    "ShardedNTT",
    "ShardedProverCore",
    "ShardedBackend",
]
