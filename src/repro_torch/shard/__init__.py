"""Sequence- and tensor-parallel serving.

Counterpart of ``repro/shard``: the KV cache's sequence axis (sp) or the
heads and FFN width (tp) split into shards, served either by one process
on one device (the shards as views of one global model and cache) or by
one process per shard on a rank mesh (``launch.mesh.RankMesh``: each rank
its slice, joined by ``torch.distributed`` collectives).

  * ``ShardContext`` / ``shard_scope``: the context the attention and row
    layers read (``sp_shard_info``, ``context.tp_shard_info``);
  * ``ShardedModel``: the serving model surface run inside that scope;
  * ``ShardedEngine``: the Engine facade with ``tp=`` / ``sp=`` (and
    ``mesh=`` a rank mesh);
  * ``partial_softmax``: the exact merge of the shards' decode partials;
  * ``seq_cache``: a sequence-parallel rank's owner writes and gathers.
"""
from repro_torch.shard.context import ShardContext, shard_scope, sp_shard_info
from repro_torch.shard.engine import ShardedEngine
from repro_torch.shard.model import ShardedModel

__all__ = ["ShardContext", "ShardedEngine", "ShardedModel", "shard_scope",
           "sp_shard_info"]
