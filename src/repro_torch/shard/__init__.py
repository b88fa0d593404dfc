"""Sequence-parallel serving on one device.

Counterpart of ``repro/shard``: the KV cache's sequence axis is split into
shards; decode scores each shard's keys into flash partials (the partials
kernel) and merges them into the exact unsharded softmax
(``partial_softmax``).

  * ``ShardContext`` / ``shard_scope``: the context the attention layers
    read (``sp_shard_info``);
  * ``ShardedModel``: the serving model surface run inside that scope;
  * ``ShardedEngine``: the Engine facade with ``sp=``.

Tensor parallelism and shards on several devices are ROADMAP Queue A
item 18.
"""
from repro_torch.shard.context import ShardContext, shard_scope, sp_shard_info
from repro_torch.shard.engine import ShardedEngine
from repro_torch.shard.model import ShardedModel

__all__ = ["ShardContext", "ShardedEngine", "ShardedModel", "shard_scope",
           "sp_shard_info"]
