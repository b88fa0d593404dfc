"""The shard context of the sharded serving paths.

Counterpart of ``repro/shard/context.py``.  ``ShardedModel`` installs a
``ShardContext`` around each serving call of the wrapped model; the layers
deep in that call read it instead of a new argument threaded through every
Module signature: the attention layers under sequence parallelism
(``sp_shard_info``: their per-shard partials and merge), the row-parallel
Dense layers under tensor parallelism (``tp_shard_info``: their int32
partials and the reduce, ``core/api.py``).  Outside any ``shard_scope``
both return None and the model runs its unsharded path unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """``tp``/``sp``: the numbers of tensor and sequence shards (1 = off).
    They share the reference's one ``model`` mesh axis, so at most one of
    them is above 1.  ``mesh``: the ``launch.mesh.RankMesh`` of this
    process where each shard is a process of its own (its weights, KV
    heads or cache rows are this rank's), None where one process serves
    every shard."""

    tp: int = 1
    sp: int = 1
    mesh: object = None

    def __post_init__(self):
        if self.tp > 1 and self.sp > 1:
            raise ValueError(
                "tp and sp share the one 'model' mesh axis — run one of "
                "them per engine (tp*sp composition needs a 2-axis mesh)")


_CURRENT: Optional[ShardContext] = None


@contextlib.contextmanager
def shard_scope(ctx: ShardContext):
    """Install ``ctx`` for the duration of a call (re-entrant; restores the
    previous context on exit, also when the call raises)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield ctx
    finally:
        _CURRENT = prev


def tp_shard_info() -> Optional[ShardContext]:
    """The context iff tensor parallelism is active (tp > 1)."""
    c = _CURRENT
    return c if c is not None and c.tp > 1 else None


def sp_shard_info() -> Optional[ShardContext]:
    """The context iff sequence parallelism is active (sp > 1)."""
    c = _CURRENT
    return c if c is not None and c.sp > 1 else None
