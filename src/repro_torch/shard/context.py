"""The shard context of the sequence-parallel serving path.

Counterpart of ``repro/shard/context.py``.  ``ShardedModel`` installs a
``ShardContext`` around each serving call of the wrapped model; the
attention layers deep in that call (their per-shard partials and merge)
read it through ``sp_shard_info`` instead of a new argument threaded
through every Module signature.  Outside any ``shard_scope`` it returns
None and the model runs its unsharded path unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """``sp``: the number of sequence shards (1 = off)."""

    sp: int = 1


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


def sp_shard_info() -> Optional[ShardContext]:
    """The context iff sequence parallelism is active (sp > 1)."""
    c = _CURRENT
    return c if c is not None and c.sp > 1 else None
