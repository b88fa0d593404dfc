"""``ShardedModel``: the serving model surface under sequence parallelism.

Counterpart of ``repro/shard/model.py``.  The reference runs each serving
entry point through ``shard_map``, once per shard; every op except the
cache writes and decode attention is replicated there, computing the same
values on every shard.  The port runs that body ONCE, on one card, inside
a ``shard_scope``: the cache is the ordinary global cache, whose shard i is
the view ``k[:, i*S_local:(i+1)*S_local]``, so the unsharded writes are the
union of the reference's owner writes, and only decode attention loops
over the shards (each shard's flash partials, then the merge;
``models/attention.py``).  ``init_cache`` rounds to a shard multiple;
``readout_fn`` and everything else delegate to the wrapped model, and the
engine, its steps and the slot scheduler drive a ShardedModel exactly like
the model it wraps.
"""
from __future__ import annotations

from repro_torch.cache import layer_caches
from repro_torch.shard.context import ShardContext, shard_scope


def check_sp_cache(cache_tree, sp: int) -> None:
    """Raise unless every layer's cache is dense with a sequence axis that
    splits into ``sp`` equal shards (the check of the reference's
    ``dist/sharding.py::sp_cache_specs``)."""
    for c in layer_caches(cache_tree):
        if c.layout != "dense":
            raise ValueError(
                f"sequence-parallel serving shards the dense cache's S axis "
                f"-- layout {c.layout!r} unsupported")
        if c.capacity % sp:
            raise ValueError(f"cache k: sequence axis {c.capacity} not "
                             f"divisible by sp={sp}")


class ShardedModel:
    """Serving-surface wrapper; ``model``/``cfg`` are the GLOBAL model and
    config, served with ``sp`` sequence shards on the model's device."""

    def __init__(self, model, cfg, *, sp: int):
        self._shard_ctx = ShardContext(sp=sp)
        self._model = model
        self.cfg = cfg
        self.sp = sp

    def _run(self, method: str, cache, *args, **kw):
        check_sp_cache(cache, self.sp)
        with shard_scope(self._shard_ctx):
            return getattr(self._model, method)(*args, **kw)

    # -- the serving entry points -------------------------------------------
    def prefill(self, params, batch, cache, ctx=None):
        return self._run("prefill", cache, params, batch, cache, ctx)

    def prefill_chunk(self, params, tokens, cache, q_offset, ctx=None, *,
                      lengths=None, kv_limit=None):
        return self._run("prefill_chunk", cache, params, tokens, cache,
                         q_offset, ctx, lengths=lengths, kv_limit=kv_limit)

    def decode_step(self, params, tokens, cache, cur_pos, ctx=None, *,
                    slot_mask=None):
        return self._run("decode_step", cache, params, tokens, cache,
                         cur_pos, ctx, slot_mask=slot_mask)

    def verify_step(self, *args, **kw):
        raise NotImplementedError(
            "the sequence-parallel speculative verify window is not ported "
            "(ROADMAP Queue A item 13, speculative decoding)")

    # -- cache construction ---------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *args, **kw):
        """Global-shape caches with the S axis rounded up to a multiple of
        ``sp`` (the extra rows lie beyond every valid count).  Rounding here
        keeps the scheduler's batch cache and its batch-1 admission template
        consistent: both are sized through this method."""
        max_len = -(-max_len // self.sp) * self.sp
        return self._model.init_cache(batch, max_len, *args, **kw)

    # -- everything else is the global model ----------------------------------
    def __getattr__(self, name):
        # reached only for attributes not set on self: readout_fn, embed,
        # stack, hidden, ...
        if name == "_model":
            raise AttributeError(name)
        return getattr(self._model, name)
