"""``ShardedModel``: the serving model surface under sequence or tensor
parallelism.

Counterpart of ``repro/shard/model.py``.  The reference runs each serving
entry point through ``shard_map``, once per shard.  The port runs that
body ONCE, on one card, inside a ``shard_scope``, and only the layers whose
result depends on the sharding read the shards.

Tensor parallel (``tp`` > 1).  The reference rebuilds the model at a local
config (``n_heads / tp``, ``n_kv_heads / tp``, ``d_ff / tp``), slices the
weights by role, the per-KV-head thresholds and the KV cache by heads
(``dist/sharding.py``), and reduces the row-parallel layers' int32
accumulators.  Every column of a column-parallel layer and every head of
attention is computed alone, so the union of the shards' local work is the
global model's; the port serves the global model, and only its
row-parallel layers read the shards: each shard's partial over its slice of
the weight's input rows, then the exact sum (``core/api.py``).  The
widths must divide as the reference's do (its ``ValueError``s), and a
mixture-of-experts stack is refused (``check_tp``).

Sequence parallel (``sp`` > 1).  Every op except the cache writes and
attention is replicated in the reference, computing the same values on
every shard.  The cache is the ordinary global cache, whose shard i is
the view ``k[:, i*S_local:(i+1)*S_local]``, so the unsharded writes are the
union of the reference's owner writes, and only the attentions read the
shards (decode: each shard's flash partials, then the merge; prefill and
the speculative verify window: the whole cache, as the reference's gather;
``models/attention.py``).  An SSM state has no sequence axis and is the
unsharded state.  An encoder-decoder's cross cache is the rows every shard
holds alike: the reference's cross prefill writes the first
min(S_local, frames) rows of the encoder's memory into each shard's slice
of the cross cache and its cross decode attends that slice, so
``init_cache`` sizes the cross cache to those rows.  ``init_cache`` rounds
to a shard multiple; ``readout_fn`` and everything else delegate to the
wrapped model, and the engine, its steps, its strategies and the slot
scheduler drive a ShardedModel exactly like the model it wraps.

On a rank mesh (``launch.mesh.RankMesh``: one process per shard, as the
reference's devices) the wrapper is the reference's local model: under tp
the model is built at the local config (``local_config``: heads, KV heads
and ``d_ff`` divided by tp), served with the rank's slices of the weights,
thresholds and KV heads, and its row-parallel layers reduce their int32
partials over the ranks; under sp the rank's cache holds its S / sp rows,
written by owner writes and read by gathers (``shard/seq_cache.py``).
"""
from __future__ import annotations

from repro_torch.dist.sharding import check_tp_cache
from repro_torch.launch.mesh import RankMesh
from repro_torch.shard.context import ShardContext, shard_scope

# ROADMAP Queue C's line on the reference's mixture-of-experts under tp
MOE_TP_REFUSAL = (
    "tensor-parallel serving of a mixture-of-experts stack is refused: the "
    "reference's ShardedEngine(tp > 1) splits each expert's d_ff over the "
    "shards but never reduces the experts' down-projection partial sums, "
    "so its tokens are wrong (ROADMAP Queue C)")


def check_tp(cfg, tp: int) -> None:
    """Raise unless ``cfg`` serves with ``tp`` tensor shards: the heads,
    the KV heads and the FFN width divide by ``tp`` (the reference's
    message), and no layer is a mixture of experts (``MOE_TP_REFUSAL``)."""
    for field, dim in (("n_heads", cfg.n_heads),
                       ("n_kv_heads", cfg.n_kv_heads), ("d_ff", cfg.d_ff)):
        if dim % tp:
            raise ValueError(f"cfg.{field}={dim} not divisible by tp={tp}")
    if cfg.ffn == "moe":
        raise ValueError(MOE_TP_REFUSAL)


def local_config(cfg, tp: int):
    """The config of one of ``tp`` tensor-parallel ranks: the reference's
    local config, heads, KV heads and FFN width divided by ``tp`` at the
    same head dim and name (so every layer path and threshold key is the
    global model's)."""
    return cfg.replace(n_heads=cfg.n_heads // tp,
                       n_kv_heads=cfg.n_kv_heads // tp, d_ff=cfg.d_ff // tp,
                       head_dim=cfg.head_dim)


def check_sp_cache(cache_tree, sp: int) -> None:
    """Raise unless the sequence axis of every layer's attention cache
    splits into ``sp`` equal shards: the check of the reference's
    ``dist/sharding.py::sp_cache_specs``, which reads only the S axis of
    the k/v leaves (a layout the sequence-parallel attention cannot read
    raises there, naming its layer).  SSM states pass; a cross cache holds
    the rows every shard holds alike (``ShardedModel.init_cache``), not a
    split axis."""
    for key, sub in cache_tree.items():
        if key in ("mamba", "cross"):
            continue
        if isinstance(sub, dict):
            check_sp_cache(sub, sp)
        elif sub.k.shape[-3] % sp:
            raise ValueError(f"cache k: sequence axis {sub.k.shape[-3]} "
                             f"not divisible by sp={sp}")


class ShardedModel:
    """Serving-surface wrapper; ``model``/``cfg`` are the GLOBAL model and
    config, served with ``tp`` tensor or ``sp`` sequence shards on the
    model's device; ``mesh`` (``launch.mesh.make_serving_mesh``, or a
    ``RankMesh``: this process is one of the shards) must have an ``axis``
    of ``max(tp, sp)`` slots, as the reference checks its device mesh."""

    def __init__(self, model, cfg, mesh, *, tp: int = 1, sp: int = 1,
                 axis: str = "model"):
        self.ranked = isinstance(mesh, RankMesh)
        # validates tp/sp exclusivity
        self._shard_ctx = ShardContext(tp=tp, sp=sp,
                                       mesh=mesh if self.ranked else None)
        n = max(tp, sp)
        if axis not in mesh.shape:
            raise ValueError(f"mesh has no {axis!r} axis (axes: "
                             f"{tuple(mesh.shape)})")
        if mesh.shape[axis] != n:
            raise ValueError(
                f"mesh axis {axis!r} has size {mesh.shape[axis]}, "
                f"expected {n} (tp={tp}, sp={sp})")
        if tp > 1:
            check_tp(cfg, tp)
        if self.ranked and tp > 1:
            from repro_torch.models import build_model

            model = build_model(local_config(cfg, tp))
        self._model = model
        self.cfg = cfg
        self.mesh = mesh
        self.tp, self.sp, self.axis = tp, sp, axis

    def _run(self, method: str, cache, *args, **kw):
        # a rank's cache is its own (its KV heads or its rows): nothing to
        # split
        if self.sp > 1 and not self.ranked:
            check_sp_cache(cache, self.sp)
        elif not self.ranked:
            # the reference's tp_cache_specs: every k/v leaf splits on its
            # KV-head axis (raises where it does not divide)
            check_tp_cache(cache, self.tp)
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

    def verify_step(self, params, tokens, cache, cur_pos, ctx=None, *,
                    slot_mask=None):
        return self._run("verify_step", cache, params, tokens, cache,
                         cur_pos, ctx, slot_mask=slot_mask)

    # -- cache construction ---------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *args, **kw):
        """The global model's caches (every layout; under tp a shard's
        cache is its KV heads' slice of them).  Under sp, with the S axis
        rounded up to a multiple of ``sp`` (the extra rows lie beyond every
        valid count).  Rounding here
        keeps the scheduler's batch cache and its batch-1 admission template
        consistent: both are sized through this method.  An
        encoder-decoder's cross caches hold min(S_local, ``enc_len``) rows,
        the encoder positions each of the reference's shards keeps."""
        if self.sp == 1:
            return self._model.init_cache(batch, max_len, *args, **kw)
        max_len = -(-max_len // self.sp) * self.sp
        s_local = max_len // self.sp
        if self.cfg.family == "encdec":
            enc_len = kw.get("enc_len")
            kw["enc_len"] = s_local if enc_len is None else min(enc_len,
                                                                 s_local)
        if not self.ranked:
            return self._model.init_cache(batch, max_len, *args, **kw)
        # a rank holds its own rows only
        from repro_torch.shard.seq_cache import rank_rows

        return rank_rows(self._model.init_cache(batch, s_local, *args, **kw),
                         self.sp)

    # -- everything else is the global model ----------------------------------
    def __getattr__(self, name):
        # reached only for attributes not set on self: readout_fn, embed,
        # stack, hidden, ...
        if name == "_model":
            raise AttributeError(name)
        return getattr(self._model, name)
