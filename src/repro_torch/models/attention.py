"""GQA attention with rotary embedding and an optional sliding window: the
full-sequence forward used by calibration and by the fine-tune's teacher
and student, one-shot and chunked ragged prefill into the KV cache through
the prefill kernel (with the window mask on a windowed layer), and
single-token decode, at one position or at a position per slot
(continuous batching), through the decode kernel (over a float cache, and
on a windowed layer, the plain ``decode_attention``, as in the reference;
over the ring of a windowed layer, plain attention against the ring's
absolute positions), and the speculative verify window: a few tokens a
slot, each slot at its own position, through the prefill kernel's per-row
``q_start`` (over a float cache or on a windowed layer, the plain
``verify_attention``).

An encoder-decoder's encoder attends bidirectionally (``causal=False``,
``__call__`` only), and its decoder's cross attention (``cross=True``)
reads the encoder's output: its keys and values, without rotary, go once
into a float cache at prefill, and decode attends every row of that cache;
both are plain attention (``full_attention``), as in the reference.

Counterpart of ``repro/models/attention.py`` on the single-device serving
and threshold-training paths.  All paths share the GQA grouping
Hq = KV * G, computed on a (B, S, KV, G, D) view so no head replication is
materialized.  K/V quantize ONCE (``cache.ready``) against the frozen
calibrated per-head thresholds, and the same int8 (or packed int4) tiles
are written to the cache and attended by the kernel; a float cache (the
bf16-KV serving modes) stores K/V cast to its dtype, with unit scales.
The cache is dense
or paged (``repro_torch.cache``); the kernels read either through the
cache's ``kernel_view``.

Under sequence parallelism (a ``repro_torch.shard`` scope with sp > 1) the
dense cache's S axis is split into ``sp`` shards, each a view of the one
global cache, so the cache writes are the unsharded ones (their union over
the shards is the reference's owner writes); only the attention differs,
as in the reference's sequence-parallel branches: decode scores each
shard's keys into flash partials (the partials kernel over a quantized
cache, plain float32 partials over a float one) and merges them exactly;
prefill attends the prompt's exact K/V (a chunk: the cache's dequantized
view) and a verify window the whole dequantized cache, both in plain
attention with no kernel; a windowed layer's decode raises, as the
reference's does.  Under a rank mesh (``ShardContext.mesh``: one process
per shard) the cache is this rank's rows only: every write is an owner
write and every whole-sequence read a gather (``shard/seq_cache.py``), and
decode merges the ranks' gathered partials (``shard/partial_softmax.py``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.cache import DenseCache, kv_levels, make_cache
from repro_torch.models.layers import apply_rotary, rotary_angles
from repro_torch.models.module import Dense, Module

NEG_INF = -1e30


def _sp_info():
    """The sequence-parallel context (``repro_torch.shard.context``), or None
    on the unsharded path.  Imported here: the shard package sits on top of
    the model stack, so a module-level import would be a cycle."""
    from repro_torch.shard.context import sp_shard_info

    return sp_shard_info()


def _sp_dense(path: str, cache):
    """The sequence-parallel context (None unsharded), after the
    reference's check that it shards a dense cache."""
    sp = _sp_info()
    if sp is not None and cache.layout != "dense":
        raise ValueError(
            f"{path}: sequence-parallel serving shards the dense cache's S "
            f"axis — layout {cache.layout!r} unsupported")
    return sp


def _ranks(sp):
    """The rank mesh of a sequence-parallel context whose shards are
    processes (``cache`` is then this rank's rows), else None."""
    return None if sp is None else sp.mesh


def _append(cache, kq, vq, start: int, sp):
    """Write tiles at global positions [start, start + s): the owner
    write under a rank mesh."""
    if _ranks(sp) is None:
        return cache.append(kq, vq, start)
    from repro_torch.shard.seq_cache import owner_append

    return owner_append(cache, kq, vq, start, sp.mesh)


def _append_slots(cache, kq, vq, pos, sp, active=None):
    """The per-slot write; the owner write under a rank mesh."""
    if _ranks(sp) is None:
        return cache.append_slots(kq, vq, pos, active=active)
    from repro_torch.shard.seq_cache import owner_append_slots

    return owner_append_slots(cache, kq, vq, pos, sp.mesh, active=active)


def _dense_kv(cache, sp, limit=None):
    """The dequantized (k, v) of every position (the first ``limit``): the
    ranks' gathered tiles under a rank mesh."""
    if _ranks(sp) is None:
        return cache.dequantize(*cache.dense_view(limit))
    from repro_torch.shard.seq_cache import gathered_dense

    return gathered_dense(cache, sp.mesh, limit)


@functools.lru_cache(maxsize=None)
def sqrt_d(d: int, device) -> torch.Tensor:
    """The float32 0-d ``sqrt(d)`` on ``device``, made once per (d, device)
    (the ring decode divides by it, as the reference does)."""
    with torch.inference_mode(False):
        return torch.sqrt(torch.tensor(float(d), device=device))


@functools.lru_cache(maxsize=None)
def softmax_scale(d: int, device) -> torch.Tensor:
    """The float32 0-d ``1 / sqrt(d)`` of the plain attentions on
    ``device``, made once per (d, device) by the expression they always
    used (the same bits): a tensor made from a host value on every call is
    a host-to-device copy, which a CUDA graph capture does not allow."""
    with torch.inference_mode(False):
        return 1.0 / torch.sqrt(torch.tensor(float(d), device=device))


def decode_attention(q, k_cache, v_cache, valid, window=None):
    """One-token attention over a float cache, the counterpart of the
    reference's jnp ``decode_attention`` (the path it takes over a float
    cache, where its decode kernel needs a quantized one, and on a
    windowed layer).  q: (B, 1, KV, G, D); k/v_cache: (B, S, KV, D) at full
    capacity; ``valid`` counts the visible positions of each row: an int,
    or a 0-d or (B,) tensor; ``window``: only the last ``window`` of them
    are visible.  Scores and softmax in float32 over the whole capacity,
    masked beyond ``valid``; a row with ``valid`` 0 returns zeros.  Output
    in q's dtype, (B, 1, KV, G, D)."""
    b, d, smax = q.shape[0], q.shape[-1], k_cache.shape[1]
    scale = softmax_scale(d, q.device)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float() * scale, k_cache.float())
    pos = torch.as_tensor(valid, dtype=torch.int32,
                          device=q.device).reshape(-1).expand(b)
    k_pos = torch.arange(smax, device=q.device)[None, :]
    mask = k_pos < pos[:, None]
    if window is not None:
        mask = mask & (k_pos >= pos[:, None] - window)
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # a row with no visible key softmaxes uniformly over NEG_INF scores:
    # zero it, so an inactive slot attends to nothing
    p = p * (pos > 0).reshape(b, 1, 1, 1, 1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return o.to(q.dtype)


def verify_attention(q, k_cache, v_cache, pos_vec, window=None):
    """Speculative-verify attention over a float cache, the counterpart of
    the reference's jnp ``verify_attention``: s window queries a row, query
    j of row b at position ``pos_vec[b] + j``, seeing the cache keys at
    positions <= its own (the window itself included, causally).  At s == 1
    this is ``decode_attention`` with ``valid = pos_vec + 1``: the same
    contractions and mask, the same bits.  A row with ``pos_vec < 0`` (an
    inactive slot) sees no key and returns zeros; ``window``: a query sees
    only keys less than ``window`` positions behind it.  q: (B, s, KV, G,
    D); k/v_cache: (B, S, KV, D); output in q's dtype, (B, s, KV, G, D)."""
    b, s, d, smax = q.shape[0], q.shape[1], q.shape[-1], k_cache.shape[1]
    scale = softmax_scale(d, q.device)
    sc = torch.einsum("bqkgd,bskd->bkgqs", q.float() * scale, k_cache.float())
    pos = pos_vec.to(torch.int32).reshape(-1).expand(b)
    q_pos = pos[:, None] + torch.arange(s, device=q.device)
    k_pos = torch.arange(smax, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[..., None]
    if window is not None:
        mask = mask & ((q_pos[..., None] - k_pos[None, None, :]) < window)
    mask = mask & (pos >= 0)[:, None, None]
    sc = torch.where(mask[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    p = p * (pos >= 0).reshape(b, 1, 1, 1, 1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return o.to(q.dtype)


def ring_decode_attention(q, k_ring, v_ring, abs_pos, cur_pos, window):
    """One-token attention over a ring buffer, the reference's ring decode:
    q: (B, 1, KV, G, D); k/v_ring: (B, window, KV, D) float (dequantized)
    tiles; ``abs_pos``: the absolute position of each slot, (window,) or
    (B, window) (``RingCache.abs_positions``); ``cur_pos``: the newest
    token's position, an int or a (B,) tensor.  A slot is visible when it
    holds a position in (cur_pos - window, cur_pos].  q is divided by
    sqrt(D), as the reference writes it.  Output in q's dtype."""
    d = q.shape[-1]
    sc = torch.einsum("bqkgd,bskd->bkgqs", q.float() / sqrt_d(d, q.device),
                      k_ring.float())
    if isinstance(cur_pos, torch.Tensor):
        cur_pos = cur_pos.reshape(-1, 1)
    mask = (abs_pos >= 0) & (abs_pos >= cur_pos - window + 1)
    mask = mask.reshape(-1, 1, 1, 1, abs_pos.shape[-1])
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v_ring.float())
    return o.to(q.dtype)


def full_attention(q, k, v):
    """Plain attention with every key visible: the counterpart of the
    reference's jnp ``flash_attention(causal=False)`` (the encoder's
    bidirectional attention and the cross attention's prefill over the
    whole memory) and of its ``decode_attention`` over a cross cache's
    whole capacity, whose all-true mask leaves the softmax as it is.  q:
    (B, Sq, KV, G, D); k/v: (B, Sk, KV, D).  Scores and softmax in float32
    (one softmax, where the reference's flash attention runs an online
    softmax over chunks), output in v's dtype."""
    scale = softmax_scale(q.shape[-1], q.device)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float() * scale, k.float())
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.to(v.dtype)


def causal_attention(q, k, v, q_offset: int = 0, window=None):
    """Plain causal attention, the counterpart of the reference's jnp
    ``flash_attention`` (one softmax over the whole sequence instead of an
    online softmax over chunks).  q: (B, Sq, KV, G, D) at positions
    ``q_offset + arange(Sq)``; k/v: (B, Sk, KV, D) at positions
    ``arange(Sk)`` -- the prompt itself, or the first Sk positions of a
    cache that a chunk continues; key p is visible to a query at position
    t when p <= t (and, with ``window``, t - p < window).  Scores and
    softmax in float32, output in v's dtype."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = softmax_scale(d, q.device)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float() * scale, k.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.to(v.dtype)


class Attention(Module):
    """GQA attention with rotary embedding: causal self-attention with an
    optional sliding ``window`` (the decoders); with ``causal=False`` the
    encoder's bidirectional self-attention (``__call__`` only: the encoder
    never prefills a cache); with ``cross=True`` the decoder's cross
    attention, whose keys and values come from the encoder's output
    (``memory``) with no rotary, through a float cache written once at
    prefill.  As in the reference, the bidirectional and cross attentions
    are plain attention, not kernels, and own no KV thresholds."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, path: str, window: int | None = None,
                 rope_base: float = 10000.0, causal: bool = True,
                 cross: bool = False, dtype=torch.bfloat16):
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_kv = n_kv_heads
        self.head_dim = head_dim
        self.groups = n_heads // n_kv_heads
        self.window = window
        self.rope_base = rope_base
        self.causal = causal
        self.cross = cross
        self.path = path
        self.wq = Dense(d_model, n_heads * head_dim, path=f"{path}/wq",
                        dtype=dtype)
        self.wk = Dense(d_model, n_kv_heads * head_dim, path=f"{path}/wk",
                        dtype=dtype)
        self.wv = Dense(d_model, n_kv_heads * head_dim, path=f"{path}/wv",
                        dtype=dtype)
        self.wo = Dense(n_heads * head_dim, d_model, path=f"{path}/wo",
                        dtype=dtype, logical_axes=("heads", "embed"))

    def init(self, gen):
        return {"wq": self.wq.init(gen), "wk": self.wk.init(gen),
                "wv": self.wv.init(gen), "wo": self.wo.init(gen)}

    # -- cache ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None,
                   kv_bits: int = 8, *, layout: str = "dense",
                   page_size: int = 64, extra_pages: int = 0,
                   kv_int8: bool = True, dtype=torch.bfloat16):
        """This layer's cache in ``layout`` (``repro_torch.cache.make_cache``,
        which gives a windowed layer its ring): int8, or packed int4
        nibbles at ``kv_bits=4``; with ``kv_int8`` False, ``dtype`` tiles
        with unit scales.  A cross attention's cache is always a dense
        ``dtype`` cache of ``max_len`` rows (the encoder's memory, written
        once a request, is not what decode streams), as in the
        reference."""
        if self.cross:
            return DenseCache.init(batch, max_len, self.n_kv, self.head_dim,
                                   device=device, quantized=False,
                                   dtype=dtype)
        return make_cache(batch, max_len, self.n_kv, self.head_dim,
                          device=device, layout=layout, window=self.window,
                          page_size=page_size,
                          extra_pages=extra_pages, bits=kv_bits,
                          quantized=kv_int8, dtype=dtype)

    def _observe_kv(self, ctx, k, v):
        """Feed post-rope K / raw V into the KV calibration observers."""
        if ctx is None or ctx.mode != "calibrate":
            return
        from repro_torch.core import api as A
        from repro_torch.core import calibration as calib

        key = A.kv_path(self.path)
        if key not in ctx.qparams:
            return
        ent = ctx.qparams[key]
        spec = ctx.policy.kv_spec()
        ctx.updates[key] = {
            "k": calib.update_observer(ent["k"], k, spec),
            "v": calib.update_observer(ent["v"], v, spec),
        }

    def _fake_quant_kv(self, ctx, k, v):
        """Trained-threshold fake-quant of the K/V stream (paper §3 applied
        to the cache): fires in fake mode only when ``finalize_calibration``
        emitted trainable ``log2_t`` leaves.  The differentiable stand-in
        for ``cache.ready``: the distillation loss sees the quantization
        error serving will pay, and the TQT backward moves the per-head
        thresholds."""
        if ctx is None or ctx.mode != "fake":
            return k, v
        from repro_torch.core import api as A
        from repro_torch.core import quant as Q

        ent = ctx.qparams.get(A.kv_path(self.path))
        if not ent or "log2_t" not in ent.get("k", {}):
            return k, v
        spec = ctx.policy.kv_spec()
        return (Q.fake_quant_log_t(k, ent["k"]["log2_t"], spec),
                Q.fake_quant_log_t(v, ent["v"]["log2_t"], spec))

    def _kv_scales(self, ctx):
        """Frozen per-head dequant scales T / levels from calibrated,
        finalized qparams (levels 127 at kv_bits 8, 7 at kv_bits 4)."""
        from repro_torch.core import api as A

        ent = None if ctx is None else ctx.qparams.get(A.kv_path(self.path))
        finalized = (ent is not None and "t_max" in ent.get("k", {})
                     and "count" not in ent["k"])
        if not finalized:
            raise ValueError(
                f"{self.path}: a quantized KV cache requires "
                "calibrated+finalized kv thresholds in qparams "
                "(QuantPolicy(kv_int8=True) at init_qparams, the "
                "calibration pass, then finalize_calibration)")
        # T / levels, evaluated as T * (1 / levels): the float32 expression
        # the reference's compiled graph evaluates (XLA rewrites a division
        # by a constant, 127 and 7 alike), so both packages write the same
        # tiles
        inv = 1.0 / kv_levels(ctx.policy.kv_bits)
        k_s = torch.clamp_min(ent["k"]["t_max"], 1e-8) * inv
        v_s = torch.clamp_min(ent["v"]["t_max"], 1e-8) * inv
        return k_s.float(), v_s.float()

    def _qkv(self, params, x, ctx, kv_src=None):
        """q from ``x``; k and v from ``kv_src`` (the encoder's memory of a
        cross attention), else from ``x``."""
        b, s, _ = x.shape
        q = self.wq(params["wq"], x, ctx).reshape(
            b, s, self.n_kv, self.groups, self.head_dim)
        src = x if kv_src is None else kv_src
        sk = src.shape[1]
        k = self.wk(params["wk"], src, ctx).reshape(b, sk, self.n_kv,
                                                    self.head_dim)
        v = self.wv(params["wv"], src, ctx).reshape(b, sk, self.n_kv,
                                                    self.head_dim)
        return q, k, v

    def _rope(self, q, k, positions):
        cos, sin = rotary_angles(positions, self.head_dim, self.rope_base)
        b, s, kvh, g, d = q.shape
        qf = apply_rotary(q.reshape(b, s, kvh * g, d), cos, sin)
        k = apply_rotary(k, cos, sin)
        return qf.reshape(b, s, kvh, g, d), k

    def __call__(self, params, x, ctx=None, *, memory=None):
        """Full-sequence forward (calibration, fine-tune teacher and
        student, and the encoder in every mode); observes K/V in calibrate
        mode and fake-quantizes them through trained thresholds in fake
        mode, where qparams hold an entry for this layer (a causal
        self-attention's).  A cross attention attends ``memory`` (the
        encoder's output), every position, with no rotary."""
        b, s, _ = x.shape
        q, k, v = self._qkv(params, x, ctx, memory)
        if self.cross:
            o = full_attention(q, k, v)
        else:
            q, k = self._rope(q, k, torch.arange(s, device=x.device))
            self._observe_kv(ctx, k, v)
            k, v = self._fake_quant_kv(ctx, k, v)
            o = (causal_attention(q, k, v, window=self.window) if self.causal
                 else full_attention(q, k, v))
        o = o.reshape(b, s, self.n_heads * self.head_dim)
        return self.wo(params["wo"], o, ctx)

    def _cross_prefill(self, params, x, memory, cache, ctx):
        """A cross attention's prefill: K/V of the whole memory, its first
        ``cache.capacity`` rows written to the cache (the reference keeps
        the first min(capacity, S_enc) rows: a cache sized so, by the
        caller, is written in place), and every memory position attended
        exactly."""
        b, s, _ = x.shape
        q, k, v = self._qkv(params, x, ctx, memory)
        cap = cache.capacity
        if k.shape[1] < cap:
            raise ValueError(
                f"{self.path}: the cross cache holds {cap} rows, the memory "
                f"{k.shape[1]}; size it to min(max_len, memory length) "
                "(init_cache(..., enc_len=)), the rows the reference keeps")
        cache = cache.append(*cache.ready(k[:, :cap], v[:, :cap]), 0)
        o = full_attention(q, k, v).to(x.dtype)
        o = o.reshape(b, s, self.n_heads * self.head_dim)
        return self.wo(params["wo"], o, ctx), cache

    def prefill(self, params, x, cache, ctx=None, *, memory=None,
                q_offset: int = 0, lengths=None, kv_limit=None):
        """Prompt forward that populates the cache; returns (y, cache).

        The prompt's K/V quantize once (``cache.ready``) and are appended
        at positions [q_offset, q_offset + S).  One-shot (``lengths`` None):
        the prefill kernel attends those same tiles.  Chunked ragged
        prefill (``lengths`` (B,) valid prompt lengths): the chunk attends
        the updated cache through its kernel view, masked to each
        request's length and to the first ``kv_limit`` positions (the
        padded prompt: per-chunk work scales with the prompt, not the
        cache).  A windowed layer masks its window in both; its ring
        (``RingCache``) takes the one-shot write only.  A cross attention
        writes and attends ``memory`` (``_cross_prefill``)."""
        from repro_torch.kernels import ops

        if self.cross:
            return self._cross_prefill(params, x, memory, cache, ctx)
        b, s, _ = x.shape
        if lengths is not None and cache.layout == "ring":
            raise ValueError(
                f"{self.path}: chunked prefill needs absolute slots (a "
                "dense cache or paged layout); the SWA ring buffer "
                "drops them (size the cache >= max_len or prefill "
                "one-shot)")
        q, k, v = self._qkv(params, x, ctx)
        q, k = self._rope(q, k, q_offset + torch.arange(s, device=x.device))
        if cache.quantized:
            # a float cache keeps its unit scales
            cache = cache.with_scales(*self._kv_scales(ctx))
        kq, vq = cache.ready(k, v)
        sp = _sp_dense(self.path, cache)
        cache = _append(cache, kq, vq, q_offset, sp)
        if lengths is None and sp is not None:
            # the reference's sequence-parallel prefill attends the prompt's
            # exact float K/V, with no kernel
            o = causal_attention(q, k, v, window=self.window)
        elif lengths is None:
            o = ops.prefill_attention(q, kq, vq, *cache.scales(), 0, s,
                                      causal=True, window=self.window,
                                      kv_bits=cache.bits)
        else:
            limit = (cache.capacity if kv_limit is None
                     else min(kv_limit, cache.capacity))
            if sp is not None:
                # ... and a chunk the dequantized cache, also with no kernel
                k_eff, v_eff = _dense_kv(cache, sp, limit)
                o = causal_attention(q, k_eff, v_eff, q_offset=q_offset,
                                     window=self.window)
            else:
                kv_len = torch.clamp(lengths.to(torch.int32), 0,
                                     q_offset + s)
                o = ops.prefill_attention_view(q, cache.kernel_view(limit),
                                               *cache.scales(), q_offset,
                                               kv_len, causal=True,
                                               window=self.window)
        o = o.to(x.dtype).reshape(b, s, self.n_heads * self.head_dim)
        return self.wo(params["wo"], o, ctx), cache

    def decode(self, params, x, cache, cur_pos, ctx=None, *, slot_mask=None):
        """Single-token decode (tokens already cached).  ``cur_pos`` is an
        int (one position for the batch, baked into the step: the eager
        ``loop=True`` driver and ``sp`` > 1) or a (B,) tensor (continuous
        batching, and the captured greedy step: every slot decodes at its
        own position, read on the device, with per-slot rotary, and writes
        at its own index); both give the same bits for the same positions.
        ``slot_mask`` (B,) bool marks the live slots: an inactive slot
        leaves the cache bit-for-bit unchanged and attends over zero keys
        (a zero output row).  The new K/V quantize with the scales stored
        at prefill, and the decode kernel attends the valid prefix of each
        row; a windowed layer attends its last ``window`` positions in
        plain attention, as the reference does.  A ring (``RingCache``)
        keeps one position for the batch: a (B,) ``cur_pos`` there is that
        position on the device (the captured step), and a ``slot_mask``
        raises.  A cross attention attends its cache's every row and
        writes nothing: the reference also projects the token's K/V there
        and drops them, which the port skips (the same output).  Under
        sequence parallelism (sp > 1) every shard of the dense cache is
        scored into partials and merged (``shard.partial_softmax.
        sp_decode_attention``), and a windowed layer raises, as the
        reference's does."""
        from repro_torch.kernels import ops

        b, s, _ = x.shape
        if self.cross:
            q = self.wq(params["wq"], x, ctx).reshape(
                b, s, self.n_kv, self.groups, self.head_dim)
            o = full_attention(q, cache.k, cache.v).to(x.dtype)
            o = o.reshape(b, s, self.n_heads * self.head_dim)
            return self.wo(params["wo"], o, ctx), cache
        ring = cache.layout == "ring"
        if ring and slot_mask is not None:
            raise ValueError(
                f"{self.path}: per-slot decode (vector cur_pos / slot_mask) "
                "needs absolute slots (a dense cache or paged layout); the "
                "SWA ring buffer drops them — size the cache >= max_len or "
                "decode with a scalar position")
        sp = _sp_dense(self.path, cache)
        if sp is not None and self.window is not None:
            raise ValueError(
                f"{self.path}: sliding-window decode is local by "
                "construction — run SWA layers unsharded (sp=1)")
        q, k, v = self._qkv(params, x, ctx)
        per_slot = (isinstance(cur_pos, torch.Tensor) and cur_pos.ndim > 0
                    or slot_mask is not None)
        if per_slot:
            pos = torch.as_tensor(cur_pos, dtype=torch.int32,
                                  device=x.device).reshape(-1).expand(b)
            q, k = self._rope(q, k, pos[:, None])
            kq, vq = cache.ready(k, v)
            if ring:
                cache = cache.append(kq, vq, pos)
            else:
                cache = _append_slots(cache, kq, vq, pos, sp,
                                      active=slot_mask)
            valid = pos + 1
            if slot_mask is not None:
                valid = torch.where(slot_mask, valid, 0)
        else:
            # (B, S) positions, the per-slot branch's shape: an elementwise
            # op on the CPU takes its vector or its scalar path by the
            # tensor's length, and the two branches must rotate by the
            # same bits
            q, k = self._rope(q, k, torch.full((b, s), int(cur_pos),
                                               device=x.device))
            kq, vq = cache.ready(k, v)
            cache = _append(cache, kq, vq, int(cur_pos), sp)
            valid = int(cur_pos) + 1
        if ring:
            # the ring's slots hold the last `window` positions: attend
            # them against their absolute positions, in plain attention
            at = pos if per_slot else int(cur_pos)
            o = ring_decode_attention(q, *cache.dequantize(cache.k, cache.v),
                                      cache.abs_positions(at), at,
                                      self.window)[:, 0]
        elif sp is None and (not cache.quantized or self.window is not None):
            # the decode kernels read quantized tiles only, and the
            # reference's windowed decode takes none: over a float cache or
            # on a windowed layer the reference attends in plain jnp, and so
            # does the port
            o = decode_attention(q, *cache.dequantize(*cache.dense_view()),
                                 valid, window=self.window)[:, 0]
        elif sp is None:
            o = ops.decode_attention_view(q[:, 0], cache.kernel_view(),
                                          *cache.scales(), valid)
        elif _ranks(sp) is None:
            from repro_torch.shard.partial_softmax import sp_decode_attention

            o = sp_decode_attention(q[:, 0], cache, valid, sp.sp)
        else:
            from repro_torch.shard.partial_softmax import (
                rank_decode_attention)

            o = rank_decode_attention(q[:, 0], cache, valid, sp.mesh)
        o = o[:, None].to(x.dtype)
        o = o.reshape(b, s, self.n_heads * self.head_dim)
        return self.wo(params["wo"], o, ctx), cache

    def verify(self, params, x, cache, cur_pos, ctx=None, *, slot_mask=None):
        """Speculative-verify pass: s window tokens a slot, each slot at its
        own position.  x: (B, s, d); ``cur_pos`` (B,) counts each slot's
        valid cache entries, and the window takes positions ``cur_pos[b] +
        [0, s)``: rotary there, its K/V made cache-ready once and appended
        at those slots (``append_slots``, the multi-token form), then query
        j attends the keys at positions <= ``cur_pos[b] + j``.  A quantized
        cache attends through the prefill kernel (a short per-slot chunked
        prefill: ``q_start = cur_pos``, ``kv_len = cur_pos + s``, 0 for an
        inactive slot); a float cache, a windowed layer, or any cache under
        sequence parallelism, through the plain ``verify_attention`` over
        the whole dequantized cache, as the reference does (its kernel path
        needs a quantized cache, no window and no shards: its sp branch
        gathers the shards' tiles and attends them in jnp).  ``slot_mask``
        inactive slots write nothing and give zero rows, as in ``decode``.
        A ring raises: the window's per-slot writes need absolute slots."""
        from repro_torch.kernels import ops

        if self.cross:
            raise ValueError(f"{self.path}: speculative verify covers causal "
                             "self-attention only")
        if cache.layout == "ring":
            raise ValueError(
                f"{self.path}: speculative verify needs absolute slots (a "
                "dense cache or paged layout); the SWA ring buffer drops "
                "them — size the cache >= max_len")
        sp = _sp_dense(self.path, cache)
        b, s, _ = x.shape
        q, k, v = self._qkv(params, x, ctx)
        pos = torch.as_tensor(cur_pos, dtype=torch.int32,
                              device=x.device).reshape(-1).expand(b)
        q, k = self._rope(q, k, pos[:, None] + torch.arange(s,
                                                            device=x.device))
        kq, vq = cache.ready(k, v)
        cache = _append_slots(cache, kq, vq, pos, sp, active=slot_mask)
        if cache.quantized and self.window is None and sp is None:
            kv_len = pos + s
            if slot_mask is not None:
                kv_len = torch.where(slot_mask, kv_len, 0)
            o = ops.prefill_attention_view(q, cache.kernel_view(),
                                           *cache.scales(), pos, kv_len,
                                           causal=True)
        else:
            pos_eff = pos if slot_mask is None else torch.where(slot_mask,
                                                                pos, -1)
            o = verify_attention(q, *_dense_kv(cache, sp), pos_eff,
                                 window=self.window)
        o = o.to(x.dtype).reshape(b, s, self.n_heads * self.head_dim)
        return self.wo(params["wo"], o, ctx), cache
