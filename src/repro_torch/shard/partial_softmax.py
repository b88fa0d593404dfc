"""Exact cross-shard merge of flash-decode partials (sequence parallelism).

Counterpart of ``repro/shard/partial_softmax.py``.  With the KV cache's S
axis split into ``sp`` shards, each shard scores only its local keys; the
online-softmax state makes the split exact: shard i emits (m_i, l_i,
acc_i) -- running max, normalizer and UNNORMALIZED value accumulator over
its visible keys -- and

    M     = max_i m_i
    l_tot = sum_i l_i * exp(m_i - M)
    out   = sum_i acc_i * exp(m_i - M) / l_tot

is the unsharded softmax up to float32 summation order.  A shard with no
visible key contributes (-1e30, 0, 0), and a row no shard sees (an
inactive scheduler slot) comes out as exact zeros.  A quantized cache's
partials come from the partials kernel; a float cache's (the bf16-KV
serving modes) from ``local_decode_partials`` in plain PyTorch, as the
reference computes them in jnp.  The reference gathers the partials
across devices.  On one device (``sp_decode_attention``) they are already
on the one card; under a rank mesh (``rank_decode_attention``) each rank
scores its own rows and all-gathers the partials, in rank order.  The
merge is plain PyTorch (it is not a kernel in the reference either).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.attention import NEG_INF, softmax_scale


def local_decode_partials(q, k_local, v_local, valid_local):
    """One shard's flash-decode partials over float K/V, the reference's
    jnp ``local_decode_partials``.

    q: (B, 1, KV, G, D); k/v_local: (B, S_local, KV, D), the shard's rows
    of a float cache; ``valid_local`` (B,): the visible keys IN THIS
    SHARD.  Scores in float32, masked beyond ``valid_local`` to NEG_INF,
    their probabilities multiplied to exact zero there.  Returns (m, l,
    acc): (B, KV, G, 1), (B, KV, G, 1), (B, KV, G, 1, D) float32; a shard
    with nothing visible returns (NEG_INF, 0, 0), the merge's identity."""
    b, s_local = q.shape[0], k_local.shape[1]
    scale = softmax_scale(q.shape[-1], q.device)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float() * scale,
                     k_local.float())                   # (B, KV, G, 1, S_l)
    valid = valid_local.to(torch.int32).reshape(-1).expand(b)
    mask = torch.arange(s_local, device=q.device)[None, :] < valid[:, None]
    maskb = mask[:, None, None, None, :]
    s = torch.where(maskb, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None]) * maskb
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, v_local.float())
    return m, l, acc


def sp_decode_attention(q, cache, valid, sp: int):
    """Decode attention over a dense cache split into ``sp`` shards: each
    shard's LOCAL visible keys are scored into partials, reading the
    shard's view ``k[:, i*S_local:(i+1)*S_local]`` in place -- a quantized
    cache through the partials kernel (one launch per shard), a float
    cache through ``local_decode_partials`` -- and ``sp_partial_combine``
    merges them.

    q: (B, KV, G, D); valid: (B,) tensor or an int, the GLOBAL count of
    visible keys.  Returns (B, KV, G, D) float32."""
    b = q.shape[0]
    s_local = cache.capacity // sp
    if isinstance(valid, torch.Tensor):
        valid = valid.to(torch.int32).reshape(-1).expand(b)
    else:
        valid = torch.full((b,), valid, dtype=torch.int32, device=q.device)
    ms, ls, accs = [], [], []
    for i in range(sp):
        lo = i * s_local
        k, v = cache.k[:, lo:lo + s_local], cache.v[:, lo:lo + s_local]
        local = torch.clamp(valid - lo, 0, s_local)
        m, l, acc = _local_partials(q, k, v, cache, local)
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return sp_partial_combine(ms, ls, accs)[:, 0]


def _local_partials(q, k, v, cache, local):
    """(m, l, acc) of one shard's rows ``k``/``v``, ``local`` (B,) of them
    visible: the partials kernel over quantized tiles, plain float32 over
    float ones; shapes as ``sp_partial_combine`` takes them."""
    if not cache.quantized:
        return local_decode_partials(q[:, None], k, v, local)
    acc, m, l = ops.decode_attention_partials(
        q, k, v, *cache.scales(), local, kv_bits=cache.bits)
    return m[..., None], l[..., None], acc[..., None, :]


def rank_decode_attention(q, cache, valid, mesh):
    """Decode attention on a rank of a sequence-parallel rank mesh: this
    rank's rows of the cache (its whole ``cache``) scored into partials,
    the partials of every rank all-gathered in rank order, and merged by
    ``sp_partial_combine``: the same partials, in the same order, as
    ``sp_decode_attention`` merges on one device.

    q: (B, KV, G, D); valid: (B,) tensor or an int, the GLOBAL count of
    visible keys.  Returns (B, KV, G, D) float32."""
    from repro_torch.dist.collectives import all_gather

    b = q.shape[0]
    s_local = cache.rows
    if isinstance(valid, torch.Tensor):
        valid = valid.to(torch.int32).reshape(-1).expand(b)
    else:
        valid = torch.full((b,), valid, dtype=torch.int32, device=q.device)
    local = torch.clamp(valid - mesh.rank * s_local, 0, s_local)
    m, l, acc = _local_partials(q, cache.k, cache.v, cache, local)
    # one gather for the three: (B, KV, G, D + 2) float32
    packed = torch.cat([acc[..., 0, :], m, l], dim=-1)
    parts = all_gather(packed, mesh)
    ms = [p[..., -2:-1] for p in parts]
    ls = [p[..., -1:] for p in parts]
    accs = [p[..., None, :-2] for p in parts]
    return _merge(ms, ls, accs)[:, 0]


def sp_partial_combine(m, l, acc):
    """Merge the shards' partials into the exact softmax output.

    ``m``, ``l``, ``acc``: sequences in shard order (or tensors with a
    leading shard axis) of (B, KV, G, 1), (B, KV, G, 1) and (B, KV, G, 1,
    D) float32.  Returns (B, 1, KV, G, D) float32 (callers cast to the
    residual dtype); a row with l_tot == 0 returns exact zeros.  The shards
    are one process's, so the merge counts and reports the all-gather of
    the packed (B, KV, G, D + 2) partials it stands for
    (``dist.collectives.stand_in``), as ``rank_decode_attention`` moves
    them between ranks."""
    from repro_torch.dist.collectives import stand_in

    stand_in("all_gather", acc[0].dtype, l[0].numel() * (acc[0].shape[-1] + 2),
             len(acc))
    return _merge(m, l, acc)


def _merge(m, l, acc):
    """``sp_partial_combine``'s arithmetic."""
    mg, lg, ag = (torch.stack(list(t)) for t in (m, l, acc))
    m_tot = torch.amax(mg, dim=0)
    # NEG_INF is finite: an all-empty row has m_i == M, weights exp(0) == 1
    # and l_tot == 0, which the zero guard below turns into zeros, never NaN
    w = torch.exp(mg - m_tot[None])                       # (sp, B, KV, G, 1)
    l_tot = torch.sum(lg * w, dim=0)
    o = torch.sum(ag * w[..., None], dim=0)
    o = o / torch.clamp_min(l_tot[..., None], 1e-30)
    o = o * (l_tot[..., None] > 0)
    # (B, KV, G, 1, D) -> (B, 1, KV, G, D): the attention output layout
    return torch.movedim(o, 3, 1)
