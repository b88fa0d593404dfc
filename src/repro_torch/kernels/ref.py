"""Plain PyTorch versions of the kernels (the int8 / int4-weight matmul,
the attentions over a dense K/V stream or, through a block table, a paged
pool, the decode attention's raw flash state for the sequence-parallel
merge, and the fused fake-quantize).

Counterparts of ``repro/kernels/ref.py``: ``ops`` runs them for tensors
that lie on the CPU, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  They compute the kernels' function with the kernels'
order of scale folding (key dequant scale and 1/sqrt(D) folded into q,
value dequant scale applied after the P @ V product), so on the CPU the
port follows the same arithmetic as the reference's fused path.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_int4
from repro_torch.core.quant import rdiv

NEG_INF = -1e30


def quant_matmul_ref(x, w_q, w_scale, act_scale, w_bits=8,
                     out_dtype=torch.bfloat16):
    """y = int8(clip(rint(x * act_scale), ±127)) @ w_q, dequantized by the
    per-output-channel ``w_scale`` and rounded to ``out_dtype`` (bf16, or
    float32 as the reference kernel's ``out_dtype`` allows).  ``w_bits ==
    4``: w_q arrives nibble-packed along K ((K/2, N) bytes) and is unpacked
    first.

    The integer product is a float64 matmul on every device: exact while
    |acc| < 2^53, i.e. for any K < 2^53 / 127^2 (CUDA has no int32
    matmul, and on the CPU it is several times faster than an int32 one).
    """
    if w_bits == 4:
        w_q = unpack_int4(w_q, axis=0)
    k = x.shape[-1]
    if k * 127 * 127 >= 2**53:
        raise ValueError(f"K={k} is too deep for an exact float64 product")
    x_q = torch.clamp(torch.round(x.float() * act_scale), -127, 127)
    acc = x_q.double() @ w_q.double()
    return (acc.float() * w_scale).to(out_dtype)


def quant_matmul_acc_ref(x_q, w_q, k0, k1):
    """The int32 sums of x_q[:, k0:k1] @ w_q[k0:k1] (int8 operands, no
    scale): a float64 product, exact while |acc| < 2^53, cast to int32
    (the kernel's sums never wrap below K = 2^31 / 127^2)."""
    acc = x_q[:, k0:k1].double() @ w_q[k0:k1].double()
    return acc.to(torch.int64).to(torch.int32)


def _q_fold(q, k_scale, head_axis):
    """q * k_scale[h] / sqrt(D), with q's head axis at ``head_axis``."""
    d = q.shape[-1]
    c = k_scale.float() * torch.rsqrt(
        torch.tensor(float(d), device=q.device))
    shape = [1] * q.ndim
    shape[head_axis] = -1
    return q.float() * c.reshape(shape)


def decode_attention_ref(q, k_cache, v_cache, k_scale, v_scale, cur_pos,
                         kv_bits=8):
    """One-token attention over the quantized cache.

    q: (B, KV, G, D); k/v_cache: (B, S, KV, D) int8, or (B, S, KV, D/2)
    packed nibbles at ``kv_bits == 4`` (unpacked first, then the same
    math); k/v_scale: (KV,) f32; cur_pos: (B,) int32 count of valid
    positions.  Returns (B, KV, G, D) f32; a row with cur_pos == 0 returns
    zeros.  It is the normalized flash state of
    ``decode_attention_partials_ref``, as in the kernel's epilogue."""
    acc, _, l = decode_attention_partials_ref(q, k_cache, v_cache, k_scale,
                                              v_scale, cur_pos, kv_bits)
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def decode_attention_partials_ref(q, k_cache, v_cache, k_scale, v_scale,
                                  cur_pos, kv_bits=8):
    """The raw flash state of one-token attention over ``cur_pos`` valid
    positions of ``k/v_cache`` (one shard's slice of the sequence axis:
    positions are LOCAL): acc = v_scale * sum_p e^(s_p - m) V_p
    (unnormalized), m = max_p s_p, l = sum_p e^(s_p - m), with s_p the
    scaled score (key scale and 1/sqrt(D) folded into q).  Returns (acc (B,
    KV, G, D), m (B, KV, G), l (B, KV, G)) f32; a row with nothing visible
    returns (0, -1e30, 0), the merge's identity."""
    b, kvh, g, d = q.shape
    if kv_bits == 4:
        k_cache = unpack_int4(k_cache, axis=-1, size=d)
        v_cache = unpack_int4(v_cache, axis=-1, size=d)
    s_len = k_cache.shape[1]
    qf = _q_fold(q, k_scale, 1)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    pos = torch.arange(s_len, device=q.device)
    valid = (pos[None, :] < cur_pos.reshape(-1, 1))[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o * v_scale.reshape(1, -1, 1, 1), m[..., 0], l


def prefill_attention_ref(q, k, v, k_scale, v_scale, q_start, kv_len, *,
                          causal=True, window=None, kv_bits=8):
    """Multi-row attention over a quantized K/V stream.

    q: (B, Sq, KV, G, D); k/v: (B, Sk, KV, D) int8, or (B, Sk, KV, D/2)
    packed nibbles at ``kv_bits == 4``; q_start: (B,) int32 absolute
    position of query row 0; kv_len: (B,) int32 valid K/V count.  Masks
    kv_len, causal (k <= q) and the optional window (q - k < window).
    Returns (B, Sq, KV, G, D) f32; rows with no visible key are zeros."""
    b, sq, kvh, g, d = q.shape
    if kv_bits == 4:
        k = unpack_int4(k, axis=-1, size=d)
        v = unpack_int4(v, axis=-1, size=d)
    sk = k.shape[1]
    qf = _q_fold(q, k_scale, 2)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    q_pos = q_start.reshape(-1, 1) + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    valid = (k_pos[None, None, :] < kv_len.reshape(-1, 1, 1)).expand(
        b, sq, sk)
    if causal:
        valid = valid & (k_pos[None, None, :] <= q_pos[:, :, None])
    if window is not None:
        valid = valid & ((q_pos[:, :, None] - k_pos[None, None, :]) < window)
    valid = valid[:, None, None]                      # (B, 1, 1, Sq, Sk)
    s = torch.where(valid, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    o = o * v_scale.reshape(1, -1, 1, 1, 1) / torch.clamp_min(l, 1e-30)
    return o.permute(0, 3, 1, 2, 4).contiguous()


def gather_pages(pool, table):
    """(pages, page_size, KV, D) pool read through a (B, NB) block table ->
    the contiguous (B, NB * page_size, KV, D) stream it maps."""
    b, nb = table.shape
    return pool[table.long()].reshape((b, nb * pool.shape[1])
                                      + tuple(pool.shape[2:]))


def decode_attention_paged_ref(q, k_pool, v_pool, table, k_scale, v_scale,
                               cur_pos, kv_bits=8):
    """``decode_attention_ref`` over the pages the table maps."""
    return decode_attention_ref(q, gather_pages(k_pool, table),
                                gather_pages(v_pool, table), k_scale,
                                v_scale, cur_pos, kv_bits)


def decode_attention_partials_paged_ref(q, k_pool, v_pool, table, k_scale,
                                        v_scale, cur_pos, kv_bits=8):
    """``decode_attention_partials_ref`` over the pages the table maps."""
    return decode_attention_partials_ref(q, gather_pages(k_pool, table),
                                         gather_pages(v_pool, table),
                                         k_scale, v_scale, cur_pos, kv_bits)


def prefill_attention_paged_ref(q, k_pool, v_pool, table, k_scale, v_scale,
                                q_start, kv_len, *, causal=True, window=None,
                                kv_bits=8):
    """``prefill_attention_ref`` over the pages the table maps."""
    return prefill_attention_ref(q, gather_pages(k_pool, table),
                                 gather_pages(v_pool, table), k_scale,
                                 v_scale, q_start, kv_len, causal=causal,
                                 window=window, kv_bits=kv_bits)


def fake_quant_ref(x, t_max, alpha, *, levels=127.0, qmin=-127.0,
                   qmax=127.0, alpha_min=0.5, alpha_max=1.0):
    """clip(round(x * s), qmin, qmax) / s per column, s = levels /
    max(clip(alpha, alpha_min, alpha_max) * t_max, 1e-8), in float32 and
    cast to x's dtype; t_max and alpha are one value or one a column
    (the reference's ``fake_quant_ref``, with its true divisions)."""
    a = torch.clamp(alpha.float(), alpha_min, alpha_max)
    t_adj = torch.clamp_min(a * t_max.float(), 1e-8)
    s = rdiv(levels, t_adj)
    xq = torch.clamp(torch.round(x.float() * s), qmin, qmax)
    return (xq / s).to(x.dtype)
