"""The numerics of the tensor-core prefill attention kernel (B2,
``csrc/prefill_attention.cu``), emulated on the CPU.

The kernel feeds its two matrix products 16-bit operands and sums in
float32.  Q @ K^T runs in bf16: K (int8 or int4 values) is exact there,
q goes in unscaled (a bf16 q is exact; a float32 q is split into hi =
bf16(q) and lo = bf16(q - hi), two products), and each score is
multiplied by k_scale / sqrt(D) after its product.  P @ V runs in fp16: V
is exact there, and the probabilities of the online softmax are split,
P = hi + lo = fp16(p) + fp16(p - hi).  These tests repeat that rounding in
torch, tile by tile as the kernel walks the keys, and hold it against the
float32 plain version ``ref.prefill_attention_ref`` within the tolerance
``chip_smoke.py`` holds the kernel to on the card: 1e-4 x (1 + max |out|).
A single 16-bit P (no split) misses it, which is why the kernel splits P.

A bf16 K/V stream (a float KV cache, unit scales) is copied into the tiles
as it is: K is exact in bf16 as before, but V may lie outside fp16's range,
so P @ V runs in bf16 with P split into three bf16 pieces, hi + mid + lo.
Two bf16 pieces leave 2^-18 of each weight, an error that grows with
max |V|; three leave 2^-27.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.packing import pack_int4, unpack_int4
from repro_torch.kernels import ref

B, S, KV, G, D = 1, 512, 3, 3, 64
BK = 64          # the kernel's key tile
TOL = 1e-4       # chip_smoke.ATTN_TOL


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _f16(x):
    return x.to(torch.float16).float()


def emulate(q, k, v, k_scale, v_scale, q_start, kv_len, *, kv_bits,
            window=None, split_p=True, p_round=_f16, pieces=2):
    """The kernel's arithmetic with its operand rounding: causal prompt
    attention, (B, Sq, KV, G, D) float32.  P goes into P @ V as ``pieces``
    ``p_round`` pieces (one without ``split_p``), each rounding what the
    earlier ones leave out; K/V are int8, packed int4 or bf16 tiles."""
    b, sq, kvh, g, d = q.shape
    if kv_bits == 4:
        k = unpack_int4(k, axis=-1, size=d)
        v = unpack_int4(v, axis=-1, size=d)
    kf, vf = k.float(), v.float()
    sk = k.shape[1]
    if q.dtype == torch.bfloat16:
        q_ops = [q.float()]
    else:
        hi = _bf16(q)
        q_ops = [hi, _bf16(q - hi)]
    c = (k_scale * torch.rsqrt(torch.tensor(float(d)))).reshape(1, -1, 1, 1, 1)
    q_pos = q_start.reshape(-1, 1) + torch.arange(sq)
    m = torch.full((b, kvh, g, sq, 1), ref.NEG_INF)
    l = torch.zeros((b, kvh, g, sq, 1))
    acc = torch.zeros((b, kvh, g, sq, d))
    for k0 in range(0, sk, BK):
        kt, vt = kf[:, k0:k0 + BK], vf[:, k0:k0 + BK]
        s = sum(torch.einsum("bqkgd,bskd->bkgqs", op, kt) for op in q_ops) * c
        k_pos = k0 + torch.arange(kt.shape[1])
        vis = (k_pos[None, None, :] < kv_len.reshape(-1, 1, 1)) \
            & (k_pos[None, None, :] <= q_pos[:, :, None])
        if window is not None:
            vis = vis & ((q_pos[:, :, None] - k_pos[None, None, :]) < window)
        s = torch.where(vis[:, None, None], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        parts, rest = [], p
        for _ in range(pieces if split_p else 1):
            parts.append(p_round(rest))
            rest = rest - parts[-1]
        acc = acc * corr + sum(torch.einsum("bkgqs,bskd->bkgqd", pp, vt)
                               for pp in parts)
        m = m_new
    o = acc * v_scale.reshape(1, -1, 1, 1, 1) / torch.clamp_min(l, 1e-30)
    return o.permute(0, 3, 1, 2, 4).contiguous()


def _inputs(kv_bits, q_dtype, seed=17):
    """chip_smoke.py's shapes (one request) and scale ranges."""
    rng = np.random.default_rng(seed)
    lv = 127 if kv_bits == 8 else 7
    q = torch.from_numpy(rng.normal(size=(B, S, KV, G, D)).astype(np.float32))
    q = q.to(q_dtype)
    k, v = (torch.from_numpy(rng.integers(-lv, lv + 1, (B, S, KV, D),
                                          dtype=np.int8)) for _ in range(2))
    if kv_bits == 4:
        k, v = pack_int4(k), pack_int4(v)
    ks, vs = (torch.from_numpy((rng.random(KV) * 0.05 + 0.01).astype(
        np.float32)) for _ in range(2))
    return q, k, v, ks, vs


def _inputs_bf16(q_dtype, v_scale=1.0, seed=18):
    """A bf16 K/V stream with unit dequant scales (a float cache); V
    multiplied by ``v_scale`` before its bf16 rounding."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, S, KV, G, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, D)).astype(
        np.float32)) for _ in range(2))
    ones = torch.ones(KV)
    return (q.to(q_dtype), k.to(torch.bfloat16),
            (v * v_scale).to(torch.bfloat16), ones, ones)


def _err(kv_bits, q_dtype, window=None, split_p=True, p_round=_f16,
         pieces=2, inputs=None):
    q, k, v, ks, vs = inputs or _inputs(kv_bits, q_dtype)
    qs = torch.zeros((B,), dtype=torch.int32)
    kl = torch.full((B,), S, dtype=torch.int32)
    got = emulate(q, k, v, ks, vs, qs, kl, kv_bits=kv_bits, window=window,
                  split_p=split_p, p_round=p_round, pieces=pieces)
    want = ref.prefill_attention_ref(q, k, v, ks, vs, qs, kl, causal=True,
                                     window=window, kv_bits=kv_bits)
    return ((got - want).abs().max().item(),
            TOL * (1 + want.abs().max().item()))


@pytest.mark.parametrize("window", [None, 100], ids=["causal", "window"])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32],
                         ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_split_operands_within_tolerance(kv_bits, q_dtype, window):
    err, tol = _err(kv_bits, q_dtype, window)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("kv_bits,p_round", [(8, _bf16), (4, _bf16),
                                              (8, _f16)],
                         ids=["int8-bf16", "int4-bf16", "int8-fp16"])
def test_unsplit_p_misses_tolerance(kv_bits, p_round):
    """One 16-bit P puts 2^-9 (bf16) or 2^-12 (fp16) relative error into
    every weight: the reason the kernel runs P @ V as hi + lo."""
    err, tol = _err(kv_bits, torch.bfloat16, split_p=False, p_round=p_round)
    assert err > tol, (err, tol)


def test_ragged_rows_and_empty_rows():
    """Ragged q_start / kv_len, and a request whose kv_len is 0: its rows
    see no key and come out as exact zeros, as the kernel's l == 0 rows."""
    q, k, v, ks, vs = _inputs(8, torch.bfloat16)
    q, k, v = (torch.cat([t, t.flip(1)]) for t in (q, k, v))
    qs = torch.tensor([40, 0], dtype=torch.int32)
    kl = torch.tensor([300, 0], dtype=torch.int32)
    got = emulate(q, k, v, ks, vs, qs, kl, kv_bits=8)
    want = ref.prefill_attention_ref(q, k, v, ks, vs, qs, kl, causal=True)
    assert (got - want).abs().max().item() <= TOL * (
        1 + want.abs().max().item())
    assert torch.equal(got[1], torch.zeros_like(got[1]))


@pytest.mark.parametrize("window", [None, 100], ids=["causal", "window"])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32],
                         ids=["q_bf16", "q_f32"])
def test_bf16_kv_three_bf16_pieces_within_tolerance(q_dtype, window):
    """A bf16 K/V stream: K and V staged as they are, P @ V in bf16 with P
    in three bf16 pieces, the kernel's choice."""
    err, tol = _err(8, q_dtype, window, p_round=_bf16, pieces=3,
                    inputs=_inputs_bf16(q_dtype))
    assert err <= tol, (err, tol)


def test_bf16_kv_unsplit_p_misses_tolerance():
    err, tol = _err(8, torch.bfloat16, split_p=False, p_round=_bf16,
                    inputs=_inputs_bf16(torch.bfloat16))
    assert err > tol, (err, tol)


def test_bf16_kv_two_pieces_error_grows_with_v():
    """The error two bf16 pieces leave, bounded by 2^-18 x sum p |V| / l,
    grows with |V| while the tolerance grows with max |out|: within it
    here, but held there by the data (how far V's signs cancel in the
    output), not by the kernel.  Three pieces stay far below at any V;
    the kernel takes three."""
    small = _inputs_bf16(torch.bfloat16)
    big = _inputs_bf16(torch.bfloat16, v_scale=1e4)
    two = [_err(8, torch.bfloat16, p_round=_bf16, pieces=2, inputs=x)
           for x in (small, big)]
    three = [_err(8, torch.bfloat16, p_round=_bf16, pieces=3, inputs=x)
             for x in (small, big)]
    assert two[1][0] > 1e3 * two[0][0]
    for (e2, tol), (e3, _) in zip(two, three):
        assert e3 * 5 < e2 <= tol, (e3, e2, tol)


def test_bf16_kv_v_outside_fp16_range():
    """|V| above fp16's largest value (65504): fp16 staging would overflow
    to inf, bf16 staging keeps it, and three bf16 pieces stay within the
    tolerance."""
    q, k, v, ks, vs = _inputs_bf16(torch.bfloat16, v_scale=1e5)
    assert v.float().abs().max() > 65504
    assert torch.isinf(v.to(torch.float16)).any()
    err, tol = _err(8, torch.bfloat16, p_round=_bf16, pieces=3,
                    inputs=(q, k, v, ks, vs))
    assert err <= tol, (err, tol)
