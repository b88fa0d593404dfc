#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

1. builds the hand-written Hopper kernels (``src/repro_torch/csrc``);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path (quant_matmul bit for bit; the attentions with
   an int8 and a packed int4 K/V stream), and times kernel, plain version
   and one PyTorch library call as a yardstick;
3. drives the int8 main path at the full width of smollm-135m (30 layers,
   seeded random weights): ``Engine.from_checkpoint`` -> §2 calibration ->
   int8 conversion -> ``generate_batch`` on 4 prompts of 512 tokens with 32
   generated tokens, and checks that every kernel was launched by it;
4. holds the GPU logits and greedy tokens against the same engine moved to
   the CPU (the plain versions), teacher-forced on the GPU's tokens;
5. [finetune] builds the int4 engine with 2 epochs of the paper's §3
   threshold fine-tune on the card (``kv_bits=4, finetune_thresholds=2``)
   and checks its losses; fine-tunes from KV thresholds 4x too wide, where
   each batch's loss must fall; holds the first step's loss and threshold
   gradients against the same step on the CPU;
6. [int4 path] drives that engine's ``generate_batch`` (int4 KV cache,
   the kernels' int4 variants) and holds it against the CPU as in 4;
7. [kernels], paged: both attention kernels over a page pool read through
   a permuted block table (one page mapped into two rows), int8 and int4,
   pages of 16 and 64, at the scheduler's decode shape and the paged
   path's prefill chunk: against their plain versions, and bit for bit
   against the dense kernel on the gathered copy; timed beside it;
8. [paged path] serves 4 x 512 prompts for 32 tokens through a paged cache
   with chunked prefill (chunks of 128, pages of 64): logits and tokens
   bit-identical to the same engine with a dense cache, every attention
   launch through the paged variants, no gather of the pool; [int4 paged
   path] the same for the int4 engine;
9. [scheduler] streams 16 ragged requests (prompts of 64-512 tokens, 32
   generated tokens each) through ``Engine.generate`` with 8 slots of the
   paged cache, and re-serves 4 of them alone through ``generate_batch``;
10. [prefix] serves 4 requests with one 512-token prompt: one prefill,
   three prefix-store hits, equal tokens.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.  Without a CUDA device the script exits 1 before any of it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

B, PROMPT, GEN = 4, 512, 32
# the paged path and the scheduler: chunked prefill, pages, slot batch
CHUNK, PAGE, SLOTS, BLOCK_STEPS, N_REQUESTS = 128, 64, 8, 8, 16
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12   # dense bf16 tensor-core peak
ATTN_TOL = 1e-4             # kernel vs plain attention (float32 sums reordered)
# GPU vs CPU logits of the whole 30-layer bf16 model: bf16 rounds at other
# places in the two devices' norms, rotary, SiLU and readout, and the
# differences pass through 30 residual layers
LOGIT_ATOL = 0.25
# the same at int4 KV: a K/V element that the bf16 differences move across
# a rounding boundary moves by one int4 step, T/7, not T/127
LOGIT_ATOL_INT4 = 0.5
# GPU vs CPU for the engine's first fine-tune step (bfloat16), same inputs:
# the loss's relative error, and the relative L2 error of all alpha (or all
# KV log2_t) gradients together.  Both devices round differently, and at
# the int4 KV grid an element moved across a rounding boundary moves by
# T/7 and carries on through the later layers: the engine's loss moves by
# 1.5% over two fine-tune steps that move every threshold by 0.1%, and
# even in float32 an H100 and the CPU give losses 1.9e-3 apart at full
# width.  The alpha gradients are sums of rounding residuals (y - x)/T,
# each flipped element moving its alpha's gradient by about one step
# times its incoming gradient, so they agree only roughly; a wrong
# gradient would be off by its whole norm or more.
FT_LOSS_RTOL = 2e-2
FT_GRAD_RTOL = {"alpha": 0.5, "log2_t": 0.1}


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=10):
    """Device time per call of ``fn``, summed over its kernels by
    ``torch.profiler``; None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


def timed(torch, fn, **kw):
    """(ms, call_ms): the kernel's device time (profiler; the CUDA-event
    time when the profiler sees no device time) and the CUDA-event time per
    call, which includes the host's launch cost when that is the larger."""
    call = cuda_ms(torch, fn, **kw)
    dev = device_ms(torch, fn)
    return (call if dev is None else dev), call


def bound_ms(nbytes, ops, rate):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / rate * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def check_quant_matmul(torch, ops, ref, dev):
    """Every (K, N) of a layer at decode and prefill M; returns the JSON
    entries (one per phase, summed over the layer's seven matmuls)."""
    layer = [("wq", 576, 576), ("wk", 576, 192), ("wv", 576, 192),
             ("wo", 576, 576), ("gate", 576, 1536), ("up", 576, 1536),
             ("down", 1536, 576)]
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = []
    for phase, m in (("decode", B), ("prefill", B * PROMPT)):
        tot = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   library_ms=0.0, nbytes=0, ops=0)
        for name, k, n in layer:
            x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
                torch.bfloat16)
            w_q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                                dtype=torch.int8)
            w_scale = torch.rand((n,), generator=gen, device=dev) * 1e-3
            act_scale = (127.0 / (x.float().abs().amax() * 0.8)).reshape(())
            got = ops.quant_matmul(x, w_q, w_scale, act_scale)
            want = ref.quant_matmul_ref(x, w_q, w_scale, act_scale)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                diff = (got.float() - want.float()).abs().max().item()
                raise AssertionError(
                    f"quant_matmul {phase} {name} (M={m}, K={k}, N={n}) is "
                    f"not bit-exact with its plain version (max |diff| {diff})")
            ms, call = timed(torch, lambda: ops.quant_matmul(
                x, w_q, w_scale, act_scale))
            plain, _ = timed(torch, lambda: ref.quant_matmul_ref(
                x, w_q, w_scale, act_scale), iters=5, warmup=1)
            nbytes = m * k * 2 + k * n + 4 * n + 4 + m * n * 2
            bnd, _ = bound_ms(nbytes, 2 * m * k * n, INT8_OPS_PER_S)
            # yardstick: cuBLAS int8 GEMM, not called anywhere in the port;
            # torch._int_mm needs M > 16, so the decode rows are zero-padded
            # to M = 32 (the same product, plus padding)
            x_q = torch.clamp(torch.round(x.float() * act_scale), -127,
                              127).to(torch.int8)
            if m <= 16:
                x_q = torch.cat([x_q, x_q.new_zeros((32 - m, k))])
            lib, _ = timed(torch, lambda: torch._int_mm(x_q, w_q))
            print(f"  quant_matmul {phase:7s} {name:4s} M={m:5d} K={k:4d} "
                  f"N={n:4d}: {ms * 1e3:8.1f} us (per call {call * 1e3:6.1f}"
                  f" us)  plain {plain * 1e3:9.1f} us"
                  f"  bound {bnd * 1e3:6.2f} us  _int_mm {lib * 1e3:.1f} us"
                  + (" (M padded to 32)" if m <= 16 else ""))
            tot["ms"] += ms
            tot["call_ms"] += call
            tot["plain_ms"] += plain
            tot["bound_ms"] += bnd
            tot["nbytes"] += nbytes
            tot["ops"] += 2 * m * k * n
            tot["library_ms"] += lib
        _, by = bound_ms(tot["nbytes"], tot["ops"], INT8_OPS_PER_S)
        entries.append({
            "name": f"quant_matmul[{phase}: one layer's 7 matmuls, M={m}]",
            "route": "cuda", "source": "src/repro_torch/csrc/quant_matmul.cu",
            "replaces": "src/repro/kernels/quant_matmul.py:72",
            "kernel": "quant_matmul", "max_abs_err": 0.0, "ms": tot["ms"],
            "call_ms": tot["call_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "library_ms": tot["library_ms"],
            "library": "torch._int_mm" + (
                f" on x zero-padded from M={m} to M=32" if m <= 16 else "")})
    return entries


def dequant_heads(torch, t, scale, groups, bits):
    """(B, S, KV, D) int8 or (B, S, KV, D/2) packed int4 -> (B, KV*G, S, D)
    bf16 for the SDPA yardstick."""
    from repro_torch.core.packing import unpack_int4

    if bits == 4:
        t = unpack_int4(t)
    f = (t.float() * scale.reshape(1, 1, -1, 1)).to(torch.bfloat16)
    return f.permute(0, 2, 1, 3).repeat_interleave(groups, dim=1).contiguous()


def check_attention(torch, ops, ref, dev, bits):
    """Both attention kernels at the main path's shapes with a ``bits``-wide
    K/V stream (int8, or int4 packed two per byte): against their plain
    versions (main-path, ragged and windowed cases), then timed."""
    import torch.nn.functional as F

    from repro_torch.core.packing import pack_int4

    kvh, g, d = 3, 3, 64
    lv = 127 if bits == 8 else 7
    cache_len = -(-(PROMPT + GEN) // 128) * 128
    gen = torch.Generator(device=dev).manual_seed(1)
    k_scale = torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
    v_scale = torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
    tag = "int8" if bits == 8 else "int4 packed"
    variant = "" if bits == 8 else "@int4"

    def tiles(shape):
        t = torch.randint(-lv, lv + 1, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        return pack_int4(t) if bits == 4 else t

    def kv_bytes(n_pos):        # K and V of n_pos positions, one layer
        return 2 * B * n_pos * kvh * d * bits // 8

    entries = []

    # -- prefill: main-path shape, then ragged / windowed variants ---------
    q = torch.randn((B, PROMPT, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k = tiles((B, PROMPT, kvh, d))
    v = tiles((B, PROMPT, kvh, d))
    full = torch.full((B,), PROMPT, dtype=torch.int32, device=dev)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    err = 0.0
    cases = [(zero, full, None),
             (torch.tensor([0, 5, 100, 3], dtype=torch.int32, device=dev),
              torch.tensor([512, 300, 1, 0], dtype=torch.int32, device=dev),
              None),
             (zero, full, 100)]
    for q_start, kv_len, window in cases:
        got = ops.prefill_attention(q, k, v, k_scale, v_scale, q_start,
                                    kv_len, causal=True, window=window,
                                    kv_bits=bits)
        want = ref.prefill_attention_ref(q, k, v, k_scale, v_scale, q_start,
                                         kv_len, causal=True, window=window,
                                         kv_bits=bits)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not e <= ATTN_TOL * (1 + want.abs().max().item()):
            raise AssertionError(f"prefill_attention ({tag}) disagrees with "
                                 f"its plain version: max |diff| {e} "
                                 f"(window={window})")
        err = max(err, e)
    ms, call = timed(torch, lambda: ops.prefill_attention(
        q, k, v, k_scale, v_scale, zero, full, causal=True, kv_bits=bits))
    plain, _ = timed(torch, lambda: ref.prefill_attention_ref(
        q, k, v, k_scale, v_scale, zero, full, causal=True, kv_bits=bits),
        iters=5, warmup=1)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, kvh * g, PROMPT, d).contiguous()
    kh = dequant_heads(torch, k, k_scale, g, bits)
    vh = dequant_heads(torch, v, v_scale, g, bits)
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    pairs = PROMPT * (PROMPT + 1) // 2
    nbytes = q.numel() * 2 + kv_bytes(PROMPT) + 8 * kvh + 8 * B + q.numel() * 4
    bnd, by = bound_ms(nbytes, 4 * d * pairs * B * kvh * g, BF16_FLOPS_PER_S)
    print(f"  prefill_attention [{tag}] B={B} S={PROMPT} KV={kvh} G={g} "
          f"D={d}: {ms * 1e3:.1f} us (per call {call * 1e3:.1f} us)  plain "
          f"{plain * 1e3:.1f} us  bound {bnd * 1e3:.2f} us  sdpa "
          f"{lib * 1e3:.1f} us  max|err| {err:.2e} (tolerance {ATTN_TOL} x "
          f"(1 + max|out|))")
    entries.append({
        "name": f"prefill_attention[{tag} K/V, B={B}, S={PROMPT}, one layer]",
        "route": "cuda", "source": "src/repro_torch/csrc/prefill_attention.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:192",
        "kernel": "prefill_attention" + variant, "max_abs_err": err, "ms": ms,
        "call_ms": call, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib})

    # -- decode: mid-generation position, then ragged positions incl. 0 ----
    cur = PROMPT + GEN // 2
    qd = torch.randn((B, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kc = tiles((B, cache_len, kvh, d))
    vc = tiles((B, cache_len, kvh, d))
    pos = torch.full((B,), cur, dtype=torch.int32, device=dev)
    err = 0.0
    for cur_pos in (pos, torch.tensor([0, 1, 300, cache_len],
                                      dtype=torch.int32, device=dev)):
        got = ops.decode_attention(qd, kc, vc, k_scale, v_scale, cur_pos,
                                   kv_bits=bits)
        want = ref.decode_attention_ref(qd, kc, vc, k_scale, v_scale,
                                        cur_pos, kv_bits=bits)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not e <= ATTN_TOL * (1 + want.abs().max().item()):
            raise AssertionError(f"decode_attention ({tag}) disagrees with "
                                 f"its plain version: max |diff| {e}")
        err = max(err, e)
    ms, call = timed(torch, lambda: ops.decode_attention(
        qd, kc, vc, k_scale, v_scale, pos, kv_bits=bits))
    plain, _ = timed(torch, lambda: ref.decode_attention_ref(
        qd, kc, vc, k_scale, v_scale, pos, kv_bits=bits))
    qh = qd.reshape(B, kvh * g, 1, d)
    kh = dequant_heads(torch, kc[:, :cur], k_scale, g, bits)
    vh = dequant_heads(torch, vc[:, :cur], v_scale, g, bits)
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
    nbytes = (qd.numel() * 2 + kv_bytes(cur) + 8 * kvh + 4 * B
              + qd.numel() * 4)
    bnd, by = bound_ms(nbytes, 4 * B * kvh * g * cur * d, BF16_FLOPS_PER_S)
    print(f"  decode_attention [{tag}] B={B} cache={cache_len} cur_pos={cur}: "
          f"{ms * 1e3:.1f} us (per call {call * 1e3:.1f} us)  plain "
          f"{plain * 1e3:.1f} us  bound {bnd * 1e3:.2f} us  sdpa "
          f"{lib * 1e3:.1f} us  max|err| {err:.2e} (tolerance {ATTN_TOL} x "
          f"(1 + max|out|))")
    entries.append({
        "name": f"decode_attention[{tag} K/V, B={B}, cur_pos={cur}, one "
                f"layer]",
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:172",
        "kernel": "decode_attention" + variant, "max_abs_err": err, "ms": ms,
        "call_ms": call, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib})
    return entries


def paged_inputs(torch, dev, gen, b, cap, page, bits, kvh=3, d=64):
    """K/V pools of ``b`` rows of ``cap`` positions in pages of ``page``
    (and two spare pages), with a seeded permuted block table in which rows
    0 and 1 share their first page (a shared prefix page)."""
    from repro_torch.core.packing import pack_int4

    lv = 127 if bits == 8 else 7
    nb = cap // page
    pages = b * nb + 2

    def pool():
        t = torch.randint(-lv, lv + 1, (pages, page, kvh, d), generator=gen,
                          device=dev, dtype=torch.int8)
        return pack_int4(t) if bits == 4 else t

    kp, vp = pool(), pool()
    perm = torch.randperm(pages, generator=gen, device=dev)
    table = perm[:b * nb].reshape(b, nb).to(torch.int32)
    table[1, 0] = table[0, 0]
    return kp, vp, table.contiguous()


def check_paged_attention(torch, ops, ref, dev, bits, page):
    """Both attention kernels over a paged pool: the scheduler's decode shape
    (8 slots, cache 640, ragged positions including 0) and the paged path's
    prefill chunk (4 rows, 128 queries at position 384, 512 keys).  Each is
    held against its plain version (``ATTN_TOL``) and against the dense
    kernel on the gathered contiguous copy (bit for bit), and timed beside
    it; returns the JSON entries."""
    import torch.nn.functional as F

    from repro_torch.cache import KernelView

    kvh, g, d = 3, 3, 64
    gen = torch.Generator(device=dev).manual_seed(7 + bits + page)
    k_scale = torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
    v_scale = torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
    tag = f"paged {'int8' if bits == 8 else 'int4 packed'} K/V, page {page}"
    variant = "@paged" if bits == 8 else "@paged-int4"
    entries = []

    def held(name, got, want, dense):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= ATTN_TOL * (1 + want.abs().max().item()):
            raise AssertionError(f"{name} ({tag}) disagrees with its plain "
                                 f"version: max |diff| {err}")
        if not torch.equal(got, dense):
            raise AssertionError(
                f"{name} ({tag}) is not bit-identical to the dense kernel on "
                f"the gathered copy: max |diff| "
                f"{(got - dense).abs().max().item()}")
        return err

    # -- decode: the scheduler's slot batch -----------------------------------
    cap = -(-(PROMPT + GEN) // 128) * 128
    bd = SLOTS
    kp, vp, table = paged_inputs(torch, dev, gen, bd, cap, page, bits)
    view = KernelView(kp, vp, table, page, bits)
    kd, vd = ref.gather_pages(kp, table), ref.gather_pages(vp, table)
    q = torch.randn((bd, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    cur = torch.tensor([0, 75, 130, 287, 401, 512, 543, cap],
                       dtype=torch.int32, device=dev)
    got = ops.decode_attention_view(q, view, k_scale, v_scale, cur)
    err = held("decode_attention", got,
               ref.decode_attention_paged_ref(q, kp, vp, table, k_scale,
                                              v_scale, cur, bits),
               ops.decode_attention(q, kd, vd, k_scale, v_scale, cur,
                                    kv_bits=bits))
    ms, call = timed(torch, lambda: ops.decode_attention_view(
        q, view, k_scale, v_scale, cur))
    dense, _ = timed(torch, lambda: ops.decode_attention(
        q, kd, vd, k_scale, v_scale, cur, kv_bits=bits))
    plain, _ = timed(torch, lambda: ref.decode_attention_paged_ref(
        q, kp, vp, table, k_scale, v_scale, cur, bits))
    qh = q.reshape(bd, kvh * g, 1, d)
    kh = dequant_heads(torch, kd, k_scale, g, bits)
    vh = dequant_heads(torch, vd, v_scale, g, bits)
    mask = (torch.arange(cap, device=dev)[None, :] < cur[:, None])[
        :, None, None, :]
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    live = int(cur.sum())
    nbytes = (q.numel() * 2 + 2 * live * kvh * d * bits // 8 + 8 * kvh
              + 4 * bd + 4 * sum(-(-int(c) // page) for c in cur)
              + q.numel() * 4)
    bnd, by = bound_ms(nbytes, 4 * live * kvh * g * d, BF16_FLOPS_PER_S)
    print(f"  decode_attention [{tag}] B={bd} cache={cap} cur_pos="
          f"{cur.tolist()}: {ms * 1e3:.1f} us (per call {call * 1e3:.1f} us)"
          f"  dense kernel on the gathered copy {dense * 1e3:.1f} us  plain "
          f"{plain * 1e3:.1f} us  bound {bnd * 1e3:.2f} us  sdpa "
          f"{lib * 1e3:.1f} us  max|err| {err:.2e}; bit-identical to dense")
    entries.append({
        "name": f"decode_attention[{tag}, B={bd}, ragged cur_pos, one "
                f"layer]",
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:172",
        "kernel": "decode_attention" + variant, "max_abs_err": err, "ms": ms,
        "call_ms": call, "dense_ms": dense, "plain_ms": plain,
        "bound_ms": bnd, "bound_by": by, "library_ms": lib,
        "library": "SDPA on the gathered dequantized bf16, masked"})

    # -- prefill: one 128-query chunk of the paged path -----------------------
    q0, limit = PROMPT - CHUNK, PROMPT
    kp, vp, table = paged_inputs(torch, dev, gen, B, cap, page, bits)
    table = table[:, :limit // page].contiguous()      # kernel_view(limit)
    view = KernelView(kp, vp, table, page, bits)
    kd, vd = ref.gather_pages(kp, table), ref.gather_pages(vp, table)
    q = torch.randn((B, CHUNK, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    qs = torch.full((B,), q0, dtype=torch.int32, device=dev)
    kl = torch.full((B,), limit, dtype=torch.int32, device=dev)
    got = ops.prefill_attention_view(q, view, k_scale, v_scale, qs, kl)
    err = held("prefill_attention", got,
               ref.prefill_attention_paged_ref(q, kp, vp, table, k_scale,
                                               v_scale, qs, kl,
                                               kv_bits=bits),
               ops.prefill_attention(q, kd, vd, k_scale, v_scale, qs, kl,
                                     kv_bits=bits))
    ms, call = timed(torch, lambda: ops.prefill_attention_view(
        q, view, k_scale, v_scale, qs, kl))
    dense, _ = timed(torch, lambda: ops.prefill_attention(
        q, kd, vd, k_scale, v_scale, qs, kl, kv_bits=bits))
    plain, _ = timed(torch, lambda: ref.prefill_attention_paged_ref(
        q, kp, vp, table, k_scale, v_scale, qs, kl, kv_bits=bits),
        iters=5, warmup=1)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, kvh * g, CHUNK, d).contiguous()
    kh = dequant_heads(torch, kd, k_scale, g, bits)
    vh = dequant_heads(torch, vd, v_scale, g, bits)
    mask = (torch.arange(limit, device=dev)[None, :]
            <= q0 + torch.arange(CHUNK, device=dev)[:, None])
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    pairs = CHUNK * q0 + CHUNK * (CHUNK + 1) // 2
    nbytes = (q.numel() * 2 + 2 * B * limit * kvh * d * bits // 8 + 8 * kvh
              + 8 * B + 4 * table.numel() + q.numel() * 4)
    bnd, by = bound_ms(nbytes, 4 * d * pairs * B * kvh * g, BF16_FLOPS_PER_S)
    print(f"  prefill_attention [{tag}] B={B} chunk of {CHUNK} at {q0}, "
          f"kv_len {limit}: {ms * 1e3:.1f} us (per call {call * 1e3:.1f} us)"
          f"  dense kernel on the gathered copy {dense * 1e3:.1f} us  plain "
          f"{plain * 1e3:.1f} us  bound {bnd * 1e3:.2f} us  sdpa "
          f"{lib * 1e3:.1f} us  max|err| {err:.2e}; bit-identical to dense")
    entries.append({
        "name": f"prefill_attention[{tag}, B={B}, {CHUNK} queries at {q0}, "
                f"kv_len {limit}, one layer]",
        "route": "cuda",
        "source": "src/repro_torch/csrc/prefill_attention.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:192",
        "kernel": "prefill_attention" + variant, "max_abs_err": err,
        "ms": ms, "call_ms": call, "dense_ms": dense, "plain_ms": plain,
        "bound_ms": bnd, "bound_by": by, "library_ms": lib,
        "library": "SDPA on the gathered dequantized bf16, masked"})
    return entries


def forced_logits(torch, A, engine, prompts, tokens, n):
    """Prefill + n - 1 decode steps fed with ``tokens``; the float32
    logits of each step on the CPU."""
    dev = engine.device
    with torch.inference_mode():
        cache = engine.init_cache(prompts.shape[0],
                                  engine._cache_len(prompts.shape[1], GEN))
        ctx = A.make_ctx("int8", engine.policy, engine.qparams)
        logits, cache = engine.model.prefill(
            engine.serve_params, {"tokens": prompts.to(dev)}, cache, ctx)
        out = [logits[:, -1].float().cpu()]
        for i in range(n - 1):
            logits, cache = engine.model.decode_step(
                engine.serve_params, tokens[:, i:i + 1].to(dev), cache,
                prompts.shape[1] + i, ctx)
            out.append(logits[:, -1].float().cpu())
    return out


def breakdown(torch, engine, prompts, card):
    """Where the main path's time goes: device busy time by kernel name
    (torch.profiler) against the wall clock, for prefill and for decode."""
    from torch.profiler import ProfilerActivity, profile

    def busy(gen):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = engine.generate_batch({"tokens": prompts}, gen=gen)
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0]
        return res, rows

    steps = 8
    res1, pre = busy(1)
    res2, both = busy(1 + steps)
    pre_us = sum(t for _, t, _ in pre)
    dec = {k: [t, c] for k, t, c in both}
    for k, t, c in pre:
        d = dec.setdefault(k, [0, 0])
        d[0] -= t
        d[1] -= c
    dec_us = sum(t for t, _ in dec.values()) / steps
    if pre_us == 0:
        print("[breakdown] the profiler recorded no device time: not measured")
        return
    print(f"[breakdown] prefill: device busy {pre_us / 1e3:.2f} ms of "
          f"{res1.prefill_s * 1e3:.2f} ms wall (profiled); decode: device "
          f"busy {dec_us / 1e3:.3f} ms of {res2.decode_s / steps * 1e3:.2f} "
          f"ms wall per step (profiled) on {card}")
    for title, rows, div in (("prefill", [(k, t) for k, t, _ in pre], 1),
                             ("decode step", [(k, v[0]) for k, v in
                                              dec.items()], steps)):
        top = sorted(rows, key=lambda r: -r[1])[:6]
        print(f"  top device time per {title}: " + "; ".join(
            f"{k[:48]} {t / div / 1e3:.3f} ms" for k, t in top))


def drive_main_path(torch, ops, engine, prompts, label, kind, card):
    """Warm up, zero the launch counts, serve 4 x 512 prompts for 32 tokens
    and check what came out and which kernels ran; returns (result, all
    launch counts, int4-variant launch counts)."""
    engine.generate_batch({"tokens": prompts}, gen=2)   # warm-up
    ops.reset_launches()
    res = engine.generate_batch({"tokens": prompts}, gen=GEN)
    counts, int4 = ops.launch_counts(), ops.int4_launch_counts()
    n_layers = engine.cfg.n_layers
    expected = {"quant_matmul": 7 * n_layers * GEN,
                "prefill_attention": n_layers,
                "decode_attention": n_layers * (GEN - 1)}
    int4_expected = ({k: expected[k] for k in int4}
                     if engine.policy.kv_bits == 4 else {k: 0 for k in int4})
    print(f"[{label}] kernel launches {counts} (expected {expected}); int4 "
          f"variants {int4} (expected {int4_expected})")
    if counts != expected or int4 != int4_expected:
        raise AssertionError(f"launch counts {counts} / {int4} != "
                             f"{expected} / {int4_expected}")
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise AssertionError("non-finite prefill logits")
    toks = res.tokens.cpu()
    if toks.shape != (B, GEN) or not bool(
            ((toks >= 0) & (toks < engine.cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    prefill_tps = B * PROMPT / res.prefill_s
    decode_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"[{label}] prefill {B}x{PROMPT} tokens: {res.prefill_s * 1e3:.1f}"
          f" ms = {prefill_tps:.0f} tokens/s; decode: {decode_ms:.2f} ms per "
          f"step of {B} tokens (ms/token per request) on {kind} ({card})")
    return res, counts, int4


def cpu_check(torch, A, engine, prompts, toks, tol, label):
    """Teacher-forced logits of the GPU engine against the same engine
    moved to the CPU (plain versions): the GPU's token must be the CPU's
    argmax or within ``tol`` of it (a near-tie that rounding may flip), and
    no logit may differ by more than ``tol``."""
    n_check = 4
    tok_t = torch.as_tensor(toks, dtype=torch.long)
    gpu = forced_logits(torch, A, engine, torch.as_tensor(prompts), tok_t,
                        n_check)
    for i, lg in enumerate(gpu):
        if not torch.equal(lg.argmax(-1), tok_t[:, i]):
            raise AssertionError(f"step {i}: teacher-forced GPU argmax "
                                 f"differs from generate_batch's tokens")
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"step {i}: non-finite logits")
    t0 = time.perf_counter()
    cpu = forced_logits(torch, A, engine.to("cpu"),
                        torch.as_tensor(prompts), tok_t, n_check)
    worst, same, ties, gaps = 0.0, 0, 0, []
    for i, (g_lg, c_lg) in enumerate(zip(gpu, cpu)):
        worst = max(worst, (g_lg - c_lg).abs().max().item())
        pick = c_lg.argmax(-1)
        for r in range(B):
            gap = (c_lg[r, pick[r]] - c_lg[r, tok_t[r, i]]).item()
            if int(pick[r]) == int(tok_t[r, i]):
                same += 1
            elif gap <= tol:
                ties += 1   # a near-tie that bf16 rounding may flip
            else:
                gaps.append(f"step {i} row {r}: CPU picks {int(pick[r])}, "
                            f"GPU {int(tok_t[r, i])}, {gap:.4f} apart")
    print(f"[{label}] {n_check} teacher-forced steps on the CPU (plain "
          f"versions) in {time.perf_counter() - t0:.1f} s: max |logit diff| "
          f"{worst:.4f} (tolerance {tol}); greedy tokens equal "
          f"{same}/{n_check * B}, near-ties {ties}, further apart "
          f"{len(gaps)}")
    if gaps:
        raise AssertionError(f"tokens differ by more than {tol}: {gaps}")
    if worst > tol:
        raise AssertionError(f"GPU and CPU logits differ by {worst}")


class GatherCount:
    """Counts, while active, every contiguous gather of a page pool
    (``PagedCache.dense_view`` and the plain versions' ``gather_pages``):
    the paged path on the card must run none."""

    def __init__(self, paged_cls, ref):
        self.paged_cls, self.ref, self.n = paged_cls, ref, 0

    def __enter__(self):
        self.saved = (self.paged_cls.dense_view, self.ref.gather_pages)
        view, gather = self.saved

        def counted_view(cache, *a, **kw):
            self.n += 1
            return view(cache, *a, **kw)

        def counted_gather(*a, **kw):
            self.n += 1
            return gather(*a, **kw)

        self.paged_cls.dense_view = counted_view
        self.ref.gather_pages = counted_gather
        return self

    def __exit__(self, *exc):
        self.paged_cls.dense_view, self.ref.gather_pages = self.saved


def layout_twin(Engine, engine, layout):
    """The same weights and thresholds served through another cache layout,
    with chunked prefill in chunks of CHUNK (pages of PAGE)."""
    return Engine(engine.model, engine.cfg, engine.policy,
                  engine.serve_params, engine.qparams, device=engine.device,
                  cache_layout=layout, page_size=PAGE, prefill_chunk=CHUNK)


def drive_paged_path(torch, ops, ref, Engine, PagedCache, engine, prompts,
                     label, kind, card):
    """4 x 512 prompts for 32 tokens through a paged cache with chunked
    prefill: every attention launch through the paged variants, no gather
    of the pool, and logits and tokens bit-identical to the same engine
    with a dense cache.  Returns (all, int4, paged) launch counts."""
    paged = layout_twin(Engine, engine, "paged")
    dense = layout_twin(Engine, engine, "dense")
    paged.generate_batch({"tokens": prompts}, gen=2)       # warm-up
    ops.reset_launches()
    with GatherCount(PagedCache, ref) as gathers:
        res = paged.generate_batch({"tokens": prompts}, gen=GEN)
    counts, int4 = ops.launch_counts(), ops.int4_launch_counts()
    pg = ops.paged_launch_counts()
    n_layers, chunks = engine.cfg.n_layers, PROMPT // CHUNK
    attn = {"prefill_attention": n_layers * chunks,
            "decode_attention": n_layers * (GEN - 1)}
    expected = {"quant_matmul": 7 * n_layers * (chunks + GEN - 1), **attn}
    int4_expected = attn if engine.policy.kv_bits == 4 else {
        k: 0 for k in attn}
    print(f"[{label}] kernel launches {counts} (expected {expected}); paged "
          f"variants {pg} (expected {attn}); int4 variants {int4}; pool "
          f"gathers {gathers.n} (expected 0)")
    if (counts, pg, int4, gathers.n) != (expected, attn, int4_expected, 0):
        raise AssertionError(f"launch counts {counts} / paged {pg} / int4 "
                             f"{int4} / gathers {gathers.n}")
    want = dense.generate_batch({"tokens": prompts}, gen=GEN)
    if not (torch.equal(res.prefill_logits, want.prefill_logits)
            and torch.equal(res.tokens, want.tokens)):
        diff = (res.prefill_logits.float() - want.prefill_logits.float()).abs()
        raise AssertionError(
            f"paged and dense caches disagree: prefill logits max |diff| "
            f"{diff.max().item()}, tokens equal "
            f"{int((res.tokens == want.tokens).sum())}/{res.tokens.numel()}")
    cache = paged.init_cache(B, paged._cache_len(PROMPT, GEN))
    pool = sum(c["attn"].k.numel() + c["attn"].v.numel()
               + 4 * c["attn"].table.numel() for c in cache.values())
    print(f"[{label}] prefill {B}x{PROMPT} tokens in chunks of {CHUNK}: "
          f"{res.prefill_s * 1e3:.1f} ms = {B * PROMPT / res.prefill_s:.0f} "
          f"tokens/s; decode {res.decode_s / (GEN - 1) * 1e3:.2f} ms per step;"
          f" pool {pool} bytes ({len(cache)} layers, pages of {PAGE}) on "
          f"{kind} ({card}); prefill logits and {GEN} greedy tokens "
          "bit-identical to the dense cache")
    return counts, int4, pg


def teacher_forced_gap(torch, A, ST, engine, prompt, tokens):
    """Batch-1 chunked prefill + decode of ``prompt`` fed ``tokens``: the
    first step whose argmax is not ``tokens[step]``, with the logit gap
    between the two; None when every argmax agrees."""
    with torch.inference_mode():
        ctx = A.make_ctx("int8", engine.policy, engine.qparams)
        toks = torch.as_tensor(prompt, device=engine.device)[None]
        cache = engine.init_cache(1, engine._cache_len(toks.shape[1],
                                                       len(tokens)))
        padded, lengths = ST.pad_for_chunked_prefill(toks, CHUNK)
        logits, cache = ST.make_prefill_step(
            engine.model, engine.policy, prefill_chunk=CHUNK)(
            engine.serve_params, engine.qparams, {"tokens": padded}, cache,
            lengths)
        for i, t in enumerate(tokens):
            row = logits[0, -1].float()
            pick = int(row.argmax())
            if pick != t:
                return i, (row[pick] - row[t]).item()
            logits, cache = engine.model.decode_step(
                engine.serve_params, torch.tensor([[t]], device=engine.device),
                cache, toks.shape[1] + i, ctx)
    return None


def check_scheduler(torch, ops, A, ST, Engine, Request, engine, kind, card):
    """16 ragged requests through 8 slots of the paged cache; every one must
    finish by its 32-token budget, and 4 of them re-served alone through
    batch-1 ``generate_batch`` (dense cache, same chunks) must give the same
    tokens or first differ at a near-tie.  Returns the launch counts."""
    rng = np.random.default_rng(3)
    lengths = rng.integers(64, PROMPT + 1, N_REQUESTS)
    reqs = [Request(rid=i, tokens=rng.integers(0, engine.cfg.vocab, n,
                                               dtype=np.int32), max_gen=GEN)
            for i, n in enumerate(lengths)]
    ops.reset_launches()
    t0 = time.perf_counter()
    done = engine.generate(reqs, max_slots=SLOTS, block_steps=BLOCK_STEPS,
                           eos_id=-1)
    wall = time.perf_counter() - t0
    counts, pg = ops.launch_counts(), ops.paged_launch_counts()
    sched = engine._scheduler
    calls, sec = sched.call_counts(), sched.stage_seconds()
    n_layers = engine.cfg.n_layers
    steps = calls["decode"] * BLOCK_STEPS
    bad = [(c.rid, c.status, c.finished_by, len(c.tokens)) for c in done
           if (c.status, c.finished_by, len(c.tokens)) != ("ok", "budget",
                                                           GEN)]
    print(f"[scheduler] {len(done)} requests (prompts {lengths.min()}-"
          f"{lengths.max()} tokens, {GEN} generated each) through {SLOTS} "
          f"slots in {wall:.2f} s: {len(done) / wall:.2f} requests/s, "
          f"{len(done) * GEN / wall:.1f} generated tokens/s; admission "
          f"{sec['admit'] / calls['prefill'] * 1e3:.1f} ms per request; "
          f"decode {sec['decode'] / calls['decode'] * 1e3:.1f} ms per block "
          f"of {BLOCK_STEPS} steps = {sec['decode'] / steps * 1e3:.2f} ms per "
          f"step on {kind} ({card})")
    print(f"[scheduler] calls {calls}; kernel launches {counts}; paged "
          f"variants {pg} (decode expected {n_layers * steps}); health "
          f"{sched.health_stats()}")
    if len(done) != N_REQUESTS or bad:
        raise AssertionError(f"{len(done)} completions; not ok/budget/{GEN}: "
                             f"{bad}")
    if pg != {"prefill_attention": 0, "decode_attention": n_layers * steps}:
        raise AssertionError(f"paged launches {pg}")
    dense = layout_twin(Engine, engine, "dense")
    by_rid = {c.rid: c for c in done}
    for r in range(4):
        alone = dense.generate_batch({"tokens": reqs[r].tokens[None]},
                                     gen=GEN).tokens[0].tolist()
        got = by_rid[r].tokens
        if alone == got:
            print(f"[scheduler] request {r} ({lengths[r]} tokens) alone: "
                  f"{GEN} tokens equal")
            continue
        forced = teacher_forced_gap(torch, A, ST, dense, reqs[r].tokens,
                                    got)
        if forced is None:
            raise AssertionError(
                f"request {r}: batch-1 generate_batch gives other tokens, "
                "but teacher-forced on the scheduler's tokens every argmax "
                "agrees")
        step, gap = forced
        print(f"[scheduler] request {r} ({lengths[r]} tokens) alone: first "
              f"differs at token {step}, where the batch-1 logits put the "
              f"scheduler's token {gap:.4f} below their argmax (near-tie "
              f"tolerance {LOGIT_ATOL})")
        if not gap <= LOGIT_ATOL:
            raise AssertionError(f"request {r}: the scheduler's token {step} "
                                 f"is {gap} below the batch-1 argmax")
    return counts, pg


def check_prefix(torch, ops, Request, engine, kind, card):
    """4 requests with one 512-token prompt through the paged scheduler:
    one prefill, three prefix-store hits, every request the first's
    tokens.  Returns the launch counts."""
    prompt = np.random.default_rng(4).integers(0, engine.cfg.vocab, PROMPT,
                                               dtype=np.int32)
    ops.reset_launches()
    t0 = time.perf_counter()
    done = engine.generate([Request(rid=r, tokens=prompt, max_gen=GEN)
                            for r in range(4)], max_slots=4,
                           block_steps=BLOCK_STEPS)
    wall = time.perf_counter() - t0
    sched = engine._scheduler
    calls, stats = sched.call_counts(), sched.prefix_stats()
    counts, pg = ops.launch_counts(), ops.paged_launch_counts()
    toks = [c.tokens for c in sorted(done, key=lambda c: c.rid)]
    print(f"[prefix] 4 requests, one {PROMPT}-token prompt, in {wall:.2f} s "
          f"on {kind} ({card}): calls {calls}; prefix store {stats}; paged "
          f"launches {pg}; tokens equal to the first's "
          f"{sum(t == toks[0] for t in toks)}/4")
    if calls["prefill"] != 1 or stats["hits"] != 3:
        raise AssertionError(f"prefill calls {calls['prefill']}, hits "
                             f"{stats['hits']} (want 1 and 3)")
    if any(t != toks[0] for t in toks) or len(toks[0]) != GEN:
        raise AssertionError(f"prefix-shared requests differ: {toks}")
    return counts, pg


def calibrated(torch, A, ST, model, params, policy, batches):
    """§2 calibration over ``batches``, finalized with trainable
    thresholds (what the engine's fine-tune starts from)."""
    with torch.no_grad():
        qp = A.init_qparams(model, params, policy)
        calib = ST.make_calibrate_step(model, policy)
        for b in batches:
            qp = calib(params, qp, b)
        return A.finalize_calibration(qp, train_thresholds=True)


def inflate_kv(A, qparams, factor):
    """Every KV threshold ``factor`` times too wide, as one outlier in the
    calibration set makes it (the reference's over-calibration case,
    ``tests/test_threshold_train.py::_calibrate(inflate=)``)."""
    return {k: ({kk: {"t_max": st["t_max"] * factor,
                      "log2_t": st["log2_t"] + float(np.log2(factor))}
                 for kk, st in v.items()} if A.is_kv_path(k) else v)
            for k, v in qparams.items()}


def per_batch(losses, n):
    """(first-epoch, last-epoch) loss of each of the n batches."""
    return [(losses[b], losses[len(losses) - n + b]) for b in range(n)]


def check_finetune(torch, A, ST, engine, card):
    """The §3 fine-tune on the card.

    1. The int4 engine's own fine-tune (lr 1e-3, 2 epochs): every loss
       finite; the change of each batch's loss is printed.
    2. The over-calibration case the reference pins
       (``test_distill_loss_strictly_decreases``: KV thresholds 4x too
       wide, lr 0.1, cosine period 8), from the engine's weights and
       calibration, 2 epochs over the same batches on the card: each
       batch's loss must be lower in the last epoch than in the first.
    3. The first step of 1, from the same seeded inputs, on the card and
       on the CPU: the loss and the alpha and KV log2_t gradients."""
    from repro_torch import data as D
    from repro_torch.bridge import tree_to

    log = engine.finetune_log
    losses, step_s = log["losses"], log["step_s"]
    for i, (lo, sec) in enumerate(zip(losses, step_s)):
        print(f"[finetune] step {i}: loss {lo:.6f}  {sec * 1e3:.1f} ms "
              f"(synchronized)")
    batches = D.calibration_batches(engine.cfg.vocab, seed=0)
    n = len(batches)
    if not all(np.isfinite(losses)) or len(losses) % n:
        raise AssertionError(f"fine-tune losses {losses}")
    print(f"[finetune] {len(losses)} steps, {np.mean(step_s[1:]) * 1e3:.1f} "
          f"ms per step after the first ({step_s[0] * 1e3:.1f} ms) on {card}; "
          "loss per batch, first -> last epoch: " + ", ".join(
              f"{a:.4f} -> {b:.4f} ({(b - a) / a:+.2%})"
              for a, b in per_batch(losses, n)))

    dev = engine.device
    model, policy = engine.model, engine.policy
    params = tree_to(model.init(torch.Generator().manual_seed(0)), dev)
    toks = [{"tokens": torch.as_tensor(b["tokens"], device=dev)}
            for b in batches]
    qp = calibrated(torch, A, ST, model, params, policy, toks)

    # 2. recovery from over-calibrated KV thresholds
    t0 = time.perf_counter()
    _, rec = ST.finetune_thresholds(
        model, policy, params, inflate_kv(A, qp, 4.0), toks, epochs=2,
        hp=ST.TrainHParams(base_lr=0.1, anneal_period=8))
    print(f"[finetune] KV thresholds 4x too wide, lr 0.1, 2 epochs in "
          f"{time.perf_counter() - t0:.1f} s: losses " + " ".join(
              f"{lo:.4f}" for lo in rec))
    for b, (first, last) in enumerate(per_batch(rec, n)):
        if not (np.isfinite(rec).all() and last < first):
            raise AssertionError(f"over-calibrated fine-tune, batch {b}: loss "
                                 f"{last} in the last epoch is not below "
                                 f"{first} in the first")

    # 3. the first step on the card and on the CPU
    grad_fn = ST.make_fat_grad_fn(model, policy)
    loss_g, grads_g = grad_fn(params, qp, toks[0])
    t0 = time.perf_counter()
    loss_c, grads_c = grad_fn(tree_to(params, "cpu"), tree_to(qp, "cpu"),
                              {"tokens": toks[0]["tokens"].cpu()})
    cpu_s = time.perf_counter() - t0
    loss_g, loss_c = float(loss_g), float(loss_c)
    rel_loss = abs(loss_g - loss_c) / abs(loss_c)
    print(f"[finetune] first step: loss {loss_g:.6f} on the card (the "
          f"engine's: {losses[0]:.6f}), {loss_c:.6f} on the CPU ({cpu_s:.1f}"
          f" s); relative difference {rel_loss:.2e} (tolerance "
          f"{FT_LOSS_RTOL})")
    bad = [] if rel_loss <= FT_LOSS_RTOL else ["loss"]
    for kind, tol in FT_GRAD_RTOL.items():
        keys = [k for k in grads_c if k[-1] == kind]
        g = torch.cat([grads_g[k].float().cpu().reshape(-1) for k in keys])
        c = torch.cat([grads_c[k].float().reshape(-1) for k in keys])
        rel = ((g - c).norm() / c.norm()).item()
        agree = (torch.sign(g) == torch.sign(c)).float().mean().item()
        print(f"[finetune]   {kind} gradients ({len(keys)} leaves, "
              f"{c.numel()} values): relative L2 difference card vs CPU "
              f"{rel:.3e} (tolerance {tol}), signs agree {agree:.3f}, "
              f"|grad| max {c.abs().max().item():.3e}")
        if not rel <= tol:
            bad.append(f"{kind} gradients")
    if bad:
        raise AssertionError(f"first fine-tune step: {', '.join(bad)} differ "
                             "between card and CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))

    from repro_torch.cache import PagedCache
    from repro_torch.core import api as A
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import steps as ST
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.scheduler import Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card "
          f"(name, power limit):")
    print(card)

    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    print(f"[build] kernels built and loaded in {build_s:.1f} s")
    for name, log in build.ptxas_logs().items():
        lines = {line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line}
        for line in sorted(lines):
            print(f"  ptxas {name}: {line}")

    dev = torch.device("cuda")
    t_kern = time.perf_counter()
    print(f"[kernels] each kernel against its plain version on {kind} "
          f"({card}); quant_matmul must be bit-exact:")
    kernels = check_quant_matmul(torch, ops, ref, dev)
    kernels += check_attention(torch, ops, ref, dev, bits=8)
    kernels += check_attention(torch, ops, ref, dev, bits=4)
    for bits in (8, 4):
        for page in (16, PAGE):
            kernels += check_paged_attention(torch, ops, ref, dev, bits, page)

    phases = {"build": build_s, "kernels": time.perf_counter() - t_kern}

    failures = []

    def phase(name, fn, *args):
        """Run one checked phase and time it; a failed check is recorded
        and the later phases still run, so one run reports them all."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except AssertionError as err:
            failures.append(f"[{name}] {err}")
            print(f"[{name}] FAILED: {err}")
            return None
        finally:
            phases[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    engine = Engine.from_checkpoint("smollm-135m", smoke=False)
    torch.cuda.synchronize()
    print(f"[engine] smollm-135m full width: init + calibration + int8 "
          f"conversion in {time.perf_counter() - t0:.1f} s; "
          f"{engine.n_int8_weights()} int8 weight tensors")
    phases["int8 engine"] = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, engine.cfg.vocab, (B, PROMPT), dtype=np.int32)
    res, counts, _ = drive_main_path(torch, ops, engine, prompts,
                                     "main path", kind, card)
    phases["main path"] = time.perf_counter() - t0 - phases["int8 engine"]
    phase("breakdown", breakdown, torch, engine, prompts, card)
    phase("cpu check", cpu_check, torch, A, engine, prompts,
          res.tokens.cpu(), LOGIT_ATOL, "cpu check")
    del engine

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine4 = Engine.from_checkpoint("smollm-135m", smoke=False, kv_bits=4,
                                     finetune_thresholds=2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[finetune] smollm-135m full width, kv_bits=4, 2 epochs x 2 "
          f"calibration batches of 4 x 32: init + calibration + fine-tune "
          f"+ int8 conversion in {time.perf_counter() - t0:.1f} s; peak "
          f"device memory {peak / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated)")
    phases["int4 engine"] = time.perf_counter() - t0
    phase("finetune", check_finetune, torch, A, ST, engine4, card)
    out4 = phase("int4 path", drive_main_path, torch, ops, engine4, prompts,
                 "int4 path", kind, card)
    if out4 is not None:
        phase("int4 cpu check", cpu_check, torch, A, engine4, prompts,
              out4[0].tokens.cpu(), LOGIT_ATOL_INT4, "int4 cpu check")
    paged4 = phase("int4 paged path", drive_paged_path, torch, ops, ref,
                   Engine, PagedCache, engine4, prompts, "int4 paged path",
                   kind, card)
    del engine4

    t0 = time.perf_counter()
    engine_p = Engine.from_checkpoint("smollm-135m", smoke=False,
                                      cache_layout="paged", page_size=PAGE,
                                      prefill_chunk=CHUNK)
    torch.cuda.synchronize()
    phases["paged engine"] = time.perf_counter() - t0
    # the paged launches of each of this slice's paths, each counted from 0
    paged_runs = {
        "paged path": phase("paged path", drive_paged_path, torch, ops, ref,
                            Engine, PagedCache, engine_p, prompts,
                            "paged path", kind, card),
        "scheduler": phase("scheduler", check_scheduler, torch, ops, A, ST,
                           Engine, Request, engine_p, kind, card),
        "prefix": phase("prefix", check_prefix, torch, ops, Request,
                        engine_p, kind, card)}
    print("[time] " + "; ".join(f"{k} {v:.1f} s" for k, v in phases.items()))
    if failures:
        print("chip_smoke: failed checks:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1

    by_path = {path: run[-1] for path, run in paged_runs.items()}
    launched = {**counts, **{f"{k}@int4": n for k, n in out4[2].items()},
                **{f"{k}@paged-int4": n for k, n in paged4[2].items()},
                **{f"{k}@paged": sum(pg[k] for pg in by_path.values())
                   for k in ops.ATTENTION}}
    for e in kernels:
        kernel = e.pop("kernel")
        e["launches"] = launched[kernel]
        if kernel.endswith("@paged"):
            e["launches_by_path"] = {path: pg[kernel.split("@")[0]]
                                     for path, pg in by_path.items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
