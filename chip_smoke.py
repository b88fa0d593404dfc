#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

1. builds the hand-written Hopper kernels (``src/repro_torch/csrc``);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path (quant_matmul bit for bit), and times kernel,
   plain version and one PyTorch library call as a yardstick;
3. drives the main path at the full width of smollm-135m (30 layers,
   seeded random weights): ``Engine.from_checkpoint`` -> §2 calibration ->
   int8 conversion -> ``generate_batch`` on 4 prompts of 512 tokens with 32
   generated tokens, and checks that every kernel was launched by it;
4. holds the GPU logits and greedy tokens against the same engine moved to
   the CPU (the plain versions), teacher-forced on the GPU's tokens.

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

B, PROMPT, GEN = 4, 512, 32
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12   # dense bf16 tensor-core peak
ATTN_TOL = 1e-4             # kernel vs plain attention (float32 sums reordered)
# GPU vs CPU logits of the whole 30-layer bf16 model: bf16 rounds at other
# places in the two devices' norms, rotary, SiLU and readout, and the
# differences pass through 30 residual layers
LOGIT_ATOL = 0.25


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
        library_ok = True
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
            # yardstick: cuBLAS int8 GEMM (torch._int_mm needs M > 16 and
            # K, N multiples of 8); not called anywhere in the port
            lib = None
            if m > 16 and k % 8 == 0 and n % 8 == 0:
                x_q = torch.clamp(torch.round(x.float() * act_scale), -127,
                                  127).to(torch.int8)
                lib, _ = timed(torch, lambda: torch._int_mm(x_q, w_q))
            print(f"  quant_matmul {phase:7s} {name:4s} M={m:5d} K={k:4d} "
                  f"N={n:4d}: {ms * 1e3:8.1f} us (per call {call * 1e3:6.1f}"
                  f" us)  plain {plain * 1e3:9.1f} us"
                  f"  bound {bnd * 1e3:6.2f} us  _int_mm "
                  f"{'n/a' if lib is None else f'{lib * 1e3:.1f} us'}")
            tot["ms"] += ms
            tot["call_ms"] += call
            tot["plain_ms"] += plain
            tot["bound_ms"] += bnd
            tot["nbytes"] += nbytes
            tot["ops"] += 2 * m * k * n
            if lib is None:
                library_ok = False
            else:
                tot["library_ms"] += lib
        _, by = bound_ms(tot["nbytes"], tot["ops"], INT8_OPS_PER_S)
        entries.append({
            "name": f"quant_matmul[{phase}: one layer's 7 matmuls, M={m}]",
            "route": "cuda", "source": "src/repro_torch/csrc/quant_matmul.cu",
            "replaces": "src/repro/kernels/quant_matmul.py:72",
            "kernel": "quant_matmul", "max_abs_err": 0.0, "ms": tot["ms"],
            "call_ms": tot["call_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "library_ms": tot["library_ms"] if library_ok else None})
    return entries


def dequant_heads(torch, t, scale, groups):
    """(B, S, KV, D) int8 -> (B, KV*G, S, D) bf16 for the SDPA yardstick."""
    f = (t.float() * scale.reshape(1, 1, -1, 1)).to(torch.bfloat16)
    return f.permute(0, 2, 1, 3).repeat_interleave(groups, dim=1).contiguous()


def check_attention(torch, ops, ref, dev):
    import torch.nn.functional as F

    kvh, g, d = 3, 3, 64
    cache_len = -(-(PROMPT + GEN) // 128) * 128
    gen = torch.Generator(device=dev).manual_seed(1)
    k_scale = torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
    v_scale = torch.rand((kvh,), generator=gen, device=dev) * 0.05 + 0.01
    entries = []

    # -- prefill: main-path shape, then ragged / windowed variants ---------
    q = torch.randn((B, PROMPT, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randint(-127, 128, (B, PROMPT, kvh, d), generator=gen,
                      device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (B, PROMPT, kvh, d), generator=gen,
                      device=dev, dtype=torch.int8)
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
                                    kv_len, causal=True, window=window)
        want = ref.prefill_attention_ref(q, k, v, k_scale, v_scale, q_start,
                                         kv_len, causal=True, window=window)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not e <= ATTN_TOL * (1 + want.abs().max().item()):
            raise AssertionError(f"prefill_attention disagrees with its plain "
                                 f"version: max |diff| {e} (window={window})")
        err = max(err, e)
    ms, call = timed(torch, lambda: ops.prefill_attention(
        q, k, v, k_scale, v_scale, zero, full, causal=True))
    plain, _ = timed(torch, lambda: ref.prefill_attention_ref(
        q, k, v, k_scale, v_scale, zero, full, causal=True), iters=5,
        warmup=1)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, kvh * g, PROMPT, d).contiguous()
    kh = dequant_heads(torch, k, k_scale, g)
    vh = dequant_heads(torch, v, v_scale, g)
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    pairs = PROMPT * (PROMPT + 1) // 2
    nbytes = q.numel() * 2 + 2 * k.numel() + 8 * kvh + 8 * B + q.numel() * 4
    bnd, by = bound_ms(nbytes, 4 * d * pairs * B * kvh * g, BF16_FLOPS_PER_S)
    print(f"  prefill_attention B={B} S={PROMPT} KV={kvh} G={g} D={d}: "
          f"{ms * 1e3:.1f} us (per call {call * 1e3:.1f} us)  plain {plain * 1e3:.1f} us  bound "
          f"{bnd * 1e3:.2f} us  sdpa {lib * 1e3:.1f} us  max|err| {err:.2e} "
          f"(tolerance {ATTN_TOL} x (1 + max|out|))")
    entries.append({
        "name": f"prefill_attention[B={B}, S={PROMPT}, one layer]",
        "route": "cuda", "source": "src/repro_torch/csrc/prefill_attention.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:192",
        "kernel": "prefill_attention", "max_abs_err": err, "ms": ms,
        "call_ms": call, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib})

    # -- decode: mid-generation position, then ragged positions incl. 0 ----
    cur = PROMPT + GEN // 2
    qd = torch.randn((B, kvh, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kc = torch.randint(-127, 128, (B, cache_len, kvh, d), generator=gen,
                       device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (B, cache_len, kvh, d), generator=gen,
                       device=dev, dtype=torch.int8)
    pos = torch.full((B,), cur, dtype=torch.int32, device=dev)
    err = 0.0
    for cur_pos in (pos, torch.tensor([0, 1, 300, cache_len],
                                      dtype=torch.int32, device=dev)):
        got = ops.decode_attention(qd, kc, vc, k_scale, v_scale, cur_pos)
        want = ref.decode_attention_ref(qd, kc, vc, k_scale, v_scale, cur_pos)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not e <= ATTN_TOL * (1 + want.abs().max().item()):
            raise AssertionError(f"decode_attention disagrees with its plain "
                                 f"version: max |diff| {e}")
        err = max(err, e)
    ms, call = timed(torch, lambda: ops.decode_attention(qd, kc, vc, k_scale,
                                                         v_scale, pos))
    plain, _ = timed(torch, lambda: ref.decode_attention_ref(
        qd, kc, vc, k_scale, v_scale, pos))
    qh = qd.reshape(B, kvh * g, 1, d)
    kh = dequant_heads(torch, kc[:, :cur], k_scale, g)
    vh = dequant_heads(torch, vc[:, :cur], v_scale, g)
    lib, _ = timed(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
    nbytes = (qd.numel() * 2 + 2 * B * cur * kvh * d + 8 * kvh + 4 * B
              + qd.numel() * 4)
    bnd, by = bound_ms(nbytes, 4 * B * kvh * g * cur * d, BF16_FLOPS_PER_S)
    print(f"  decode_attention B={B} cache={cache_len} cur_pos={cur}: "
          f"{ms * 1e3:.1f} us (per call {call * 1e3:.1f} us)  plain {plain * 1e3:.1f} us  bound "
          f"{bnd * 1e3:.2f} us  sdpa {lib * 1e3:.1f} us  max|err| {err:.2e} "
          f"(tolerance {ATTN_TOL} x (1 + max|out|))")
    entries.append({
        "name": f"decode_attention[B={B}, cur_pos={cur}, one layer]",
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:172",
        "kernel": "decode_attention", "max_abs_err": err, "ms": ms,
        "call_ms": call, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": lib})
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np

    from repro_torch.core import api as A
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.engine import Engine

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
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f}"
          f" s")
    for name, log in build.ptxas_logs().items():
        lines = {line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line}
        for line in sorted(lines):
            print(f"  ptxas {name}: {line}")

    dev = torch.device("cuda")
    print(f"[kernels] each kernel against its plain version on {kind} "
          f"({card}); quant_matmul must be bit-exact:")
    kernels = check_quant_matmul(torch, ops, ref, dev)
    kernels += check_attention(torch, ops, ref, dev)

    t0 = time.perf_counter()
    engine = Engine.from_checkpoint("smollm-135m", smoke=False)
    torch.cuda.synchronize()
    print(f"[engine] smollm-135m full width: init + calibration + int8 "
          f"conversion in {time.perf_counter() - t0:.1f} s; "
          f"{engine.n_int8_weights()} int8 weight tensors")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, engine.cfg.vocab, (B, PROMPT), dtype=np.int32)
    engine.generate_batch({"tokens": prompts}, gen=2)   # warm-up

    ops.reset_launches()
    res = engine.generate_batch({"tokens": prompts}, gen=GEN)
    counts = ops.launch_counts()
    n_layers = engine.cfg.n_layers
    expected = {"quant_matmul": 7 * n_layers * GEN,
                "prefill_attention": n_layers,
                "decode_attention": n_layers * (GEN - 1)}
    print(f"[main path] kernel launches {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != {expected}")
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise AssertionError("non-finite prefill logits")
    toks = res.tokens.cpu()
    if toks.shape != (B, GEN) or not bool(
            ((toks >= 0) & (toks < engine.cfg.vocab)).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    prefill_tps = B * PROMPT / res.prefill_s
    decode_ms = res.decode_s / (GEN - 1) * 1e3
    print(f"[main path] prefill {B}x{PROMPT} tokens: {res.prefill_s * 1e3:.1f}"
          f" ms = {prefill_tps:.0f} tokens/s; decode: {decode_ms:.2f} ms per "
          f"step of {B} tokens (ms/token per request) on {kind} ({card})")

    breakdown(torch, engine, prompts, card)

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
    worst, same, ties = 0.0, 0, 0
    for i, (g_lg, c_lg) in enumerate(zip(gpu, cpu)):
        worst = max(worst, (g_lg - c_lg).abs().max().item())
        pick = c_lg.argmax(-1)
        for r in range(B):
            if int(pick[r]) == int(tok_t[r, i]):
                same += 1
            elif c_lg[r, pick[r]] - c_lg[r, tok_t[r, i]] <= LOGIT_ATOL:
                ties += 1   # a near-tie that bf16 rounding may flip
            else:
                raise AssertionError(
                    f"step {i} row {r}: CPU picks {int(pick[r])}, GPU "
                    f"{int(tok_t[r, i])}, by more than {LOGIT_ATOL}")
    print(f"[cpu check] {n_check} teacher-forced steps on the CPU (plain "
          f"versions) in {time.perf_counter() - t0:.1f} s: max |logit diff| "
          f"{worst:.4f} (tolerance {LOGIT_ATOL}); greedy tokens equal "
          f"{same}/{n_check * B}, near-ties {ties}")
    if worst > LOGIT_ATOL:
        raise AssertionError(f"GPU and CPU logits differ by {worst}")

    for e in kernels:
        e["launches"] = counts[e.pop("kernel")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
