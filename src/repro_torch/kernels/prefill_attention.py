"""Wrapper of the Hopper kernel ``csrc/prefill_attention.cu``: flash
attention of a prompt over its int8 or packed-int4 K/V stream (causal,
kv_len and optional sliding-window masks).

Replaces the TPU kernel
``repro/kernels/prefill_attention.py::prefill_attention_tiles`` through its
dense entry ``prefill_attention_int8``.  ``launch`` takes CUDA tensors
only; ``ops.prefill_attention`` routes CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "src/repro_torch/csrc/prefill_attention.cu"
REPLACES = "src/repro/kernels/prefill_attention.py:192"

G_MAX = 64      # query heads per KV head: one row tile holds 64 rows
D_MAX = 128

# kernel launches made by ``launch`` in this process, all and at int4
launches = 0
launches_int4 = 0

_FN = None


def check(q, k, v, k_scale, v_scale, q_start, kv_len, window, kv_bits=8):
    """Raise on inputs the kernel (and its plain version) does not take."""
    if q.ndim != 5 or k.ndim != 4:
        raise ValueError(f"prefill_attention takes q (B, Sq, KV, G, D) and "
                         f"k/v (B, Sk, KV, D), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    b, sq, kvh, g, d = q.shape
    dp = d // 2 if kv_bits == 4 else d     # storage bytes per row
    if k.shape[0] != b or k.shape[2:] != (kvh, dp):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} at kv_bits={kv_bits} (int4 "
                         "tiles hold D/2 packed bytes)")
    if v.shape != k.shape:
        raise ValueError("k and v differ in shape")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError("the kernel reads int8 (or packed int4) K/V tiles")
    if d % 8 or d > D_MAX:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= {D_MAX}")
    if g > G_MAX:
        raise ValueError(f"{g} query heads per KV head exceeds {G_MAX}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.dtype != torch.float32 or s.shape != (kvh,):
            raise ValueError(f"{name} must be float32 ({kvh},)")
    for name, t in (("q_start", q_start), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.shape != (b,):
            raise ValueError(f"{name} must be int32 ({b},)")
    devs = {t.device for t in (q, k, v, k_scale, v_scale, q_start, kv_len)}
    if len(devs) != 1:
        raise ValueError(f"prefill_attention inputs span devices {devs}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must start on a 4-byte boundary")


def _fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build

        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = build.function("prefill_attention", "repro_prefill_attention",
                             [p, i, p, p, p, p, p, p, p,
                              i, i, i, i, i, i, i, i, i, p])
    return _FN


def launch(q, k, v, k_scale, v_scale, q_start, kv_len, *, causal=True,
           window=None, kv_bits=8):
    """Run the CUDA kernel; returns (B, Sq, KV, G, D) float32."""
    global launches, launches_int4
    check(q, k, v, k_scale, v_scale, q_start, kv_len, window, kv_bits)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, kvh, g, d), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), int(q.dtype == torch.bfloat16),
                    k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                    v_scale.data_ptr(), q_start.data_ptr(), kv_len.data_ptr(),
                    out.data_ptr(), b, sq, sk, kvh, g, d, int(bool(causal)),
                    0 if window is None else int(window), kv_bits, stream)
    if err:
        raise RuntimeError(f"prefill_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    if kv_bits == 4:
        launches_int4 += 1
    return out
