"""Wrapper of the Hopper kernel ``csrc/decode_attention.cu``: one-token
online-softmax attention over the dense int8 or packed-int4 KV cache.

Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_tiles`` through its
dense entry ``decode_attention_int8``.  ``launch`` takes CUDA tensors
only; ``ops.decode_attention`` routes CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:172"

G_MAX = 16      # query heads per KV head the kernel instantiates for
D_MAX = 128

# kernel launches made by ``launch`` in this process, all and at int4
launches = 0
launches_int4 = 0

_FN = None


def check(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits=8):
    """Raise on inputs the kernel (and its plain version) does not take."""
    if q.ndim != 4 or k_cache.ndim != 4:
        raise ValueError(f"decode_attention takes q (B, KV, G, D) and a "
                         f"(B, S, KV, D) cache, got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    b, kvh, g, d = q.shape
    dp = d // 2 if kv_bits == 4 else d     # storage bytes per row
    if k_cache.shape[0] != b or k_cache.shape[2:] != (kvh, dp):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)} at kv_bits={kv_bits} (int4 "
                         "caches hold D/2 packed bytes)")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k and v caches differ in shape")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise TypeError("the kernel reads an int8 (or packed int4) cache")
    if d % 8 or d > D_MAX:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= {D_MAX}")
    if g > G_MAX:
        raise ValueError(f"{g} query heads per KV head exceeds {G_MAX}")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.dtype != torch.float32 or s.shape != (kvh,):
            raise ValueError(f"{name} must be float32 ({kvh},)")
    if cur_pos.dtype != torch.int32 or cur_pos.shape != (b,):
        raise ValueError(f"cur_pos must be int32 ({b},)")
    devs = {t.device for t in (q, k_cache, v_cache, k_scale, v_scale, cur_pos)}
    if len(devs) != 1:
        raise ValueError(f"decode_attention inputs span devices {devs}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must start on a 4-byte boundary")


def _fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build

        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = build.function("decode_attention", "repro_decode_attention",
                             [p, i, p, p, p, p, p, p, i, i, i, i, i, i, p])
    return _FN


def launch(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits=8):
    """Run the CUDA kernel; returns (B, KV, G, D) float32."""
    global launches, launches_int4
    check(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    b, kvh, g, d = q.shape
    s = k_cache.shape[1]
    out = torch.empty((b, kvh, g, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q.data_ptr(), int(q.dtype == torch.bfloat16),
                    k_cache.data_ptr(), v_cache.data_ptr(),
                    k_scale.data_ptr(), v_scale.data_ptr(),
                    cur_pos.data_ptr(), out.data_ptr(), b, s, kvh, g, d,
                    kv_bits, stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    if kv_bits == 4:
        launches_int4 += 1
    return out
