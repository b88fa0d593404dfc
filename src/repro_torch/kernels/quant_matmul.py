"""Wrapper of the Hopper kernel ``csrc/quant_matmul.cu``: fused activation
quantize -> int8 x int8 (or packed int4) -> int32 -> per-channel dequant ->
bf16.

Replaces the TPU kernel ``repro/kernels/quant_matmul.py::quant_matmul``.
``launch`` takes CUDA tensors only; ``ops.quant_matmul`` routes CPU
tensors to the plain version (``ref.quant_matmul_ref``).
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "src/repro_torch/csrc/quant_matmul.cu"
REPLACES = "src/repro/kernels/quant_matmul.py:72"

# kernel launches made by ``launch`` in this process: all, and with int4
# (packed) weights
launches = 0
launches_w4 = 0

_FN = None


def check(x, w_q, w_scale, act_scale, w_bits=8, out=None):
    """Raise on inputs the kernel (and its plain version) does not take.
    ``w_bits == 4``: w_q holds (K/2, N) bytes, nibbles packed along K;
    ``out``, when given, takes the (M, N) bfloat16 result."""
    if w_bits not in (4, 8):
        raise ValueError(f"w_bits must be 4 or 8, got {w_bits}")
    if x.ndim != 2 or w_q.ndim != 2:
        raise ValueError(f"quant_matmul takes x (M, K) and w_q (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    m, k = x.shape
    if w_bits == 4 and k % 2:
        raise ValueError(f"int4 weights pack K in pairs: K={k} is odd")
    k_rows = k // 2 if w_bits == 4 else k
    if w_q.shape[0] != k_rows:
        raise ValueError(f"x is (M, {k}) but w_q is {tuple(w_q.shape)} at "
                         f"w_bits={w_bits} (int4 weights are packed to "
                         f"({k_rows}, N))")
    if m < 1:
        raise ValueError("quant_matmul needs M >= 1")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    if w_scale.dtype != torch.float32 or w_scale.shape != (w_q.shape[1],):
        raise ValueError(f"w_scale must be float32 ({w_q.shape[1]},), got "
                         f"{w_scale.dtype} {tuple(w_scale.shape)}")
    if act_scale.dtype != torch.float32 or act_scale.numel() != 1:
        raise ValueError("act_scale must be one float32 value")
    tensors = (("x", x), ("w_q", w_q), ("w_scale", w_scale))
    if out is not None:
        if out.dtype != torch.bfloat16 or out.shape != (m, w_q.shape[1]):
            raise ValueError(f"out must be bfloat16 ({m}, {w_q.shape[1]}), "
                             f"got {out.dtype} {tuple(out.shape)}")
        tensors += (("out", out),)
    devs = {t.device for _, t in tensors} | {act_scale.device}
    if len(devs) != 1:
        raise ValueError(f"quant_matmul inputs span devices {devs}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must start on a 4-byte boundary")


def _fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build

        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = build.function("quant_matmul", "repro_quant_matmul",
                             [p, i, p, i, p, p, p, i, i, i, p])
    return _FN


def launch(x, w_q, w_scale, act_scale, w_bits=8, out=None):
    """Run the CUDA kernel; returns (M, N) bfloat16 (``out`` when given)."""
    global launches, launches_w4
    check(x, w_q, w_scale, act_scale, w_bits, out)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    m, k = x.shape
    n = w_q.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                    w_q.data_ptr(), w_bits, w_scale.data_ptr(),
                    act_scale.data_ptr(), out.data_ptr(), m, k, n, stream)
    if err:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    launches_w4 += w_bits == 4
    return out
