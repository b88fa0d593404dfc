"""Wrapper of the Hopper kernel ``csrc/quant_matmul.cu``: fused activation
quantize -> int8 x int8 -> int32 -> per-channel dequant -> bf16.

Replaces the TPU kernel ``repro/kernels/quant_matmul.py::quant_matmul``.
``launch`` takes CUDA tensors only; ``ops.quant_matmul`` routes CPU
tensors to the plain version (``ref.quant_matmul_ref``).
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "src/repro_torch/csrc/quant_matmul.cu"
REPLACES = "src/repro/kernels/quant_matmul.py:72"

# kernel launches made by ``launch`` in this process
launches = 0

_FN = None


def check(x, w_q, w_scale, act_scale):
    """Raise on inputs the kernel (and its plain version) does not take."""
    if x.ndim != 2 or w_q.ndim != 2:
        raise ValueError(f"quant_matmul takes x (M, K) and w_q (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    m, k = x.shape
    if w_q.shape[0] != k:
        raise ValueError(f"x is (M, {k}) but w_q is {tuple(w_q.shape)}")
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
    devs = {t.device for t in (x, w_q, w_scale, act_scale)}
    if len(devs) != 1:
        raise ValueError(f"quant_matmul inputs span devices {devs}")
    for name, t in (("x", x), ("w_q", w_q), ("w_scale", w_scale)):
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
                             [p, i, p, p, p, p, i, i, i, p])
    return _FN


def launch(x, w_q, w_scale, act_scale):
    """Run the CUDA kernel; returns (M, N) bfloat16."""
    global launches
    check(x, w_q, w_scale, act_scale)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                    w_q.data_ptr(), w_scale.data_ptr(), act_scale.data_ptr(),
                    out.data_ptr(), m, k, n, stream)
    if err:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
