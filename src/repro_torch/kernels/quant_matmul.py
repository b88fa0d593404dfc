"""Wrapper of the Hopper kernel ``csrc/quant_matmul.cu``: fused activation
quantize -> int8 x int8 (or packed int4) -> int32 -> per-channel dequant ->
bf16 or float32 (the TPU kernel's ``out_dtype``); and its int32-accumulator branch (``launch_acc``): already quantized
int8 x times the weight rows [k0, k1) -> int32, no scale (one
tensor-parallel shard's partial of a row-parallel layer).

Replaces the TPU kernel ``repro/kernels/quant_matmul.py::quant_matmul``.
``launch`` and ``launch_acc`` take CUDA tensors only; ``ops.quant_matmul``
and ``ops.quant_matmul_acc`` route CPU tensors to the plain versions
(``ref.quant_matmul_ref``, ``ref.quant_matmul_acc_ref``).
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "src/repro_torch/csrc/quant_matmul.cu"
REPLACES = "src/repro/kernels/quant_matmul.py:72"

# kernel launches made by ``launch`` in this process: all, with int4
# (packed) weights, and with a float32 output; and those of the
# int32-accumulator branch (``launch_acc``), counted apart
launches = 0
launches_w4 = 0
launches_f32 = 0
launches_acc = 0

OUT_DTYPES = (torch.bfloat16, torch.float32)

_FN = None
_FN_ACC = None


def check(x, w_q, w_scale, act_scale, w_bits=8, out=None,
          out_dtype=torch.bfloat16):
    """Raise on inputs the kernel (and its plain version) does not take.
    ``w_bits == 4``: w_q holds (K/2, N) bytes, nibbles packed along K;
    ``out``, when given, takes the (M, N) result of type ``out_dtype``
    (bfloat16 or float32)."""
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32, got "
                        f"{out_dtype}")
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
        if out.dtype != out_dtype or out.shape != (m, w_q.shape[1]):
            raise ValueError(f"out must be {out_dtype} ({m}, "
                             f"{w_q.shape[1]}), got {out.dtype} "
                             f"{tuple(out.shape)}")
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
                             [p, i, p, i, p, p, p, i, i, i, i, p])
    return _FN


def launch(x, w_q, w_scale, act_scale, w_bits=8, out=None,
           out_dtype=torch.bfloat16):
    """Run the CUDA kernel; returns (M, N) of ``out_dtype`` (``out`` when
    given)."""
    global launches, launches_w4, launches_f32
    check(x, w_q, w_scale, act_scale, w_bits, out, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    m, k = x.shape
    n = w_q.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                    w_q.data_ptr(), w_bits, w_scale.data_ptr(),
                    act_scale.data_ptr(), out.data_ptr(),
                    int(out_dtype == torch.float32), m, k, n, stream)
    if err:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    launches_w4 += w_bits == 4
    launches_f32 += out_dtype == torch.float32
    return out


def check_acc(x_q, w_q, k0, k1, out=None):
    """Raise on inputs the int32-accumulator branch (and its plain version)
    does not take: ``x_q`` (M, K) int8, ``w_q`` (K, N) int8, a contraction
    range 0 <= k0 <= k1 <= K, ``out`` a contiguous (M, N) int32 tensor."""
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul_acc takes x_q (M, K) and w_q (K, N), "
                         f"got {tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    if x_q.shape[0] < 1:
        raise ValueError("quant_matmul_acc needs M >= 1")
    if not 0 <= k0 <= k1 <= x_q.shape[1]:
        raise ValueError(f"contraction range [{k0}, {k1}) is not inside K = "
                         f"{x_q.shape[1]}")
    tensors = (("x_q", x_q), ("w_q", w_q))
    if out is not None:
        shape = (x_q.shape[0], w_q.shape[1])
        if out.dtype != torch.int32 or tuple(out.shape) != shape:
            raise ValueError(f"out must be int32 {shape}, got {out.dtype} "
                             f"{tuple(out.shape)}")
        tensors += (("out", out),)
    devs = {t.device for _, t in tensors}
    if len(devs) != 1:
        raise ValueError(f"quant_matmul_acc inputs span devices {devs}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "x_q" and t.data_ptr() % 4:
            raise ValueError(f"{name} must start on a 4-byte boundary")


def _fn_acc():
    global _FN_ACC
    if _FN_ACC is None:
        from repro_torch.kernels import build

        p, i = ctypes.c_void_p, ctypes.c_int
        _FN_ACC = build.function("quant_matmul", "repro_quant_matmul_acc",
                                 [p, i, p, p, i, i, i, p])
    return _FN_ACC


def launch_acc(x_q, w_q, k0, k1, out=None):
    """Run the int32-accumulator branch: (M, N) int32, the sums of x_q[:,
    k0:k1] @ w_q[k0:k1] (``out`` when given), read in place."""
    global launches_acc
    check_acc(x_q, w_q, k0, k1, out)
    if x_q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{x_q.device}")
    m, k = x_q.shape
    n = w_q.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=torch.int32, device=x_q.device)
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn_acc()(x_q.data_ptr() + k0, k, w_q.data_ptr() + k0 * n,
                        out.data_ptr(), m, k1 - k0, n, stream)
    if err:
        raise RuntimeError(f"quant_matmul_acc kernel launch failed: CUDA "
                           f"error {err}")
    launches_acc += 1
    return out
