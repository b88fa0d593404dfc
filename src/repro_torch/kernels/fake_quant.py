"""Wrapper of the Hopper kernel ``csrc/fake_quant.cu``: fused per-channel
fake-quantize, clip(round(x * s), qmin, qmax) / s with s = levels /
max(clip(alpha) * t_max, 1e-8).

Replaces the TPU kernel ``repro/kernels/fake_quant.py::fake_quant_fwd``
(forward only; the STE backward is plain PyTorch in ``ops.fake_quant``, as
the reference has it in jnp).  ``launch`` takes CUDA tensors only;
``ops.fake_quant`` routes CPU tensors to the plain version
(``ref.fake_quant_ref``).
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "src/repro_torch/csrc/fake_quant.cu"
REPLACES = "src/repro/kernels/fake_quant.py:39"

ROWS = 8                # rows a thread walks (csrc/fake_quant.cu)
MAX_GRID_Y = 65535

# kernel launches made by ``launch`` in this process
launches = 0

_FN = None


def check(x, t_max, alpha):
    """Raise on inputs the kernel (and its plain version) does not take:
    x (M, N) float32 or bfloat16; t_max and alpha one value or (N,)."""
    if x.ndim != 2:
        raise ValueError(f"fake_quant takes x (M, N), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    n = x.shape[1]
    for name, t in (("t_max", t_max), ("alpha", alpha)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
        if t.ndim > 1 or t.numel() not in (1, n):
            raise ValueError(f"{name} must be one value or ({n},), got "
                             f"{tuple(t.shape)}")
    devs = {t.device for t in (x, t_max, alpha)}
    if len(devs) != 1:
        raise ValueError(f"fake_quant inputs span devices {devs}")


def _fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build

        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        _FN = build.function("fake_quant", "repro_fake_quant",
                             [p, i, p, i, p, i, p, i, i, f, f, f, f, f, p])
    return _FN


def launch(x, t_max, alpha, *, levels=127.0, qmin=-127.0, qmax=127.0,
           alpha_min=0.5, alpha_max=1.0):
    """Run the CUDA kernel; returns (M, N) in x's dtype."""
    global launches
    check(x, t_max, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    m, n = x.shape
    if -(-m // ROWS) > MAX_GRID_Y:
        raise ValueError(f"M={m} exceeds the kernel's grid "
                         f"({MAX_GRID_Y * ROWS} rows)")
    t = t_max.float().contiguous()
    a = alpha.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                    t.data_ptr(), int(t.numel() > 1), a.data_ptr(),
                    int(a.numel() > 1), out.data_ptr(), m, n, levels, qmin,
                    qmax, alpha_min, alpha_max, stream)
    if err:
        raise RuntimeError(f"fake_quant kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
