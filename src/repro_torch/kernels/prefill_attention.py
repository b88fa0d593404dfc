"""Wrapper of the Hopper kernel ``csrc/prefill_attention.cu``: flash
attention of a prompt (or a prompt chunk) over an int8, packed-int4, bf16 or
float32 K/V stream, dense or paged (a page pool read through a block table),
with causal, kv_len and optional sliding-window masks.  A bf16 or float32
stream is a float KV cache, served with unit scales, as the TPU kernel
serves one.

Replaces the TPU kernel
``repro/kernels/prefill_attention.py::prefill_attention_tiles``, through its
dense entry ``prefill_attention_int8`` and with the paged layout's table.
``launch`` takes CUDA tensors only; ``ops.prefill_attention`` and
``ops.prefill_attention_view`` route CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.decode_attention import check_table

SOURCE = "src/repro_torch/csrc/prefill_attention.cu"
REPLACES = "src/repro/kernels/prefill_attention.py:192"

G_MAX = 64      # query heads per KV head: one row tile holds 64 rows
D_MAX = 256     # the output accumulator lives in registers: D/2 floats a
                # lane; head dims past it: ROADMAP Queue B

# kernel launches made by ``launch`` in this process: all, at int4, over a
# bf16 K/V stream, over a float32 one, over a paged pool, and with a sliding
# window
launches = 0
launches_int4 = 0
launches_bf16 = 0
launches_f32 = 0
launches_paged = 0
launches_window = 0

_FN: dict = {}    # {wide: the C entry of the D <= 128 or the wide library}


def check(q, k, v, k_scale, v_scale, q_start, kv_len, window, kv_bits=8,
          table=None):
    """Raise on inputs the kernel (and its plain version) does not take.
    K/V are int8 tiles (packed int4 at ``kv_bits=4``) or float tiles of D
    values a row at ``kv_bits=8``: bf16 or float32 (float32 at D <= 128 on
    the card: the wide library has no float32 branch, ROADMAP Queue B).
    With ``table``
    (B, NB) int32, k/v are (pages, page_size, KV, D) pools (D/2 at int4)
    read through it."""
    if q.ndim != 5 or k.ndim != 4:
        raise ValueError(f"prefill_attention takes q (B, Sq, KV, G, D) and "
                         f"k/v (B, Sk, KV, D) or (pages, page_size, KV, D) "
                         f"pools, got {tuple(q.shape)} and {tuple(k.shape)}")
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    b, sq, kvh, g, d = q.shape
    dp = d // 2 if kv_bits == 4 else d     # storage bytes per row
    if table is not None:
        check_table(table, b, k, q.device)
    elif k.shape[0] != b:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if k.shape[2:] != (kvh, dp):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} at kv_bits={kv_bits} (int4 "
                         "tiles hold D/2 packed bytes)")
    if v.shape != k.shape:
        raise ValueError("k and v differ in shape")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if v.dtype != k.dtype or k.dtype not in (torch.int8, torch.bfloat16,
                                              torch.float32):
        raise TypeError(f"K/V must be int8 (or packed int4) tiles or float "
                        f"tiles of one dtype, got {k.dtype} and {v.dtype}")
    if k.dtype != torch.int8 and kv_bits != 8:
        raise ValueError("float K/V tiles hold D values a row: kv_bits must "
                         "be 8")
    if d % 8 or d > D_MAX:
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= "
                         f"{D_MAX} (a wider head is ROADMAP Queue B)")
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


def _fn(wide: bool):
    """The C entry of the library for D <= 128, or (``wide``) for
    128 < D <= 256."""
    if wide not in _FN:
        from repro_torch.kernels import build

        p, i = ctypes.c_void_p, ctypes.c_int
        lib = "prefill_attention_wide" if wide else "prefill_attention"
        _FN[wide] = build.function(lib, "repro_prefill_attention",
                                   [p, i, p, p, p, p, p, p, p,
                                    i, i, i, i, i, i, i, i, i, p, i, i, i,
                                    p])
    return _FN[wide]


def storage_code(k, kv_bits, d):
    """The kernel's K/V storage code (``BITS``): 8 int8 or 4 packed int4
    tiles, 16 bf16 and 32 float32 tiles with unit scales.  A float32
    stream past D 128 raises: the wide library has no float32 branch."""
    if k.dtype == torch.float32:
        if d > 128:
            raise TypeError(f"float32 K/V at head dim {d}: the wide library "
                            f"(D > 128) has no float32 branch, its tiles do "
                            f"not fit shared memory (ROADMAP Queue B)")
        return 32
    return 16 if k.dtype == torch.bfloat16 else kv_bits


def launch(q, k, v, k_scale, v_scale, q_start, kv_len, *, causal=True,
           window=None, kv_bits=8, table=None):
    """Run the CUDA kernel over a dense K/V stream, or over page pools
    through ``table``; returns (B, Sq, KV, G, D) float32."""
    global launches, launches_int4, launches_bf16, launches_f32
    global launches_paged, launches_window
    check(q, k, v, k_scale, v_scale, q_start, kv_len, window, kv_bits, table)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    b, sq, kvh, g, d = q.shape
    bits = storage_code(k, kv_bits, d)
    bf16, f32 = bits == 16, bits == 32
    if table is None:
        sk, paging = k.shape[1], (None, 0, 0, 0)
    else:
        nb, ps = table.shape[1], k.shape[1]
        sk, paging = nb * ps, (table.data_ptr(), nb, ps, k.shape[0])
    out = torch.empty((b, sq, kvh, g, d), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(d > 128)(q.data_ptr(), int(q.dtype == torch.bfloat16),
                    k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                    v_scale.data_ptr(), q_start.data_ptr(), kv_len.data_ptr(),
                    out.data_ptr(), b, sq, sk, kvh, g, d, int(bool(causal)),
                    0 if window is None else int(window), bits, *paging,
                    stream)
    if err:
        raise RuntimeError(f"prefill_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    launches_int4 += kv_bits == 4
    launches_bf16 += bf16
    launches_f32 += f32
    launches_paged += table is not None
    launches_window += window is not None
    return out
