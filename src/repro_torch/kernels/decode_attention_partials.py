"""Wrapper of the Hopper kernel ``csrc/decode_attention_partials.cu``: the
decode kernel's body (``csrc/decode_attention.cuh``) with the partials
epilogue.  One-token attention over one shard of a sequence-split int8 or
packed-int4 KV cache (or a page pool read through a block table) that
returns the raw flash state instead of the normalized output, for the
sequence-parallel merge
(``repro_torch.shard.partial_softmax.sp_partial_combine``).

Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_partials_tiles``,
through its dense entry ``decode_attention_partials`` (one shard's slice of
the cache) and with a paged table.  It is the decode kernel's chunks and
in-order merge with another epilogue (``decode_attention``'s docstring has
the design), so what bounds it is the same: latency.  The output, the
running max and normalizer and the chunk scratch are one allocation; the
arrival counters are the decode kernel's.  A dense slice ``k[:, lo:hi]``
of the global cache is read in place through the row pitch, never copied.
``launch`` takes CUDA tensors only; ``ops.decode_attention_partials`` and
``ops.decode_attention_partials_view`` route CPU tensors to the plain
versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import decode_attention as _da

SOURCE = "src/repro_torch/csrc/decode_attention_partials.cu"
REPLACES = "src/repro/kernels/decode_attention.py:305"

# kernel launches made by ``launch`` in this process: all, at int4, and
# over a paged pool
launches = 0
launches_int4 = 0
launches_paged = 0

_FN: dict = {}    # {wide: the C entry of the D <= 128 or the wide library}


def check(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits=8,
          table=None):
    """Raise on inputs the kernel (and its plain version) does not take:
    those of the decode kernel, where a dense cache may be a slice along S
    of a longer contiguous one (``decode_attention.row_pitch``)."""
    _da.check(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits, table,
              pitched=True)


def _fn(wide: bool):
    """The C entry of the library for D <= 128, or (``wide``) for
    128 < D <= 256."""
    if wide not in _FN:
        from repro_torch.kernels import build

        p, i = ctypes.c_void_p, ctypes.c_int
        lib = ("decode_attention_partials_wide" if wide
               else "decode_attention_partials")
        _FN[wide] = build.function(lib, "repro_decode_attention_partials",
                                   [p, i, p, p, p, p, p, p, p, p, p, p, i, i,
                                    i, i, i, i, i, i, p, i, i, i, p])
    return _FN[wide]


def launch(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits=8,
           table=None):
    """Run the CUDA kernel with its partials epilogue over ``cur_pos``
    LOCAL positions; returns (acc (B, KV, G, D), m (B, KV, G), l (B, KV, G))
    float32, acc unnormalized and value-dequantized."""
    global launches, launches_int4, launches_paged
    check(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits, table)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    b, kvh, g, d = q.shape
    s, paging = _da.geometry(k_cache, table)
    pitch = _da.row_pitch(k_cache) if table is None else s
    n_acc, n_ml = b * kvh * g * d, b * kvh * g
    buf = torch.empty(n_acc + 2 * n_ml + _da.scratch_numel(b, kvh, s, g, d),
                      dtype=torch.float32, device=q.device)
    acc = buf[:n_acc].view(b, kvh, g, d)
    m, l = buf[n_acc:n_acc + 2 * n_ml].view(2, b, kvh, g)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(d > 128)(q.data_ptr(), int(q.dtype == torch.bfloat16),
                    k_cache.data_ptr(), v_cache.data_ptr(),
                    k_scale.data_ptr(), v_scale.data_ptr(),
                    cur_pos.data_ptr(), acc.data_ptr(), m.data_ptr(),
                    l.data_ptr(), buf[n_acc + 2 * n_ml:].data_ptr(),
                    _da.counters(q.device, b * kvh).data_ptr(), b, s, pitch,
                    kvh, g, d, kv_bits, _da.SPLIT, *paging, stream)
    if err:
        raise RuntimeError(f"decode_attention_partials kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    launches_int4 += kv_bits == 4
    launches_paged += table is not None
    return acc, m, l
