"""Wrapper of the Hopper kernel ``csrc/decode_attention.cu``: one-token
online-softmax attention over an int8 or packed-int4 KV cache, dense or
paged (a page pool read through a block table).

Replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_tiles``, through its
dense entry ``decode_attention_int8`` and with the paged layout's table.
``launch`` takes CUDA tensors only; ``ops.decode_attention`` and
``ops.decode_attention_view`` route CPU tensors to the plain versions.
The same kernel body with the partials epilogue (the sequence-parallel
path's raw flash state) is ``decode_attention_partials``.

Design (the source note of ``csrc/decode_attention.cuh`` has it in full):
the sequence axis is cut into chunks of ``SPLIT`` positions, fixed by
position alone, and each block of the grid (KV, B, ceil(S / SPLIT)) takes
one chunk of one (request, KV head).  A chunk past ``cur_pos`` leaves at
once.  Each live chunk writes its raw flash state (acc, m, l) to a scratch
buffer and bumps a per-(request, KV head) arrival counter; the last chunk
to arrive merges the row's chunks in chunk order, so the result does not
depend on the order the blocks ran in, nor on S, the page size or the
grid.  A row whose live positions fit in one chunk skips the scratch.  The
kernel is bound by latency (its K/V bytes take well under a microsecond at
the serving shapes): the chunks spread a row over many SMs and cut each
block's chain of memory round trips and barriers to one pass.

One launch a call and one allocation (the output and the scratch
together); the counters are a per-device int32 buffer allocated once
(``counters``), which every launch leaves zeroed.  They assume that the
launches that share them run one after another, on one stream.  A CUDA
graph keeps the address of the buffer it was captured with, so no buffer
that was ever handed out is freed.  The wrapper never reads ``cur_pos`` on
the host.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:172"

G_MAX = 16      # query heads per KV head the kernel instantiates for
D_MAX = 256     # head dims past it: ROADMAP Queue B (no config has one)
SPLIT = 64      # positions per chunk: the kernel's SPLIT (it checks)

# kernel launches made by ``launch`` in this process: all, at int4, and
# over a paged pool
launches = 0
launches_int4 = 0
launches_paged = 0

_FN: dict = {}    # {wide: the C entry of the D <= 128 or the wide library}
_COUNTERS: dict = {}
# every counter buffer replaced by a larger one: a graph captured with it
# still launches on its address, so it stays allocated
_RETIRED: list = []


def counters(device, n):
    """The device's int32 arrival counters of the chunk merge, at least
    ``n`` of them: allocated zeroed on first use (or when a launch needs
    more, the old buffer then kept alive in ``_RETIRED``), shared by the
    decode and partials kernels, and left at 0 by every launch."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def scratch_numel(b, kvh, s, g, d):
    """Floats of the chunk states a launch over ``s`` positions needs:
    (B, KV, ceil(s / SPLIT), G * (D + 2))."""
    return b * kvh * -(-s // SPLIT) * g * (d + 2)


def check(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits=8,
          table=None, pitched=False):
    """Raise on inputs the kernel (and its plain version) does not take.
    With ``table`` (B, NB) int32 the caches are (pages, page_size, KV, D)
    pools (D/2 at int4) read through it.  ``pitched``: a dense cache may be
    a slice of a longer one along S (``row_pitch``), read in place."""
    if q.ndim != 4 or k_cache.ndim != 4:
        raise ValueError(f"decode_attention takes q (B, KV, G, D) and a "
                         f"(B, S, KV, D) cache or a (pages, page_size, KV, "
                         f"D) pool, got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    b, kvh, g, d = q.shape
    dp = d // 2 if kv_bits == 4 else d     # storage bytes per row
    if table is not None:
        check_table(table, b, k_cache, q.device)
    elif k_cache.shape[0] != b:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if k_cache.shape[2:] != (kvh, dp):
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
        raise ValueError(f"head dim {d} must be a multiple of 8 and <= "
                         f"{D_MAX} (a wider head is ROADMAP Queue B)")
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
        if pitched and table is None and name != "q":
            row_pitch(t)
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must start on a 4-byte boundary")
    if pitched and table is None and row_pitch(k_cache) != row_pitch(v_cache):
        raise ValueError("k and v caches differ in their row pitch")


def row_pitch(cache) -> int:
    """Positions between the batch rows of a (B, S, KV, D) cache whose
    positions are contiguous rows of KV * D elements: S for a whole cache,
    the full length for a slice ``c[:, lo:hi]`` of a longer one."""
    b, s, kvh, dp = cache.shape
    row = kvh * dp
    if (cache.stride(3) != 1 or cache.stride(2) != dp or cache.stride(1) != row
            or (b > 1 and (cache.stride(0) % row or cache.stride(0) < s * row))):
        raise ValueError(f"cache {tuple(cache.shape)} with strides "
                         f"{cache.stride()} is not a slice along S of a "
                         "contiguous cache")
    return cache.stride(0) // row if b > 1 else s


def check_table(table, b, pool, device):
    """Raise unless ``table`` is a contiguous (b, NB) int32 block table on
    ``device`` over a pool with page_size a multiple of 8 (the entries are
    data: the kernel clamps each into the pool)."""
    if (table.dtype != torch.int32 or table.ndim != 2 or table.shape[0] != b
            or table.shape[1] < 1):
        raise ValueError(f"block table must be int32 ({b}, n_blocks), got "
                         f"{table.dtype} {tuple(table.shape)}")
    if pool.shape[1] % 8:
        raise ValueError(f"page_size {pool.shape[1]} must be a multiple of 8")
    if table.device != device or not table.is_contiguous():
        raise ValueError("block table must be contiguous and on the "
                         "device of q")


def _fn(wide: bool):
    """The C entry of the library for D <= 128, or (``wide``) for
    128 < D <= 256."""
    if wide not in _FN:
        from repro_torch.kernels import build

        p, i = ctypes.c_void_p, ctypes.c_int
        lib = "decode_attention_wide" if wide else "decode_attention"
        _FN[wide] = build.function(lib, "repro_decode_attention",
                                   [p, i, p, p, p, p, p, p, p, p, i, i, i, i,
                                    i, i, i, p, i, i, i, p])
    return _FN[wide]


def geometry(k_cache, table):
    """(S, paging arguments) of a launch: the dense stream's length and a
    null table, or the table's extent and (table, NB, page_size, pages)."""
    if table is None:
        return k_cache.shape[1], (None, 0, 0, 0)
    nb, ps = table.shape[1], k_cache.shape[1]
    return nb * ps, (table.data_ptr(), nb, ps, k_cache.shape[0])


def launch(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits=8,
           table=None):
    """Run the CUDA kernel over a dense cache, or over a page pool through
    ``table``; returns (B, KV, G, D) float32."""
    global launches, launches_int4, launches_paged
    check(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits, table)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    b, kvh, g, d = q.shape
    s, paging = geometry(k_cache, table)
    n_out = b * kvh * g * d
    buf = torch.empty(n_out + scratch_numel(b, kvh, s, g, d),
                      dtype=torch.float32, device=q.device)
    out = buf[:n_out].view(b, kvh, g, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(d > 128)(q.data_ptr(), int(q.dtype == torch.bfloat16),
                    k_cache.data_ptr(), v_cache.data_ptr(),
                    k_scale.data_ptr(), v_scale.data_ptr(),
                    cur_pos.data_ptr(), out.data_ptr(),
                    buf[n_out:].data_ptr(),
                    counters(q.device, b * kvh).data_ptr(), b, s, kvh, g, d,
                    kv_bits, SPLIT, *paging, stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    launches_int4 += kv_bits == 4
    launches_paged += table is not None
    return out
