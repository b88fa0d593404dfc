"""Public kernel entry points, dispatched on the tensors' device.

Counterpart of ``repro/kernels/ops.py``: a tensor on the CPU runs the
plain PyTorch version (``ref``), a tensor on a CUDA device launches the
hand-written Hopper kernel or raises.  There is no fallback from one to
the other.  A tensor on the meta device (the dry run,
``launch/dryrun.py``) takes the meta route: empty outputs of the shapes
and dtypes the plain version returns, and nothing run.  Inputs are
validated the same way on every side (the CUDA wrappers' ``launch``
validates its own).  Within ``plain_versions()`` a
CUDA tensor runs the plain version too: the twin a caller holds a run of
the kernels against, on the same card; ``plain_calls`` counts those runs.

Every wrapper decides its route in ``_route``, which also hands the call
(the kernel, whether it launched, its operands and its variant) to
``observer`` when one is installed: ``repro_torch.analysis.record``'s
``Recorder`` checks the kernels' launch contracts from those records.
The plain version or meta route runs inside ``scope`` when one is
installed (``analysis/cost.py`` counts the call by its own formula and
keeps the plain version's arithmetic out of the count).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.dist import collectives as _coll
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import decode_attention_partials as _dap
from repro_torch.kernels import fake_quant as _fq
from repro_torch.kernels import prefill_attention as _pa
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels import ref

KERNELS = {"quant_matmul": _qm, "prefill_attention": _pa,
           "decode_attention": _da, "decode_attention_partials": _dap,
           "fake_quant": _fq}
ATTENTION = {"prefill_attention": _pa, "decode_attention": _da,
             "decode_attention_partials": _dap}
# counters that advance with the kernels' but count no kernel: the
# tensor-parallel reduces and their bytes (``dist.collectives``)
TALLIES = {"compressed_psum": _coll}
# the modules of every counter below, by name
COUNTED = {**KERNELS, **TALLIES}
# every launch counter of every wrapper, and the tallies: (name, module
# attribute)
COUNTERS = (("quant_matmul", "launches"), ("quant_matmul", "launches_w4"),
            ("quant_matmul", "launches_acc"),
            ("compressed_psum", "reduces"), ("compressed_psum", "wire_bytes"),
            ("prefill_attention", "launches_bf16"),
            ("prefill_attention", "launches_window"),
            ("fake_quant", "launches"),
            *((name, attr) for name in ATTENTION
              for attr in ("launches", "launches_int4", "launches_paged")))


_plain = False
# wrapper calls that ran the plain version on CUDA tensors (within
# ``plain_versions()``), since the last ``reset_launches``
plain_calls = 0
# called as observer(kernel, launched, operands, attrs) by every wrapper
# before it launches or runs its plain version (None: nobody listens)
observer = None
# entered as ``with scope() as keep:`` around every plain version and meta
# route a wrapper runs, ``keep`` called on its result (None: no scope)
scope = None


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return not _plain
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _meta(*specs):
    """Empty meta tensors of (shape, dtype) ``specs``: one, or a tuple."""
    out = tuple(torch.empty(tuple(shape), dtype=dtype, device="meta")
                for shape, dtype in specs)
    return out[0] if len(out) == 1 else out


def _run_plain(lead: torch.Tensor, meta_specs, fn, *args, **kw):
    """``fn(*args, **kw)``, the plain version; on meta tensors the empty
    outputs ``_meta(*meta_specs)`` instead, with nothing run.  Inside
    ``scope`` where one is installed."""
    def run():
        if lead.device.type == "meta":
            return _meta(*meta_specs)
        return fn(*args, **kw)

    if scope is None:
        return run()
    with scope() as keep:
        y = run()
        keep(y)
    return y


def _partials_specs(q: torch.Tensor) -> list:
    """The plain partials' (acc, m, l) shapes and dtypes for ``q``."""
    return [(q.shape, torch.float32), (q.shape[:-1], torch.float32),
            (q.shape[:-1], torch.float32)]


def _host(value):
    """``value`` where it is a host int (the attended span of an attention
    call, known without reading the device), else None."""
    return value if isinstance(value, int) else None


@contextlib.contextmanager
def plain_versions():
    """Within: every wrapper runs its plain version, on whatever device its
    tensors lie, and launches nothing."""
    global _plain
    saved, _plain = _plain, True
    try:
        yield
    finally:
        _plain = saved


def _route(kernel: str, lead: torch.Tensor, operands: dict, **attrs) -> bool:
    """Whether ``kernel``'s wrapper launches the CUDA kernel (True) or runs
    the plain version, decided by ``lead``'s device; counts a plain run on
    CUDA tensors and tells the observer (``operands``: the tensors the
    launch would hand the kernel, by name; ``attrs``: its variant)."""
    global plain_calls
    launched = _on_cuda(lead)
    if not launched and lead.device.type == "cuda":
        plain_calls += 1
    if observer is not None:
        observer(kernel, launched, operands, dict(attrs, twin=_plain))
    return launched


def reset_launches() -> None:
    global plain_calls
    plain_calls = 0
    for name, attr in COUNTERS:
        setattr(COUNTED[name], attr, 0)
    # the rank mesh's gathers and collective wall time (never captured)
    _coll.gathers = _coll.gather_bytes = 0
    _coll.seconds = 0.0


def launch_snapshot() -> dict:
    """Every launch counter now, keyed by (kernel, attribute)."""
    return {(name, attr): getattr(COUNTED[name], attr)
            for name, attr in COUNTERS}


def launch_delta(before: dict, after: dict) -> dict:
    """The counters that moved from snapshot ``before`` to ``after``, by
    how much."""
    return {k: after[k] - n for k, n in before.items() if after[k] != n}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a ``launch_delta``) to the counters: a
    CUDA graph's capture calls the wrappers but launches nothing (-1), and
    each replay launches what the capture counted without a call (+1)."""
    for (name, attr), n in delta.items():
        mod = COUNTED[name]
        setattr(mod, attr, getattr(mod, attr) + times * n)


def plain_call_count() -> int:
    """Wrapper calls that ran the plain version on CUDA tensors since the
    last reset (only ``plain_versions()`` lets one)."""
    return plain_calls


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel (every variant)."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def w4_launch_counts() -> dict:
    """Launches of quant_matmul with int4 (packed) weights."""
    return {"quant_matmul": _qm.launches_w4}


def acc_launch_counts() -> dict:
    """Launches of quant_matmul's int32-accumulator branch (the
    tensor-parallel row partials)."""
    return {"quant_matmul": _qm.launches_acc}


def reduce_counts() -> dict:
    """The tensor-parallel reduces since the last reset: how many, and the
    int32 payload bytes of the other shards they sum."""
    return {"reduces": _coll.reduces, "wire_bytes": _coll.wire_bytes}


def gather_counts() -> dict:
    """The gathers since the last reset (the sequence-parallel ranks' tiles
    and partials, and the one-process merges of the shards' decode
    partials, each counted as the gather it stands for): how many, the
    bytes each shard receives from the others, and the wall seconds of
    every group collective, reduces included."""
    return {"gathers": _coll.gathers, "gather_bytes": _coll.gather_bytes,
            "seconds": _coll.seconds}


def int4_launch_counts() -> dict:
    """Launches of the attention kernels' int4 (packed K/V) variant."""
    return {name: mod.launches_int4 for name, mod in ATTENTION.items()}


def bf16_launch_counts() -> dict:
    """Launches of the prefill attention kernel over a bf16 K/V stream (a
    float KV cache); the decode kernels have no such variant."""
    return {"prefill_attention": _pa.launches_bf16}


def window_launch_counts() -> dict:
    """Launches of the prefill attention kernel with a sliding window (a
    windowed layer's prompt); the decode kernels take no window."""
    return {"prefill_attention": _pa.launches_window}


def paged_launch_counts() -> dict:
    """Launches of the attention kernels over a paged pool (block table)."""
    return {name: mod.launches_paged for name, mod in ATTENTION.items()}


def _rows(value, b: int, device) -> torch.Tensor:
    """A per-request (B,) int32 vector from an int, a 0-d or a (B,) tensor."""
    if isinstance(value, torch.Tensor):
        t = value.to(device=device, dtype=torch.int32).reshape(-1)
        return t.expand(b).contiguous() if t.numel() == 1 else t
    return torch.full((b,), int(value), dtype=torch.int32, device=device)


def quant_matmul(x, w_q, w_scale, act_scale, *, w_bits: int = 8,
                 out=None):
    """Fused quantize -> int8 matmul -> dequant; (M, N) bfloat16.

    x: (M, K) raw float32/bf16 activations; w_q: (K, N) int8, or at
    ``w_bits=4`` (K/2, N) bytes of int4 nibbles packed along K; w_scale:
    (N,) combined dequant scale (already divided by act_scale); act_scale:
    one float32, levels / T_adj, applied to x before rounding.  ``out``, a
    contiguous (M, N) bfloat16 tensor (one expert's slice of an MoE
    layer's output), receives the result in place of a new one."""
    if _route("quant_matmul", x, dict(x=x, w_q=w_q, w_scale=w_scale,
                                      act_scale=act_scale, out=out),
              w_bits=w_bits):
        return _qm.launch(x, w_q, w_scale, act_scale, w_bits, out=out)
    _qm.check(x, w_q, w_scale, act_scale, w_bits, out)
    y = _run_plain(x, [((x.shape[0], w_q.shape[1]), torch.bfloat16)],
                   ref.quant_matmul_ref, x, w_q, w_scale, act_scale, w_bits)
    return y if out is None else out.copy_(y)


def quant_matmul_acc(x_q, w_q, k0: int, k1: int, *, out=None):
    """int8 x_q (M, K) times the int8 weight rows [k0, k1) of w_q (K, N):
    the (M, N) int32 sums, no quantize and no scale (one tensor-parallel
    shard's partial of a row-parallel layer).  ``out``, a contiguous (M, N)
    int32 tensor (one shard's slice of the stacked partials), receives
    them."""
    if _route("quant_matmul", x_q, dict(x_q=x_q, w_q=w_q, out=out),
              acc=True, k0=k0, k1=k1):
        return _qm.launch_acc(x_q, w_q, k0, k1, out=out)
    _qm.check_acc(x_q, w_q, k0, k1, out)
    y = _run_plain(x_q, [((x_q.shape[0], w_q.shape[1]), torch.int32)],
                   ref.quant_matmul_acc_ref, x_q, w_q, k0, k1)
    return y if out is None else out.copy_(y)


def decode_attention(q, k_cache, v_cache, k_scale, v_scale, cur_pos, *,
                     kv_bits: int = 8):
    """One-token attention over the quantized cache; (B, KV, G, D)
    float32.  ``kv_bits=4``: the cache holds packed nibbles (D/2 bytes).

    cur_pos counts the valid positions of each row: an int, or a 0-d or
    (B,) int tensor; a row with 0 returns zeros."""
    span = _host(cur_pos)
    cur_pos = _rows(cur_pos, q.shape[0], q.device)
    if _route("decode_attention", q, dict(
            q=q, k=k_cache, v=v_cache, k_scale=k_scale, v_scale=v_scale,
            cur_pos=cur_pos), kv_bits=kv_bits, span=span):
        return _da.launch(q, k_cache, v_cache, k_scale, v_scale, cur_pos,
                          kv_bits)
    _da.check(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits)
    return _run_plain(q, [(q.shape, torch.float32)], ref.decode_attention_ref,
                      q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits)


def decode_attention_partials(q, k_cache, v_cache, k_scale, v_scale,
                              cur_pos, *, kv_bits: int = 8):
    """The raw flash state of one-token attention over ONE shard's slice
    of the cache's sequence axis (sequence-parallel serving): ``cur_pos``
    counts the LOCAL visible positions (an int, or a 0-d or (B,) tensor),
    and the return is (acc (B, KV, G, D) unnormalized and value-
    dequantized, m (B, KV, G), l (B, KV, G)) float32 for
    ``repro_torch.shard.partial_softmax.sp_partial_combine``.  The slice
    may be a view ``k[:, lo:hi]`` of the global cache: the kernel reads it
    in place."""
    span = _host(cur_pos)
    cur_pos = _rows(cur_pos, q.shape[0], q.device)
    if _route("decode_attention_partials", q, dict(
            q=q, k=k_cache, v=v_cache, k_scale=k_scale, v_scale=v_scale,
            cur_pos=cur_pos), kv_bits=kv_bits, span=span):
        return _dap.launch(q, k_cache, v_cache, k_scale, v_scale, cur_pos,
                           kv_bits)
    _dap.check(q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits)
    return _run_plain(q, _partials_specs(q), ref.decode_attention_partials_ref,
                      q, k_cache, v_cache, k_scale, v_scale, cur_pos, kv_bits)


def prefill_attention(q, k, v, k_scale, v_scale, q_start, kv_len, *,
                      causal: bool = True, window: int | None = None,
                      kv_bits: int = 8):
    """Prompt attention over a quantized or float K/V stream; (B, Sq, KV,
    G, D) float32.  ``kv_bits=4``: K/V hold packed nibbles (D/2 bytes); float
    K/V (a float cache, served with unit scales) take ``kv_bits=8``.

    q_start (position of query row 0) and kv_len (valid K/V count) are
    ints, or 0-d or (B,) int tensors."""
    b = q.shape[0]
    span = (_host(q_start), _host(kv_len))
    q_start = _rows(q_start, b, q.device)
    kv_len = _rows(kv_len, b, q.device)
    if _route("prefill_attention", q, dict(
            q=q, k=k, v=v, k_scale=k_scale, v_scale=v_scale, q_start=q_start,
            kv_len=kv_len), kv_bits=kv_bits, window=window, causal=causal,
            span=span):
        return _pa.launch(q, k, v, k_scale, v_scale, q_start, kv_len,
                          causal=causal, window=window, kv_bits=kv_bits)
    _pa.check(q, k, v, k_scale, v_scale, q_start, kv_len, window, kv_bits)
    return _run_plain(q, [(q.shape, torch.float32)],
                      ref.prefill_attention_ref, q, k, v, k_scale, v_scale,
                      q_start, kv_len, causal=causal, window=window,
                      kv_bits=kv_bits)


def decode_attention_view(q, view, k_scale, v_scale, cur_pos):
    """One-token attention over a cache's ``KernelView``: a dense view
    (``block_table`` None) goes to ``decode_attention``, a paged view
    streams its page pool through the block table (the kernel reads the
    pool in place; only the plain version gathers the pages).  ``view.bits``
    picks the int8 or packed-int4 variant."""
    if view.block_table is None:
        return decode_attention(q, view.k, view.v, k_scale, v_scale, cur_pos,
                                kv_bits=view.bits)
    span = _host(cur_pos)
    cur_pos = _rows(cur_pos, q.shape[0], q.device)
    if _route("decode_attention", q, dict(
            q=q, k=view.k, v=view.v, k_scale=k_scale, v_scale=v_scale,
            cur_pos=cur_pos, table=view.block_table), kv_bits=view.bits,
            span=span):
        return _da.launch(q, view.k, view.v, k_scale, v_scale, cur_pos,
                          view.bits, table=view.block_table)
    _da.check(q, view.k, view.v, k_scale, v_scale, cur_pos, view.bits,
              view.block_table)
    return _run_plain(q, [(q.shape, torch.float32)],
                      ref.decode_attention_paged_ref, q, view.k, view.v,
                      view.block_table, k_scale, v_scale, cur_pos, view.bits)


def decode_attention_partials_view(q, view, k_scale, v_scale, cur_pos):
    """Partials variant of ``decode_attention_view``: the same dense-or-
    paged (and ``view.bits``) routing, the raw (acc, m, l) flash state
    out."""
    if view.block_table is None:
        return decode_attention_partials(q, view.k, view.v, k_scale, v_scale,
                                         cur_pos, kv_bits=view.bits)
    span = _host(cur_pos)
    cur_pos = _rows(cur_pos, q.shape[0], q.device)
    if _route("decode_attention_partials", q, dict(
            q=q, k=view.k, v=view.v, k_scale=k_scale, v_scale=v_scale,
            cur_pos=cur_pos, table=view.block_table), kv_bits=view.bits,
            span=span):
        return _dap.launch(q, view.k, view.v, k_scale, v_scale, cur_pos,
                           view.bits, table=view.block_table)
    _dap.check(q, view.k, view.v, k_scale, v_scale, cur_pos, view.bits,
               view.block_table)
    return _run_plain(q, _partials_specs(q),
                      ref.decode_attention_partials_paged_ref, q, view.k,
                      view.v, view.block_table, k_scale, v_scale, cur_pos,
                      view.bits)


def prefill_attention_view(q, view, k_scale, v_scale, q_start, kv_len, *,
                           causal: bool = True, window: int | None = None):
    """Prompt (chunk) attention over a cache's ``KernelView``; the same
    dense-or-paged routing as ``decode_attention_view``."""
    if view.block_table is None:
        return prefill_attention(q, view.k, view.v, k_scale, v_scale,
                                 q_start, kv_len, causal=causal,
                                 window=window, kv_bits=view.bits)
    b = q.shape[0]
    span = (_host(q_start), _host(kv_len))
    q_start = _rows(q_start, b, q.device)
    kv_len = _rows(kv_len, b, q.device)
    if _route("prefill_attention", q, dict(
            q=q, k=view.k, v=view.v, k_scale=k_scale, v_scale=v_scale,
            q_start=q_start, kv_len=kv_len, table=view.block_table),
            kv_bits=view.bits, window=window, causal=causal, span=span):
        return _pa.launch(q, view.k, view.v, k_scale, v_scale, q_start,
                          kv_len, causal=causal, window=window,
                          kv_bits=view.bits, table=view.block_table)
    _pa.check(q, view.k, view.v, k_scale, v_scale, q_start, kv_len, window,
              view.bits, view.block_table)
    return _run_plain(q, [(q.shape, torch.float32)],
                      ref.prefill_attention_paged_ref, q, view.k, view.v,
                      view.block_table, k_scale, v_scale, q_start, kv_len,
                      causal=causal, window=window, kv_bits=view.bits)


def _column_sum(p: torch.Tensor) -> torch.Tensor:
    """(M, N) float32 -> (N,): the rows in blocks of 32, each block summed
    in row order by up to 31 adds over all blocks at once; then the block
    sums the same way, until one row is left.  Up to 1024 rows that is
    XLA's order for a column sum on the CPU (so the reference's bits at M
    a multiple of 32), and the order is fixed, so every device gives the
    same bits: a column whose sum cancels moves by far more than 1e-5
    relative between orders.  On the card: about 32 launches per factor of
    32 in M, 62 at M = 1024, 93 at M = 32768."""
    while p.shape[0] > 1:
        m, n = p.shape
        k = min(m, 32)
        blocks = torch.nn.functional.pad(p, (0, 0, 0, -m % k))
        blocks = blocks.reshape(-1, k, n)
        p = blocks[:, 0]
        for r in range(1, k):
            p = p + blocks[:, r]
    return p[0]


class _FakeQuant(torch.autograd.Function):
    """B5's forward with the reference's STE backward
    (``repro/kernels/ops.py::_fq_bwd``, paper eqs. 16-19), which is plain
    jnp there and plain PyTorch here, on either device."""

    @staticmethod
    def forward(ctx, x, t_max, alpha, levels, alpha_min, alpha_max):
        ctx.consts = (levels, alpha_min, alpha_max)
        ctx.save_for_backward(x, t_max, alpha)
        kw = dict(levels=levels, qmin=-levels, qmax=levels,
                  alpha_min=alpha_min, alpha_max=alpha_max)
        if _route("fake_quant", x, dict(x=x, t_max=t_max, alpha=alpha)):
            return _fq.launch(x, t_max, alpha, **kw)
        return _run_plain(x, [(x.shape, x.dtype)], ref.fake_quant_ref, x,
                          t_max, alpha, **kw)

    @staticmethod
    def backward(ctx, g):
        x, t_max, alpha = ctx.saved_tensors
        levels, alpha_min, alpha_max = ctx.consts
        xf, gf = x.float(), g.float()
        a = torch.clamp(alpha.float(), alpha_min, alpha_max)
        t_adj = torch.clamp_min(a * t_max.float(), 1e-8)
        inside = (torch.abs(xf) <= t_adj).float()
        # STE: straight through inside the clip range (eqs. 17, 19); a
        # product, as in the reference, so g = -c outside gives -0.0
        dx = (gf * inside).to(x.dtype)
        # dy/dt_adj: (y - x)/t_adj inside, sign(x) saturated, with y the
        # forward's value (the kernel's output is the plain version's bits)
        y = _run_plain(x, [(x.shape, x.dtype)], ref.fake_quant_ref, x, t_max,
                       alpha, levels=levels, qmin=-levels, qmax=levels,
                       alpha_min=alpha_min, alpha_max=alpha_max).float()
        dy_dt = torch.where(inside > 0, (y - xf) / t_adj, torch.sign(xf))
        # the alpha gradient only inside the clip(alpha) band, taken on
        # the unclipped alpha with its ends included (eq. 19)
        band = ((alpha >= alpha_min) & (alpha <= alpha_max)).float()
        # a 0-d alpha (one for every column) gets the sum of this (N,)
        # gradient from autograd
        dalpha = _column_sum(gf * dy_dt) * t_max.float() * band
        # t_max is calibration data, not trained: zero cotangent
        return (dx, torch.zeros_like(t_max), dalpha.to(alpha.dtype), None,
                None, None)


def fake_quant(x, t_max, alpha, levels=127.0, alpha_min=0.5,
               alpha_max=1.0):
    """Fused per-channel fake-quant with the STE backward; (M, N) in x's
    dtype.  x: (M, N) float32/bf16; t_max, alpha: one value or (N,) per
    output channel (the paper's vector mode).  On a CUDA tensor the
    forward is the B5 kernel, on a CPU tensor its plain version."""
    _fq.check(x, t_max, alpha)
    return _FakeQuant.apply(x, t_max, alpha, float(levels),
                            float(alpha_min), float(alpha_max))
