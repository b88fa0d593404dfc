"""FAT quantization context: the integration point between the paper's
technique (``core.quant``) and the model (``models``).

Counterpart of ``repro/core/api.py``.  ``QuantPolicy`` picks the paper's
variant (Tables 1-2): the bit width, symmetric or asymmetric activations
(§3.1.3-3.1.4), vector or scalar weight thresholds (§3.1.5), per-tensor or
per-channel activation thresholds, the §4.2 pointwise weight scales, the
max-abs or percentile observer, layers left unquantized by path, and a KV
cache of int8 or packed int4 with per-head thresholds.  A forward without
a context is full precision (the distillation teacher, §3.2); the
context's modes are

  none       full-precision weights (bf16 serving, the paper's baseline):
             every Dense is ``x @ w``; the context still carries the KV
             thresholds to attention when the KV cache is quantized
  calibrate  full-precision forward that also feeds the activation and
             KV observers (paper §2 calibration)
  fake       fake-quantized forward with trained threshold scales: the
             distillation student (§3.1.3-3.1.5), differentiable by STE
  int8       integer serving: int8 weights resident, int8 activations with
             static calibrated thresholds, int32 accumulation, dequant in
             the epilogue (eq. 20) -- always through ``kernels.ops``

In int8 mode every quantized matmul runs through the fused kernel (B3),
whatever the variant, but a row-parallel layer under tensor parallelism
(below): scalar-mode weights broadcast their one dequant
scale over the output channels, and an asymmetric or non-8-bit activation
goes in with ``s_x = levels / T_adj`` and the kernel's ±127 clip (what the
reference's fused path computes).  Per-channel activation thresholds have
no int8 form: the kernel takes one activation scale (the reference fails
to broadcast them too).

Tensor parallelism (``shard.context.tp_shard_info``, ``tp`` > 1): the
shards live on one device and the serving body runs once, over all heads
and columns.  Column-parallel layers and attention are the unsharded
calls: each output column and each head is computed alone, so the union
of the shards' local work is the global call.  A row-parallel layer (its
input axis 'heads' or 'mlp': attention ``wo``, the MLPs' ``down`` and
``fc2``, the SSM mixer's ``out_proj``) is where the shards' results meet,
and it takes the reference's unfused path: x quantized once as the
reference's XLA graph computes it, each shard's int8 x int8 -> int32
partial over its slice of K (B3's int32-accumulator branch), the exact
int32 sum of the partials (``dist.collectives.compressed_psum``), and one
dequant.

State layout, as in the reference: ``qparams`` is a flat dict keyed by
layer path (``"smollm-135m/stack/layer0/attn/wq"``) holding
``{"w": {...}, "act": {...}}`` threshold states, plus ``"<attn>/kv"``
entries with per-head K/V thresholds; ``params`` is the nested dict of
tensors that mirrors the module tree, where int8 mode replaces a
quantized ``{"w"}`` leaf with ``{"w_q": int8, "w_scale": f32[C] (or f32[]
in scalar mode)}`` and a bias ``b`` with ``b_q`` int32 and ``b_scale``
(eq. 20).  The trainable leaves of qparams are the threshold scales
(``alpha``, ``alpha_t``, ``alpha_r``), the pointwise weight scales
(``pointwise``) and the trained log2 KV thresholds (``log2_t``); the
weights never train.
"""
from __future__ import annotations

import dataclasses
import functools
import re

import torch

from repro_torch.core import calibration as calib
from repro_torch.core import quant as Q

MODES = ("none", "calibrate", "fake", "int8")
TRAINABLE_KEYS = frozenset({"alpha", "alpha_t", "alpha_r", "pointwise",
                            "log2_t"})


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Which FAT variant to run (the paper's experiment grid, Tables 1-2).

    ``bits`` wide weights and activations; ``act_symmetric`` (§3.1.3) or
    asymmetric (§3.1.4) activation thresholds; ``weight_per_channel``
    vector (§3.1.5) or scalar weight thresholds; ``act_per_channel``
    per-channel activation thresholds (fake and calibrate modes only);
    ``pointwise_scales`` trainable [0.75, 1.25] scales per weight (§4.2);
    ``observer`` "max_abs" (the paper's), "percentile" (at
    ``percentile``) or "min_max"; ``skip_patterns`` regular expressions of
    layer paths left in full precision.  ``kv_int8`` adds per-head K/V
    thresholds for the quantized KV cache, ``kv_bits`` its width (8, or 4
    stored as packed nibbles).  The reference's ``use_pallas`` has no
    counterpart: the port picks its kernels by the tensors' device (the
    CUDA kernels on the card, their plain versions on the CPU)."""

    bits: int = 8
    act_symmetric: bool = True
    weight_per_channel: bool = True
    act_per_channel: bool = False
    pointwise_scales: bool = False
    observer: str = "max_abs"
    percentile: float = 99.99
    skip_patterns: tuple[str, ...] = ()
    kv_int8: bool = False
    kv_bits: int = 8

    def __post_init__(self):
        if self.kv_bits not in (4, 8):
            raise ValueError(f"kv_bits must be 4 or 8, got {self.kv_bits}")
        if self.observer not in calib.OBSERVERS:
            raise ValueError(f"observer must be one of {calib.OBSERVERS}, "
                             f"got {self.observer!r}")

    @functools.cached_property
    def _skip_res(self) -> tuple[re.Pattern, ...]:
        return tuple(re.compile(p) for p in self.skip_patterns)

    def skips(self, path: str) -> bool:
        """True for a layer path that one of ``skip_patterns`` matches."""
        return any(p.search(path) for p in self._skip_res)

    def weight_spec(self) -> Q.QuantSpec:
        """Weights (in, out): symmetric (eq. 1-4), one threshold per output
        channel in vector mode, one per tensor in scalar mode."""
        return Q.QuantSpec(bits=self.bits, per_channel=self.weight_per_channel,
                           channel_axis=-1)

    def act_spec(self, unsigned: bool = False) -> Q.QuantSpec:
        """Activations: static thresholds, per tensor unless
        ``act_per_channel``; ``unsigned`` for a non-negative input."""
        return Q.QuantSpec(bits=self.bits, symmetric=self.act_symmetric,
                           unsigned=unsigned,
                           per_channel=self.act_per_channel)

    def kv_spec(self) -> Q.QuantSpec:
        """K/V cache entries (B, S, KV, D): one static threshold per KV
        head (channel_axis=-2), ``kv_bits`` wide (levels 127 or 7)."""
        return Q.QuantSpec(bits=self.kv_bits, per_channel=True,
                           channel_axis=-2)


@dataclasses.dataclass
class QuantCtx:
    """Threaded through every forward.  ``updates`` collects observer
    states during a 'calibrate' pass; the calibrate step merges them into
    qparams."""

    mode: str
    policy: QuantPolicy
    qparams: dict
    updates: dict = dataclasses.field(default_factory=dict)

    def enabled(self, layer) -> bool:
        """Whether ``layer`` (a Dense or an ExpertDense) runs quantized: any
        mode but "none", on a layer with ``quantize`` set (every layer but
        the MoE router) that the policy does not skip."""
        return (self.mode != "none" and layer.quantize
                and not self.policy.skips(layer.path))


def make_ctx(mode: str, policy: QuantPolicy,
             qparams: dict | None = None) -> QuantCtx:
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r} (modes: {MODES})")
    return QuantCtx(mode=mode, policy=policy, qparams=qparams or {})


# ---------------------------------------------------------------------------
# qparams construction
# ---------------------------------------------------------------------------


def kv_path(attn_path: str) -> str:
    """qparams key holding the KV-cache thresholds of one attention layer."""
    return f"{attn_path}/kv"


def is_kv_path(path: str) -> bool:
    return path.endswith("/kv")


def _modules_with_params(model, params, cls):
    """(module of type ``cls``, its params subtree) pairs."""
    for module, sub in model.walk_with_params(params):
        if isinstance(module, cls):
            yield module, sub


def _quant_layers_with_params(model, params, policy: QuantPolicy):
    """(Dense or ExpertDense with ``quantize`` set, its params subtree)
    pairs that the policy does not skip."""
    from repro_torch.models.module import Dense, ExpertDense

    for layer, lp in _modules_with_params(model, params,
                                          (Dense, ExpertDense)):
        if layer.quantize and not policy.skips(layer.path):
            yield layer, lp


def _base_ndim(layer) -> int:
    """The weight's own axes: (in, out) for a Dense, (E, in, out) for an
    ExpertDense."""
    from repro_torch.models.module import ExpertDense

    return 3 if isinstance(layer, ExpertDense) else 2


def init_qparams(model, params: dict, policy: QuantPolicy) -> dict:
    """Threshold state for every quantizable layer: weight thresholds
    straight from the weights (T_w = max|W| per output channel, per
    (expert, output channel) of an ExpertDense, or per tensor in scalar
    mode, eq. 2) with alpha = 1, unit ``pointwise``
    scales with ``pointwise_scales``, activation thresholds as empty
    observers for calibration, and (with ``kv_int8``) per-head K/V
    observers for every causal self-attention (an encoder's bidirectional
    attention and a cross attention own no KV cache, so no thresholds, as
    in the reference)."""
    from repro_torch.models.attention import Attention

    qparams: dict = {}
    for layer, lp in _quant_layers_with_params(model, params, policy):
        w = lp["w"]
        dims = ((-2,) if policy.weight_per_channel
                else tuple(range(-_base_ndim(layer), 0)))
        t_w = torch.amax(w.float().abs(), dim=dims)
        wstate = {"t_max": t_w, "alpha": torch.ones_like(t_w)}
        if policy.pointwise_scales:
            wstate["pointwise"] = torch.ones(w.shape, dtype=torch.float32,
                                             device=w.device)
        qparams[layer.path] = {
            "w": wstate,
            "act": calib.init_observer(policy.act_spec(), device=w.device),
        }
    if policy.kv_int8:
        for attn, lp in _modules_with_params(model, params, Attention):
            if attn.cross or not attn.causal:
                continue
            spec = policy.kv_spec()
            dev = lp["wk"]["w"].device
            qparams[kv_path(attn.path)] = {
                "k": calib.init_observer(spec, channels=attn.n_kv, device=dev),
                "v": calib.init_observer(spec, channels=attn.n_kv, device=dev),
            }
    return qparams


def finalize_calibration(qparams: dict, *,
                         train_thresholds: bool = False) -> dict:
    """Observer stats -> threshold params (paper §3.1.3 init).  KV entries
    freeze to bare per-head thresholds, floored with ``where`` (not
    ``maximum``) so a NaN-poisoned observer still floors at 1e-8.  With
    ``train_thresholds`` each KV entry also gains a trainable log2-domain
    threshold ``log2_t`` (TQT), initialized at the §2 max-abs value; the
    fake-mode forward quantizes K/V through it and ``freeze_thresholds``
    collapses it back to a bare ``t_max`` for serving."""
    out = {}
    for path, entry in qparams.items():
        if is_kv_path(path):
            kv = {
                kk: {"t_max": torch.where(obs["t_max"] > 1e-8,
                                          obs["t_max"], 1e-8)}
                for kk, obs in entry.items()
            }
            if train_thresholds:
                for st in kv.values():
                    st["log2_t"] = Q.log2(st["t_max"]).float()
            out[path] = kv
            continue
        out[path] = {**entry, "act": calib.observer_thresholds(entry["act"])}
    return out


def freeze_thresholds(qparams: dict) -> dict:
    """Collapse trained KV thresholds back to the frozen serving form: every
    KV entry carrying a ``log2_t`` becomes a bare ``{"t_max": 2**log2_t}``
    (floored like ``finalize_calibration``), which is what
    ``Attention._kv_scales`` reads."""
    out = {}
    for path, entry in qparams.items():
        if is_kv_path(path) and any("log2_t" in st for st in entry.values()):
            out[path] = {}
            for kk, st in entry.items():
                t = Q.exp2(st["log2_t"])
                out[path][kk] = {"t_max": torch.where(t > 1e-8, t, 1e-8)}
        else:
            out[path] = entry
    return out


def trainable_mask(qparams: dict) -> dict:
    """The qparams tree with a bool per leaf: True only on the trained FAT
    parameters (threshold scales, pointwise scales, trained log2 KV
    thresholds)."""
    def mask_entry(d):
        return {k: (mask_entry(v) if isinstance(v, dict)
                    else k in TRAINABLE_KEYS) for k, v in d.items()}

    return {p: mask_entry(e) for p, e in qparams.items()}


def flatten(tree: dict, prefix: tuple = ()) -> dict:
    """Nested dict -> {key path tuple: leaf}."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def unflatten(flat: dict) -> dict:
    """Inverse of ``flatten``."""
    tree: dict = {}
    for keys, leaf in flat.items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


# ---------------------------------------------------------------------------
# Forward (called by Dense and ExpertDense)
# ---------------------------------------------------------------------------


def dense_forward(layer, params: dict, x: torch.Tensor, ctx: QuantCtx | None):
    """A Dense layer without a context (full precision) and in each mode."""
    b = params.get("b")
    tp = _tp_row_shards(layer)
    if tp and (ctx is None or ctx.mode != "int8" or not ctx.enabled(layer)):
        # the float paths have no integer accumulator to reduce exactly
        raise ValueError(
            f"{layer.path}: tensor-parallel serving requires mode='int8' "
            "with this layer quantized (the row epilogue reduces int32 "
            "accumulators; see repro_torch.shard)")
    if ctx is None or not ctx.enabled(layer):
        y = x @ params["w"]
    elif ctx.mode == "calibrate":
        ctx.updates[layer.path] = calib.update_observer(
            ctx.qparams[layer.path]["act"], x,
            ctx.policy.act_spec(layer.act_unsigned),
            kind=ctx.policy.observer, percentile=ctx.policy.percentile)
        y = x @ params["w"]
    elif ctx.mode == "fake":
        qs = ctx.qparams[layer.path]
        xq = _fq_act(x, qs["act"],
                     ctx.policy.act_spec(layer.act_unsigned)).to(x.dtype)
        y = xq @ _fq_weight(params["w"], qs["w"], ctx.policy.weight_spec())
    else:
        matmul = (_int8_matmul if not tp else functools.partial(
            _int8_matmul_tp, tp=tp, key=layer.path.rsplit("/", 1)[-1],
            mesh=_tp_rank_mesh()))
        y = matmul(x, params["w_q"], params["w_scale"],
                   ctx.qparams[layer.path]["act"],
                   ctx.policy.act_spec(layer.act_unsigned))
        if "b_q" in params:
            # the int32 bias at the dequantized output scale (eq. 20)
            y = _add_int32_bias(y, params["b_q"], params["b_scale"])
    if b is not None:
        y = y + b
    return y


def _add_int32_bias(y, b_q, b_scale):
    """y + b_q * b_scale (eq. 20's bias, dequantized).  Into a float32 y
    the reference's compiled graph fuses the product and the add into one
    FMA (one rounding), which the float64 sum reproduces: b_q (|b_q| <
    2^29) times a float32 scale is exact in float64.  Into a bf16 y the
    product rounds to bf16 first, as the reference's cast does."""
    if y.dtype == torch.float32:
        return (y.double() + b_q.double() * b_scale.double()).float()
    return y + (b_q.float() * b_scale).to(y.dtype)


def _fq_act(x, astate, spec: Q.QuantSpec):
    """Activation fake-quant of the student: symmetric with the analytic
    STE backward, or asymmetric with trained limits (§3.1.4)."""
    if spec.symmetric:
        return Q.fake_quant_symmetric_fused(x, astate["t_max"],
                                            astate["alpha"], spec)
    return Q.fake_quant_asymmetric(x, astate["t_l"], astate["t_r"],
                                   astate["alpha_t"], astate["alpha_r"],
                                   spec)


def _fq_weight(w, wstate, spec: Q.QuantSpec):
    """Weight fake-quant of the student, after the §4.2 pointwise scales
    when qparams hold them: per-output-channel thresholds, (in, out) ->
    (1, out) or, for expert weights, (E, in, out) -> (E, 1, out), with STE
    round and clip, so the threshold scales get their gradient through the
    autodiff of the scale; or, in scalar mode, one threshold per
    tensor."""
    if "pointwise" in wstate:
        w = Q.apply_pointwise_scale(w, wstate["pointwise"].to(w.dtype))
    if not spec.per_channel:
        return Q.fake_quant_symmetric(w.float(), wstate["t_max"],
                                      wstate["alpha"], spec).to(w.dtype)
    shape = (*w.shape[:-2], 1, w.shape[-1])
    t = wstate["t_max"].reshape(shape)
    alpha = wstate["alpha"].reshape(shape)
    t_adj = torch.clamp_min(Q.adjusted_threshold(t, alpha, spec), 1e-8)
    s = Q.rdiv(spec.levels, t_adj).float()
    wq = Q.clip_grad_passthrough(Q.ste_round(w.float() * s), spec.qmin,
                                 spec.qmax)
    return (wq / s).to(w.dtype)


def expert_dense_forward(layer, params: dict, x: torch.Tensor,
                         ctx: QuantCtx | None):
    """An ExpertDense, x (E, M, in) @ w (E, in, out) -> (E, M, out), without
    a context and in each mode.  Full precision, calibrate and fake mode
    are one batched product (the reference's einsum); calibrate observes
    the whole dispatch buffer, its zero sentinel rows included.  int8 mode
    runs the fused kernel once per expert (``_expert_int8``)."""
    if ctx is None or not ctx.enabled(layer):
        return torch.bmm(x, params["w"])
    if ctx.mode == "calibrate":
        ctx.updates[layer.path] = calib.update_observer(
            ctx.qparams[layer.path]["act"], x, ctx.policy.act_spec(),
            kind=ctx.policy.observer, percentile=ctx.policy.percentile)
        return torch.bmm(x, params["w"])
    qs = ctx.qparams[layer.path]
    if ctx.mode == "fake":
        xq = _fq_act(x, qs["act"], ctx.policy.act_spec()).to(x.dtype)
        return torch.bmm(xq, _fq_weight(params["w"], qs["w"],
                                        ctx.policy.weight_spec()))
    return _expert_int8(x, params["w_q"], params["w_scale"], qs["act"],
                        ctx.policy.act_spec(), layer.dtype)


def _expert_int8(x, w_q, w_scale, astate, aspec: Q.QuantSpec, dtype):
    """The reference's int8 expert product (an XLA einsum with int32
    accumulation, not its fused kernel) through the fused kernel, one
    launch per expert on that expert's contiguous rows, each writing its
    slice of one (E, M, out) output in ``dtype``, the layer's, as the
    reference's einsum returns it (x may be the float32 product the
    reference quantizes unrounded): the kernel's bf16 or float32 output.

    The reference quantizes ``clip(round(x * s_x), qmin, qmax)`` and casts
    to int8, saturating at ±127; the kernel rounds ``x * s_x`` and clips to
    ±127.  The two give the same integers once x is clamped to [qmin / s_x,
    qmax / s_x] where that range is narrower than the kernel's (the
    asymmetric scheme's qmin 0, the 4-bit levels): round is monotone, and
    an end within an ulp of its integer still rounds to it.  Its compiled
    graph divides ``w_scale / s_x`` as one IEEE division
    (``_dequant_scale``), and a scalar-mode ``w_scale`` broadcasts over
    every (expert, channel)."""
    from repro_torch.kernels import ops

    t_adj = torch.clamp_min(
        Q.adjusted_threshold(astate["t_max"], astate["alpha"], aspec), 1e-8)
    if t_adj.ndim:
        raise ValueError(
            f"int8 mode takes one activation threshold per tensor: the "
            f"per-channel act scale {tuple(t_adj.shape)} does not broadcast "
            f"against the expert weight scale {tuple(w_scale.shape)} "
            f"(act_per_channel serves in fake mode only)")
    s_x = Q.rdiv(aspec.levels, t_adj)
    lo, hi = max(aspec.qmin, -127.0), min(aspec.qmax, 127.0)
    if lo == 0.0:
        x = x.clamp_min(0)
    elif lo != -127.0:
        x = torch.maximum(x, Q.rdiv(lo, s_x).to(x.dtype))
    if hi != 127.0:
        x = torch.minimum(x, Q.rdiv(hi, s_x).to(x.dtype))
    n_exp, m, _ = x.shape
    scale = _dequant_scale(w_scale.float().expand(n_exp, w_q.shape[-1]),
                           s_x)
    x = x.contiguous()
    out = torch.empty((n_exp, m, w_q.shape[-1]), dtype=dtype,
                      device=x.device)
    act_scale = s_x.float()
    for e in range(n_exp):
        ops.quant_matmul(x[e], w_q[e], scale[e], act_scale, out=out[e])
    return out


def _tp_row_shards(layer) -> int:
    """The tensor-parallel shard count a row-parallel layer reduces over,
    or 0: only under ``tp_shard_info`` (tp > 1), and only for a layer whose
    logical input axis is 'heads' (attention ``wo``, the SSM ``out_proj``)
    or 'mlp' (``down``, ``fc2``), the projections whose contraction the
    shards split (the reference's ``_tp_reduce_axis``)."""
    from repro_torch.shard.context import tp_shard_info

    info = tp_shard_info()
    if info is None:
        return 0
    axes = getattr(layer, "logical_axes", None)
    return info.tp if axes and axes[0] in ("heads", "mlp") else 0


def _tp_rank_mesh():
    """The rank mesh of the tensor-parallel context, where each shard is a
    process of its own (its weights are this rank's slice), else None."""
    from repro_torch.shard.context import tp_shard_info

    return tp_shard_info().mesh


def _act_scale(astate, aspec: Q.QuantSpec, w_scale):
    """T_adj and s_x = levels / T_adj of a per-tensor activation threshold;
    a per-channel one raises (int8 mode takes one)."""
    t_adj = torch.clamp_min(
        Q.adjusted_threshold(astate["t_max"], astate["alpha"], aspec), 1e-8)
    if t_adj.ndim:
        raise ValueError(
            f"int8 mode takes one activation threshold per tensor: the "
            f"per-channel act scale {tuple(t_adj.shape)} does not broadcast "
            f"against the weight scale {tuple(w_scale.shape)} "
            f"(act_per_channel serves in fake mode only)")
    return t_adj, Q.rdiv(aspec.levels, t_adj)


def _dequant_scale(w_scale, s_x):
    """The combined per-channel dequant ``w_scale / s_x`` in float32, one
    IEEE division a channel: the form the reference's compiled graph
    evaluates (an XLA ``divide`` by the broadcast ``s_x``).  The divisor is
    materialized: PyTorch's CPU kernel multiplies by the reciprocal of a
    divisor that broadcasts from one value."""
    w_scale = w_scale.float()
    return w_scale / s_x.float().expand_as(w_scale).contiguous()


def _int8_matmul_tp(x, w_q, w_scale, astate, aspec: Q.QuantSpec, *,
                    tp: int, key: str, mesh=None):
    """The row-parallel epilogue (the reference's ``_int8_matmul`` with a
    ``reduce_axis``): x quantized as its XLA graph computes it,
    ``clip(round(x * s_x), qmin, qmax)`` in float32, cast to int8
    saturating at ±127; each of the ``tp`` shards' int8 x int8 -> int32
    partial over its contraction slice (``dist.sharding.tp_row_slices``:
    the weight rows [k0, k1) read in place, or all of K where the weight is
    replicated), by B3's int32-accumulator branch into one stacked (tp, M,
    N) buffer; their exact sum (``compressed_psum``); one dequant with the
    combined scale ``_dequant_scale``.  These are the
    reference's bits in float32; in bf16 its XLA fusions keep some
    roundings out (ROADMAP Queue C), and this path equals the port's
    unsharded one bit for bit.  On a rank of a rank mesh (``mesh``), ``x``
    and ``w_q`` are this rank's slices: one partial over all of its K,
    summed over the ranks by ``compressed_psum``'s group form."""
    from repro_torch.dist.collectives import compressed_psum
    from repro_torch.dist.sharding import tp_row_slices
    from repro_torch.kernels import ops

    _, s_x = _act_scale(astate, aspec, w_scale)
    k, n = w_q.shape
    lead = x.shape[:-1]
    x_q = torch.clamp(torch.round(x.reshape(-1, k).float() * s_x),
                      max(aspec.qmin, -128.0),
                      min(aspec.qmax, 127.0)).to(torch.int8)
    if mesh is not None:
        acc = compressed_psum(ops.quant_matmul_acc(x_q, w_q, 0, k),
                              mean=False, group=mesh)
    else:
        parts = torch.empty((tp, x_q.shape[0], n), dtype=torch.int32,
                            device=x.device)
        for i, (k0, k1) in enumerate(tp_row_slices(key, k, tp)):
            ops.quant_matmul_acc(x_q, w_q, k0, k1, out=parts[i])
        acc = compressed_psum(parts, mean=False)
    y = acc.float() * _dequant_scale(w_scale, s_x)
    return y.reshape(*lead, n).to(x.dtype)


def _int8_matmul(x, w_q, w_scale, astate, aspec: Q.QuantSpec):
    """int8 x int8 -> int32 -> dequant with a static activation threshold.

    Always the fused kernel (``kernels.ops.quant_matmul``): raw
    activations plus act_scale = levels / T_adj go in, the kernel
    quantizes on load (clip ±127, whatever ``aspec``'s range: the
    reference's fused path does the same); ``w_scale / act_scale`` is the
    combined per-channel dequant of the epilogue, broadcast over the
    output channels when the weights have one scalar-mode scale.  The
    kernel emits bf16, cast back to ``x.dtype`` here, as in the
    reference."""
    from repro_torch.kernels import ops

    _, s_x = _act_scale(astate, aspec, w_scale)
    combined = _dequant_scale(w_scale, s_x)
    if combined.ndim == 0:
        combined = combined.expand(w_q.shape[-1])
    lead = x.shape[:-1]
    # the kernel streams contiguous rows: the untied lm_head reads the
    # prefill's last position, a strided view
    y = ops.quant_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w_q,
                         combined.float().contiguous(), s_x.float())
    return y.reshape(*lead, -1).to(x.dtype)


# ---------------------------------------------------------------------------
# int8 model conversion (serving path)
# ---------------------------------------------------------------------------


def convert_to_int8(model, params: dict, qparams: dict,
                    policy: QuantPolicy) -> dict:
    """Replace every quantized Dense and ExpertDense 'w' with int8 ``w_q``
    and its dequant scale ``w_scale`` (per output channel, (E, out) for
    expert weights, or one in scalar mode), after
    the pointwise scales when qparams hold them, and a bias ``b`` with
    ``b_q`` int32 at the combined input/weight scale and ``b_scale``
    (eq. 20): the serving parameter tree, weights resident as int8.  The
    input tree is left untouched; unquantized leaves are shared."""
    out = _copy_tree(params)
    spec = policy.weight_spec()
    for layer, lp in _quant_layers_with_params(model, out, policy):
        wstate = qparams[layer.path]["w"]
        w = lp.pop("w").float()
        if "pointwise" in wstate:
            w = Q.apply_pointwise_scale(w, wstate["pointwise"])
        t, alpha = wstate["t_max"], wstate["alpha"]
        if spec.per_channel:
            shape = (*w.shape[:-2], 1, w.shape[-1])
            t, alpha = t.reshape(shape), alpha.reshape(shape)
        t_adj = torch.clamp_min(Q.adjusted_threshold(t, alpha, spec), 1e-8)
        s = Q.rdiv(spec.levels, t_adj)
        lp["w_q"] = torch.clamp(torch.round(w * s), spec.qmin,
                                spec.qmax).to(torch.int8)
        w_scale = Q.rdiv(1.0, s)
        lp["w_scale"] = (w_scale.squeeze(-2) if spec.per_channel
                         else w_scale).float()
        if "b" in lp:
            astate = qparams[layer.path]["act"]
            aspec = policy.act_spec(layer.act_unsigned)
            t_a = torch.clamp_min(Q.adjusted_threshold(
                astate["t_max"], astate["alpha"], aspec), 1e-8)
            act_scale = t_a / aspec.levels
            b = lp.pop("b")
            lp["b_q"] = Q.quantize_bias_int32(b.float(), act_scale,
                                              lp["w_scale"])
            lp["b_scale"] = (act_scale * lp["w_scale"]).float()
    return out


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}
