"""FAT quantization context: the integration point between the paper's
technique (``core.quant``) and the model (``models``).

Counterpart of ``repro/core/api.py`` in the paper's default variant:
symmetric int8, per-output-channel weight thresholds, per-tensor
activation thresholds, max-abs calibration, and a KV cache of int8 or
packed int4 with per-head thresholds.  A forward without a context is full
precision (the distillation teacher, §3.2); the context's modes are

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

Asymmetric activations, pointwise scales and the percentile observer of
the reference's ``QuantPolicy`` are not ported (ROADMAP Queue A item 16).

State layout, as in the reference: ``qparams`` is a flat dict keyed by
layer path (``"smollm-135m/stack/layer0/attn/wq"``) holding
``{"w": {...}, "act": {...}}`` threshold states, plus ``"<attn>/kv"``
entries with per-head K/V thresholds; ``params`` is the nested dict of
tensors that mirrors the module tree, where int8 mode replaces a
quantized ``{"w"}`` leaf with ``{"w_q": int8, "w_scale": f32[C]}``.  The
trainable leaves of qparams are the threshold scales (``alpha``,
``alpha_t``, ``alpha_r``) and the trained log2 KV thresholds (``log2_t``);
the weights never train.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import calibration as calib
from repro_torch.core import quant as Q

MODES = ("none", "calibrate", "fake", "int8")
TRAINABLE_KEYS = frozenset({"alpha", "alpha_t", "alpha_r", "log2_t"})


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Which FAT variant to run: int8 weights and activations; ``kv_int8``
    adds per-head K/V thresholds for the quantized KV cache, ``kv_bits``
    its width (8, or 4 stored as packed nibbles)."""

    kv_int8: bool = False
    kv_bits: int = 8

    def __post_init__(self):
        if self.kv_bits not in (4, 8):
            raise ValueError(f"kv_bits must be 4 or 8, got {self.kv_bits}")

    def weight_spec(self) -> Q.QuantSpec:
        """Weights (in, out): one threshold per output channel."""
        return Q.QuantSpec(per_channel=True, channel_axis=-1)

    def act_spec(self) -> Q.QuantSpec:
        """Activations: one static threshold per tensor."""
        return Q.QuantSpec()

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


def init_qparams(model, params: dict, policy: QuantPolicy) -> dict:
    """Threshold state for every quantizable layer: weight thresholds
    straight from the weights (T_w = max|W| per output channel, eq. 2),
    activation thresholds as empty observers for calibration, and (with
    ``kv_int8``) per-head K/V observers for every causal attention."""
    from repro_torch.models.attention import Attention
    from repro_torch.models.module import Dense

    qparams: dict = {}
    for layer, lp in _modules_with_params(model, params, Dense):
        w = lp["w"]
        t_w = torch.amax(w.float().abs(), dim=-2)
        qparams[layer.path] = {
            "w": {"t_max": t_w, "alpha": torch.ones_like(t_w)},
            "act": calib.init_observer(policy.act_spec(), device=w.device),
        }
    if policy.kv_int8:
        for attn, lp in _modules_with_params(model, params, Attention):
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
    parameters (threshold scales, trained log2 KV thresholds)."""
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
# Forward (called by Dense)
# ---------------------------------------------------------------------------


def dense_forward(layer, params: dict, x: torch.Tensor, ctx: QuantCtx | None):
    """A Dense layer without a context (full precision) and in each mode."""
    if ctx is None or ctx.mode == "none":
        return x @ params["w"]
    if ctx.mode == "calibrate":
        ctx.updates[layer.path] = calib.update_observer(
            ctx.qparams[layer.path]["act"], x, ctx.policy.act_spec())
        return x @ params["w"]
    if ctx.mode == "fake":
        qs = ctx.qparams[layer.path]
        xq = _fq_act(x, qs["act"], ctx.policy.act_spec()).to(x.dtype)
        return xq @ _fq_weight(params["w"], qs["w"], ctx.policy.weight_spec())
    return _int8_matmul(x, params["w_q"], params["w_scale"],
                        ctx.qparams[layer.path]["act"], ctx.policy.act_spec())


def _fq_act(x, astate, spec: Q.QuantSpec):
    """Activation fake-quant of the student (per-tensor threshold)."""
    return Q.fake_quant_symmetric_fused(x, astate["t_max"], astate["alpha"],
                                        spec)


def _fq_weight(w, wstate, spec: Q.QuantSpec):
    """Weight fake-quant of the student: per-output-channel thresholds
    (in, out) -> (1, out), STE round and clip, so the threshold scales
    get their gradient through the autodiff of the scale."""
    shape = (1, w.shape[-1])
    t = wstate["t_max"].reshape(shape)
    alpha = wstate["alpha"].reshape(shape)
    t_adj = torch.clamp_min(Q.adjusted_threshold(t, alpha, spec), 1e-8)
    s = Q.rdiv(spec.levels, t_adj).float()
    wq = Q.clip_grad_passthrough(Q.ste_round(w.float() * s), spec.qmin,
                                 spec.qmax)
    return (wq / s).to(w.dtype)


def _int8_matmul(x, w_q, w_scale, astate, aspec: Q.QuantSpec):
    """int8 x int8 -> int32 -> dequant with a static activation threshold.

    Always the fused kernel (``kernels.ops.quant_matmul``): raw
    activations plus act_scale = levels / T_adj go in, the kernel
    quantizes on load; ``w_scale / act_scale`` is the combined per-channel
    dequant of the epilogue.  The kernel emits bf16, cast back to
    ``x.dtype`` here, as in the reference."""
    from repro_torch.kernels import ops

    t_adj = torch.clamp_min(
        Q.adjusted_threshold(astate["t_max"], astate["alpha"], aspec), 1e-8)
    s_x = Q.rdiv(aspec.levels, t_adj)
    # w_scale / s_x, evaluated as (w_scale * T_adj) * (1 / levels): the
    # float32 expression the reference's compiled graph evaluates for it,
    # so both packages dequantize with the same bits
    combined = (w_scale * t_adj) * (1.0 / aspec.levels)
    lead = x.shape[:-1]
    # the kernel streams contiguous rows: the untied lm_head reads the
    # prefill's last position, a strided view
    y = ops.quant_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w_q,
                         combined.float(), s_x.float())
    return y.reshape(*lead, -1).to(x.dtype)


# ---------------------------------------------------------------------------
# int8 model conversion (serving path)
# ---------------------------------------------------------------------------


def convert_to_int8(model, params: dict, qparams: dict,
                    policy: QuantPolicy) -> dict:
    """Replace every quantized Dense 'w' with int8 ``w_q`` + per-channel
    ``w_scale`` (the serving parameter tree: weights resident as int8).
    The input tree is left untouched; unquantized leaves are shared."""
    from repro_torch.models.module import Dense

    out = _copy_tree(params)
    spec = policy.weight_spec()
    for layer, lp in _modules_with_params(model, out, Dense):
        wstate = qparams[layer.path]["w"]
        w = lp.pop("w").float()
        t_adj = torch.clamp_min(Q.adjusted_threshold(
            wstate["t_max"].reshape(1, -1), wstate["alpha"].reshape(1, -1),
            spec), 1e-8)
        s = Q.rdiv(spec.levels, t_adj)
        lp["w_q"] = torch.clamp(torch.round(w * s), spec.qmin,
                                spec.qmax).to(torch.int8)
        lp["w_scale"] = Q.rdiv(1.0, s).squeeze(-2).float()
    return out


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}
