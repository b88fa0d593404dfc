"""FAT uniform quantization primitives (paper §2, §3.1, §4.2).

Counterpart of ``repro/core/quant.py``:

  * the quantization point (eq. 1 resolution): signed symmetric tensors
    use ``(2^{n-1}-1)/T`` with clip ``±(2^{n-1}-1)`` (127 at int8, 7 at
    int4); unsigned symmetric and asymmetric (affine) tensors use
    ``(2^n-1)/T`` with clip ``[0, 2^n-1]``;
  * the trained-scale threshold ``T_adj = clip(alpha, a_min, a_max) * T_max``
    (eq. 12-13) and the asymmetric limits (left, width) of eqs. 21-23;
  * the STE round and clip (eq. 16-19), the symmetric and asymmetric
    fake-quants, and the symmetric one with the analytic STE backward of
    the reference's ``custom_vjp`` (``fake_quant_symmetric_fused``);
  * the TQT-style log2-domain trained threshold (``fake_quant_log_t``) the
    int4 KV fine-tune trains;
  * the serving conversions (int8 weights, int32 biases, eq. 20) and the
    §4.2 pointwise weight scales.

Everything works per tensor (the paper's scalar mode) or per channel (its
vector mode, §3.1.5) by passing thresholds that broadcast against ``x``.

Gradients follow the reference's exactly where they differ from PyTorch's
defaults: ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, whose gradient
is 1/2 where ``x`` sits on a bound (``torch.clamp`` gives 1).  That case is
common, not rare: a weight alpha starts at its upper bound 1.0, and the
largest weight of a channel rounds onto the grid's edge.
"""
from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-8
_LN2 = 0.6931471805599453
# the float32 constants of the reference's compiled exp2 / log2: XLA
# evaluates exp2(x) as exp(x * 0.693147182) and log2(x) as
# log(x) * 1.44269502
_LN2_F32 = 0.693147182
_INV_LN2_F32 = 1.44269502


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one quantization point.

    ``bits`` wide; ``symmetric`` (§3.1.3) or asymmetric (§3.1.4)
    thresholds; ``unsigned`` for non-negative inputs (symmetric only: the
    affine scheme always maps onto the unsigned range); one threshold per
    channel along ``channel_axis`` in the paper's vector mode (§3.1.5).
    The trained scales are clipped to [alpha_min, alpha_max] (symmetric),
    [alpha_t_min, alpha_t_max] (the asymmetric left-limit shift; its lower
    end is 0 when unsigned) and [alpha_r_min, alpha_r_max] (the width)."""

    bits: int = 8
    symmetric: bool = True
    unsigned: bool = False
    per_channel: bool = False
    channel_axis: int = -1
    alpha_min: float = 0.5
    alpha_max: float = 1.0
    alpha_t_min: float = -0.2
    alpha_t_max: float = 0.4
    alpha_r_min: float = 0.5
    alpha_r_max: float = 1.0

    @property
    def levels(self) -> float:
        """Positive scale numerator (eq. 1): 127 for int8 and 7 for int4
        when signed symmetric, else 2^n - 1 (255 for uint8 / affine)."""
        if self.symmetric and not self.unsigned:
            return float(2 ** (self.bits - 1) - 1)
        return float(2 ** self.bits - 1)

    @property
    def qmin(self) -> float:
        if self.symmetric and not self.unsigned:
            return -self.levels                             # eq. 4
        return 0.0

    @property
    def qmax(self) -> float:
        return self.levels

    def signed_alpha_t_range(self) -> tuple[float, float]:
        """§3.1.4: the left-limit shift range depends on signedness."""
        if self.unsigned:
            return (0.0, self.alpha_t_max)
        return (self.alpha_t_min, self.alpha_t_max)


def rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as one IEEE division (``float / Tensor`` in PyTorch
    multiplies by ``t.reciprocal()``, which rounds twice)."""
    return torch.full_like(t, a) / t


def exp2(x: torch.Tensor) -> torch.Tensor:
    """2**x as the reference computes it (exp of x * ln2 in float32)."""
    return torch.exp(x * _LN2_F32)


def log2(x: torch.Tensor) -> torch.Tensor:
    """log2(x) as the reference computes it (log(x) * 1/ln2 in float32)."""
    return torch.log(x) * _INV_LN2_F32


# ---------------------------------------------------------------------------
# STE primitives (paper eqs. 16-19)
# ---------------------------------------------------------------------------


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through gradient (eq. 16-17)."""
    return x + (torch.round(x) - x).detach()


class _Clip(torch.autograd.Function):
    """clip(x, lo, hi) with ``jnp.clip``'s gradient: 1 inside, 0 outside,
    1/2 on a bound (``minimum(maximum(x, lo), hi)`` splits ties)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(g.dtype)
        on_bound = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside + 0.5 * on_bound), None, None


def clip_grad_passthrough(x: torch.Tensor, lo: float, hi: float):
    """clip with the paper's eq. 18-19 gradient (1 inside, 0 outside) and
    the reference's 1/2 on a bound; a plain clamp where no gradient is
    taken (the serving path)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Clip.apply(x, lo, hi)
    return torch.clamp(x, lo, hi)


# ---------------------------------------------------------------------------
# Threshold computation
# ---------------------------------------------------------------------------


def max_abs_threshold(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """T = max|x| (eq. 2/6): per tensor, or per channel in vector mode."""
    if spec.per_channel:
        return torch.amax(torch.abs(x), dim=_reduce_axes(x, spec))
    return torch.amax(torch.abs(x))


def min_max_threshold(x: torch.Tensor, spec: QuantSpec):
    """(T_l, T_r) of the asymmetric scheme (§3.1.4)."""
    if spec.per_channel:
        axes = _reduce_axes(x, spec)
        return torch.amin(x, dim=axes), torch.amax(x, dim=axes)
    return torch.amin(x), torch.amax(x)


def _bcast(t: torch.Tensor, x: torch.Tensor, spec: QuantSpec):
    """Broadcast a per-channel threshold against x along channel_axis."""
    if not spec.per_channel or t.ndim == 0:
        return t
    shape = [1] * x.ndim
    shape[spec.channel_axis % x.ndim] = t.shape[0]
    return t.reshape(shape)


def _reduce_axes(x: torch.Tensor, spec: QuantSpec) -> tuple[int, ...]:
    ch = spec.channel_axis % x.ndim
    return tuple(i for i in range(x.ndim) if i != ch)


# ---------------------------------------------------------------------------
# Fake quantization (quantize-dequantize) with trained thresholds
# ---------------------------------------------------------------------------


def adjusted_threshold(t_max: torch.Tensor, alpha: torch.Tensor,
                       spec: QuantSpec) -> torch.Tensor:
    """T_adj = clip(alpha, a_min, a_max) * T_max  (eq. 12-13)."""
    return clip_grad_passthrough(alpha, spec.alpha_min, spec.alpha_max) * t_max


def fake_quant_symmetric(x, t_max, alpha, spec: QuantSpec):
    """Symmetric fake-quant with a trained threshold scale (§3.1.3);
    gradients reach ``alpha`` through the scale and the dequantize, round
    and clip pass straight through (eqs. 16-19)."""
    t_adj = adjusted_threshold(_bcast(t_max, x, spec), alpha, spec)
    t_adj = torch.clamp_min(t_adj, _EPS)
    scale = rdiv(spec.levels, t_adj)                        # eq. 14
    x_int = ste_round(x * scale)                            # eq. 15
    x_q = clip_grad_passthrough(x_int, spec.qmin, spec.qmax)
    return x_q / scale


def asymmetric_limits(t_l, t_r, alpha_t, alpha_r, spec: QuantSpec):
    """Adjusted (left, width) of the asymmetric thresholds (eqs. 21-23)."""
    r = t_r - t_l                                           # eq. 21
    at_min, at_max = spec.signed_alpha_t_range()
    left = t_l + clip_grad_passthrough(alpha_t, at_min, at_max) * r  # eq. 22
    width = clip_grad_passthrough(alpha_r, spec.alpha_r_min,
                                  spec.alpha_r_max) * r     # eq. 23
    return left, torch.clamp_min(width, _EPS)


def fake_quant_asymmetric(x, t_l, t_r, alpha_t, alpha_r, spec: QuantSpec):
    """Asymmetric (affine) fake-quant with trained limits (§3.1.4): maps
    [left, left + width] onto [0, 2^n - 1] with an integer zero point.
    The zero point is STE-rounded (so ``alpha_t`` keeps its gradient) and
    not clamped to the level range: for a one-sided range such as
    [2.6, 3.4] it lies far outside [0, 2^n - 1]."""
    left, width = asymmetric_limits(_bcast(t_l, x, spec),
                                    _bcast(t_r, x, spec), alpha_t, alpha_r,
                                    spec)
    n_levels = float(2 ** spec.bits - 1)
    scale = rdiv(n_levels, width)
    zp = ste_round(-left * scale)
    x_int = ste_round(x * scale) + zp
    x_q = clip_grad_passthrough(x_int, 0.0, n_levels)
    return (x_q - zp) / scale


def _fq_sym_fwd_math(x, t_max, alpha, spec: QuantSpec):
    t_adj = adjusted_threshold(_bcast(t_max, x, spec), alpha, spec)
    t_adj = torch.clamp_min(t_adj, _EPS)
    scale = rdiv(spec.levels, t_adj)
    xq = torch.clamp(torch.round(x.float() * scale), spec.qmin, spec.qmax)
    return (xq / scale).to(x.dtype)


class _FakeQuantSymmetricFused(torch.autograd.Function):
    """Forward: the fake-quant in one elementwise chain; backward: the
    reference's analytic STE cotangents (``quant.py::_fq_sym_bwd``), with
    only x and the threshold vectors saved."""

    @staticmethod
    def forward(ctx, x, t_max, alpha, spec):
        ctx.spec = spec
        ctx.save_for_backward(x, t_max, alpha)
        return _fq_sym_fwd_math(x, t_max, alpha, spec)

    @staticmethod
    def backward(ctx, g):
        x, t_max, alpha = ctx.saved_tensors
        spec = ctx.spec
        xf, gf = x.float(), g.float()
        t_b = _bcast(t_max, x, spec)
        a_b = _bcast(alpha, x, spec) if alpha.ndim else alpha
        a_c = torch.clamp(a_b, spec.alpha_min, spec.alpha_max)
        t_adj = torch.clamp_min(a_c * t_b, _EPS)
        inside = torch.abs(xf) <= t_adj
        # dx: straight-through inside the clip range (eqs. 17, 19)
        dx = torch.where(inside, gf, 0.0).to(x.dtype)
        # dy/dT: inside -> (y - x)/T (rounding residual), outside -> sign(x)
        scale = rdiv(spec.levels, t_adj)
        y = torch.clamp(torch.round(xf * scale), spec.qmin, spec.qmax) / scale
        dy_dt = torch.where(inside, (y - xf) / t_adj, torch.sign(xf))
        # alpha passthrough band (eq. 19 on clip(alpha))
        band = (a_b >= spec.alpha_min) & (a_b <= spec.alpha_max)
        dalpha_full = gf * dy_dt * t_b * band.float()
        if alpha.ndim == 0:
            dalpha = torch.sum(dalpha_full)
        else:
            dalpha = torch.sum(dalpha_full, dim=_reduce_axes(x, spec)).reshape(
                alpha.shape)
        return dx, torch.zeros_like(t_max), dalpha.to(alpha.dtype), None


def fake_quant_symmetric_fused(x, t_max, alpha, spec: QuantSpec):
    """The math of ``fake_quant_symmetric`` with an analytic STE backward
    (the QAT student's activation quantizer)."""
    return _FakeQuantSymmetricFused.apply(x, t_max, alpha, spec)


# ---------------------------------------------------------------------------
# TQT-style trained thresholds (log2 parameterization)
# ---------------------------------------------------------------------------


def _fq_log_t_math(x, log2_t, spec: QuantSpec):
    t = exp2(_bcast(log2_t, x, spec).float())
    scale = rdiv(spec.levels, torch.clamp_min(t, _EPS))
    xq = torch.clamp(torch.round(x.float() * scale), spec.qmin, spec.qmax)
    return (xq / scale).to(x.dtype)


class _FakeQuantLogT(torch.autograd.Function):
    """Backward (TQT eq. 6-8), as ``quant.py::_fq_log_t_bwd``:
    dx = g inside the clip band (|x| <= t), 0 saturated;
    d/dt = (y - x)/t inside, sign(x) saturated;
    d/dlog2_t = ln(2) * t * d/dt."""

    @staticmethod
    def forward(ctx, x, log2_t, spec):
        ctx.spec = spec
        ctx.save_for_backward(x, log2_t)
        return _fq_log_t_math(x, log2_t, spec)

    @staticmethod
    def backward(ctx, g):
        x, log2_t = ctx.saved_tensors
        spec = ctx.spec
        xf, gf = x.float(), g.float()
        t = torch.clamp_min(exp2(_bcast(log2_t, x, spec).float()), _EPS)
        inside = torch.abs(xf) <= t
        dx = torch.where(inside, gf, 0.0).to(x.dtype)
        scale = rdiv(spec.levels, t)
        y = torch.clamp(torch.round(xf * scale), spec.qmin, spec.qmax) / scale
        dy_dt = torch.where(inside, (y - xf) / t, torch.sign(xf))
        dlog_full = gf * dy_dt * _LN2 * t
        if log2_t.ndim == 0:
            dlog = torch.sum(dlog_full)
        else:
            dlog = torch.sum(dlog_full, dim=_reduce_axes(x, spec)).reshape(
                log2_t.shape)
        return dx, dlog.to(log2_t.dtype), None


def fake_quant_log_t(x, log2_t, spec: QuantSpec):
    """Symmetric fake-quant with a trained log2-domain threshold
    ``t = 2**log2_t`` (TQT, arxiv 1903.08066): unbounded, always positive,
    with a gradient scale-invariant across layers."""
    return _FakeQuantLogT.apply(x, log2_t, spec)


# ---------------------------------------------------------------------------
# Real integer quantization (serving path)
# ---------------------------------------------------------------------------


def quantize_weights_int8(w, t_max, alpha, spec: QuantSpec):
    """(w_int8, per-channel float scale) with ``w ~= w_q * scale`` and
    ``scale = T_adj / levels``."""
    t_adj = torch.clamp_min(adjusted_threshold(t_max, alpha, spec), _EPS)
    s = rdiv(spec.levels, t_adj)
    w_int = torch.clamp(torch.round(w * _bcast(s, w, spec)), spec.qmin,
                        spec.qmax)
    return w_int.to(torch.int8), rdiv(1.0, s).float()


def quantize_bias_int32(b, act_scale, w_scale):
    """Bias to int32 at the combined input/weight scale (eq. 20):
    b_q = clip(round(b / (act_scale * w_scale)), ±(2^31 - 1)), with
    ``act_scale`` and ``w_scale`` the dequantization scales (T / levels).
    The limit is float32 2^31 - 1, which rounds to 2^31, as in the
    reference; its int32 cast saturates there, as XLA's does."""
    s = rdiv(1.0, torch.clamp_min(act_scale * w_scale, _EPS))
    lim = float(2 ** 31 - 1)
    q = torch.clamp(torch.round(b * s), -lim, lim)
    return torch.clamp(q.double(), -2.0 ** 31, lim).to(torch.int32)


# ---------------------------------------------------------------------------
# Pointwise weight fine-tuning scales (§4.2)
# ---------------------------------------------------------------------------


def apply_pointwise_scale(w, p, lo: float = 0.75, hi: float = 1.25):
    """W_eff = W * clip(p, 0.75, 1.25): the paper's per-value trainable
    scale that lets single weights switch quantization bins (§4.2)."""
    return w * clip_grad_passthrough(p, lo, hi)
