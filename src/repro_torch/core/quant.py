"""FAT uniform quantization primitives (paper §2, §3.1).

The counterpart of ``repro/core/quant.py`` for the symmetric signed grids
the ported path uses:

  * the quantization point: ``(2^{n-1}-1)/T`` with clip ``±(2^{n-1}-1)``
    (eq. 1 resolution; 127 at int8, 7 at int4);
  * the trained-scale threshold ``T_adj = clip(alpha, a_min, a_max) * T_max``
    (eq. 12-13);
  * the STE round and clip (eq. 16-19) and the symmetric fake-quant of the
    distillation student, with the analytic STE backward of the reference's
    ``custom_vjp`` (``fake_quant_symmetric_fused``);
  * the TQT-style log2-domain trained threshold (``fake_quant_log_t``) the
    int4 KV fine-tune trains.

Gradients follow the reference's exactly where they differ from PyTorch's
defaults: ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, whose gradient
is 1/2 where ``x`` sits on a bound (``torch.clamp`` gives 1).  That case is
common, not rare: a weight alpha starts at its upper bound 1.0, and the
largest weight of a channel rounds onto the grid's edge.  Unsigned and
asymmetric grids are not on the ported path (``fake_quant_asymmetric``
raises).
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
    """Static description of one symmetric quantization point: ``bits``
    wide, one threshold per channel along ``channel_axis`` in the paper's
    vector mode (§3.1.5), trained scale clipped to [alpha_min, alpha_max]."""

    bits: int = 8
    per_channel: bool = False
    channel_axis: int = -1
    alpha_min: float = 0.5
    alpha_max: float = 1.0

    @property
    def levels(self) -> float:
        """Positive scale numerator: 127 for int8, 7 for int4 (eq. 1)."""
        return float(2 ** (self.bits - 1) - 1)

    @property
    def qmin(self) -> float:
        return -self.levels

    @property
    def qmax(self) -> float:
        return self.levels


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


def fake_quant_asymmetric(*args, **kwargs):
    """The asymmetric (affine) scheme of §3.1.4 is not on the ported path."""
    raise NotImplementedError(
        "asymmetric fake-quant is not ported (ROADMAP Queue A item 16: "
        "asymmetric and percentile variants)")


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
