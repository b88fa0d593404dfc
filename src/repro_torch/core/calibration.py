"""Calibration observers (paper §2): running statistics of activations
fed with unlabeled batches, finalized into the static thresholds serving
uses.  Counterpart of ``repro/core/calibration.py`` (max-abs observer;
the percentile observer comes with ROADMAP Queue A item 16).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QuantSpec


def init_observer(spec: QuantSpec, channels: int | None = None,
                  lead_shape: tuple = (), *, device=None) -> dict:
    """Fresh observer state: ``t_max`` running max |x|, ``t_min``/``t_hi``
    running min/max, ``count`` batches seen.  Per-channel (vector) mode
    keeps one entry per channel."""
    shape = tuple(lead_shape) + (
        (channels,) if (spec.per_channel and channels) else ())
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "t_max": torch.zeros(shape, **f32),
        "t_min": torch.full(shape, float("inf"), **f32),
        "t_hi": torch.full(shape, float("-inf"), **f32),
        "count": torch.zeros(shape, dtype=torch.int32, device=device),
    }


def _reduce_axes(x: torch.Tensor, spec: QuantSpec) -> tuple[int, ...]:
    if spec.per_channel:
        ch = spec.channel_axis % x.ndim
        return tuple(i for i in range(x.ndim) if i != ch)
    return tuple(range(x.ndim))


def update_observer(state: dict, x: torch.Tensor, spec: QuantSpec) -> dict:
    """One calibration step: fold the batch statistics into the observer
    (max-abs, the paper's default)."""
    axes = _reduce_axes(x, spec)
    xf = x.float()
    return {
        "t_max": torch.maximum(state["t_max"], torch.amax(xf.abs(), dim=axes)),
        "t_min": torch.minimum(state["t_min"], torch.amin(xf, dim=axes)),
        "t_hi": torch.maximum(state["t_hi"], torch.amax(xf, dim=axes)),
        "count": state["count"] + 1,
    }


def observer_thresholds(state: dict) -> dict:
    """Finalize calibration into threshold parameters (§3.1.3 init):
    T_max from the observer with trained scale alpha = 1; (T_l, T_r) from
    min/max with alpha_t = 0, alpha_r = 1, the asymmetric scheme's leaves,
    kept so qparams have the reference's layout."""
    t_max = state["t_max"]
    ones = torch.ones_like(t_max)
    t_min = torch.where(torch.isfinite(state["t_min"]), state["t_min"], 0.0)
    t_hi = torch.where(torch.isfinite(state["t_hi"]), state["t_hi"], 0.0)
    return {
        "t_max": torch.clamp_min(t_max, 1e-8),
        "t_l": t_min,
        "t_r": torch.maximum(t_hi, t_min + 1e-8),
        "alpha": ones,
        "alpha_t": torch.zeros_like(t_max),
        "alpha_r": ones.clone(),
    }
