"""Calibration observers (paper §2): running statistics of activations
fed with unlabeled batches, finalized into the static thresholds serving
uses.  Counterpart of ``repro/core/calibration.py``: the max-abs observer
(the paper's default), the percentile observer (a running mean of
per-batch percentiles of |x|, robust to the outliers of the paper's
Figure 1), and the running min/max the asymmetric scheme starts from
(every kind keeps it).
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


OBSERVERS = ("max_abs", "percentile", "min_max")


def percentile_linear(a: torch.Tensor, percentile: float,
                      axes: tuple[int, ...]) -> torch.Tensor:
    """``jnp.percentile(a, percentile, axis=axes)`` with its default linear
    interpolation, in its float32 arithmetic: position q = (p / 100) *
    (n - 1) into the sorted values, result v[floor q] * (1 - w) +
    v[ceil q] * w with w = q - floor q, the two values read from the top
    n - floor q of ``torch.topk`` (a few at the high percentiles that
    calibration takes, where a whole sort would order every value).
    ``torch.quantile`` would refuse inputs above 2^24 elements (a wide FFN
    input at 2048 tokens has 26M)."""
    keep = [i for i in range(a.ndim) if i not in axes]
    flat = a.permute(*keep, *axes).reshape(
        *(a.shape[i] for i in keep), -1)
    n = flat.shape[-1]
    q = torch.tensor(percentile, dtype=torch.float32) / 100
    q = q * torch.tensor(float(n), dtype=torch.float32).sub(1)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1 - w_hi
    i_lo, i_hi = int(lo.clamp(0, n - 1)), int(hi.clamp(0, n - 1))
    # the n - i_lo largest values, descending: the sorted values from i_lo
    top = torch.topk(flat, n - i_lo, dim=-1, sorted=True).values
    v_lo = top[..., n - 1 - i_lo]
    v_hi = top[..., n - 1 - i_hi]
    return v_lo * w_lo.to(a.device) + v_hi * w_hi.to(a.device)


def update_observer(state: dict, x: torch.Tensor, spec: QuantSpec,
                    kind: str = "max_abs", percentile: float = 99.99) -> dict:
    """One calibration step: fold the batch statistics into the observer.
    ``kind`` "percentile" keeps the running mean of the per-batch
    ``percentile`` of |x| in ``t_max``; "max_abs" and "min_max" keep the
    running max |x| (the reference's, for both); every kind keeps the
    running min and max."""
    if kind not in OBSERVERS:
        raise ValueError(f"observer must be one of {OBSERVERS}, got {kind!r}")
    axes = _reduce_axes(x, spec)
    xf = x.float()
    if kind == "percentile":
        batch_t = percentile_linear(xf.abs(), percentile, axes)
        c = state["count"].float()
        t_max = (state["t_max"] * c + batch_t) / (c + 1.0)
    else:
        t_max = torch.maximum(state["t_max"], torch.amax(xf.abs(), dim=axes))
    return {
        "t_max": t_max,
        "t_min": torch.minimum(state["t_min"], torch.amin(xf, dim=axes)),
        "t_hi": torch.maximum(state["t_hi"], torch.amax(xf, dim=axes)),
        "count": state["count"] + 1,
    }


def observer_thresholds(state: dict) -> dict:
    """Finalize calibration into threshold parameters (§3.1.3 init):
    T_max from the observer with trained scale alpha = 1; (T_l, T_r) from
    min/max with alpha_t = 0, alpha_r = 1, the asymmetric scheme's leaves.
    Both sets are always made, whatever the scheme, as in the reference
    (whose ``spec`` argument is not read)."""
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
