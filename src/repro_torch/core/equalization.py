"""Cross-layer equalization: the paper's §3.3 DWS rescaling, generalized.

Counterpart of ``repro/core/equalization.py``.  If a positive per-channel
scale S multiplies the output channels of layer k and 1/S the matching
input rows of layer k+1, the composite is unchanged provided the op in
between commutes with positive diagonal scaling (eqs. 26-27 prove it for
ReLU6 on channels that never saturate).  Choosing S so the per-channel
thresholds equalize makes scalar (per-tensor) quantization nearly as good
as vector (per-channel): the paper's fix for MobileNet-v2's scalar-mode
collapse (1.6% -> 67% top-1).

  * ``dws_relu6_rescale``: the paper's DWS -> ReLU6 -> conv algorithm
    (steps 1-6 of §3.3.1), with the "locked channel" rule for outputs near
    the 6.0 saturation;
  * ``pair_rescale``: the transformer analogs, SwiGLU up -> down through
    the gate product and attention v -> o through the weighted sum, both
    linear in the scaled path;
  * ``equalize_model``: the walk over a model's declared pairs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.folding import sqrt_rn
from repro_torch.core.quant import rdiv

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class EqualizationResult:
    scales: torch.Tensor      # per-channel S applied
    locked: torch.Tensor      # bool mask of locked channels
    t_before: torch.Tensor    # per-channel thresholds before
    t_after: torch.Tensor     # after rescaling


def _sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of a vector in XLA's CPU order (exact for up to 32 entries and
    for multiples of 32), so T0 has the reference's bits."""
    from repro_torch.kernels.ops import _column_sum

    return _column_sum(t.reshape(-1, 1))[0]


def _per_channel_t(w: torch.Tensor, axis: int) -> torch.Tensor:
    axes = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    return torch.amax(torch.abs(w), dim=axes)


def dws_relu6_rescale(w_dws, b_dws, w_conv, act_max, *,
                      relu_cap: float = 6.0, lock_limit: float = 5.9):
    """The paper's §3.3.1 algorithm on depthwise weights ``w_dws`` (..., C),
    their bias ``b_dws`` (C,) or None, the following 1x1 conv ``w_conv``
    (C, F) and the calibrated pre-ReLU6 maxima ``act_max`` (C,):

    1. T_c = max|w_dws[..., c]| per filter;
    2. act_max from calibration;
    3. lock the channels with act_max >= lock_limit (5.9 in the paper);
    4. T0 = mean of the locked channels' thresholds (of all, if none is);
    5. S_c = T0 / T_c for the channels not locked (1 for locked ones);
    6. cap S_c so act_max * S_c <= relu_cap.

    Returns (w_dws', b_dws', w_conv', result), w_conv's rows divided by S."""
    t_w = _per_channel_t(w_dws, -1)
    locked = act_max >= lock_limit
    n_locked = torch.sum(locked.float())
    t0_locked = _sum(torch.where(locked, t_w, 0.0)) / torch.clamp_min(
        n_locked, 1.0)
    t0 = torch.where(n_locked > 0, t0_locked, _sum(t_w) / t_w.numel())
    s = t0 / torch.clamp_min(t_w, _EPS)
    # step 6: never push an output past the ReLU6 saturation knee
    s = torch.minimum(s, rdiv(relu_cap, torch.clamp_min(act_max, _EPS)))
    s = torch.clamp_min(torch.where(locked, 1.0, s), _EPS)
    w_dws2 = (w_dws.float() * s).to(w_dws.dtype)
    b_dws2 = None if b_dws is None else (b_dws.float() * s).to(b_dws.dtype)
    w_conv2 = (w_conv.float() / s[:, None]).to(w_conv.dtype)
    return w_dws2, b_dws2, w_conv2, EqualizationResult(
        scales=s, locked=locked, t_before=t_w,
        t_after=_per_channel_t(w_dws2, -1))


def pair_rescale(w_up, w_down, *, target: str = "mean"):
    """Equalize the per-channel thresholds across a linear producer (d, h)
    / consumer (h, d) pair (SwiGLU up -> down, attention v -> o).  No
    activation cap applies, so this is the paper's steps 4-5 with no
    locking.  ``target`` "mean": T0 = the mean threshold (the paper's);
    "joint": S = sqrt(T_down / T_up), balancing the pair."""
    t_up = _per_channel_t(w_up, -1)
    if target == "joint":
        s = sqrt_rn(_per_channel_t(w_down, 0)
                    / torch.clamp_min(t_up, _EPS))
    else:
        s = (_sum(t_up) / t_up.numel()) / torch.clamp_min(t_up, _EPS)
    s = torch.clamp_min(s, _EPS)
    w_up2 = (w_up.float() * s).to(w_up.dtype)
    w_down2 = (w_down.float() / s[:, None]).to(w_down.dtype)
    return w_up2, w_down2, EqualizationResult(
        scales=s, locked=torch.zeros_like(s, dtype=torch.bool),
        t_before=t_up, t_after=_per_channel_t(w_up2, -1))


def equalize_model(model, params: dict):
    """Apply the model's declared equalization plan
    (``model.equalization_plan()``: (up path, down path) Dense pairs whose
    in-between op commutes with positive channel scaling), in place.
    Expert weights (E, in, out) rescale expert by expert; the report then
    holds the last expert's result, as the reference's does.  Returns
    (params, report {up path: EqualizationResult}).  As in the reference,
    a pair whose keys the param tree does not hold is skipped; on the
    served configs every pair is (module paths never match param keys), so
    the walk returns the params unchanged and an empty report."""
    from repro_torch.core.folding import flatten_ref

    plan = getattr(model, "equalization_plan", lambda: [])()
    flat = flatten_ref(params)
    report = {}
    for up_path, down_path in plan:
        uk, dk = up_path + "/w", down_path + "/w"
        if uk not in flat or dk not in flat:
            continue
        (up_parent, up_leaf), (dn_parent, dn_leaf) = flat[uk], flat[dk]
        w_up, w_down = up_parent[up_leaf], dn_parent[dn_leaf]
        if w_up.ndim == 3:
            pairs = [pair_rescale(w_up[e], w_down[e])
                     for e in range(w_up.shape[0])]
            up_parent[up_leaf] = torch.stack([p[0] for p in pairs])
            dn_parent[dn_leaf] = torch.stack([p[1] for p in pairs])
            res = pairs[-1][2]
        else:
            up_parent[up_leaf], dn_parent[dn_leaf], res = pair_rescale(
                w_up, w_down)
        report[up_path] = res
    return params, report
