"""FAT uniform quantization primitives needed for serving (paper §2).

The counterpart of ``repro/core/quant.py``, cut to what int8 serving
reads: the symmetric signed integer grid of a quantization point (eq. 1
resolution: ``(2^{n-1}-1)/T`` with clip ``±(2^{n-1}-1)``) and the
trained-scale threshold ``T_adj = clip(alpha, a_min, a_max) * T_max``
(eq. 12-13).  Unsigned and asymmetric grids, fake-quant and the STE
training primitives come with the training slice (ROADMAP Queue A item
16).
"""
from __future__ import annotations

import dataclasses

import torch


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
        """Positive scale numerator, 127 for int8 (eq. 1)."""
        return float(2 ** (self.bits - 1) - 1)

    @property
    def qmin(self) -> float:
        return -self.levels

    @property
    def qmax(self) -> float:
        return self.levels


def adjusted_threshold(t_max: torch.Tensor, alpha: torch.Tensor,
                       spec: QuantSpec) -> torch.Tensor:
    """T_adj = clip(alpha, a_min, a_max) * T_max  (eq. 12-13)."""
    return torch.clamp(alpha, spec.alpha_min, spec.alpha_max) * t_max


def rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as one IEEE division (``float / Tensor`` in PyTorch
    multiplies by ``t.reciprocal()``, which rounds twice)."""
    return torch.full_like(t, a) / t
