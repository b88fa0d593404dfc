"""Depthwise-separable conv stack: the paper's §3.3 setting, in miniature.

Counterpart of ``benchmarks/dws_model.py``.  A MobileNet-style cell chain
[DWS conv -> BN -> ReLU6 -> conv1x1] with planted per-channel weight
outliers that reproduce the paper's Figure 1 pathology: ~3% of the filters
carry ~100x the weight scale of the rest, so a scalar (per-tensor) int8
threshold leaves the others under two levels (the paper's MobileNet-v2
collapse to 1.6-8.1% top-1), while vector thresholds or the §3.3 rescaling
recover them.  It exercises ``fold_batchnorm`` (§3.1.2, eqs. 10-11) and
``dws_relu6_rescale`` (§3.3.1, steps 1-6) end to end.

``init`` takes the integer seed of its numpy generator (the reference
draws that integer from a JAX key, which the port does not have; a test
hands both packages the same integer).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.core.equalization import dws_relu6_rescale
from repro_torch.core.folding import fold_batchnorm


@dataclasses.dataclass
class DWSNet:
    channels: int = 64
    depth: int = 3
    classes: int = 64
    outlier_frac: float = 0.03
    outlier_scale: float = 100.0

    def init(self, np_seed: int, device=None) -> dict:
        """Params as float32 tensors on ``device`` (default the CPU), drawn
        from ``numpy.random.default_rng(np_seed)`` in the reference's
        order."""
        rng = np.random.default_rng(np_seed)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        c = self.channels
        cells = []
        for _ in range(self.depth):
            dws = rng.normal(size=(3, c)).astype(np.float32) * 0.3
            # plant outliers: a few channels dominate the weight range
            n_out = max(1, int(c * self.outlier_frac))
            idx = rng.choice(c, n_out, replace=False)
            dws[:, idx] *= self.outlier_scale
            cells.append({
                "dws_w": t(dws),                      # (K=3, C) depthwise 1D
                "dws_bn": {
                    "gamma": t(rng.uniform(0.5, 1.5, c)),
                    "beta": t(rng.normal(size=c) * 0.1),
                    "mu": t(rng.normal(size=c) * 0.1),
                    "var": t(rng.uniform(0.5, 2.0, c)),
                },
                "pw_w": t(rng.normal(size=(c, c)).astype(np.float32)
                          / np.sqrt(c)),
            })
        head = t(rng.normal(size=(c, self.classes)).astype(np.float32)
                 / np.sqrt(c))
        return {"cells": cells, "head": head}

    # -- building blocks ----------------------------------------------------
    @staticmethod
    def dws_conv(x, w):
        """Causal depthwise 1D conv; x: (B, T, C), w: (K, C)."""
        k = w.shape[0]
        xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
        return sum(xp[:, i: i + x.shape[1], :] * w[i] for i in range(k))

    @staticmethod
    def fold_cell(cell):
        """BN-fold the depthwise conv (paper §3.1.2)."""
        bn = cell["dws_bn"]
        w_f, b_f = fold_batchnorm(cell["dws_w"], bn["gamma"], bn["beta"],
                                  bn["mu"], bn["var"])
        return {"dws_w": w_f, "dws_b": b_f, "pw_w": cell["pw_w"]}

    def forward_folded(self, folded_cells, head, x, quant=None):
        """quant: None (float32) or {"mode": "scalar" | "vector"}: weights
        fake-quantized at max-abs thresholds per tensor or per output
        channel, the ReLU6 output on the unsigned 8-bit grid of [0, 6]."""
        for cell in folded_cells:
            h = self.dws_conv(x, self._maybe_q(cell["dws_w"], quant))
            h = h + cell["dws_b"]
            h = Q.clip_grad_passthrough(h, 0.0, 6.0)         # ReLU6
            if quant is not None:
                h = self._act_q(h)
            x = h @ self._maybe_q(cell["pw_w"], quant)
        return x.mean(dim=1) @ head

    @staticmethod
    def _maybe_q(w, quant):
        if quant is None:
            return w
        spec = Q.QuantSpec(bits=8, per_channel=quant["mode"] == "vector",
                           channel_axis=-1)
        t = Q.max_abs_threshold(w, spec)
        return Q.fake_quant_symmetric(w, t, torch.ones_like(t), spec)

    @staticmethod
    def _act_q(h):
        spec = Q.QuantSpec(bits=8, unsigned=True)
        one = torch.ones((), dtype=torch.float32, device=h.device)
        return Q.fake_quant_symmetric(h, one * 6.0, one, spec)

    # -- §3.3 rescaling -------------------------------------------------------
    def rescale_cells(self, folded_cells, calib_x):
        """The paper's DWS -> ReLU6 -> conv rescale, with the per-channel
        output maxima of calibration activations (steps 2-3)."""
        out = []
        x = calib_x
        for cell in folded_cells:
            pre = self.dws_conv(x, cell["dws_w"]) + cell["dws_b"]
            act_max = torch.amax(torch.abs(pre), dim=(0, 1))
            w_d, b_d, w_p, _ = dws_relu6_rescale(
                cell["dws_w"], cell["dws_b"], cell["pw_w"], act_max)
            out.append({"dws_w": w_d, "dws_b": b_d, "pw_w": w_p})
            x = torch.clamp(pre, 0, 6) @ cell["pw_w"]
        return out
