"""Gated feed-forward block: SwiGLU (llama family) or, with
``activation="gelu"``, GeGLU (gemma); counterpart of
``repro/models/mlp.py::SwiGLU``."""
from __future__ import annotations

import torch

from repro_torch.models.layers import ACTIVATIONS
from repro_torch.models.module import Dense, Module


class SwiGLU(Module):
    def __init__(self, d_model: int, d_ff: int, *, path: str,
                 dtype=torch.bfloat16, activation: str = "silu"):
        self.d_model = d_model
        self.d_ff = d_ff
        self.path = path
        self.act = ACTIVATIONS[activation]
        self.gate = Dense(d_model, d_ff, path=f"{path}/gate", dtype=dtype)
        self.up = Dense(d_model, d_ff, path=f"{path}/up", dtype=dtype)
        self.down = Dense(d_ff, d_model, path=f"{path}/down", dtype=dtype)

    def init(self, gen):
        return {"gate": self.gate.init(gen), "up": self.up.init(gen),
                "down": self.down.init(gen)}

    def __call__(self, params, x, ctx=None):
        g = self.act(self.gate(params["gate"], x, ctx))
        u = self.up(params["up"], x, ctx)
        return self.down(params["down"], g * u, ctx)

    def equalization_pairs(self):
        """§3.3 analog: up -> down is linear through the gate product (the
        gate's path holds the nonlinearity, like the paper's locked
        channels)."""
        return [(self.up.path, self.down.path)]
