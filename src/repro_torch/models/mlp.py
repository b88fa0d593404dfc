"""Feed-forward blocks: the gated SwiGLU (llama family) or, with
``activation="gelu"``, GeGLU (gemma); and the classic two-layer MLP with
biases (seamless-m4t's ``GeluMLP``).  Counterparts of
``repro/models/mlp.py``."""
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
        self.down = Dense(d_ff, d_model, path=f"{path}/down", dtype=dtype,
                          logical_axes=("mlp", "embed"))

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


class GeluMLP(Module):
    """fc1 -> activation -> fc2, both with a bias (the encoder-decoder's
    MLP).  fc1 -> gelu -> fc2 is no equalization pair (gelu does not
    commute with a per-channel scale), so the block declares none.  With
    ``activation="relu"`` fc2's input is non-negative and quantizes on the
    unsigned range (``act_unsigned``)."""

    def __init__(self, d_model: int, d_ff: int, *, path: str,
                 dtype=torch.bfloat16, activation: str = "gelu"):
        self.d_model = d_model
        self.d_ff = d_ff
        self.path = path
        self.act = ACTIVATIONS[activation]
        self.fc1 = Dense(d_model, d_ff, path=f"{path}/fc1", bias=True,
                         dtype=dtype)
        self.fc2 = Dense(d_ff, d_model, path=f"{path}/fc2", bias=True,
                         dtype=dtype, act_unsigned=activation == "relu",
                         logical_axes=("mlp", "embed"))

    def init(self, gen):
        return {"fc1": self.fc1.init(gen), "fc2": self.fc2.init(gen)}

    def __call__(self, params, x, ctx=None):
        h = self.act(self.fc1(params["fc1"], x, ctx))
        return self.fc2(params["fc2"], h, ctx)

    def equalization_pairs(self):
        return []
