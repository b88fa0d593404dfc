"""Common layers: RMSNorm and LayerNorm, token embedding with tied
readout, rotary position encoding, and the activations (counterparts of
``repro/models/layers.py``)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models.module import Module, normal_init


class RMSNorm(Module):
    def __init__(self, dim: int, *, path: str, eps: float = 1e-6,
                 dtype=torch.bfloat16):
        self.dim = dim
        self.path = path
        self.eps = eps
        self.dtype = dtype

    def init(self, gen):
        return {"scale": torch.ones((self.dim,), dtype=torch.float32)}

    def __call__(self, params, x, ctx=None):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps) * params["scale"]
        return y.to(x.dtype)


class LayerNorm(Module):
    """Mean-centred norm with a scale and a bias (stablelm), in float32 as
    the reference: ``var`` is the population variance of the centred
    values, taken as the mean of their squares (``jnp.var``'s form), then
    ``rsqrt(var + eps)``, the scale and bias fused; cast back to the input
    dtype.  XLA's row sums and rsqrt round otherwise than torch's in the
    last bit (ROADMAP Queue C)."""

    def __init__(self, dim: int, *, path: str, eps: float = 1e-5,
                 dtype=torch.bfloat16):
        self.dim = dim
        self.path = path
        self.eps = eps
        self.dtype = dtype

    def init(self, gen):
        return {"scale": torch.ones((self.dim,), dtype=torch.float32),
                "bias": torch.zeros((self.dim,), dtype=torch.float32)}

    def __call__(self, params, x, ctx=None):
        xf = x.float()
        c = xf - torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(c * c, dim=-1, keepdim=True)
        y = c * torch.rsqrt(var + self.eps)
        # y * scale + bias as one fused multiply-add, as XLA compiles it: the
        # product is exact in float64, rounded once (to float64, then float32)
        y = (y.double() * params["scale"].double()
             + params["bias"].double()).float()
        return y.to(x.dtype)


class Embedding(Module):
    """Token embedding; the table is padded to ``vocab_padded`` (a multiple
    of 128) and the padded rows are masked at readout."""

    def __init__(self, vocab: int, dim: int, *, path: str,
                 dtype=torch.bfloat16, vocab_padded: int | None = None):
        self.vocab = vocab
        self.vocab_padded = vocab_padded or (-(-vocab // 128) * 128)
        self.dim = dim
        self.path = path
        self.dtype = dtype

    def init(self, gen):
        return {"table": normal_init(gen, (self.vocab_padded, self.dim),
                                     self.dtype)}

    def __call__(self, params, tokens, ctx=None):
        return params["table"][tokens]

    def attend(self, params, x, ctx=None):
        """Tied-weight readout (..., d) @ (d, Vp) -> logits, padded vocab
        entries set to -1e9 so argmax/softmax never pick them."""
        logits = x @ params["table"].T
        if self.vocab_padded != self.vocab:
            pad = torch.arange(self.vocab_padded,
                               device=logits.device) >= self.vocab
            logits = logits.masked_fill(pad, -1e9)
        return logits


@functools.lru_cache(maxsize=None)
def rotary_freqs(head_dim: int, base: float, device) -> torch.Tensor:
    """The (head_dim/2,) float32 frequency table on ``device``, made once
    per (head_dim, base, device): computed in float32 numpy, as in the
    reference, so both packages rotate by the same angles.  Kept, because
    a host-to-device copy on every call synchronizes the stream, which a
    CUDA graph capture does not allow.  Made outside inference mode, so the
    training forwards may use it too."""
    half = head_dim // 2
    freqs = 1.0 / (base ** (np.arange(0, half, dtype=np.float32) / half))
    with torch.inference_mode(False):
        return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rotary_angles(positions: torch.Tensor, head_dim: int,
                  base: float = 10000.0):
    """(..., S) int positions -> (cos, sin) of shape (..., S, head_dim/2)."""
    ang = positions.float()[..., None] * rotary_freqs(head_dim, base,
                                                      positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads
    (rotate-half, llama family).  Computed in float32 (x converted
    explicitly: the bits of torch's implicit promotion), cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]
    s = sin[..., None, :]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def check_no_tf32(x: torch.Tensor, what: str) -> None:
    """Raise when ``x``'s float32 products would run in TF32 on the card
    (``what``: the products, for the message)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{what} would run in TF32 (torch.backends.cuda.matmul."
            "allow_tf32); they need float32")


def silu(x):
    return x * torch.sigmoid(x)


def silu_xla(x: torch.Tensor) -> torch.Tensor:
    """silu as the reference's compiled graphs evaluate it inside a fusion
    (the MoE experts, the SSM's conv stream and gate): x / (1 + exp(-x))
    as exp, add, reciprocal and product, each rounded to x's dtype
    (``torch.sigmoid`` rounds once)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default is
    the erf form, which moves a GeGLU model's logits by ~1e-3)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


ACTIVATIONS = {"silu": silu, "gelu": gelu, "relu": torch.relu,
               "relu6": relu6}
