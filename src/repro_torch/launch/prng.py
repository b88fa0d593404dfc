"""The reference's ``jax.random`` calls, as torch integer arithmetic.

The reference draws all the randomness of its serving path from
``jax.random`` with the default threefry2x32 PRNG and
``jax_threefry_partitionable`` on (the default of jax 0.9).  Threefry is a
counter-based hash over uint32 words, so the same integer arithmetic
reproduces it on any device: this module is that arithmetic, in int64
tensors masked to 32 bits after every add and shift (torch has no unsigned
32-bit shifts on every device).  A key is a (2,) int64 tensor holding two
uint32 words, or a (..., 2) tensor of several keys (the slot scheduler's
per-slot keys), on the caller's device; every function here is plain
tensor work on that device (a CUDA graph captures it), and computes what
the reference's function of the same name computes, bit for bit, except
``gumbel``, whose ``log`` may differ from XLA's by an ulp.

Counters follow the partitionable layout: a draw of shape ``shape`` hashes
the (hi, lo) words of each element's row-major flat index, so row b of a
(B, V) draw is not a (V,) draw.  A batch of keys (..., 2) draws ``shape``
once per key, as the reference's ``jax.vmap`` over its keys does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA           # threefry's key schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of the counter words ``(x0, x1)``
    under the key words ``(k0, k1)``; all int64 tensors (or ints) holding
    uint32 values, broadcast together.  Returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & 0xFFFFFFFF)
    of a 64-bit seed; a negative seed is an int32 (high word 0), as in the
    reference, whose seeds are 32-bit."""
    seed = int(seed)
    hi = (seed >> 32) & MASK if seed >= 0 else 0
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def _hash_iota(key: torch.Tensor, shape):
    """threefry of every flat index of ``shape`` (its (hi, lo) words) under
    each key of ``key`` (..., 2): two int64 tensors of shape
    ``key.shape[:-1] + shape``."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    hi, lo = (idx >> 32).reshape(shape), (idx & MASK).reshape(shape)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,) * len(shape))
    k1 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k0, k1, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys, or (..., num, 2) for a
    batch of keys (the reference's ``jax.vmap(jax.random.split)``)."""
    y0, y1 = _hash_iota(key, (num,))
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a (2,) key and a uint32
    ``data``: the hash of the counter words (0, data)."""
    y0, y1 = threefry2x32(key[0], key[1], 0, int(data) & MASK)
    return torch.stack([y0, y1])


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32, held in int64):
    ``y0 ^ y1`` of each element's counter."""
    y0, y1 = _hash_iota(key, tuple(shape))
    return y0 ^ y1


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits of ``bits`` as the mantissa of a float in [1, 2), minus
    one, scaled into [minval, maxval).  XLA contracts the scale and shift
    into one fused multiply-add; the float64 product of two float32 values
    is exact, so a float64 add rounded to float32 gives its bits (bar a
    double rounding at an exact float32 midpoint; none at the sampling
    range [tiny, 1), whose scale is 1)."""
    b = bits(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min((f.double() * span + lo).float(), lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (its default "low" mode):
    ``-log(-log(u))`` of a uniform on [tiny, 1).  The uniform is bit-exact;
    each ``log`` may differ from XLA's by an ulp."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the argmax (first
    maximum) of logits plus Gumbel noise drawn over the logits' shape.  A
    batch of keys (B, 2) draws row b's noise with key b over the row's
    (V,) shape, as the reference's vmapped per-slot draw does."""
    if key.dim() == 1:
        noise = gumbel(key, logits.shape)
    else:
        noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(noise + logits, dim=-1)
