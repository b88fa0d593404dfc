"""Quantized KV cache, dense layout: position p of request b lives at slot
[b, p].  int8 tiles, or int4 packed two per byte along the head dim
(``bits=4``: D/2 storage bytes, ``core/packing.py``).

Counterpart of the dense, quantized half of ``repro/cache/base.py``.  K/V
quantize ONCE against the frozen per-head calibrated thresholds (paper §2)
in ``ready``; the same int8 tiles are written by ``append`` and attended
by the fused kernels.  Unlike the reference's immutable pytree, ``append``
writes into the cache buffers in place (a decode step then moves only the
new token's bytes) and returns the same object.

A bf16 cache is ROADMAP Queue A item 8, the SWA ring and paged layouts
items 9 and 12.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.packing import pack_int4, unpack_int4

# int8 KV cache uses the symmetric signed-8-bit grid (paper eq. 4)
KV_LEVELS = 127.0


def kv_levels(bits: int) -> float:
    """Symmetric signed level count for a KV bit width (127 / 7)."""
    if bits not in (4, 8):
        raise ValueError(f"kv cache bits must be 4 or 8, got {bits}")
    return float(2 ** (bits - 1) - 1)


# a dead channel (zero or non-finite calibration threshold) must not turn
# the cache into inf/NaN: floor at the 1e-8 threshold floor of the matmul
# path, expressed as a dequant scale (T / 127; the same floor at int4, as
# in the reference)
_SCALE_FLOOR = 1e-8 / KV_LEVELS


def _safe_scale(scale: torch.Tensor) -> torch.Tensor:
    """Clamp per-head dequant scales to a positive finite floor; ``where``
    (not ``maximum``) so a NaN scale also takes the floor."""
    s = scale.float()
    return torch.where(s > _SCALE_FLOOR, s, _SCALE_FLOOR)


def quantize_kv(x: torch.Tensor, scale: torch.Tensor,
                bits: int = 8) -> torch.Tensor:
    """(B, S, KV, D) float -> storage tiles with per-head dequant
    ``scale`` (KV,).  Divides by the scale, as the reference does.
    ``bits == 8`` emits int8; ``bits == 4`` clips to the int4 grid (±7)
    and packs two values per byte along D (D/2 storage bytes)."""
    lv = kv_levels(bits)
    s = scale.reshape(1, 1, -1, 1)
    q = torch.clamp(torch.round(x.float() / s), -lv, lv).to(torch.int8)
    return pack_int4(q, axis=-1) if bits == 4 else q


def dequantize_kv(x_q: torch.Tensor, scale: torch.Tensor,
                  bits: int = 8) -> torch.Tensor:
    """Storage tiles -> f32 with per-head dequant ``scale`` (KV,); int4
    tiles unpack their nibbles first."""
    if bits == 4:
        x_q = unpack_int4(x_q, axis=-1)
    return x_q.float() * scale.reshape(1, 1, -1, 1)


class KernelView(NamedTuple):
    """What the fused kernels consume: contiguous (B, S, KV, D) tiles (the
    block table is the identity for the dense layout); at ``bits == 4``
    the last dim holds D/2 packed bytes."""
    k: torch.Tensor
    v: torch.Tensor
    bits: int = 8


@dataclasses.dataclass
class DenseCache:
    """Contiguous quantized KV cache of one attention layer."""

    k: torch.Tensor        # (B, S, KV, D) int8 (D/2 packed bytes at bits 4)
    v: torch.Tensor
    k_scale: torch.Tensor  # (KV,) f32 dequant scales (ones until prefill)
    v_scale: torch.Tensor
    bits: int = 8

    @classmethod
    def init(cls, batch, max_len, n_kv, head_dim, *, device=None, bits=8):
        kv_levels(bits)             # raises unless bits is 4 or 8
        if bits == 4:
            if head_dim % 2:
                raise ValueError(
                    f"int4 KV packing needs an even head dim, got {head_dim}")
            head_dim //= 2          # two nibbles per stored byte
        shape = (batch, max_len, n_kv, head_dim)
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.ones((n_kv,), dtype=torch.float32, device=device),
                   torch.ones((n_kv,), dtype=torch.float32, device=device),
                   bits=bits)

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]

    def scales(self):
        return self.k_scale, self.v_scale

    def with_scales(self, k_scale, v_scale) -> "DenseCache":
        """Install calibrated per-head dequant scales (floored once here)."""
        return dataclasses.replace(self, k_scale=_safe_scale(k_scale),
                                   v_scale=_safe_scale(v_scale))

    def ready(self, k, v):
        """Cache-ready tiles: quantize against the frozen per-head scales."""
        return (quantize_kv(k, self.k_scale, self.bits),
                quantize_kv(v, self.v_scale, self.bits))

    def append(self, kq, vq, start: int) -> "DenseCache":
        """Write tiles at positions [start, start + len) in place."""
        s = kq.shape[1]
        if start < 0 or start + s > self.capacity:
            raise ValueError(
                f"append of {s} positions at {start} overruns the cache "
                f"capacity {self.capacity}")
        self.k[:, start:start + s] = kq
        self.v[:, start:start + s] = vq
        return self

    def dense_view(self):
        """(k, v) storage tiles, (B, S, KV, D) each (D/2 at bits 4)."""
        return self.k, self.v

    def kernel_view(self) -> KernelView:
        return KernelView(self.k, self.v, self.bits)
