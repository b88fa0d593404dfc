"""int4 nibble packing: two signed 4-bit values per int8 byte.

Counterpart of ``repro/core/packing.py``.  The int4 KV cache stores its
quantized values as packed nibbles, so every buffer is half the int8
bytes.

Layout: along the packed axis, element ``2i`` lives in the LOW nibble and
element ``2i + 1`` in the HIGH nibble of byte ``i``.  Values must lie in
the signed int4 range [-8, 7] (the symmetric quantizer only emits
[-7, 7]).  An odd-length axis is padded with one zero nibble; callers that
pack odd lengths pass the original ``size`` to ``unpack_int4`` to slice
the pad back off (cache head dims are always even, so serving never pads).

Sign handling, in int32 as in the reference:

    lo = ((b & 15) ^ 8) - 8      # low nibble, sign-extended
    hi = b >> 4                  # arithmetic shift sign-extends

The CUDA attention kernels unpack the same layout on their shared-memory
tiles (``csrc/decode_attention.cu``, ``csrc/prefill_attention.cu``).
"""
from __future__ import annotations

import torch


def pack_int4(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack signed int values in [-8, 7] into nibbles along ``axis``;
    returns int8 with that axis ``ceil(n / 2)`` long."""
    ax = axis % x.ndim
    x = torch.movedim(x, ax, -1)
    if x.shape[-1] % 2:
        x = torch.nn.functional.pad(x, (0, 1))
    xi = x.to(torch.int32)
    even = xi[..., 0::2] & 15
    odd = xi[..., 1::2] & 15
    return torch.movedim((even | (odd << 4)).to(torch.int8), -1, ax)


def unpack_int4(p: torch.Tensor, axis: int = -1,
                size: int | None = None) -> torch.Tensor:
    """Unpack nibbles along ``axis`` back to int8 values in [-8, 7];
    ``size`` slices the axis back to an odd pre-pack length (default
    ``2 * packed_length``)."""
    ax = axis % p.ndim
    p = torch.movedim(p, ax, -1)
    pi = p.to(torch.int32)
    lo = ((pi & 15) ^ 8) - 8
    hi = pi >> 4          # arithmetic shift: the high nibble carries the sign
    out = torch.stack([lo, hi], dim=-1).reshape(
        *p.shape[:-1], 2 * p.shape[-1])
    if size is not None:
        out = out[..., :size]
    return torch.movedim(out.to(torch.int8), -1, ax)
