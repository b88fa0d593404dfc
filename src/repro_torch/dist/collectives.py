"""``compressed_psum``: the reduce of the tensor-parallel row epilogues.

Counterpart of ``repro/dist/collectives.py``.  The reference reduces over a
mesh axis inside ``shard_map``; the port's shards live on one device, so
the payload arrives stacked, shard ``i`` at ``x[i]``, and the reduce sums
over that leading axis.  Two regimes, as in the reference:

  * integer payloads (the serving stream: the row-parallel layers' int32
    accumulators): the exact int32 sum (wrapping, as XLA's), with no
    threshold; ``mean=True`` raises, an integer mean would truncate;
  * float payloads (the reference's gradient stream): one max-abs
    threshold shared by every shard (NaN squashed to 0 first, so one
    poisoned shard cannot widen every shard's step), an int8 payload, the
    sum in int32, dequantized once, then the mean or the sum (in the forms
    the reference's jitted reduce compiles to).

``reduces`` and ``wire_bytes`` count what the reduces would move between
devices: each reduce sums the int32 payload of ``tp`` shards, of which
``tp - 1`` arrive from other devices.  They advance with the kernel
launch counters (``kernels.ops``), also across a captured step's replays.
"""
from __future__ import annotations

import torch

# reduces since the last ``kernels.ops.reset_launches``, and the int32
# payload bytes of the tp - 1 other shards they sum
reduces = 0
wire_bytes = 0


def compressed_psum(x: torch.Tensor, *, mean: bool = True) -> torch.Tensor:
    """Reduce the stacked shard payloads ``x`` (``tp``, ...) to one tensor
    of ``x.shape[1:]``: the exact int32 sum of an integer payload, or the
    int8-compressed mean (or sum) of a float one."""
    global reduces, wire_bytes
    tp = x.shape[0]
    reduces += 1
    wire_bytes += (tp - 1) * (x[0].numel() * 4)
    if not torch.is_floating_point(x):
        if mean:
            raise ValueError(
                "integer payloads reduce exactly; a mean would truncate — "
                "pass mean=False and rescale after the reduce")
        return x.to(torch.int32).sum(0, dtype=torch.int32)
    xf = torch.nan_to_num(x.float(), nan=0.0)
    # one shared threshold: the max over every shard's max|x|
    t = xf.abs().amax()
    # T / 127 as XLA compiles it: T * (1 / 127)
    s = torch.clamp_min(t, 1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    acc = q.to(torch.int32).sum(0, dtype=torch.int32)
    out = acc.float() * s
    if mean:
        # the mean over a shard count known at compile time, as XLA
        # compiles it: a multiply by the reciprocal
        out = out * (1.0 / tp)
    return out.to(x.dtype)
