"""``compressed_psum``: the reduce of the tensor-parallel row epilogues,
and the gathers of the sequence-parallel ranks.

Counterpart of ``repro/dist/collectives.py``.  The reference reduces over a
mesh axis inside ``shard_map``.  The port has two forms of it: with
``group`` None, the one-process form, whose shards live on one device, so
the payload arrives stacked, shard ``i`` at ``x[i]``, and the reduce sums
over that leading axis; with ``group`` a ``launch.mesh.RankMesh``, the
group form, where each rank holds its own payload and the reduce is a
``torch.distributed.all_reduce`` over the rank mesh (``all_gather``, the
gathers of ``shard/seq_cache.py`` and ``shard/partial_softmax.py``).  Over
gloo a CUDA payload is staged through the host here, explicitly.  Two
regimes, as in the reference:

  * integer payloads (the serving stream: the row-parallel layers' int32
    accumulators): the exact int32 sum (wrapping, as XLA's), with no
    threshold; ``mean=True`` raises, an integer mean would truncate;
  * float payloads (the reference's gradient stream): one max-abs
    threshold shared by every shard (NaN squashed to 0 first, so one
    poisoned shard cannot widen every shard's step), an int8 payload, the
    sum in int32, dequantized once, then the mean or the sum (in the forms
    the reference's jitted reduce compiles to).

``reduces`` and ``wire_bytes`` count the reduces and the int32 payload
bytes each sums from the ``tp - 1`` other shards: what the one-process
form would move between devices, and what each rank of the group form
receives (so a rank's counts equal the one-process counts).  ``gathers``
and ``gather_bytes`` count the group form's gathers and the bytes each
receives from the other ranks, and the one-process merges of the
sequence-parallel decode partials (``shard/partial_softmax.py``) count the
gathers they stand for (``stand_in``); ``seconds`` the wall time of the
group form's collectives, staging included.  They advance with the kernel
launch counters (``kernels.ops``), also across a captured step's replays.

Every collective, in both forms, is handed to ``observer`` when one is
installed (``repro_torch.analysis.record``'s ``Recorder``): its kind, its
payload's dtype and element count on one shard, the shard count and the
reduce op.  The one-process form reports the collective it stands for.
"""
from __future__ import annotations

import time

import torch

# reduces since the last ``kernels.ops.reset_launches``, and the int32
# payload bytes of the tp - 1 other shards they sum
reduces = 0
wire_bytes = 0
# the group form's gathers and the bytes they receive from other ranks
gathers = 0
gather_bytes = 0
# the group form's wall time in its collectives (seconds, a float)
seconds = 0.0
# called as observer(kind, dtype, numel, n, op) for every collective:
# "all_reduce" or "all_gather", one shard's payload, n shards, "sum" or
# "max" (None: nobody listens)
observer = None


def _observe(kind: str, payload: torch.Tensor, n: int, op: str = "sum"):
    if observer is not None:
        observer(kind, payload.dtype, payload.numel(), n, op)


def stand_in(kind: str, dtype, numel: int, n: int, op: str = "sum") -> None:
    """Count and report the collective that one-process shards stand for:
    ``numel`` elements of ``dtype`` from each of ``n`` shards, a gather
    counted as the group form counts one (``gathers``, ``gather_bytes``);
    an all-reduce's counts are ``compressed_psum``'s own."""
    global gathers, gather_bytes
    if kind == "all_gather":
        gathers += 1
        gather_bytes += (n - 1) * numel * dtype.itemsize
    if observer is not None:
        observer(kind, dtype, numel, n, op)


def _staged(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the group's backend takes it: gloo reads the host."""
    return x.cpu() if group.backend == "gloo" else x


def all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over the rank mesh ``group``, on
    ``x``'s device."""
    import torch.distributed as dist

    global seconds
    t0 = time.perf_counter()
    buf = _staged(group, x).contiguous()
    _observe("all_reduce", buf, group.n,
             "max" if op == dist.ReduceOp.MAX else "sum")
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op is None else op,
                    group=group.group)
    out = buf.to(x.device)
    seconds += time.perf_counter() - t0
    return out


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` over the rank mesh ``group``, in rank order, on
    ``x``'s device."""
    import torch.distributed as dist

    global gathers, gather_bytes, seconds
    t0 = time.perf_counter()
    buf = _staged(group, x).contiguous()
    _observe("all_gather", buf, group.n)
    parts = [torch.empty_like(buf) for _ in range(group.n)]
    dist.all_gather(parts, buf, group=group.group)
    out = [p.to(x.device) for p in parts]
    gathers += 1
    gather_bytes += (group.n - 1) * buf.numel() * buf.element_size()
    seconds += time.perf_counter() - t0
    return out


def compressed_psum(x: torch.Tensor, *, mean: bool = True,
                    group=None) -> torch.Tensor:
    """Reduce the payloads of the shards: with ``group`` None the stacked
    payloads ``x`` (``tp``, ...) to one tensor of ``x.shape[1:]``; over a
    rank mesh ``group`` this rank's ``x`` to one tensor of its shape (a
    ``dist.all_reduce`` standing for the reference's ``psum`` and
    ``pmax``).  The exact int32 sum of an integer payload, or the
    int8-compressed mean (or sum) of a float one."""
    import torch.distributed as dist

    global reduces, wire_bytes
    tp, one = (x.shape[0], x[0]) if group is None else (group.n, x)
    reduces += 1
    wire_bytes += (tp - 1) * (one.numel() * 4)

    def total(v):
        """The int32 sum over the shards."""
        if group is None:
            stand_in("all_reduce", v.dtype, v[0].numel(), tp)
            return v.sum(0, dtype=torch.int32)
        return all_reduce(v, group)

    if not torch.is_floating_point(x):
        if mean:
            raise ValueError(
                "integer payloads reduce exactly; a mean would truncate — "
                "pass mean=False and rescale after the reduce")
        return total(x.to(torch.int32))
    xf = torch.nan_to_num(x.float(), nan=0.0)
    # one shared threshold: the max over every shard's max|x| (over ranks,
    # the one float collective: a single float32 scalar)
    t = xf.abs().amax()
    if group is not None:
        t = all_reduce(t.reshape(1), group, op=dist.ReduceOp.MAX)[0]
    else:
        stand_in("all_reduce", t.dtype, 1, tp, "max")
    # T / 127 as XLA compiles it: T * (1 / 127)
    s = torch.clamp_min(t, 1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    out = total(q.to(torch.int32)).float() * s
    if mean:
        # the mean over a shard count known at compile time, as XLA
        # compiles it: a multiply by the reciprocal
        out = out * (1.0 / tp)
    return out.to(x.dtype)
