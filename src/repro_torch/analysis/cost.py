"""What a step costs, counted as it runs: the dry run's counter.

``CostCounter`` is a ``record.Recorder`` that leaves the Python stack
alone and keeps no op list; it counts, over the steps run inside it:

  * ``dot_flops``: the FLOPs of every aten ``mm``, ``addmm``, ``bmm``,
    ``baddbmm`` and convolution, as ``torch.utils.flop_counter`` counts
    them (2 per multiply-add);
  * ``kernel_flops``: every ``kernels.ops`` wrapper call by its own formula
    from its operand shapes (``kernel_flops``), whether the CUDA kernel
    launched, the plain version ran, or (on the meta device) nothing ran.
    The plain version runs inside the wrapper's ``scope``, where nothing
    is counted, so a step counts the same on the CPU as on meta;
  * ``bytes``: operand plus result bytes of every op but the views, and
    of every kernel call: an unfused count, what an eager program moves;
  * ``peak``: the most storage bytes that the step's own tensors held at
    once (a view shares its base's storage and is counted once; a tensor
    that autograd saved lives until autograd lets it go).  The storages
    that the step did not make (its arguments, written in place or not)
    are not counted.  A storage is counted from the op that made it until
    its last holder lets it go (a weak reference on the storage, which
    PyTorch keeps alive as long as its memory).

On meta tensors the counts need no memory and no arithmetic: the dry run
traces full-width cells on the host this way.
"""
from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.record import Recorder
from repro_torch.kernels import ops as _ops

_DOTS = {p: f for p, f in flop_registry.items()
         if getattr(p, "__name__", "") in (
             "mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
             "convolution_backward")}


def _flat(x, out: list) -> list:
    """The tensors of an op's arguments or results (lists, tuples and
    dicts of them): ``record._tensors`` without the pytree machinery."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _attended(sq: int, q_start: int, kv_len: int, causal: bool,
              window) -> int:
    """Keys attended, summed over ``sq`` query rows at positions
    ``q_start + i``, of ``kv_len`` valid keys at positions 0.."""
    pos = q_start + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos + 1, kv_len) if causal else np.full(sq, kv_len)
    lo = np.maximum(pos - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def kernel_flops(kernel: str, operands: dict, attrs: dict) -> int:
    """One wrapper call's FLOPs from its operand shapes: B3 2·M·K·N (K the
    contraction range of the int32-accumulator branch); the attention
    kernels the QK and PV products, 4·D per (query row, head, key
    attended), the keys attended from the call's host span where the
    caller gave one (an int position), else every key of the K/V stream
    (decode) or the causal block ending at its last key (prefill); B5 no
    product."""
    if kernel == "quant_matmul":
        if attrs.get("acc"):
            m = operands["x_q"].shape[0]
            k = attrs["k1"] - attrs["k0"]
        else:
            m, k = operands["x"].shape
        return 2 * m * k * operands["w_q"].shape[1]
    if kernel == "fake_quant":
        return 0
    q = operands["q"]
    heads_d = q.shape[-3] * q.shape[-2] * q.shape[-1]   # KV * G * D
    k = operands["k"]
    sk = k.shape[1]
    if "table" in operands:       # a paged pool: blocks x page size
        sk = operands["table"].shape[1] * k.shape[1]
    if kernel == "prefill_attention":
        b, sq = q.shape[0], q.shape[1]
        q_start, kv_len = attrs.get("span") or (None, None)
        kv_len = sk if kv_len is None else kv_len
        q_start = kv_len - sq if q_start is None else q_start
        keys = _attended(sq, q_start, kv_len, attrs.get("causal", True),
                         attrs.get("window"))
        return 4 * b * heads_d * keys
    span = attrs.get("span")
    keys = sk if span is None else min(span, sk)
    return 4 * q.shape[0] * heads_d * keys


class CostCounter(Recorder):
    """Counts ``dot_flops``, ``kernel_flops`` (and ``by_kernel``: calls
    and FLOPs by kernel), ``bytes``, ``n_ops`` and the ``peak`` of live
    step-made storage bytes (module docstring); the kernel calls are kept
    in ``kernels``, as a ``Recorder`` keeps them::

        with CostCounter() as c:
            step(...)
        c.flops, c.bytes, c.peak
    """

    def __init__(self):
        super().__init__(stack=False)
        self.dot_flops = 0
        self.kernel_flops = 0
        self.by_kernel = {}   # kernel -> [calls, FLOPs]
        self.bytes = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._held = {}       # storage id -> weak reference to it
        self._paused = 0

    @property
    def flops(self) -> int:
        return self.dot_flops + self.kernel_flops

    # -- hooks ---------------------------------------------------------------
    def __enter__(self):
        if _ops.scope is not None:
            raise RuntimeError("a cost counter is already installed on "
                               "kernels.ops: counters do not nest")
        _ops.scope = self._scope
        try:
            return super().__enter__()
        except BaseException:
            _ops.scope = None
            raise

    def _uninstall(self):
        super()._uninstall()
        _ops.scope = None

    @contextlib.contextmanager
    def _scope(self):
        kept = []
        self._paused += 1
        try:
            yield kept.append
        finally:
            self._paused -= 1
        for t in _flat(kept, []):
            self.bytes += _nbytes(t)
            self._hold(t, ())
        self.peak = max(self.peak, self.live)

    def _on_kernel(self, kernel, launched, operands, attrs):
        super()._on_kernel(kernel, launched, operands, attrs)
        flops = kernel_flops(kernel, operands, attrs)
        self.kernel_flops += flops
        tally = self.by_kernel.setdefault(kernel, [0, 0])
        tally[0] += 1
        tally[1] += flops
        self.bytes += sum(_nbytes(t) for t in operands.values()
                          if isinstance(t, torch.Tensor))

    # -- storages ------------------------------------------------------------
    def _hold(self, t: torch.Tensor, known: tuple) -> None:
        """Count ``t``'s storage from now on, unless it is one of ``known``
        (the op's inputs': a view, or an in-place write) or already
        counted."""
        st = t.untyped_storage()
        key = st._cdata
        if key in known or key in self._held:
            return
        n = st.nbytes()
        self.live += n

        def gone(_, key=key, n=n):
            self._held.pop(key, None)
            self.live -= n

        self._held[key] = weakref.ref(st, gone)

    # -- the ops -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        self.n_ops += 1
        ins = _flat(kwargs, _flat(args, []))
        outs = _flat(out, [])
        packet = func._overloadpacket
        dot = _DOTS.get(packet)
        if dot is not None:
            self.dot_flops += dot(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        known = tuple(t.untyped_storage()._cdata for t in ins)
        for t in outs:
            self._hold(t, known)
        self.peak = max(self.peak, self.live)
        return out
