"""What a serving step did, written down as it runs: the port's
counterpart of ``repro/analysis/jaxprs.py``.

The reference traces each entry point to a jaxpr and walks its equations.
The port runs eagerly, so it records the run instead.  One ``Recorder``
context writes down three things:

  * every aten op, under a ``TorchDispatchMode``: its name, the dtypes and
    shapes of its tensor inputs and outputs, the innermost frame of the
    port's source as ``file:line`` and the function names on the stack,
    innermost first (what ``eqn_location`` and ``eqn_function_names`` give
    the reference; the allow rules of ``dtype_drift`` match on them).  A
    ``WeakTensorKeyDictionary`` keeps, for each tensor the step made, how
    many producer hops back the nearest ``aten.round`` lies (up to
    ``MAX_DEPTH``): the counterpart of ``ancestor_prims``;
  * every kernel-wrapper call of ``kernels/ops.py`` (its ``observer``):
    the kernel, whether the CUDA kernel launched or the plain version ran,
    the operands' dtypes, shapes, strides and devices, and the variant.  On
    the CPU the plain versions run inside the recorder, so their
    arithmetic is recorded too;
  * every collective of ``dist/collectives.py`` (its ``observer``): the
    all-reduce and all-gather of a rank mesh, and what one-process shards
    stand for (``compressed_psum``'s stacked sum, the sequence-parallel
    partial merges), each with its kind, payload dtype, element count per
    shard and shard count.

Recorders do not nest, and a hook that cannot be installed raises.
``Recorder(stack=False)`` leaves the Python stack alone (every location
"" and every name list empty): the dry run's counter
(``analysis/cost.py``) runs 10^5 ops and more a step, and reads no
location.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.dist import collectives as _coll
from repro_torch.kernels import ops as _ops

# producer hops searched back from a cast for a round (ancestor_prims'
# max_depth)
MAX_DEPTH = 12
_ROUND_OPS = ("round",)
_OWN = os.path.dirname(os.path.abspath(__file__)) + os.sep
_PORT = os.sep + "repro_torch" + os.sep
_TESTS = os.sep + "tests" + os.sep


class Operand(NamedTuple):
    """A tensor as a record keeps it."""
    dtype: torch.dtype
    shape: tuple
    stride: tuple
    device: str
    contiguous: bool

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @classmethod
    def of(cls, t: torch.Tensor) -> "Operand":
        return cls(t.dtype, tuple(t.shape), tuple(t.stride()), t.device.type,
                   t.is_contiguous())


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op: ``op`` is its overload packet's name (``add``,
    ``_to_copy``, ``copy_``), ``inputs`` / ``outputs`` (dtype, shape) pairs,
    ``round_hops`` for each tensor input the hops back to its nearest round
    (None: none within ``MAX_DEPTH``), and ``fake_quant`` the outermost
    function of the port named ``*fake_quant*`` on the stack ("": none)."""
    op: str
    inputs: tuple
    outputs: tuple
    round_hops: tuple
    location: str
    names: tuple
    fake_quant: str

    @property
    def primitive(self) -> str:
        return self.op


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One call of a ``kernels.ops`` wrapper: ``launched`` (the CUDA kernel)
    or its plain version; ``operands`` by name; ``attrs`` the variant
    (``w_bits``, ``acc``, ``kv_bits``, ``window``, ...) and ``twin``,
    whether ``ops.plain_versions()`` was on."""
    kernel: str
    launched: bool
    device: str
    operands: dict
    attrs: dict
    location: str
    names: tuple

    @property
    def paged(self) -> bool:
        return "table" in self.operands


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One collective: ``kind`` "all_reduce" or "all_gather", ``numel``
    elements of ``dtype`` from each of ``n`` shards, ``op`` "sum" or
    "max"."""
    kind: str
    dtype: torch.dtype
    numel: int
    n: int
    op: str
    location: str
    names: tuple

    @property
    def primitive(self) -> str:
        return self.kind

    @property
    def nbytes(self) -> int:
        """What each shard receives from the ``n - 1`` others (the
        counters' measure: ``wire_bytes``, ``gather_bytes``)."""
        return (self.n - 1) * self.numel * self.dtype.itemsize


def _stack(outside: str = "") -> tuple:
    """(location, function names innermost first, the outermost function of
    the port named *fake_quant* on the stack or ""), from the caller's
    caller out; the location skips the port's frames under ``outside``."""
    f = sys._getframe(2)
    loc, names, fq = "", [], ""
    while f is not None:
        code = f.f_code
        path = code.co_filename
        names.append(code.co_name)
        if _PORT in path and not path.startswith(_OWN):
            if not loc and not (outside and outside in path):
                loc = "repro_torch/" + path.rsplit(_PORT, 1)[1] + \
                    f":{f.f_lineno}"
            if "fake_quant" in code.co_name:
                fq = code.co_name
        elif not loc and _TESTS in path:
            loc = f"{os.path.basename(path)}:{f.f_lineno}"
        f = f.f_back
    return loc, tuple(names), fq


_NOWHERE = ("", (), "")


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class Recorder(TorchDispatchMode):
    """Records the ops, kernel calls and collectives of the steps run inside
    it (see the module docstring)::

        with Recorder() as rec:
            step(...)
        rec.ops, rec.kernels, rec.collectives
    """

    def __init__(self, *, stack: bool = True):
        super().__init__()
        self.stack = stack
        self.ops: list[OpRecord] = []
        self.kernels: list[KernelCall] = []
        self.collectives: list[CollectiveCall] = []
        self._hops = WeakTensorKeyDictionary()

    # -- the hooks ---------------------------------------------------------
    def __enter__(self):
        if _ops.observer is not None or _coll.observer is not None:
            raise RuntimeError("a recorder is already installed on "
                               "kernels.ops / dist.collectives: recorders "
                               "do not nest")
        _ops.observer = self._on_kernel
        _coll.observer = self._on_collective
        try:
            return super().__enter__()
        except BaseException:
            self._uninstall()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._uninstall()

    def _uninstall(self):
        _ops.observer = None
        _coll.observer = None

    def _on_kernel(self, kernel, launched, operands, attrs):
        # located at the wrapper's caller
        loc, names, _ = (_stack(_PORT + "kernels" + os.sep) if self.stack
                         else _NOWHERE)
        ops_ = {k: Operand.of(t) for k, t in operands.items()
                if isinstance(t, torch.Tensor)}
        lead = next(iter(ops_.values()))
        self.kernels.append(KernelCall(kernel, launched, lead.device, ops_,
                                       attrs, loc, names))

    def _on_collective(self, kind, dtype, numel, n, op):
        # located at the collective's caller
        loc, names, _ = (_stack(_PORT + "dist" + os.sep) if self.stack
                         else _NOWHERE)
        self.collectives.append(CollectiveCall(kind, dtype, int(numel), n, op,
                                               loc, names))

    # -- the ops -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = func._overloadpacket.__name__
        hops = tuple(self._hops.get(t) for t in ins)
        if name.rstrip("_") in _ROUND_OPS:
            new: Optional[int] = 0
        else:
            near = min((h for h in hops if h is not None), default=None)
            new = None if near is None or near >= MAX_DEPTH else near + 1
        for o in outs:
            if new is None:
                self._hops.pop(o, None)
            else:
                self._hops[o] = new
        loc, names, fq = _stack() if self.stack else _NOWHERE
        self.ops.append(OpRecord(
            name, tuple((t.dtype, tuple(t.shape)) for t in ins),
            tuple((t.dtype, tuple(t.shape)) for t in outs), hops, loc, names,
            fq))
        return out
