"""Capture budgets: the no-retrace contract, and no host read inside a
captured step.

Counterpart of ``repro/analysis/budgets.py``.  The reference counts the
traces and the XLA compiles of its jitted scheduler pieces; the port
counts the ``launch/graphs.py::Program``s its scheduler builds (a CUDA
graph capture on the card, an eager program on the CPU).

**Declared budgets** (``SCHEDULER_BUDGETS``): each piece with the (min,
max) number of Programs it may build over a scheduler's lifetime.
``prefill`` and ``decode`` are built once at the first run; ``resume``
at the first re-admission, if any.  ``insert``, ``set_row`` and
``copy_page`` run eagerly in the port (the reference jits them): their
budget is (0, 0), and a Program built for one is a finding until the
table says otherwise.  The same pieces of a ``ShardedEngine``'s scheduler
are declared again under ``sharded_``.  ``check_executable_budgets``
diffs a live ``SlotScheduler.executable_counts()`` against the table:
over budget is a rebuild (a shape or host value leaked into what should
be data), a piece under its floor never ran, a piece missing from the
table is undeclared.

**CaptureWatch** (the reference's ``CompileWatch``): counts Program builds
in its scope through ``launch.graphs.builds``.  A repeat of an identical
scheduler session must build none (``budget.capture``).

**HostReadGuard** / ``guarded``: a ``TorchDispatchMode`` that fails on any
op that reads a tensor back to the host or makes one from host data inside
a step that a Program captures (``capture.host-read``).  A CUDA graph
replays such a step with the value read at capture: stale data baked into
the executable, the port's form of the reference's
``pallas.kernel-closure``.  The kernels' plain versions (``kernels/ref.py``)
run outside the guard, since on the card the kernels run in their place.
"""
from __future__ import annotations

import contextlib
from typing import Mapping, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.report import Finding
from repro_torch.kernels import ref
from repro_torch.launch import graphs

# piece -> (min, max) Programs built across one scheduler's lifetime
SCHEDULER_BUDGETS: dict = {
    "prefill": (1, 1),
    "decode": (1, 1),
    "resume": (0, 1),      # built at the first re-admission
    # eager in the port: never a Program
    "insert": (0, 0),
    "set_row": (0, 0),
    "copy_page": (0, 0),
    # the same pieces of a ShardedEngine's scheduler (entrypoints reports
    # them under a sharded_ prefix)
    "sharded_prefill": (1, 1),
    "sharded_decode": (1, 1),
    "sharded_resume": (0, 1),
    "sharded_insert": (0, 0),
    "sharded_set_row": (0, 0),
    "sharded_copy_page": (0, 0),
}


def check_executable_budgets(counts: Mapping[str, int],
                             budgets: Optional[Mapping] = None, *,
                             entry_point: str = "",
                             require_all_ran: bool = False) -> list[Finding]:
    """Diff a live ``SlotScheduler.executable_counts()`` against the
    declared budgets.  With ``require_all_ran`` each piece must also have
    built at least its declared minimum (after a session that exercised
    every piece)."""
    if budgets is None:
        budgets = SCHEDULER_BUDGETS
    findings: list[Finding] = []
    for piece, n in sorted(counts.items()):
        if piece not in budgets:
            findings.append(Finding(
                analyzer="budgets", code="budget.undeclared",
                entry_point=entry_point,
                message=f"scheduler piece '{piece}' has no declared budget "
                        "in analysis.budgets.SCHEDULER_BUDGETS: a new piece "
                        "declares its Program budget to ship"))
            continue
        lo, hi = budgets[piece]
        if n > hi:
            findings.append(Finding(
                analyzer="budgets", code="budget.retrace",
                entry_point=entry_point,
                message=f"'{piece}' built {n} Program(s) against a budget "
                        f"of {hi}: a shape or host value is leaking into "
                        "what the program keys on (admission patterns, "
                        "masks and fault plans are data, never keys)"))
        elif require_all_ran and n < lo:
            findings.append(Finding(
                analyzer="budgets", code="budget.never-traced",
                entry_point=entry_point,
                message=f"'{piece}' built {n} Program(s) but its budget "
                        f"floor is {lo}: the session claimed to exercise "
                        "it and it never ran"))
    return findings


def capture_count() -> int:
    """Programs built in this process (``launch.graphs.builds``)."""
    return graphs.builds


class CaptureWatch:
    """Counts the Programs built in its scope::

        with CaptureWatch() as w:
            scheduler.run(requests)
        findings = w.check(max_captures=0, what="a warm session")
    """

    def __init__(self):
        self._start = 0
        self.count = 0

    def __enter__(self):
        self._start = capture_count()
        return self

    def __exit__(self, *exc):
        self.count = capture_count() - self._start
        return False

    def check(self, *, max_captures: int, what: str,
              entry_point: str = "") -> list[Finding]:
        if self.count <= max_captures:
            return []
        return [Finding(
            analyzer="budgets", code="budget.capture",
            entry_point=entry_point,
            message=f"{what}: {self.count} Program build(s) (CUDA graph "
                    f"captures on the card) against a budget of "
                    f"{max_captures}: a warm path built a program again")]


# ---------------------------------------------------------------------------
# host reads inside a captured step
# ---------------------------------------------------------------------------

_BANNED = {torch.ops.aten._local_scalar_dense.default: "a host read",
           torch.ops.aten.nonzero.default: "a host read (nonzero)",
           torch.ops.aten.is_nonzero.default: "a host read (bool)",
           torch.ops.aten.lift_fresh.default: "a tensor made from host data",
           torch.ops.aten.lift_fresh_copy.default:
               "a tensor made from host data",
           torch.ops.aten.masked_select.default:
               "a host read (masked_select: its size is data)"}
# indexing ops whose boolean index is a nonzero on the card
_INDEXING = {torch.ops.aten.index.Tensor, torch.ops.aten.index_put.default,
             torch.ops.aten.index_put_.default,
             torch.ops.aten._index_put_impl_.default}


class HostRead(AssertionError):
    """A host read (or a tensor made from host data) inside a captured
    step."""


class HostReadGuard(TorchDispatchMode):
    """Fails on any op that reads a tensor back to the host or makes a
    tensor from host data; counts the ops it saw."""

    def __init__(self):
        super().__init__()
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _BANNED:
            raise HostRead(f"{_BANNED[func]} inside a captured step: {func}")
        if func in _INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in tree_flatten(args[1])[0]):
            raise HostRead(f"a host read (boolean-mask index) inside a "
                           f"captured step: {func}")
        self.n_ops += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def guarded():
    """``HostReadGuard`` around the block, with every plain kernel version
    of ``kernels/ref.py`` run outside it; fails if the block ran no op."""
    def exempt(fn):
        def run(*a, **kw):
            with _disable_current_modes():
                return fn(*a, **kw)
        return run

    saved = {name: getattr(ref, name) for name in dir(ref)
             if name.endswith("_ref") and callable(getattr(ref, name))}
    for name, fn in saved.items():
        setattr(ref, name, exempt(fn))
    try:
        guard = HostReadGuard()
        with guard:
            yield guard
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)
    if guard.n_ops == 0:
        raise AssertionError("the guard saw no op: nothing ran under it")


def check_host_reads(programs: Mapping, *, entry_point: str = ""
                     ) -> list[Finding]:
    """Run each Program's step function (``{name: Program}``) once under
    the guard; a host read in one is a ``capture.host-read`` finding."""
    findings = []
    for name, prog in programs.items():
        try:
            with guarded():
                prog.fn()
        except HostRead as err:
            findings.append(Finding(
                analyzer="budgets", code="capture.host-read",
                entry_point=entry_point,
                message=f"program '{name}': {err}: a CUDA graph replays the "
                        "value read at capture (stale data baked into the "
                        "executable); keep the value on the device"))
    return findings
