"""Deterministic fault injection for the serving stack.

Counterpart of ``repro/launch/faults.py``, kept as its own copy (plain
Python, no torch): a :class:`FaultPlan` is a frozen, hashable schedule of
injected faults that the ``SlotScheduler`` (``launch/scheduler.py``)
consults at fixed points of its host loop, so every degraded path of the
resilience layer can be driven bit-reproducibly, in tests and on the card.
Plans parse from the same dicts, JSON strings and files as the
reference's, with equal fields.

Fault classes (one knob per degraded path):

``reject``          admission fails for these request ids before any
                    device work runs (the request retires
                    ``status='failed'``).
``nan_prefill``     the admission prefill's sampling logits are forced
                    non-finite for these request ids.
``nan_decode``      ``(rid, step)`` pairs: request ``rid``'s decode
                    logits turn NaN at its ``step``-th decode step.  The
                    injection happens inside the decode block, driven by a
                    per-slot step vector: data, so a faulted run replays
                    the clean run's captured block.
``preempt``         ``(block, rid)`` pairs: at decode-block boundary
                    ``block`` the scheduler force-preempts request
                    ``rid`` (park, later re-admit through the ``resume``
                    prefill).
``exhaust_prefix``  every ``PrefixStore.reserve`` is denied, forcing the
                    private-pages path on every paged admission.
``crash``           decode-block boundaries (1-based: ``(k,)`` crashes
                    after the k-th completed block) at which the
                    scheduler raises :class:`SimulatedCrash`, after its
                    write-ahead journal records and snapshot for the
                    boundary are written.  A crash escapes ``run()``: it
                    stands in for process death.
``ms_per_block``    > 0 switches the scheduler to a virtual clock that
                    advances exactly this many milliseconds per decode
                    block, so deadlines, arrivals and shedding are
                    functions of the block schedule, not of wall time.
"""
from __future__ import annotations

import dataclasses
import json
import os


class InjectedFault(RuntimeError):
    """Raised by the scheduler at an injection point; the per-request
    isolation layer retires the request as ``failed``.  The port's
    isolation catches this class by name, never ``RuntimeError`` as a
    whole: a CUDA error must escape the run."""


class SimulatedCrash(RuntimeError):
    """Raised at a ``crash`` decode-block boundary, after the journal
    records for that boundary are durable.  Deliberately NOT caught by
    the scheduler: it stands in for process death, so recovery must run
    through a fresh scheduler (``SlotScheduler.recover``)."""


def _int_tuple(xs):
    return tuple(sorted(int(x) for x in xs))


def _pair_tuple(xs):
    """Normalize {key: val} dicts (JSON) or (a, b) pair iterables into a
    sorted tuple of int pairs."""
    if isinstance(xs, dict):
        xs = [(k, v) for k, v in xs.items()]
    return tuple(sorted((int(a), int(b)) for a, b in xs))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, hashable fault schedule (see module docstring).

    Frozen with tuple-valued fields so a plan can sit directly in the
    Engine's scheduler cache key — two generates under different plans
    never share a stale scheduler, while re-running the same plan reuses
    the captured programs.
    """

    reject: tuple = ()          # rids: admission fails before device work
    nan_prefill: tuple = ()     # rids: prefill sampling logits -> NaN
    nan_decode: tuple = ()      # ((rid, step), ...): decode logits -> NaN
    preempt: tuple = ()         # ((block, rid), ...): forced preemption
    exhaust_prefix: bool = False
    crash: tuple = ()           # block boundaries: simulated process crash
    ms_per_block: float = 0.0   # > 0: virtual clock, ms per decode block

    def __post_init__(self):
        object.__setattr__(self, "reject", _int_tuple(self.reject))
        object.__setattr__(self, "nan_prefill",
                           _int_tuple(self.nan_prefill))
        object.__setattr__(self, "nan_decode",
                           _pair_tuple(self.nan_decode))
        object.__setattr__(self, "preempt", _pair_tuple(self.preempt))
        object.__setattr__(self, "exhaust_prefix",
                           bool(self.exhaust_prefix))
        object.__setattr__(self, "crash", _int_tuple(self.crash))
        object.__setattr__(self, "ms_per_block",
                           float(self.ms_per_block))
        if self.ms_per_block < 0:
            raise ValueError("ms_per_block must be >= 0")
        # one NaN step per rid: ``nan_decode_step`` returns a single step,
        # so a duplicate rid would silently lose all but the first match
        rids = [r for r, _ in self.nan_decode]
        dup = sorted({r for r in rids if rids.count(r) > 1})
        if dup:
            raise ValueError(
                f"nan_decode schedules multiple steps for rid(s) {dup}; "
                "each rid may turn NaN at exactly one decode step")
        # duplicate (block, rid) preemptions would double-count the same
        # eviction (the pair either fires once or is a spec mistake)
        if len(set(self.preempt)) != len(self.preempt):
            dup = sorted({p for p in self.preempt
                          if self.preempt.count(p) > 1})
            raise ValueError(
                f"preempt lists duplicate (block, rid) pair(s) {dup}")
        if any(b < 1 for b in self.crash):
            raise ValueError(
                "crash boundaries are 1-based (after the k-th completed "
                f"decode block), got {self.crash}")

    # -- queries (the scheduler's injection points) -----------------------
    def rejects(self, rid: int) -> bool:
        return int(rid) in self.reject

    def nans_prefill(self, rid: int) -> bool:
        return int(rid) in self.nan_prefill

    def nan_decode_step(self, rid: int):
        """The absolute decode scan step at which ``rid``'s logits turn
        non-finite, or None."""
        for r, step in self.nan_decode:
            if r == int(rid):
                return step
        return None

    def preempts_at(self, block: int) -> tuple:
        """Request ids force-preempted at decode-block boundary
        ``block``."""
        return tuple(rid for blk, rid in self.preempt if blk == int(block))

    def crash_at(self, block: int) -> bool:
        """Whether the scheduler crashes after ``block`` completed decode
        blocks (checked once per boundary; a recovered run resumes past
        the boundary, so the same crash never re-fires)."""
        return int(block) in self.crash

    @property
    def empty(self) -> bool:
        return self == FaultPlan()

    # -- (de)serialization -------------------------------------------------
    @classmethod
    def parse(cls, spec) -> "FaultPlan":
        """Build a plan from a dict, a JSON string, or a path to a JSON
        file (the reference's ``serve.py --fault-plan`` formats).  JSON
        keys match the field names; ``nan_decode``/``preempt`` accept
        either pair lists or ``{"rid": step}`` / ``{"block": rid}``
        objects."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            if os.path.exists(spec):
                with open(spec) as f:
                    spec = json.load(f)
            else:
                spec = json.loads(spec)
        if not isinstance(spec, dict):
            raise ValueError(
                f"fault plan must be a JSON object, got {type(spec).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(
                f"unknown fault plan keys {sorted(unknown)} "
                f"(known: {sorted(known)})")
        return cls(**spec)

    def describe(self) -> str:
        """One-line human summary for CLI / bench logs."""
        bits = []
        if self.reject:
            bits.append(f"reject rids {list(self.reject)}")
        if self.nan_prefill:
            bits.append(f"nan prefill rids {list(self.nan_prefill)}")
        if self.nan_decode:
            bits.append("nan decode " +
                        ", ".join(f"rid {r}@step {s}"
                                  for r, s in self.nan_decode))
        if self.preempt:
            bits.append("preempt " +
                        ", ".join(f"rid {r}@block {b}"
                                  for b, r in self.preempt))
        if self.exhaust_prefix:
            bits.append("prefix pool exhausted")
        if self.crash:
            bits.append(f"crash at block {list(self.crash)}")
        if self.ms_per_block:
            bits.append(f"virtual clock {self.ms_per_block:g} ms/block")
        return "; ".join(bits) if bits else "no faults"
