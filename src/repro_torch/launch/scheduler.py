"""Slot-based continuous-batching scheduler over the int8 serving engine.

Counterpart of ``repro/launch/scheduler.py``.  The paper's frozen static
thresholds (§2) are what make it possible: the K/V dequant scales never
change at serve time, so a request is admitted into, or retired from, a
shared quantized KV cache without any recalibration.  The cache is one
(max_slots, cache_len) region per layer, dense or paged
(``cache_layout``), and requests stream through its slots:

  * admission runs the batch-1 chunked ragged prefill (tokens padded to
    ``prompt_cap``, the length vector masks the tail) into a dense batch-1
    template and splices the result into the free slot: a batch-row copy
    for the dense layout, a page-pool scatter plus a block-table row for
    the paged one;
  * decode runs ``strategies.make_strategy_slot_loop`` blocks of
    ``block_steps`` steps: every slot at its own position (a (B,)
    ``cur_pos`` through the decode kernel), inactive slots masked in
    attention and in the cache writes;
  * retirement is bookkeeping: a finished slot's region is dead data that
    the next admission overwrites.

Prefix sharing (paged layout): after a prompt prefills, its full pages are
copied into the pool's shared region together with its last-position
logits (a :class:`repro_torch.cache.PrefixStore` entry, keyed by the
prompt's tokens).  A later request with the same prompt admits with no
prefill at all: its table row points at the shared pages, the partial tail
page is copied into the slot's private page, and the first token comes
from the stored logits.  ``prefix_stats()`` and ``call_counts()`` expose
the hits and the prefills that ran.

Decoding follows the strategy (``launch/strategies.py``): greedy, sampled
or speculative.  Sampled requests draw from per-request keys,
``fold_in(PRNGKey(seed), rid)`` split into the first token's key and the
slot's carried key (which advances only on the request's own steps), so a
request's tokens depend on (seed, rid, prompt) and not on its arrival order,
its slot or a preemption, as in the reference.  The per-slot keys and the
speculative history (absolute position -> token) live on the device and go
through the captured block; ``spec_stats()`` counts the verify windows and
their tokens.

Resilience, as in the reference: ``run()`` never aborts because one request
is bad, and every request retires with a status:

    ok         finished (``finished_by``: eos | budget | capacity)
    rejected   failed validation (never touched the device)
    failed     an injected admission fault, or non-finite prefill or
               decode logits (only that slot stops)
    timeout    missed its ``deadline_ms`` (resident or still queued)
    preempted  evicted for a higher-priority request, and the run ended
               before it was re-admitted
    shed       dropped by the bounded admission queue (``queue_cap``)

Deadlines are checked at block boundaries against each request's arrival.
A higher-priority waiter preempts the lowest-priority resumable resident:
the victim's host state (tokens so far, carried key, step count) is parked
and its slot handed over; re-admission rebuilds its cache with ONE ragged
prefill over prompt + generated tokens (the ``resume`` program, at the
width ``resume_cap``), bit-valid because the frozen thresholds make the
quantized cache a function of the token sequence.  Under the paged layout
the victim's prefix references are released and its table row reclaimed
onto its private pages first.  A ``FaultPlan`` (``launch/faults.py``)
drives every degraded path deterministically; its decode faults are a
(B,) step vector the captured block reads, so a faulted run replays the
clean run's programs.  Admission isolates exactly ``InjectedFault``,
``FloatingPointError`` and ``ValueError``: any other exception (a CUDA
error among them) escapes ``run``, where the reference retires the request
as ``failed`` on any exception (ROADMAP Queue C, a standing difference).

Durability: a write-ahead journal (``launch/journal.py``; ``recover()``
on a fresh scheduler replays it through the ``resume`` program) and full
snapshots through ``checkpoint.manager.CheckpointManager``
(``save_state`` / ``load_state`` + ``resume_run``).  ``load_state`` copies
the saved arrays into the scheduler's own cache and buffers, because the
captured block reads the tensors it was captured with.

As the reference jits its admission prefill, its re-admission prefill and
its scanned decode block, the scheduler runs all three as programs
(``launch/graphs.py``) over static buffers.  On CUDA the admission prefill
and the decode block are captured at the first run
(``stage_seconds()["compile"]``) and the ``resume`` prefill at its first
use; each later call replays.  The host reads after each block and each
admission (one synchronization each) are the reference's.  The reference
counts compiled executables; the port counts the programs it builds
(``executable_counts``) and the calls (``call_counts``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.cache import (PrefixEntry, PrefixStore, copy_pages,
                               layer_caches, set_table_row,
                               splice_dense_into_pages)
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import api as A
from repro_torch.launch import prng
from repro_torch.launch import steps as ST
from repro_torch.launch import strategies as SG
from repro_torch.launch.faults import FaultPlan, InjectedFault, SimulatedCrash
from repro_torch.launch.graphs import Program
from repro_torch.launch.journal import (RequestJournal, completion_from_dict,
                                        completion_to_dict, request_from_dict,
                                        request_to_dict)


@dataclasses.dataclass
class Request:
    """One generation request: prompt tokens and a generation budget
    (``max_gen`` counts the first token).  ``priority`` orders admission
    and picks preemption victims (higher wins; a resident yields only to a
    strictly higher waiter).  ``deadline_ms`` is a completion deadline
    relative to ``arrive_ms`` (None: none).  ``arrive_ms`` places the
    request on the run's clock (wall ms from the run's start, or virtual ms
    under a fault plan's ``ms_per_block``); it is invisible to the
    scheduler before then."""
    rid: int
    tokens: np.ndarray          # (prompt_len,) int
    max_gen: int = 16
    priority: int = 0
    deadline_ms: Optional[float] = None
    arrive_ms: float = 0.0


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: list                # generated tokens (includes an EOS if hit)
    finished_by: str            # 'eos' | 'budget' | 'capacity' when ok,
                                # else the status
    status: str = "ok"          # ok | rejected | timeout | preempted |
                                # shed | failed
    reason: Optional[str] = None    # failure detail


@dataclasses.dataclass
class _Parked:
    """A preempted (or crash-recovered) request awaiting re-admission: the
    tokens that rebuild its cache and the host state that survives as it
    is."""
    req: Request
    out: list                   # generated so far (incl. the pending token)
    key: torch.Tensor           # (2,) int64 carried key (uint32 words), CPU
    steps: int                  # decode steps consumed so far
    recovered: bool = False     # parked by crash recovery, not preemption


_STATUSES = ("ok", "rejected", "timeout", "preempted", "shed", "failed")
_HEALTH_KEYS = _STATUSES + (
    "eos", "budget", "capacity",            # ok retirement causes
    "preemptions", "readmits", "deadline_misses", "prefix_exhausted",
    "recoveries", "replayed_tokens")        # durability counters

# the admission failures that retire a request as 'failed' (an injected
# fault, non-finite prefill logits, a request the model cannot take);
# anything else, a CUDA error among them, escapes ``run``
_ADMISSION_FAULTS = (InjectedFault, FloatingPointError, ValueError)


@dataclasses.dataclass
class _RunState:
    """The host state of one run, on the instance so that a block boundary
    can be snapshotted (``save_state``) and a crashed run rebuilt
    (``recover``, ``load_state``)."""
    pos: np.ndarray             # (B,) int32 valid cache entries per slot
    active: np.ndarray          # (B,) bool
    last_tok: np.ndarray        # (B,) int64 pending token per slot
    slot_req: list              # per-slot Request (None = free)
    slot_out: list              # per-slot generated tokens (incl. pending)
    slot_steps: list            # per-slot decode steps consumed
    done: list                  # Completions, in finish order
    n_blocks: int               # committed decode-block boundaries
    arrivals: deque             # not yet arrived, by arrive_ms
    pending: deque              # arrived, waiting for a slot
    readmit: deque              # _Parked requests
    vclock: float               # virtual ms when plan.ms_per_block > 0
    t_start: float              # wall-clock origin of the run


def _key_list(key) -> list:
    """A carried key as the journal's two Python ints (uint32 words)."""
    return [int(k) for k in key]


def _key_tensor(key) -> torch.Tensor:
    """A journal's or snapshot's two uint32 words as the port's (2,) int64
    key."""
    return torch.as_tensor(np.asarray(key, dtype=np.int64))


class SlotScheduler:
    """Continuous batching: admit and retire requests through a fixed slot
    batch.

    ``max_slots`` is the decode batch; ``prompt_cap`` the longest prompt
    (every prompt pads to it, rounded up to a ``prefill_chunk`` multiple;
    ``prefill_chunk`` None picks max(8, min(16, prompt_cap)));
    ``gen_cap`` the generation headroom each slot reserves; ``block_steps``
    the decode-block length (admission happens between blocks).
    ``cache_layout`` is "dense" or "paged" ("ring" is dense here: the
    scheduler needs absolute slots, and, as the reference's, it takes no
    stack with sliding-window layers); ``page_size`` and ``prefix_pages``
    (the shared region, default room for two full-capacity prompts) size
    the paged pool.  ``eos_id`` >= 0 stops a slot at that token.
    ``strategy`` is a ``strategies`` name, a ``DecodeStrategy`` or None
    (sampled when ``temperature`` > 0, else greedy); ``temperature``,
    ``top_p`` and ``seed`` drive sampling, ``spec_k`` and ``spec_ngram``
    speculative decoding (a slot then reserves ``spec_k`` positions of
    headroom).  ``mode`` is the serving mode ("int8" weights, or "none":
    the full-precision weights); the caches hold int8 (or packed int4) K/V
    when ``policy.kv_int8``, else ``cfg.dtype`` K/V.  The caches live on
    ``device`` (default: the weights').  ``capture`` False runs the
    programs eagerly on CUDA too (the engine's explicit branch for what it
    does not capture).

    Resilience and durability, as in the reference: ``queue_cap`` bounds
    the admission queue (None: unbounded); when it is full,
    ``shed_policy`` "shed" retires the newest arrival as 'shed', "block"
    leaves arrivals waiting upstream.  ``fault_plan`` is a
    :class:`~repro_torch.launch.faults.FaultPlan` (None: no faults, the
    wall clock).  ``journal`` (a ``RequestJournal`` or a path) journals the
    run ahead of its writes, for ``recover()`` on a fresh scheduler.
    ``snapshot_every`` > 0 writes a full snapshot (``save_state``) every N
    block boundaries through a ``CheckpointManager`` (keep 3) at
    ``snapshot_dir``, which alone enables ``save_state`` / ``load_state``
    on demand."""

    def __init__(self, model, cfg, policy: A.QuantPolicy, serve_params,
                 qparams, *, mode: str = "int8", device=None,
                 capture: bool = True, max_slots: int = 4,
                 prompt_cap: int = 64, gen_cap: int = 32,
                 prefill_chunk: int | None = None, block_steps: int = 8,
                 cache_layout: str = "dense", page_size: int = 64,
                 prefix_pages: int | None = None, eos_id: int = -1,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0, strategy=None, spec_k: int = 4,
                 spec_ngram: int = 2, queue_cap: int | None = None,
                 shed_policy: str = "shed",
                 fault_plan: FaultPlan | None = None, journal=None,
                 snapshot_every: int = 0, snapshot_dir: str | None = None):
        kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
        wins = {cfg.attn_window(i) for i in range(cfg.n_layers)}
        if kinds - {"attn", "attn_local"} or cfg.modality != "text":
            raise ValueError(
                "slot scheduler covers attention-only text stacks "
                f"(got kinds={sorted(kinds)}, modality={cfg.modality})")
        if wins != {None}:
            raise ValueError(
                "slot scheduler needs dense caches: SWA ring buffers drop "
                f"absolute slots (got windows={sorted(map(str, wins))})")
        if cache_layout == "ring":
            cache_layout = "dense"   # no windows here: ring == dense
        if cache_layout not in ("dense", "paged"):
            raise ValueError(f"slot scheduler cache_layout must be dense or "
                             f"paged, got {cache_layout!r}")
        if max_slots < 1 or block_steps < 1:
            raise ValueError(f"max_slots ({max_slots}) and block_steps "
                             f"({block_steps}) must be >= 1")
        if shed_policy not in ("shed", "block"):
            raise ValueError(f"shed_policy must be 'shed' or 'block', got "
                             f"{shed_policy!r}")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        if snapshot_every < 0:
            raise ValueError(
                f"snapshot_every must be >= 0, got {snapshot_every}")
        if snapshot_every > 0 and snapshot_dir is None:
            raise ValueError(
                "snapshot_every > 0 needs a snapshot_dir to write to")
        self.model, self.cfg, self.policy = model, cfg, policy
        self.mode = mode
        self.serve_params, self.qparams = serve_params, qparams
        self.device = torch.device(
            device if device is not None
            else serve_params["embed"]["table"].device)
        self.max_slots = max_slots
        if prefill_chunk is None:
            prefill_chunk = max(8, min(16, prompt_cap))
        self.prefill_chunk = prefill_chunk
        self.prompt_cap = -(-prompt_cap // prefill_chunk) * prefill_chunk
        self.block_steps = block_steps
        self.eos_id = eos_id
        self.cache_layout = cache_layout
        self.page_size = page_size
        self.temperature, self.top_p = temperature, top_p
        self.queue_cap, self.shed_policy = queue_cap, shed_policy
        self._plan = fault_plan if fault_plan is not None else FaultPlan()
        self._seed = int(seed)
        if isinstance(journal, (str, os.PathLike)):
            journal = RequestJournal(journal)
        self._journal: RequestJournal | None = journal
        self._snapshot_every = int(snapshot_every)
        self._snap_mgr = (CheckpointManager(snapshot_dir, keep=3)
                          if snapshot_dir is not None else None)
        self._snap_step = 0         # monotonic snapshot counter
        self._rs: _RunState | None = None   # the live run (None: idle)
        self._epoch = 0             # journal epoch counter
        if not isinstance(strategy, SG.DecodeStrategy):
            strategy = SG.make_strategy(
                strategy, model, policy, temperature=temperature,
                top_p=top_p, spec_k=spec_k, spec_ngram=spec_ngram, mode=mode)
        self._strategy = strategy
        self._emit_w = strategy.emit_width
        # per-request sampling keys fold the rid into the seed's key
        self._base_key = prng.PRNGKey(seed)
        # the decode kernel's 128-position tiles, then whole pages, so the
        # dense batch-1 prefill reshapes into the slot's pages
        cache_len = self.prompt_cap + gen_cap + (strategy.emit_width - 1)
        cache_len = -(-cache_len // 128) * 128
        if cache_layout == "paged":
            cache_len = -(-cache_len // page_size) * page_size
        self.cache_len = cache_len
        # the widest state a re-admission prefill rebuilds: chunked prefill
        # writes whole chunks, so the largest chunk multiple in the cache
        self.resume_cap = (cache_len // prefill_chunk) * prefill_chunk
        self._n_blocks = cache_len // page_size if cache_layout == "paged" \
            else 0
        if prefix_pages is None:
            prefix_pages = 2 * self._n_blocks
        self._prefix_pages = prefix_pages if cache_layout == "paged" else 0
        kv = dict(kv_int8=bool(policy.kv_int8), dtype=cfg.dtype)
        with torch.inference_mode():
            # batch-1 admission template: DENSE whatever the batch layout;
            # each admission's (and re-admission's) prefill writes into it
            # and the splice re-homes the tiles
            self._slot_cache0 = model.init_cache(
                1, cache_len, self.device, policy.kv_bits, **kv)
            # the resident batch cache lives on the instance, so pages (and
            # the prefix store pointing into them) survive across runs
            self._cache = model.init_cache(
                max_slots, cache_len, self.device, policy.kv_bits,
                layout=cache_layout, page_size=page_size,
                extra_pages=self._prefix_pages, **kv)
        if cache_layout == "paged":
            nb = self._n_blocks
            self._private_rows = [np.arange(b * nb, (b + 1) * nb,
                                            dtype=np.int32)
                                  for b in range(max_slots)]
            self._prefix = PrefixStore(max_slots * nb, self._prefix_pages,
                                       page_size)
        else:
            self._private_rows = None
            self._prefix = None
        pieces = ["prefill", "decode", "insert", "resume"]
        if cache_layout == "paged":
            pieces += ["set_row", "copy_page"]
        self._call_counts = {p: 0 for p in pieces}
        self._built = {"prefill": 0, "decode": 0, "resume": 0}
        self._seconds = {"admit": 0.0, "decode": 0.0, "resume": 0.0,
                         "compile": 0.0}
        self._health = {k: 0 for k in _HEALTH_KEYS}
        self._prefill_fn = ST.make_prefill_step(model, policy,
                                                prefill_chunk=prefill_chunk,
                                                mode=mode)
        self._decode_fn = SG.make_strategy_slot_loop(
            model, policy, strategy, n_steps=block_steps, eos_id=eos_id)
        # the programs' static inputs: the admission's padded prompt and
        # length, the re-admission's (at resume_cap), the slots' pending
        # tokens, positions, live mask and injected-NaN steps (-1: none)
        dev = self.device
        self._adm_toks = torch.zeros((1, self.prompt_cap), dtype=torch.long,
                                     device=dev)
        self._adm_len = torch.ones((1,), dtype=torch.int32, device=dev)
        self._res_toks = torch.zeros((1, self.resume_cap), dtype=torch.long,
                                     device=dev)
        self._res_len = torch.ones((1,), dtype=torch.int32, device=dev)
        self._tok = torch.zeros((max_slots,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((max_slots,), dtype=torch.bool, device=dev)
        self._nan_step = torch.full((max_slots,), -1, dtype=torch.int32,
                                    device=dev)
        # the slots' carried PRNG keys and the strategy's history (absolute
        # position -> token; width 0 for a stateless strategy), on the
        # device: the block reads and advances them in place
        self._keys = torch.zeros((max_slots, 2), dtype=torch.long,
                                 device=dev)
        hist_w = cache_len if strategy.stateful else 0
        self._hist = torch.zeros((max_slots, hist_w), dtype=torch.long,
                                 device=dev)
        # speculative observability: emitted tokens per verify window
        self._spec_emitted = 0
        self._spec_windows = 0
        self._capture = capture
        # built at the first run (admission, block) and the first
        # re-admission (resume)
        self._admission = self._block = self._resume = None

    # -- observability ----------------------------------------------------
    def call_counts(self) -> dict:
        """Invocations per piece.  ``prefill`` counts the admissions that
        ran the model: a prefix-store hit admits without one; ``resume``
        counts re-admissions (preemption or crash recovery)."""
        return dict(self._call_counts)

    def executable_counts(self) -> dict:
        """Programs built per piece (on CUDA: warmed up and captured), the
        counterpart of the reference's trace counts: ``prefill`` and
        ``decode`` 1 after the first run whatever the admissions and the
        fault plan, ``resume`` 0 until a re-admission.  ``insert``,
        ``set_row`` and ``copy_page`` run eagerly, not as programs."""
        return dict(self._built)

    def programs(self) -> dict:
        """The Programs built so far, by piece (``prefill``, ``decode``,
        ``resume``)."""
        built = {"prefill": self._admission, "decode": self._block,
                 "resume": self._resume}
        return {k: p for k, p in built.items() if p is not None}

    def check_budgets(self) -> list:
        """The no-rebuild contract as findings: this scheduler's Program
        counts against the declared per-piece budgets
        (``repro_torch.analysis.budgets.SCHEDULER_BUDGETS``).  Empty: within
        budget."""
        from repro_torch.analysis.budgets import check_executable_budgets

        return check_executable_budgets(self.executable_counts(),
                                        entry_point="scheduler")

    def prefix_stats(self) -> dict:
        """Prefix-sharing counters (paged layout; empty for dense)."""
        return self._prefix.stats() if self._prefix is not None else {}

    def health_stats(self) -> dict:
        """Cumulative counters over this scheduler's runs: terminal
        statuses (``ok``/``rejected``/``timeout``/``preempted``/``shed``/
        ``failed``), ok retirement causes (``eos``/``budget``/
        ``capacity``), events (``preemptions``, ``readmits``,
        ``deadline_misses``, ``prefix_exhausted``: registrations skipped
        for want of shared pages) and durability counters
        (``recoveries``: completed ``recover``/``load_state`` calls;
        ``replayed_tokens``: tokens re-prefilled by journal recovery).
        Never reset implicitly: :meth:`reset_health` does;
        ``load_state`` replaces them with the snapshot's, ``recover``
        re-derives the statuses of the replayed retirements."""
        return dict(self._health)

    def reset_health(self):
        """Zero the cumulative ``health_stats`` counters."""
        self._health = {k: 0 for k in _HEALTH_KEYS}

    def spec_stats(self) -> dict:
        """Speculative-decoding counters (empty for one-token strategies).
        ``acceptance_rate`` is accepted drafts per drafted token: a verify
        window emits 1 + accepted tokens, so the rate is (emitted / windows
        - 1) / spec_k, in [0, 1]."""
        if self._emit_w == 1:
            return {}
        k = self._emit_w - 1
        wins = max(self._spec_windows, 1)
        return {"emitted_tokens": int(self._spec_emitted),
                "verify_windows": int(self._spec_windows),
                "draft_k": k,
                "tokens_per_window": self._spec_emitted / wins,
                "acceptance_rate": max(self._spec_emitted / wins - 1.0,
                                       0.0) / k}

    def stage_seconds(self) -> dict:
        """Cumulative wall seconds in admissions, re-admissions (the
        ``resume`` prefill and its splice) and decode blocks; each ends
        when its result is on the host or the device is synchronized, so
        each includes the device's work.  ``compile``: the warm-up and
        capture of the programs (0.0 on the CPU and when nothing is
        captured)."""
        return dict(self._seconds)

    def _program(self, name: str, fn) -> Program:
        prog = Program(fn, self.device, capture=self._capture)
        self._built[name] += 1
        self._seconds["compile"] += prog.capture_s
        return prog

    def _programs(self):
        """Build (on CUDA: warm up and capture) the admission prefill and
        the decode block, once per scheduler.  The block is warmed up and
        captured with every slot inactive, which leaves the cache, the keys
        and the history as they were; the admission's warm-up writes only
        the template."""
        def admission():
            return self._prefill_fn(
                self.serve_params, self.qparams, {"tokens": self._adm_toks},
                self._slot_cache0, self._adm_len)

        def block():
            toks, emitted, _, pos, active, keys, hist, bad = self._decode_fn(
                self.serve_params, self.qparams, self._tok, self._cache,
                self._pos, self._active, self._keys, self._hist,
                self._nan_step)
            self._keys.copy_(keys)
            self._hist.copy_(hist)
            return toks, emitted, pos, active, bad

        self._active.zero_()
        self._admission = self._program("prefill", admission)
        self._block = self._program("decode", block)

    def _resume_program(self) -> Program:
        """The re-admission prefill: the admission's chunked ragged prefill
        at the width ``resume_cap`` into the same template, built (captured)
        at its first use."""
        if self._resume is None:
            def resume():
                return self._prefill_fn(
                    self.serve_params, self.qparams,
                    {"tokens": self._res_toks}, self._slot_cache0,
                    self._res_len)

            self._resume = self._program("resume", resume)
        return self._resume

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- one serving session ----------------------------------------------
    def _fresh_rs(self, requests: Iterable[Request]) -> _RunState:
        B = self.max_slots
        return _RunState(
            pos=np.zeros((B,), np.int32), active=np.zeros((B,), bool),
            last_tok=np.zeros((B,), np.int64), slot_req=[None] * B,
            slot_out=[[] for _ in range(B)], slot_steps=[0] * B, done=[],
            n_blocks=0,
            arrivals=deque(sorted(requests, key=lambda r: r.arrive_ms)),
            pending=deque(), readmit=deque(), vclock=0.0,
            t_start=time.monotonic())

    def _knobs(self) -> dict:
        """The knobs a recovered run must share with the crashed one for
        replay to be bit-valid: the reference's dict, key for key, so a
        journal or snapshot of either package is checked the same way."""
        return {
            "max_slots": self.max_slots, "prompt_cap": self.prompt_cap,
            "block_steps": self.block_steps,
            "cache_layout": self.cache_layout,
            "page_size": (self.page_size if self.cache_layout == "paged"
                          else None),
            "cache_len": self.cache_len,
            "prefill_chunk": self.prefill_chunk, "mode": self.mode,
            "temperature": self.temperature, "top_p": self.top_p,
            "seed": self._seed, "eos_id": self.eos_id,
            "emit_width": self._emit_w,
        }

    def _check_knobs(self, knobs: dict):
        want = self._knobs()
        got = {k: knobs.get(k) for k in want}
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        if bad:
            raise ValueError(
                "recovery scheduler knobs do not match the crashed run's "
                "(replay would not be bit-valid): " +
                ", ".join(f"{k}: saved={s!r} vs live={l!r}"
                          for k, (s, l) in sorted(bad.items())))

    @torch.inference_mode()
    def run(self, requests: Iterable[Request],
            max_blocks: Optional[int] = None) -> list:
        """Serve ``requests`` to completion through the slot batch; returns
        Completions in finish order.  Requests become visible at their
        ``arrive_ms``, wait in the (optionally bounded) pending queue, and
        enter whenever a slot frees: highest priority first, first come
        first served within a priority, parked re-admissions first on ties.
        ``max_blocks`` bounds the decode blocks (None: drain); parked
        requests still waiting at the cut retire as 'preempted'.  With a
        journal the run is journaled as a new epoch; a ``FaultPlan.crash``
        boundary raises :class:`~repro_torch.launch.faults.SimulatedCrash`
        out of this method."""
        rs = self._fresh_rs(requests)
        self._rs = rs
        if self._journal is not None:
            self._epoch = max(self._epoch, self._journal.last_epoch()) + 1
            self._journal.begin(self._epoch, self._knobs())
            for req in rs.arrivals:
                self._journal.enqueue(req)
        return self._drive(max_blocks)

    @torch.inference_mode()
    def resume_run(self, max_blocks: Optional[int] = None) -> list:
        """Drive a restored run state (``load_state``) to completion; returns
        every completion of the logical run, those restored with the state
        included.  ``max_blocks`` counts the run's blocks from its start."""
        if self._rs is None:
            raise ValueError(
                "no run state to resume (call load_state(), recover(), "
                "or run() first)")
        return self._drive(max_blocks)

    def _drive(self, max_blocks: Optional[int] = None) -> list:
        """The host loop over ``self._rs`` (see ``run``), the reference's."""
        plan = self._plan
        B = self.max_slots
        rs = self._rs
        if self._block is None:
            self._programs()

        def now_ms() -> float:
            if plan.ms_per_block > 0:
                return rs.vclock
            return (time.monotonic() - rs.t_start) * 1e3

        def finish(req, out, why, status="ok", reason=None):
            c = Completion(req.rid, len(req.tokens), out, why, status=status,
                           reason=reason)
            rs.done.append(c)
            self._health[status] += 1
            if status == "ok":
                self._health[why] += 1
            if self._journal is not None:
                self._journal.retire(c)

        def retire(slot, why, status="ok", reason=None):
            finish(rs.slot_req[slot], rs.slot_out[slot], why, status, reason)
            rs.slot_req[slot] = None
            rs.slot_out[slot] = []
            rs.active[slot] = False
            if self._prefix is not None:
                self._prefix.release(slot)

        def overdue(req) -> bool:
            return (req.deadline_ms is not None
                    and now_ms() - req.arrive_ms >= req.deadline_ms)

        def resumable(slot) -> bool:
            # the parked state (prompt + generated minus the pending token)
            # must fit the resume prefill's buffer
            return int(rs.pos[slot]) <= self.resume_cap

        def preempt(slot):
            req = rs.slot_req[slot]
            # a copy: the slot's key row is the next resident's
            rs.readmit.append(_Parked(req=req, out=rs.slot_out[slot],
                                      key=self._keys[slot].to("cpu",
                                                              copy=True),
                                      steps=rs.slot_steps[slot]))
            self._health["preemptions"] += 1
            rs.slot_req[slot] = None
            rs.slot_out[slot] = []
            rs.active[slot] = False
            if self._prefix is not None:
                # drop the shared-page references and reclaim the table row
                # onto the slot's private pages before a new resident
                self._prefix.release(slot)
                self._set_row(slot, self._private_rows[slot])

        def reap_deadlines():
            for slot in range(B):
                req = rs.slot_req[slot]
                if req is not None and overdue(req):
                    self._health["deadline_misses"] += 1
                    retire(slot, "timeout", status="timeout",
                           reason=f"deadline {req.deadline_ms:g} ms "
                                  "exceeded while decoding")
            for q in (rs.pending, rs.readmit):
                kept = []
                for item in q:
                    req = item.req if isinstance(item, _Parked) else item
                    if overdue(req):
                        self._health["deadline_misses"] += 1
                        out = item.out if isinstance(item, _Parked) else []
                        finish(req, out, "timeout", status="timeout",
                               reason=f"deadline {req.deadline_ms:g} ms "
                                      "exceeded while queued")
                    else:
                        kept.append(item)
                q.clear()
                q.extend(kept)

        def ingest():
            while rs.arrivals and rs.arrivals[0].arrive_ms <= now_ms():
                if (self.queue_cap is not None
                        and len(rs.pending) >= self.queue_cap):
                    if self.shed_policy == "shed":
                        req = rs.arrivals.popleft()
                        finish(req, [], "shed", status="shed",
                               reason=f"admission queue full "
                                      f"(queue_cap={self.queue_cap})")
                        continue
                    break   # "block": arrivals wait upstream
                rs.pending.append(rs.arrivals.popleft())

        def next_waiter():
            """The highest-priority waiter; first come first served within
            a priority, parked re-admissions first on ties."""
            best = None     # (source, index, priority)
            for i, p in enumerate(rs.readmit):
                if best is None or p.req.priority > best[2]:
                    best = ("readmit", i, p.req.priority)
            for i, r in enumerate(rs.pending):
                if best is None or r.priority > best[2]:
                    best = ("pending", i, r.priority)
            if best is None:
                return None
            src, i, _ = best
            q = rs.readmit if src == "readmit" else rs.pending
            item = q[i]
            del q[i]
            return item

        def force_preempts():
            for rid in plan.preempts_at(rs.n_blocks):
                for slot in range(B):
                    req = rs.slot_req[slot]
                    if (req is not None and req.rid == rid
                            and resumable(slot)):
                        preempt(slot)

        def priority_preempt():
            """One preemption a boundary: when no slot is free and a waiter
            strictly outranks the lowest-priority resumable resident."""
            if not (rs.pending or rs.readmit):
                return
            if any(rs.slot_req[s] is None for s in range(B)):
                return
            waiter_pri = max([p.req.priority for p in rs.readmit]
                             + [r.priority for r in rs.pending])
            victims = [s for s in range(B)
                       if rs.slot_req[s] is not None and resumable(s)]
            if not victims:
                return
            s = min(victims, key=lambda s: (rs.slot_req[s].priority, s))
            if rs.slot_req[s].priority < waiter_pri:
                preempt(s)

        def seed_host_state(slot, req, out, key, steps):
            self._seed_slot(slot, req, out, key)
            rs.slot_req[slot] = req
            rs.slot_out[slot] = out
            rs.pos[slot] = len(req.tokens) + len(out) - 1
            rs.last_tok[slot] = int(out[-1])
            rs.active[slot] = True
            rs.slot_steps[slot] = steps

        def admit_free_slots():
            for slot in range(B):
                if rs.slot_req[slot] is not None:
                    continue
                while True:
                    item = next_waiter()
                    if item is None:
                        return
                    if isinstance(item, _Parked):
                        self._readmit(slot, item.req, item.out,
                                      recovered=item.recovered)
                        seed_host_state(slot, item.req, item.out, item.key,
                                        item.steps)
                        break
                    req = item
                    err = self._check(req)
                    if err is not None:
                        finish(req, [], "rejected", status="rejected",
                               reason=err)
                        continue
                    try:
                        t0, key = self._admit(slot, req)
                    except _ADMISSION_FAULTS as e:
                        # THIS request fails; the run keeps serving
                        finish(req, [], "failed", status="failed",
                               reason=f"{type(e).__name__}: {e}")
                        continue
                    seed_host_state(slot, req, [t0], key, steps=0)
                    if self.eos_id >= 0 and t0 == self.eos_id:
                        retire(slot, "eos")
                    elif req.max_gen <= 1:
                        retire(slot, "budget")
                    break

        while rs.arrivals or rs.pending or rs.readmit or rs.active.any():
            reap_deadlines()
            ingest()
            force_preempts()
            priority_preempt()
            admit_free_slots()
            if not rs.active.any():
                if rs.arrivals and not rs.pending and not rs.readmit:
                    # nothing runnable until the next arrival: advance the
                    # clock to it
                    if plan.ms_per_block > 0:
                        rs.vclock = max(rs.vclock, rs.arrivals[0].arrive_ms)
                    else:
                        time.sleep(min(1e-3, max(
                            0.0, (rs.arrivals[0].arrive_ms - now_ms())
                            * 1e-3)))
                continue

            # -- one decode block over the slot batch ----------------------
            # nan_step: the in-block step at which a scheduled decode fault
            # fires per slot (-1: none), data for the captured block
            nan_step = np.full((B,), -1, np.int32)
            for slot in range(B):
                req = rs.slot_req[slot]
                if req is None or not rs.active[slot]:
                    continue
                step = plan.nan_decode_step(req.rid)
                if step is not None:
                    rel = step - rs.slot_steps[slot]
                    if 0 <= rel < self.block_steps:
                        nan_step[slot] = rel
            ran = rs.active.copy()
            t0 = time.perf_counter()
            self._call_counts["decode"] += 1
            self._tok.copy_(torch.from_numpy(rs.last_tok))
            self._pos.copy_(torch.from_numpy(rs.pos))
            self._active.copy_(torch.from_numpy(rs.active))
            self._nan_step.copy_(torch.from_numpy(nan_step))
            toks, emitted, pos_d, active_d, bad_d = self._block()
            toks, emitted = toks.cpu().numpy(), emitted.cpu().numpy()
            pos_new, active_new = pos_d.cpu().numpy(), active_d.cpu().numpy()
            bad = bad_d.cpu().numpy()
            self._seconds["decode"] += time.perf_counter() - t0
            for slot in range(B):
                if ran[slot]:
                    rs.slot_steps[slot] += self.block_steps
            if self._emit_w > 1:
                # a window with any emission ran a live verify pass
                win = emitted.reshape(B, self.block_steps, self._emit_w)
                self._spec_windows += int(win.any(-1).sum())
                self._spec_emitted += int(emitted.sum())

            # -- collect emissions, retire finished slots ------------------
            for slot in range(B):
                req = rs.slot_req[slot]
                if req is None or not rs.active[slot]:
                    continue
                out = rs.slot_out[slot]
                # emission lanes are ragged within a speculative window:
                # skip the gaps
                for i in range(toks.shape[1]):
                    if len(out) >= req.max_gen:
                        break
                    if emitted[slot, i]:
                        out.append(int(toks[slot, i]))
                rs.pos[slot] = pos_new[slot]
                rs.last_tok[slot] = out[-1]
                # the finish reason follows what was COLLECTED: an EOS past
                # the budget cut is not part of the output
                if self.eos_id >= 0 and out[-1] == self.eos_id:
                    retire(slot, "eos")
                elif len(out) >= req.max_gen:
                    retire(slot, "budget")
                elif bad[slot]:
                    retire(slot, "failed", status="failed",
                           reason="non-finite logits during decode")
                elif not active_new[slot]:
                    retire(slot, "capacity")
            rs.n_blocks += 1
            if plan.ms_per_block > 0:
                rs.vclock += plan.ms_per_block
            # -- boundary commit: journal, snapshot cadence, crash ---------
            self._boundary_commit(rs, now_ms())
            if max_blocks is not None and rs.n_blocks >= max_blocks:
                break
        # parked requests the run never got back to are terminal too, with
        # their tokens so far
        while rs.readmit:
            p = rs.readmit.popleft()
            finish(p.req, p.out, "preempted", status="preempted",
                   reason="preempted; run ended before re-admission")
        if self._prefix is not None:
            # drop the references this run's slots held, so unused entries
            # stay evictable
            for slot in range(B):
                self._prefix.release(slot)
        return rs.done

    def _boundary_commit(self, rs: _RunState, clock_ms: float):
        """What makes a block boundary durable, in the journal's order:
        retirements were written as they happened; then progress (each
        resident's, then each parked request's), the ``block`` record, the
        periodic snapshot, and only then a scheduled simulated crash."""
        if self._journal is not None:
            keys = self._keys.cpu()
            for slot in range(self.max_slots):
                req = rs.slot_req[slot]
                if req is not None:
                    self._journal.progress(req.rid, rs.slot_out[slot],
                                           _key_list(keys[slot]),
                                           rs.slot_steps[slot])
            for p in rs.readmit:
                self._journal.progress(p.req.rid, p.out, _key_list(p.key),
                                       p.steps)
            self._journal.block(rs.n_blocks, clock_ms)
        if (self._snap_mgr is not None and self._snapshot_every > 0
                and rs.n_blocks % self._snapshot_every == 0):
            self.save_state()
        if self._plan.crash_at(rs.n_blocks):
            raise SimulatedCrash(
                f"simulated crash at decode-block boundary {rs.n_blocks} "
                "(recover on a fresh scheduler: recover() replays the "
                "journal, load_state() restores the last snapshot)")

    # -- crash recovery ----------------------------------------------------
    @torch.inference_mode()
    def recover(self, max_blocks: Optional[int] = None) -> list:
        """Journal-replay crash recovery on a FRESH scheduler pointed at the
        crashed run's journal; no device state is read back.  The journal's
        last epoch classifies every request: retired completions are
        re-emitted as they are; in-flight requests (resident or parked at
        the crash) park and rebuild their cache with one ``resume`` prefill
        over prompt + generated tokens, their carried keys from the journal;
        never-admitted requests re-enter the arrival queue.  The surviving
        state is first written as a fresh journal epoch, so a second crash
        stays recoverable.  Returns every completion of the logical run;
        ``max_blocks`` counts the run's blocks from its start."""
        if self._journal is None:
            raise ValueError(
                "recover() needs a journal: construct the scheduler with "
                "journal=<path of the crashed run's journal>")
        rp = self._journal.replay()
        self._check_knobs(rp.knobs)
        rs = self._fresh_rs([])
        rs.n_blocks = rp.n_blocks
        # the run clock resumes where the crash left it: a virtual clock
        # exactly, a wall clock offset by the journaled elapsed ms
        if self._plan.ms_per_block > 0:
            rs.vclock = rp.vclock
        rs.t_start = time.monotonic() - rp.vclock * 1e-3
        for d in rp.done:
            c = completion_from_dict(d)
            rs.done.append(c)
            # re-derive the terminal-status counters the crash erased
            self._health[c.status] += 1
            if c.status == "ok":
                self._health[c.finished_by] += 1
        for item in rp.inflight:
            req = request_from_dict(item["req"])
            out = [int(t) for t in item["out"]]
            if len(req.tokens) + len(out) - 1 <= self.resume_cap:
                rs.readmit.append(_Parked(
                    req=req, out=out, key=_key_tensor(item["key"]),
                    steps=int(item["steps"]), recovered=True))
            else:
                # too wide for the resume buffer (a crash cannot refuse, as
                # a preemption does): serve it again from its prompt, which
                # gives the same tokens (greedy) or the same stream (the
                # key restarts from fold_in(seed, rid))
                self._health["replayed_tokens"] += len(req.tokens) + len(out)
                rs.pending.append(req)
        rs.arrivals = deque(sorted(
            (request_from_dict(d) for d in rp.queued),
            key=lambda r: r.arrive_ms))
        self._health["recoveries"] += 1
        self._rs = rs
        self._epoch = max(self._epoch, rp.epoch)
        self._rewrite_epoch(rs)
        return self._drive(max_blocks)

    def _rewrite_epoch(self, rs: _RunState):
        """Start a journal epoch that states the surviving run (retirements,
        in-flight progress, queued requests), so replay after a second
        crash sees one complete epoch."""
        j = self._journal
        if j is None:
            return
        self._epoch = max(self._epoch, j.last_epoch()) + 1
        j.begin(self._epoch, self._knobs(), recovered=True)
        for c in rs.done:
            j.retire(c)
        keys = self._keys.cpu()
        for slot in range(self.max_slots):
            req = rs.slot_req[slot]
            if req is not None:
                j.enqueue(req)
                j.progress(req.rid, rs.slot_out[slot], _key_list(keys[slot]),
                           rs.slot_steps[slot])
        for p in rs.readmit:
            j.enqueue(p.req)
            j.progress(p.req.rid, p.out, _key_list(p.key), p.steps)
        for req in list(rs.pending) + list(rs.arrivals):
            j.enqueue(req)
        j.block(rs.n_blocks, rs.vclock)

    # -- full-state snapshot (through CheckpointManager) --------------------
    @torch.inference_mode()
    def save_state(self) -> str:
        """Write a full snapshot of the serving state at ``snapshot_dir``:
        every cache layer's ``state_dict`` (tiles, scales, block table), the
        host decode vectors (positions, live mask, pending tokens, the
        slots' keys and history), the run's bookkeeping (residents, queues,
        parked requests, completions, block counter, clock), the prefix
        store and the health counters.  Atomic and keep-3 through
        ``CheckpointManager``.  Returns the checkpoint's path."""
        if self._snap_mgr is None:
            raise ValueError(
                "save_state() needs a snapshot_dir (construct the "
                "scheduler with snapshot_dir=...)")
        rs = self._rs if self._rs is not None else self._fresh_rs([])
        tree = {
            "cache": {str(i): c.state_dict()
                      for i, c in enumerate(layer_caches(self._cache))},
            "host": {"pos": rs.pos, "active": rs.active,
                     "last_tok": rs.last_tok, "slot_keys": self._keys,
                     "hist": self._hist},
        }
        clock_ms = (rs.vclock if self._plan.ms_per_block > 0
                    else (time.monotonic() - rs.t_start) * 1e3)

        def parked_d(p: _Parked) -> dict:
            return {"req": request_to_dict(p.req),
                    "out": [int(t) for t in p.out], "key": _key_list(p.key),
                    "steps": int(p.steps), "recovered": bool(p.recovered)}

        state = {
            "knobs": self._knobs(),
            "slot_req": [None if r is None else request_to_dict(r)
                         for r in rs.slot_req],
            "slot_out": [[int(t) for t in out] for out in rs.slot_out],
            "slot_steps": [int(s) for s in rs.slot_steps],
            "done": [completion_to_dict(c) for c in rs.done],
            "arrivals": [request_to_dict(r) for r in rs.arrivals],
            "pending": [request_to_dict(r) for r in rs.pending],
            "readmit": [parked_d(p) for p in rs.readmit],
            "n_blocks": int(rs.n_blocks), "clock_ms": float(clock_ms),
            "health": {k: int(v) for k, v in self._health.items()},
            "epoch": int(self._epoch),
        }
        if self._prefix is not None:
            psd = self._prefix.state_dict()
            # the logits go through the array tree (entry i's at
            # prefix_logits/i), the rest stays JSON
            tree["prefix_logits"] = {
                str(i): e.pop("logits") for i, e in enumerate(psd["entries"])}
            state["prefix"] = psd
        self._snap_step = max([self._snap_step]
                              + self._snap_mgr.list_steps()) + 1
        return self._snap_mgr.save(self._snap_step, tree,
                                   metadata={"state": state})

    @torch.inference_mode()
    def load_state(self) -> int:
        """Restore the newest committed snapshot at ``snapshot_dir`` into
        THIS scheduler (typically a fresh one standing in for a crashed
        process): the saved arrays are copied into the scheduler's own
        cache, key and history tensors (``load_state_dict_``), which the
        captured decode block reads.  Knobs must match the saving
        scheduler's.  Follow with :meth:`resume_run`; decode continues at
        the snapshot's block boundary.  Returns the restored block
        counter."""
        if self._snap_mgr is None:
            raise ValueError(
                "load_state() needs a snapshot_dir (construct the "
                "scheduler with snapshot_dir=...)")
        tree, meta = self._snap_mgr.restore_latest()
        if tree is None:
            raise FileNotFoundError(
                f"no committed snapshot under {self._snap_mgr.dir}")
        st = meta["state"]
        self._check_knobs(st["knobs"])
        live, saved = list(layer_caches(self._cache)), tree["cache"]
        if len(saved) != len(live):
            raise ValueError(
                f"snapshot has {len(saved)} cache layers, scheduler has "
                f"{len(live)} (wrong snapshot for this config?)")
        host = tree["host"]
        for name, t in (("slot_keys", self._keys), ("hist", self._hist)):
            a = host[name]
            if a.shape != t.shape or a.dtype != t.dtype:
                raise ValueError(f"snapshot {name} is {tuple(a.shape)}/"
                                 f"{a.dtype}, the scheduler holds "
                                 f"{tuple(t.shape)}/{t.dtype}")
        # every layer is checked before any is written
        for i, c in enumerate(live):
            c.check_state_dict(saved[str(i)])
        for i, c in enumerate(live):
            c.load_state_dict_(saved[str(i)])
        self._keys.copy_(host["slot_keys"])
        self._hist.copy_(host["hist"])
        rs = self._fresh_rs([])
        rs.pos = host["pos"].numpy().astype(np.int32)
        rs.active = host["active"].numpy().astype(bool)
        rs.last_tok = host["last_tok"].numpy().astype(np.int64)
        rs.slot_req = [None if d is None else request_from_dict(d)
                       for d in st["slot_req"]]
        rs.slot_out = [[int(t) for t in out] for out in st["slot_out"]]
        rs.slot_steps = [int(s) for s in st["slot_steps"]]
        rs.done = [completion_from_dict(d) for d in st["done"]]
        rs.arrivals = deque(request_from_dict(d) for d in st["arrivals"])
        rs.pending = deque(request_from_dict(d) for d in st["pending"])
        rs.readmit = deque(
            _Parked(req=request_from_dict(p["req"]),
                    out=[int(t) for t in p["out"]], key=_key_tensor(p["key"]),
                    steps=int(p["steps"]),
                    recovered=bool(p.get("recovered", False)))
            for p in st["readmit"])
        rs.n_blocks = int(st["n_blocks"])
        clock_ms = float(st["clock_ms"])
        if self._plan.ms_per_block > 0:
            rs.vclock = clock_ms
        rs.t_start = time.monotonic() - clock_ms * 1e-3
        self._health = {k: int(st["health"].get(k, 0)) for k in _HEALTH_KEYS}
        self._health["recoveries"] += 1
        self._epoch = int(st["epoch"])
        if self._prefix is not None and "prefix" in st:
            psd = dict(st["prefix"])
            logits = tree.get("prefix_logits", {})
            psd["entries"] = [{**e, "logits": logits[str(i)]}
                              for i, e in enumerate(psd["entries"])]
            self._prefix.load_state_dict(psd, device=self.device)
        self._rs = rs
        # the restored state supersedes whatever epoch the journal holds
        self._rewrite_epoch(rs)
        return rs.n_blocks

    # -- admission ---------------------------------------------------------
    def _check(self, req: Request) -> Optional[str]:
        """A rejection reason, or None for a request that can be served."""
        n = len(req.tokens)
        if n > self.prompt_cap:
            return f"prompt length {n} exceeds prompt_cap {self.prompt_cap}"
        if n < 1:
            return "empty prompt"
        if req.max_gen < 1:
            return ("max_gen must be >= 1 (the first token is sampled at "
                    "admission)")
        return None

    def _request_keys(self, rid: int):
        """A request's (first-token key, carried slot key): one split of
        ``fold_in(PRNGKey(seed), rid)``, so its sample stream does not
        depend on arrival order or slot placement."""
        ks = prng.split(prng.fold_in(self._base_key, rid))
        return ks[0].to(self.device), ks[1]

    def _first_token(self, logits, key) -> int:
        """The first token from a prompt's last logits (1, 1, Vp): argmax,
        or sampled with the request's first-token key."""
        return int(SG.sample_tokens(logits[:, -1], key,
                                    temperature=self.temperature,
                                    top_p=self.top_p)[0])

    def _seed_slot(self, slot: int, req: Request, out: list, key):
        """A resident's device state beside the cache: its carried key and
        (speculative) its history, the prompt and the generated tokens
        (the pending one last) at their positions."""
        self._keys[slot].copy_(key)
        if self._hist.shape[1]:
            seq = np.concatenate([np.asarray(req.tokens, np.int64),
                                  np.asarray(out, np.int64)])
            self._hist[slot].zero_()
            self._hist[slot, :len(seq)].copy_(torch.from_numpy(seq))

    def _splice(self, slot: int, slot_cache):
        """The template's tiles into the slot: its batch row (dense), or
        its private pages and its table row pointed back at them (paged).
        Returns the private row (paged) or None."""
        self._call_counts["insert"] += 1
        pairs = zip(layer_caches(self._cache), layer_caches(slot_cache))
        if self._prefix is None:
            for big, small in pairs:
                big.splice_slot(small, slot)
            return None
        row = self._private_rows[slot]
        for big, small in pairs:
            splice_dense_into_pages(big, small, row)
        self._set_row(slot, row)
        return row

    def _admit(self, slot: int, req: Request):
        """Admit ``req`` into ``slot``; returns (its first generated token,
        its carried key).
        Dense: chunked-prefill the prompt into the batch-1 template and
        splice it into the slot's row.  Paged: a prefix-store hit attaches
        the shared pages (no prefill); a miss prefills, scatters into the
        slot's private pages and registers the prompt.  Raises
        ``InjectedFault`` (the plan's ``reject``) before any device work
        and ``FloatingPointError`` on non-finite prefill logits (or the
        plan's ``nan_prefill``) before anything reaches the resident
        cache."""
        t_start = time.perf_counter()
        if self._plan.rejects(req.rid):
            raise InjectedFault(
                f"request {req.rid}: injected admission failure")
        k_t0, k_carry = self._request_keys(req.rid)
        n = len(req.tokens)
        key = tuple(int(t) for t in np.asarray(req.tokens))
        entry = (self._prefix.lookup(key, slot)
                 if self._prefix is not None else None)
        if entry is not None:
            t0 = self._attach_prefix(slot, entry, k_t0)
        else:
            self._adm_toks.zero_()
            self._adm_toks[0, :n].copy_(torch.from_numpy(
                np.asarray(req.tokens, dtype=np.int64)))
            self._adm_len.fill_(n)
            self._call_counts["prefill"] += 1
            # the program's outputs: the next admission rewrites them
            logits, slot_cache = self._admission()
            finite = bool(torch.isfinite(logits[:, -1]).all())
            if self._plan.nans_prefill(req.rid) or not finite:
                raise FloatingPointError(
                    f"request {req.rid}: non-finite prefill logits")
            row = self._splice(slot, slot_cache)
            if row is not None:
                self._register_prefix(key, n, row, logits.clone())
            t0 = self._first_token(logits, k_t0)
        self._seconds["admit"] += time.perf_counter() - t_start
        return t0, k_carry

    def _readmit(self, slot: int, req: Request, out: list,
                 recovered: bool = False):
        """Rebuild a parked request's cache in ``slot``: one ragged prefill
        (the ``resume`` program, at ``resume_cap``) over the prompt and the
        generated tokens but the pending one, spliced as an admission is.
        The frozen scales make the recomputed tiles those decode wrote (on
        the CPU bit for bit; on the card up to the decode and prefill
        kernels' summation orders), so decode continues where it stopped.
        Prefix pages are not consulted: the sequence holds generated
        tokens.  Counts ``readmits``, or ``replayed_tokens`` when crash
        recovery parked the request."""
        prog = self._resume_program()
        t_start = time.perf_counter()
        # the pending token is not in the cache yet
        n = len(req.tokens) + len(out) - 1
        seq = np.concatenate([np.asarray(req.tokens, np.int64),
                              np.asarray(out[:-1], np.int64)])
        self._res_toks.zero_()
        self._res_toks[0, :n].copy_(torch.from_numpy(seq))
        self._res_len.fill_(n)
        self._call_counts["resume"] += 1
        _, slot_cache = prog()
        self._splice(slot, slot_cache)
        self._sync()
        self._seconds["resume"] += time.perf_counter() - t_start
        if recovered:
            self._health["replayed_tokens"] += n
        else:
            self._health["readmits"] += 1

    # -- paged plumbing ----------------------------------------------------
    def _set_row(self, slot: int, row):
        self._call_counts["set_row"] += 1
        row = torch.as_tensor(np.asarray(row), dtype=torch.int32,
                              device=self.device)
        for c in layer_caches(self._cache):
            set_table_row(c, slot, row)

    def _copy_pages(self, pairs: list):
        """One copy of the (src, dst) page pairs in every layer's pool."""
        if not pairs:
            return
        self._call_counts["copy_page"] += 1
        src = torch.tensor([p[0] for p in pairs], device=self.device)
        dst = torch.tensor([p[1] for p in pairs], device=self.device)
        for c in layer_caches(self._cache):
            copy_pages(c, src, dst)

    def _register_prefix(self, key, n, private_row, logits):
        """Copy the freshly prefilled prompt's pages into the shared region
        and keep its last-position logits, so a later identical prompt
        skips prefill.  Skipped (and counted in ``prefix_exhausted``) when
        the shared region has no free or evictable pages, or the fault plan
        exhausts it: the admission already lives in private pages."""
        alloc = (None if self._plan.exhaust_prefix
                 else self._prefix.reserve(key, n))
        if alloc is None:
            self._health["prefix_exhausted"] += 1
            return
        pages, tail = alloc
        pairs = [(int(private_row[j]), int(dst))
                 for j, dst in enumerate(pages)]
        if tail is not None:
            pairs.append((int(private_row[len(pages)]), int(tail)))
        self._copy_pages(pairs)
        self._prefix.register(key, PrefixEntry(pages=pages, tail_page=tail,
                                               length=n, logits=logits))

    def _attach_prefix(self, slot: int, entry: PrefixEntry, k_t0) -> int:
        """Full-prompt hit: point the slot's table row at the shared pages;
        the partial tail page (decode's first append target) is copied into
        the slot's private page, so shared pages stay immutable."""
        row = self._private_rows[slot].copy()
        n_full = len(entry.pages)
        row[:n_full] = entry.pages
        self._set_row(slot, row)
        if entry.tail_page is not None:
            self._copy_pages([(int(entry.tail_page),
                               int(self._private_rows[slot][n_full]))])
        return self._first_token(entry.logits, k_t0)
