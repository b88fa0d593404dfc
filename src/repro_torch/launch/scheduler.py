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
request's tokens depend on (seed, rid, prompt) and not on its arrival order
or slot, as in the reference.  The per-slot keys and the speculative
history (absolute position -> token, seeded with the prompt and the first
token at admission) live on the device and go through the captured block;
``spec_stats()`` counts the verify windows and their tokens.

Every request retires with a status: ``ok`` (``finished_by`` eos, budget
or capacity), ``rejected`` (failed validation, never touched the device)
or ``failed`` (non-finite prefill or decode logits; only that slot stops).
Deadlines, priorities with preemption and the ``resume`` prefill, the
bounded queue, fault injection, the journal and snapshots are ROADMAP
Queue A item 14; asking for them raises ``NotImplementedError``.

As the reference jits its admission prefill and its scanned decode block,
the scheduler runs both as programs (``launch/graphs.py``) over static
buffers: the batch-1 admission prefill at ``prompt_cap`` into the
admission template, and the ``block_steps`` steps of the decode block over
the batch cache.  On CUDA both are captured at the first ``run`` (its
``stage_seconds()["compile"]``), and admissions and blocks replay them;
the host reads after each block and each admission (one synchronization
each) are the reference's.  The reference counts compiled executables;
the port counts calls (``call_counts``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.cache import (PrefixEntry, PrefixStore, copy_pages,
                               layer_caches, set_table_row,
                               splice_dense_into_pages)
from repro_torch.core import api as A
from repro_torch.launch import prng
from repro_torch.launch import steps as ST
from repro_torch.launch import strategies as SG
from repro_torch.launch.graphs import Program

# knobs of the reference scheduler that are not ported, and the ROADMAP
# Queue A item that ports each
_NOT_PORTED = {
    "queue_cap": "item 14 (resilience)",
    "shed_policy": "item 14 (resilience)",
    "fault_plan": "item 14 (resilience)",
    "journal": "item 14 (durability)",
    "snapshot_every": "item 14 (durability)",
    "snapshot_dir": "item 14 (durability)",
}


@dataclasses.dataclass
class Request:
    """One generation request: prompt tokens and a generation budget
    (``max_gen`` counts the first token).  ``arrive_ms`` places it on the
    run's wall clock (ms from the run's start); it is invisible to the
    scheduler before then.  ``priority`` and ``deadline_ms`` (preemption
    and deadlines) are ROADMAP Queue A item 14 and must stay at their
    defaults."""
    rid: int
    tokens: np.ndarray          # (prompt_len,) int
    max_gen: int = 16
    priority: int = 0
    deadline_ms: Optional[float] = None
    arrive_ms: float = 0.0

    def __post_init__(self):
        if self.priority != 0 or self.deadline_ms is not None:
            raise NotImplementedError(
                "request priorities and deadlines are not ported (ROADMAP "
                "Queue A item 14)")


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: list                # generated tokens (includes an EOS if hit)
    finished_by: str            # 'eos' | 'budget' | 'capacity' when ok,
                                # else the status
    status: str = "ok"          # ok | rejected | failed
    reason: Optional[str] = None    # failure detail


_STATUSES = ("ok", "rejected", "failed")
_HEALTH_KEYS = _STATUSES + ("eos", "budget", "capacity", "prefix_exhausted")


@dataclasses.dataclass
class _RunState:
    """The host state of one ``run``."""
    pos: np.ndarray             # (B,) int32 valid cache entries per slot
    active: np.ndarray          # (B,) bool
    last_tok: np.ndarray        # (B,) int64 pending token per slot
    slot_req: list              # per-slot Request (None = free)
    slot_out: list              # per-slot generated tokens (incl. pending)
    done: list                  # Completions, in finish order
    n_blocks: int               # decode blocks run
    arrivals: deque             # not yet arrived, by arrive_ms
    pending: deque              # arrived, waiting for a slot
    t_start: float              # wall-clock origin of the run


class SlotScheduler:
    """Continuous batching: admit and retire requests through a fixed slot
    batch.

    ``max_slots`` is the decode batch; ``prompt_cap`` the longest prompt
    (every prompt pads to it, rounded up to a ``prefill_chunk`` multiple;
    ``prefill_chunk`` None picks max(8, min(16, prompt_cap)));
    ``gen_cap`` the generation headroom each slot reserves; ``block_steps``
    the decode-block length (admission happens between blocks).
    ``cache_layout`` is "dense" or "paged" ("ring" is dense here: the
    scheduler needs absolute slots); ``page_size`` and ``prefix_pages``
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
    admission prefill and the decode block eagerly on CUDA too (the
    engine's explicit branch for what it does not capture)."""

    def __init__(self, model, cfg, policy: A.QuantPolicy, serve_params,
                 qparams, *, mode: str = "int8", device=None,
                 capture: bool = True, max_slots: int = 4,
                 prompt_cap: int = 64, gen_cap: int = 32,
                 prefill_chunk: int | None = None, block_steps: int = 8,
                 cache_layout: str = "dense", page_size: int = 64,
                 prefix_pages: int | None = None, eos_id: int = -1,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0, strategy=None, spec_k: int = 4,
                 spec_ngram: int = 2, **not_ported):
        for name in not_ported:
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected argument {name!r}")
            raise NotImplementedError(
                f"scheduler option {name!r} is not ported (ROADMAP Queue A "
                f"{_NOT_PORTED[name]})")
        if cache_layout == "ring":
            cache_layout = "dense"   # the port has no windows: ring == dense
        if cache_layout not in ("dense", "paged"):
            raise ValueError(f"slot scheduler cache_layout must be dense or "
                             f"paged, got {cache_layout!r}")
        if max_slots < 1 or block_steps < 1:
            raise ValueError(f"max_slots ({max_slots}) and block_steps "
                             f"({block_steps}) must be >= 1")
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
        # the widest state a re-admission prefill rebuilds (preemption,
        # item 14): the largest chunk multiple that fits the cache
        self.resume_cap = (cache_len // prefill_chunk) * prefill_chunk
        self._n_blocks = cache_len // page_size if cache_layout == "paged" \
            else 0
        if prefix_pages is None:
            prefix_pages = 2 * self._n_blocks
        self._prefix_pages = prefix_pages if cache_layout == "paged" else 0
        kv = dict(kv_int8=bool(policy.kv_int8), dtype=cfg.dtype)
        with torch.inference_mode():
            # batch-1 admission template: DENSE whatever the batch layout;
            # each admission's prefill writes into it and the splice
            # re-homes the tiles
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
        pieces = ["prefill", "decode", "insert"]
        if cache_layout == "paged":
            pieces += ["set_row", "copy_page"]
        self._call_counts = {p: 0 for p in pieces}
        self._seconds = {"admit": 0.0, "decode": 0.0, "compile": 0.0}
        self._health = {k: 0 for k in _HEALTH_KEYS}
        self._prefill_fn = ST.make_prefill_step(model, policy,
                                                prefill_chunk=prefill_chunk,
                                                mode=mode)
        self._decode_fn = SG.make_strategy_slot_loop(
            model, policy, strategy, n_steps=block_steps, eos_id=eos_id)
        # the programs' static inputs: the admission's padded prompt and
        # length, the slots' pending tokens, positions and live mask
        dev = self.device
        self._adm_toks = torch.zeros((1, self.prompt_cap), dtype=torch.long,
                                     device=dev)
        self._adm_len = torch.ones((1,), dtype=torch.int32, device=dev)
        self._tok = torch.zeros((max_slots,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((max_slots,), dtype=torch.bool, device=dev)
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
        self._admission = self._block = None    # built at the first run

    # -- observability ----------------------------------------------------
    def call_counts(self) -> dict:
        """Invocations per piece.  ``prefill`` counts the admissions that
        ran the model: a prefix-store hit admits without one."""
        return dict(self._call_counts)

    def prefix_stats(self) -> dict:
        """Prefix-sharing counters (paged layout; empty for dense)."""
        return self._prefix.stats() if self._prefix is not None else {}

    def health_stats(self) -> dict:
        """Cumulative counters over this scheduler's runs: terminal
        statuses (``ok``/``rejected``/``failed``), ok retirement causes
        (``eos``/``budget``/``capacity``) and ``prefix_exhausted``
        (registrations skipped for want of shared pages)."""
        return dict(self._health)

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
        """Cumulative wall seconds in admissions and in decode blocks; each
        ends when its result reaches the host, so each includes the
        device's work.  ``compile``: the warm-up and capture of the two
        programs (0.0 on the CPU and when nothing is captured)."""
        return dict(self._seconds)

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
                self._pos, self._active, self._keys, self._hist)
            self._keys.copy_(keys)
            self._hist.copy_(hist)
            return toks, emitted, pos, active, bad

        self._active.zero_()
        self._admission = Program(admission, self.device,
                                  capture=self._capture)
        self._block = Program(block, self.device, capture=self._capture)
        self._seconds["compile"] += (self._admission.capture_s
                                     + self._block.capture_s)

    # -- one serving session ----------------------------------------------
    @torch.inference_mode()
    def run(self, requests: Iterable[Request],
            max_blocks: Optional[int] = None) -> list:
        """Serve ``requests`` to completion through the slot batch; returns
        Completions in finish order.  Requests become visible at their
        ``arrive_ms`` and enter, first come first served, whenever a slot
        is free.  ``max_blocks`` bounds the decode blocks (None: drain)."""
        B = self.max_slots
        if self._block is None:
            self._programs()
        rs = _RunState(
            pos=np.zeros((B,), np.int32), active=np.zeros((B,), bool),
            last_tok=np.zeros((B,), np.int64), slot_req=[None] * B,
            slot_out=[[] for _ in range(B)], done=[], n_blocks=0,
            arrivals=deque(sorted(requests, key=lambda r: r.arrive_ms)),
            pending=deque(), t_start=time.monotonic())

        def now_ms() -> float:
            return (time.monotonic() - rs.t_start) * 1e3

        def finish(req, out, why, status="ok", reason=None):
            rs.done.append(Completion(req.rid, len(req.tokens), out, why,
                                      status=status, reason=reason))
            self._health[status] += 1
            if status == "ok":
                self._health[why] += 1

        def retire(slot, why, status="ok", reason=None):
            finish(rs.slot_req[slot], rs.slot_out[slot], why, status, reason)
            rs.slot_req[slot] = None
            rs.slot_out[slot] = []
            rs.active[slot] = False
            if self._prefix is not None:
                self._prefix.release(slot)

        def admit_free_slots():
            for slot in range(B):
                if rs.slot_req[slot] is not None:
                    continue
                while rs.pending:
                    req = rs.pending.popleft()
                    err = self._check(req)
                    if err is not None:
                        finish(req, [], "rejected", status="rejected",
                               reason=err)
                        continue
                    try:
                        t0, key = self._admit(slot, req)
                    except FloatingPointError as e:
                        # non-finite prefill logits fail THIS request; the
                        # run keeps serving
                        finish(req, [], "failed", status="failed",
                               reason=f"{type(e).__name__}: {e}")
                        continue
                    self._seed_slot(slot, req, t0, key)
                    rs.slot_req[slot] = req
                    rs.slot_out[slot] = [t0]
                    rs.pos[slot] = len(req.tokens)
                    rs.last_tok[slot] = t0
                    rs.active[slot] = True
                    if self.eos_id >= 0 and t0 == self.eos_id:
                        retire(slot, "eos")
                    elif req.max_gen <= 1:
                        retire(slot, "budget")
                    break

        while rs.arrivals or rs.pending or rs.active.any():
            while rs.arrivals and rs.arrivals[0].arrive_ms <= now_ms():
                rs.pending.append(rs.arrivals.popleft())
            admit_free_slots()
            if not rs.active.any():
                if rs.arrivals and not rs.pending:
                    # nothing runnable until the next arrival
                    time.sleep(min(1e-3, max(
                        0.0, (rs.arrivals[0].arrive_ms - now_ms()) * 1e-3)))
                continue

            # -- one decode block over the slot batch ----------------------
            t0 = time.perf_counter()
            self._call_counts["decode"] += 1
            self._tok.copy_(torch.from_numpy(rs.last_tok))
            self._pos.copy_(torch.from_numpy(rs.pos))
            self._active.copy_(torch.from_numpy(rs.active))
            toks, emitted, pos_d, active_d, bad_d = self._block()
            toks, emitted = toks.cpu().numpy(), emitted.cpu().numpy()
            pos_new, active_new = pos_d.cpu().numpy(), active_d.cpu().numpy()
            bad = bad_d.cpu().numpy()
            self._seconds["decode"] += time.perf_counter() - t0
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
            if max_blocks is not None and rs.n_blocks >= max_blocks:
                break
        if self._prefix is not None:
            # drop the references this run's slots held, so unused entries
            # stay evictable
            for slot in range(B):
                self._prefix.release(slot)
        return rs.done

    # -- admission ---------------------------------------------------------
    def _check(self, req: Request) -> Optional[str]:
        """A rejection reason, or None for a request that can be served."""
        n = len(req.tokens)
        if n > self.prompt_cap:
            return f"prompt length {n} exceeds prompt_cap {self.prompt_cap}"
        if n < 1:
            return "empty prompt"
        if req.max_gen < 1:
            return ("max_gen must be >= 1 (the first token is taken at "
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

    def _seed_slot(self, slot: int, req: Request, t0: int, key):
        """The admitted request's device state beside the cache: its carried
        key and (speculative) its history, the prompt and the first token
        at their positions."""
        self._keys[slot].copy_(key)
        if self._hist.shape[1]:
            seq = np.concatenate([np.asarray(req.tokens, np.int64), [t0]])
            self._hist[slot].zero_()
            self._hist[slot, :len(seq)].copy_(torch.from_numpy(seq))

    def _admit(self, slot: int, req: Request):
        """Admit ``req`` into ``slot``; returns (its first generated token,
        its carried key).
        Dense: chunked-prefill the prompt into the batch-1 template and
        splice it into the slot's row.  Paged: a prefix-store hit attaches
        the shared pages (no prefill); a miss prefills, scatters into the
        slot's private pages and registers the prompt.  Raises
        FloatingPointError on non-finite prefill logits, before anything
        reaches the resident cache."""
        t_start = time.perf_counter()
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
            if not bool(torch.isfinite(logits[:, -1]).all()):
                raise FloatingPointError(
                    f"request {req.rid}: non-finite prefill logits")
            self._call_counts["insert"] += 1
            pairs = zip(layer_caches(self._cache), layer_caches(slot_cache))
            if self._prefix is None:
                for big, small in pairs:
                    big.splice_slot(small, slot)
            else:
                row = self._private_rows[slot]
                for big, small in pairs:
                    splice_dense_into_pages(big, small, row)
                self._set_row(slot, row)
                self._register_prefix(key, n, row, logits.clone())
            t0 = self._first_token(logits, k_t0)
        self._seconds["admit"] += time.perf_counter() - t_start
        return t0, k_carry

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
        the shared region has no free or evictable pages: the admission
        already lives in private pages."""
        alloc = self._prefix.reserve(key, n)
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
