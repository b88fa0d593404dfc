"""Write-ahead request journal: crash recovery without device snapshots.

Counterpart of ``repro/launch/journal.py``, kept as its own copy (plain
Python, no torch), with the same record schema, so a journal written by
either package replays in the other.  The paper's §2 thresholds are
calibrated once and frozen, so the quantized KV cache is a pure function
of the token sequence: a crashed serving process needs no device state
back.  A host-side journal of tokens rebuilds every in-flight request with
one ragged prefill (the scheduler's ``resume`` program) and decoding
continues where it stopped.

Record schema (one JSON object per line, append-only)::

    begin     {"t": "begin", "epoch": N, "recovered": bool, "knobs": {...}}
              starts an epoch; replay reads only the LAST epoch (recovery
              rewrites the surviving state as a fresh epoch, so the
              journal stays replayable across repeated crashes)
    enqueue   {"t": "enqueue", "req": {rid, tokens, max_gen, priority,
              deadline_ms, arrive_ms}, "hash": sha}
              a request became known to the scheduler; ``hash`` is the
              prompt digest, verified at replay
    progress  {"t": "progress", "rid": r, "out": [...], "key": [k0, k1],
              "steps": n}
              a resident's full host state: every token generated so far
              (including the pending one not yet in the cache), the
              carried per-request sampling key as two uint32 words (the
              port's keys are int64 tensors holding those words,
              ``launch/prng.py``; the scheduler converts at this edge),
              and the decode step count.  Absolute, not a delta: the
              newest record per rid alone rebuilds the request
    retire    {"t": "retire", "c": {rid, prompt_len, tokens, finished_by,
              status, reason}}
              a terminal completion (replay re-emits it)
    block     {"t": "block", "n": n_blocks, "vclock": v}
              a decode-block boundary committed; ``vclock`` is the run
              clock at the boundary (virtual ms under a fault plan's
              ``ms_per_block``, else wall ms since the run's start).
              Written last at each boundary, so a simulated crash always
              leaves the boundary's retire/progress records durable

Write order at a boundary is retire -> progress -> block; every write is
flushed, so the only loss mode is a torn trailing line, which ``replay``
tolerates (any earlier corruption raises).

Replay classifies the last epoch's requests: ``done`` (retired),
``inflight`` (progressed, not retired: resident or parked at the crash),
and ``queued`` (enqueued, never admitted).  ``SlotScheduler.recover``
turns that into a live run state and drives it to completion.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

JOURNAL_VERSION = 1


def prompt_hash(tokens) -> str:
    """Digest of a prompt token sequence (journal integrity check)."""
    raw = ",".join(str(int(t)) for t in tokens).encode()
    return hashlib.sha256(raw).hexdigest()[:16]


def request_to_dict(req) -> dict:
    return {
        "rid": int(req.rid),
        "tokens": [int(t) for t in req.tokens],
        "max_gen": int(req.max_gen),
        "priority": int(req.priority),
        "deadline_ms": (None if req.deadline_ms is None
                        else float(req.deadline_ms)),
        "arrive_ms": float(req.arrive_ms),
    }


def request_from_dict(d: dict):
    import numpy as np

    from repro_torch.launch.scheduler import Request

    return Request(
        rid=int(d["rid"]),
        tokens=np.asarray(d["tokens"], np.int32),
        max_gen=int(d["max_gen"]), priority=int(d["priority"]),
        deadline_ms=d["deadline_ms"], arrive_ms=float(d["arrive_ms"]))


def completion_to_dict(c) -> dict:
    return {"rid": int(c.rid), "prompt_len": int(c.prompt_len),
            "tokens": [int(t) for t in c.tokens],
            "finished_by": c.finished_by, "status": c.status,
            "reason": c.reason}


def completion_from_dict(d: dict):
    from repro_torch.launch.scheduler import Completion

    return Completion(
        rid=int(d["rid"]), prompt_len=int(d["prompt_len"]),
        tokens=[int(t) for t in d["tokens"]],
        finished_by=d["finished_by"], status=d["status"],
        reason=d.get("reason"))


@dataclasses.dataclass
class JournalReplay:
    """The last epoch's surviving state (see module docstring)."""
    epoch: int
    recovered: bool             # the epoch itself was written by a recovery
    knobs: dict                 # scheduler knobs recorded at begin()
    done: list                  # retire payload dicts, in retirement order
    inflight: list              # {"req": dict, "out": [...], "key": [...],
    #                              "steps": n} — newest progress per rid,
    #                              ordered by last journal appearance
    queued: list                # request dicts, enqueue order
    n_blocks: int               # last committed decode-block boundary
    vclock: float               # run clock (virtual or wall ms) there


class RequestJournal:
    """Append-only JSONL write-ahead journal (one file per serving run).

    Writes are line-granular and flushed immediately: the journal is the
    durability root, so a record either fully lands or is a torn trailing
    line that replay drops.  ``close()`` (or context exit) releases the
    file handle; appending reopens lazily.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._f = None

    # -- writes ------------------------------------------------------------
    def _append(self, rec: dict):
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a")
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def begin(self, epoch: int, knobs: dict, *, recovered: bool = False):
        self._append({"t": "begin", "v": JOURNAL_VERSION,
                      "epoch": int(epoch), "recovered": bool(recovered),
                      "knobs": knobs})

    def enqueue(self, req):
        d = request_to_dict(req)
        self._append({"t": "enqueue", "req": d,
                      "hash": prompt_hash(d["tokens"])})

    def progress(self, rid: int, out, key, steps: int):
        self._append({"t": "progress", "rid": int(rid),
                      "out": [int(t) for t in out],
                      "key": [int(k) for k in key], "steps": int(steps)})

    def retire(self, completion):
        self._append({"t": "retire", "c": completion_to_dict(completion)})

    def block(self, n_blocks: int, vclock: float):
        self._append({"t": "block", "n": int(n_blocks),
                      "vclock": float(vclock)})

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- replay ------------------------------------------------------------
    def last_epoch(self) -> int:
        """Newest epoch number in the journal (0 if none/absent)."""
        try:
            return self.replay().epoch
        except FileNotFoundError:
            return 0

    def replay(self) -> JournalReplay:
        """Parse the journal and rebuild the last epoch's state.  A torn
        TRAILING line (the only loss mode flushed line writes allow) is
        dropped; corruption anywhere else raises ``ValueError``."""
        with open(self.path) as f:
            lines = f.read().splitlines()
        while lines and not lines[-1].strip():
            lines.pop()
        records = []
        for i, line in enumerate(lines):
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break   # torn trailing write: the WAL's tolerated loss
                raise ValueError(
                    f"{self.path}: corrupt journal record at line {i + 1} "
                    "(only the trailing line may be torn)")
        # keep only the newest epoch
        starts = [i for i, r in enumerate(records) if r.get("t") == "begin"]
        if not starts:
            raise ValueError(
                f"{self.path}: no begin record — not a request journal "
                "(or the first write was torn)")
        begin = records[starts[-1]]
        epoch_recs = records[starts[-1] + 1:]

        enq: dict = {}
        enq_order: list = []
        prog: dict = {}
        prog_order: list = []
        done: list = []
        retired: set = set()
        n_blocks, vclock = 0, 0.0
        for r in epoch_recs:
            t = r.get("t")
            if t == "enqueue":
                d = r["req"]
                if r.get("hash") != prompt_hash(d["tokens"]):
                    raise ValueError(
                        f"{self.path}: prompt hash mismatch for rid "
                        f"{d['rid']} (journal corruption)")
                enq[d["rid"]] = d
                enq_order.append(d["rid"])
            elif t == "progress":
                rid = r["rid"]
                prog[rid] = r
                if rid in prog_order:
                    prog_order.remove(rid)
                prog_order.append(rid)
            elif t == "retire":
                done.append(r["c"])
                retired.add(r["c"]["rid"])
            elif t == "block":
                n_blocks, vclock = int(r["n"]), float(r["vclock"])
            elif t == "begin":      # unreachable (sliced off) — be safe
                raise AssertionError("begin inside epoch slice")
        inflight = []
        for rid in prog_order:
            if rid in retired:
                continue
            if rid not in enq:
                raise ValueError(
                    f"{self.path}: progress for rid {rid} without an "
                    "enqueue record")
            p = prog[rid]
            inflight.append({"req": enq[rid], "out": p["out"],
                             "key": p["key"], "steps": p["steps"]})
        queued = [enq[rid] for rid in enq_order
                  if rid not in retired and rid not in prog]
        return JournalReplay(
            epoch=int(begin["epoch"]), recovered=bool(begin["recovered"]),
            knobs=dict(begin.get("knobs") or {}), done=done,
            inflight=inflight, queued=queued, n_blocks=n_blocks,
            vclock=vclock)
