"""Paged KV cache: a page pool + per-slot block tables, and the host-side
prefix store that makes prompt reuse free.

Layout::

    k, v      : (pages, page_size, KV, D)   the page pool (int8, D/2
                                            packed bytes at bits 4, or the
                                            model's float dtype)
    table     : (B, n_blocks) int32         logical block j of slot b
                                            lives in pool page table[b, j]
    k_scale,
    v_scale   : (KV,) f32                   frozen per-head dequant scales
                                            (ones in a float pool)

The pool holds ``B * n_blocks`` slot-private pages (page ``b * n_blocks +
j`` is slot b's default page for block j: the identity table) plus an
optional ``extra_pages`` shared region owned by the :class:`PrefixStore`.
The kernels read the pool through the table directly
(``KernelView.block_table``); ``dense_view`` gathers a contiguous copy for
the plain versions only.

Counterpart of ``repro/cache/paged.py``.  FAT's thresholds are calibrated
once and frozen (paper §2), so the dequant scales are request-independent
and a page quantized while serving one request is bit-valid for every
other: prefix sharing is bookkeeping.  A shared page is immutable; only
the full pages of a registered prompt are shared by reference, the partial
tail page is snapshotted at registration and copied into a sharer's
private page.  As in the dense layout, every write goes into the pool in
place.  ``PagedCache.rollback`` with ``private_row`` is the copy-on-rewind
that keeps shared pages immutable under speculative decoding.  Snapshots:
``PagedCache.state_dict`` (the table is an array, ``page_size`` a static
field, as in the reference) and ``PrefixStore.state_dict`` /
``load_state_dict`` (LRU order, the slots holding each entry, its stored
logits).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.cache.base import (KernelView, QuantizedKV, storage_dtype,
                                    storage_shape)


@dataclasses.dataclass
class PagedCache(QuantizedKV):
    """Page pool + per-slot block table of one attention layer.

    Logical position p of slot b lives at page ``table[b, p // ps]``,
    offset ``p % ps``.  With the identity table this is a dense cache whose
    sequence axis is tiled into pages."""

    layout = "paged"
    STATIC = ("_quantized", "page_size", "bits")

    k: torch.Tensor        # (T, ps, KV, D) int8 (D/2 packed bytes at bits 4)
    #                        or float (a float pool)
    v: torch.Tensor
    k_scale: torch.Tensor  # (KV,) f32
    v_scale: torch.Tensor
    table: torch.Tensor    # (B, NB) int32
    page_size: int = 64
    bits: int = 8

    @classmethod
    def init(cls, batch, max_len, n_kv, head_dim, *, device=None,
             page_size=64, extra_pages=0, bits=8, quantized=True,
             dtype=torch.bfloat16):
        """Identity-table pool: slot b owns pages [b*NB, (b+1)*NB), NB =
        ceil(max_len / page_size); ``extra_pages`` reserves the shared
        prefix region at the pool's tail.  The pool is int8 (packed int4
        at ``bits=4``), or ``dtype`` when not ``quantized``; page copies and
        splices move its tiles whatever their dtype."""
        if page_size < 8 or page_size % 8:
            raise ValueError(f"page_size must be a positive multiple of 8, "
                             f"got {page_size}")
        nb = -(-max_len // page_size)
        shape = storage_shape(batch * nb + extra_pages, page_size, n_kv,
                              head_dim, bits, quantized)
        store = storage_dtype(quantized, dtype)
        table = torch.arange(batch * nb, dtype=torch.int32,
                             device=device).reshape(batch, nb)
        return cls(torch.zeros(shape, dtype=store, device=device),
                   torch.zeros(shape, dtype=store, device=device),
                   torch.ones((n_kv,), dtype=torch.float32, device=device),
                   torch.ones((n_kv,), dtype=torch.float32, device=device),
                   table, page_size=page_size, bits=bits)

    @property
    def capacity(self) -> int:
        return self.n_blocks * self.page_size

    @property
    def n_blocks(self) -> int:
        return self.table.shape[-1]

    @property
    def n_pages(self) -> int:
        return self.k.shape[0]

    # -- writes ------------------------------------------------------------
    def _page_of(self, positions: torch.Tensor):
        """(B, n) positions -> (pages, offsets), each (B, n), through the
        table; positions clamp to the last valid slot, as the dense
        layout's clamped write does."""
        pos = torch.clamp(positions.to(torch.long), 0, self.capacity - 1)
        pages = torch.gather(self.table.to(torch.long), 1,
                             pos // self.page_size)
        return pages, pos % self.page_size

    def append(self, kq, vq, start: int) -> "PagedCache":
        """Write tokens [start, start + s) of every row into their mapped
        pages (the rows' target pages are distinct: appends only ever
        target private pages)."""
        b, s = kq.shape[0], kq.shape[1]
        if start < 0 or start + s > self.capacity:
            raise ValueError(
                f"append of {s} positions at {start} overruns the cache "
                f"capacity {self.capacity}")
        pos = torch.arange(start, start + s, device=self.k.device)
        pages, offs = self._page_of(pos.expand(b, s))
        self.k[pages, offs] = kq
        self.v[pages, offs] = vq
        return self

    def append_slots(self, kq, vq, starts, active=None) -> "PagedCache":
        """Per-slot write through the table (kq/vq (B, s, KV, D): s == 1 the
        decode step, s > 1 the speculative verify window, whose positions
        ``starts[b] + [0, s)`` may cross a page boundary; each maps
        through the table).  A position past the capacity clamps to the
        last slot, as in the reference.  A row with ``active`` False reads
        back its mapped tiles and writes them unchanged, bit-exact
        cache-neutral like ``DenseCache``."""
        s = kq.shape[1]
        pos = (starts.to(torch.long).reshape(-1, 1)
               + torch.arange(s, device=self.k.device)[None])
        pages, offs = self._page_of(pos)
        if active is not None:
            sel = active.reshape(-1, 1, 1, 1)
            kq = torch.where(sel, kq, self.k[pages, offs])
            vq = torch.where(sel, vq, self.v[pages, offs])
        self.k[pages, offs] = kq
        self.v[pages, offs] = vq
        return self

    def rollback(self, pos, private_row=None) -> "PagedCache":
        """Rewind slot b's table to ``pos[b]`` valid entries.

        Without ``private_row`` a no-op, as in the dense layout: the entries
        past pos are dead, and appends target private pages.  With
        ``private_row`` (B, NB), the slots' own page ids, the rewound region
        is re-pointed at private pages, so a rewind into a shared prefix
        page never lets a later append write shared storage: the blocks
        after the boundary only swap their table entry, and the boundary
        block (the one holding ``pos``, partly live) is copied into its
        private page first (copy-on-rewind; a self-copy when it is private
        already).  In place, like every write of the port's caches."""
        if private_row is None:
            return self
        ps, nb = self.page_size, self.n_blocks
        dev = self.k.device
        pos = torch.as_tensor(pos, device=dev).to(torch.long).reshape(-1)
        prow = torch.as_tensor(private_row, device=dev).to(torch.long)
        table = self.table.to(torch.long)
        blk = torch.clamp(pos // ps, 0, nb - 1)[:, None]
        rewind = torch.arange(nb, device=dev)[None] >= blk
        src = torch.gather(table, 1, blk)[:, 0]
        dst = torch.gather(prow, 1, blk)[:, 0]
        # the source pages are read before any destination is written
        self.k[dst] = self.k[src]
        self.v[dst] = self.v[src]
        self.table.copy_(torch.where(rewind, prow, table))
        return self

    def splice_slot(self, slot_cache, slot):
        raise NotImplementedError(
            "paged splices go through splice_dense_into_pages (admissions "
            "prefill a dense batch-1 cache and scatter it into the slot's "
            "private pages)")

    # -- reads -------------------------------------------------------------
    def _blocks_for(self, limit: Optional[int]) -> int:
        if limit is None:
            return self.n_blocks
        return min(self.n_blocks, -(-int(limit) // self.page_size))

    def dense_view(self, limit: Optional[int] = None):
        """Gather the table-mapped pages into contiguous (B, S', KV, D)
        tiles: the plain versions' input (the kernels read the pool through
        the table instead)."""
        nb = self._blocks_for(limit)
        tb = self.table[:, :nb].to(torch.long)
        shp = (tb.shape[0], nb * self.page_size) + tuple(self.k.shape[2:])
        k, v = self.k[tb].reshape(shp), self.v[tb].reshape(shp)
        if limit is not None and limit < shp[1]:
            k, v = k[:, :limit], v[:, :limit]
        return k, v

    def kernel_view(self, limit: Optional[int] = None) -> KernelView:
        """The pool and the table's first ceil(limit / page_size) blocks."""
        nb = self._blocks_for(limit)
        return KernelView(self.k, self.v, self.table[:, :nb].contiguous(),
                          self.page_size, self.bits)


# -- scheduler-side page ops (in place; each returns the cache) -------------

def splice_dense_into_pages(paged: PagedCache, dense_slot, row):
    """Admission splice: scatter a batch-1 dense cache (capacity NB *
    page_size) into the pool pages ``row`` (NB,); the caller points a
    table row at them (``set_table_row``).  The frozen scales are copied
    from the slot cache into the pool's own, in place, as
    ``DenseCache.splice_slot`` does."""
    nb, ps = paged.n_blocks, paged.page_size
    row = torch.as_tensor(row, dtype=torch.long, device=paged.k.device)
    tail = tuple(paged.k.shape[2:])
    paged.k[row] = dense_slot.k.reshape((nb, ps) + tail)
    paged.v[row] = dense_slot.v.reshape((nb, ps) + tail)
    paged.k_scale.copy_(dense_slot.k_scale)
    paged.v_scale.copy_(dense_slot.v_scale)
    return paged


def set_table_row(paged: PagedCache, slot: int, row):
    """Point slot ``slot``'s block table at pages ``row`` (NB,)."""
    paged.table[slot] = torch.as_tensor(row, dtype=torch.int32,
                                        device=paged.table.device)
    return paged


def copy_pages(paged: PagedCache, src, dst):
    """Copy pool pages ``src`` -> ``dst`` (equal-length index lists): the
    source pages are read before any destination is written."""
    src = torch.as_tensor(src, dtype=torch.long, device=paged.k.device)
    dst = torch.as_tensor(dst, dtype=torch.long, device=paged.k.device)
    paged.k[dst] = paged.k[src]
    paged.v[dst] = paged.v[src]
    return paged


# -- host-side prefix registry -----------------------------------------------

class PrefixEntry(NamedTuple):
    pages: tuple               # shared page ids of the FULL prompt pages
    tail_page: Optional[int]   # snapshot page of the partial tail (or None)
    length: int                # prompt length in tokens
    logits: torch.Tensor       # last-position logits (1, 1, V): a hit
    #                            takes its first token from these


class PrefixStore:
    """Host-side registry: full-prompt key -> shared pages + stored logits,
    with an LRU page allocator over the pool's shared region.

    Keys are the full prompt token tuple; registration is opportunistic
    (a prompt that finds no free or evictable pages is not registered).
    ``users`` records which live slots hold an entry's pages, so an entry
    is never reclaimed under a resident."""

    def __init__(self, first_page: int, n_pages: int, page_size: int):
        self.page_size = page_size
        self._free = list(range(first_page, first_page + n_pages))
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.shared_tokens = 0   # prompt tokens served from shared pages
        self.evictions = 0       # LRU entries reclaimed for new prompts
        self.exhausted = 0       # reserves denied: no free/evictable pages

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "shared_tokens": self.shared_tokens,
                "entries": len(self._entries),
                "free_pages": len(self._free),
                "evictions": self.evictions,
                "exhausted": self.exhausted}

    def lookup(self, key: tuple, slot: int):
        """Full-prompt hit: the entry, with ``slot`` marked as a user
        (``release(slot)`` at retirement); None on a miss."""
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        e["users"].add(slot)
        self.hits += 1
        self.shared_tokens += e["entry"].length
        return e["entry"]

    def release(self, slot: int):
        for e in self._entries.values():
            e["users"].discard(slot)

    def _reclaim(self, need: int):
        """Evict least-recently-used entries with no live users until
        ``need`` pages are free (or nothing evictable remains)."""
        for key in list(self._entries):
            if len(self._free) >= need:
                break
            e = self._entries[key]
            if e["users"]:
                continue
            ent = e["entry"]
            self._free.extend(ent.pages)
            if ent.tail_page is not None:
                self._free.append(ent.tail_page)
            del self._entries[key]
            self.evictions += 1

    def reserve(self, key: tuple, length: int):
        """Allocate shared pages for a prompt of ``length`` tokens:
        (full_page_ids, tail_page_id or None), or None when the key is
        registered already, the prompt is empty, or the shared region
        cannot fit it (counted in ``exhausted``)."""
        if key in self._entries:
            return None
        n_full, rem = divmod(length, self.page_size)
        need = n_full + (1 if rem else 0)
        if need == 0 or len(self._free) < need:
            self._reclaim(need)
        if need == 0:
            return None
        if len(self._free) < need:
            self.exhausted += 1
            return None
        pages = [self._free.pop() for _ in range(n_full)]
        tail = self._free.pop() if rem else None
        return tuple(pages), tail

    def register(self, key: tuple, entry: PrefixEntry):
        self._entries[key] = {"entry": entry, "users": set()}

    # -- snapshot / restore --------------------------------------------------
    def state_dict(self) -> dict:
        """The free list, the counters and every entry in LRU order, with
        the slots holding it (``users``) and its stored last-position
        logits (a hit takes its first token from them).  Everything is
        JSON-compatible except the logits, CPU tensors, which the scheduler
        routes through the checkpoint's array tree."""
        return {
            "page_size": self.page_size,
            "free": [int(p) for p in self._free],
            "counters": {"hits": self.hits, "misses": self.misses,
                         "shared_tokens": self.shared_tokens,
                         "evictions": self.evictions,
                         "exhausted": self.exhausted},
            "entries": [
                {"key": [int(t) for t in key],
                 "pages": [int(p) for p in d["entry"].pages],
                 "tail_page": (None if d["entry"].tail_page is None
                               else int(d["entry"].tail_page)),
                 "length": int(d["entry"].length),
                 "users": sorted(int(s) for s in d["users"]),
                 "logits": torch.as_tensor(d["entry"].logits).detach().to(
                     "cpu", copy=True)}
                for key, d in self._entries.items()],
        }

    def load_state_dict(self, sd: dict, device=None):
        """Restore a ``state_dict`` in place (LRU order kept), the logits
        onto ``device``.  The pool pages the entries point at are restored
        with the cache."""
        if int(sd["page_size"]) != self.page_size:
            raise ValueError(
                f"prefix store page_size mismatch: snapshot has "
                f"{sd['page_size']}, store has {self.page_size}")
        self._free = [int(p) for p in sd["free"]]
        c = sd["counters"]
        self.hits = int(c["hits"])
        self.misses = int(c["misses"])
        self.shared_tokens = int(c["shared_tokens"])
        self.evictions = int(c["evictions"])
        self.exhausted = int(c["exhausted"])
        self._entries = OrderedDict()
        for e in sd["entries"]:
            logits = e["logits"]
            if not isinstance(logits, torch.Tensor):
                logits = torch.from_numpy(np.asarray(logits))
            entry = PrefixEntry(
                pages=tuple(int(p) for p in e["pages"]),
                tail_page=(None if e["tail_page"] is None
                           else int(e["tail_page"])),
                length=int(e["length"]),
                logits=logits if device is None else logits.to(device))
            self._entries[tuple(int(t) for t in e["key"])] = {
                "entry": entry, "users": set(int(s) for s in e["users"])}
