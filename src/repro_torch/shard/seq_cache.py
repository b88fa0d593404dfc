"""Owner-shard KV-cache writes and gathers for sequence-parallel ranks.

Counterpart of ``repro/shard/seq_cache.py``.  Under a rank mesh
(``launch.mesh.RankMesh``) with sp > 1, rank i holds rows [i*S_local,
(i+1)*S_local) of the dense cache's S axis, as its own cache of S_local
rows.  Appends arrive with GLOBAL positions (a prefill chunk's offset, a
slot's decode position), and each rank writes exactly the rows it owns:
a chunk that straddles a shard boundary writes its own part of the chunk
on each side, a position another rank owns writes nothing here, and an
inactive scheduler slot writes nothing anywhere, as the reference's drop
sentinel does.  The one-device engine needs none of this: its shards are
views of one global cache.

Reads that need the whole sequence (chunked prefill, the speculative
verify window) all-gather the stored int8 (or packed int4) tiles along S
in rank order, the unsharded layout, and dequantize them with the
replicated per-head scales: bit for bit the unsharded cache's dequantized
view.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.cache import DenseCache
from repro_torch.dist.collectives import all_gather


@dataclasses.dataclass
class RankRows(DenseCache):
    """One rank's rows of a sequence-sharded dense cache: ``k``/``v`` hold
    its ``rows`` = S / ``n_ranks`` positions, and ``capacity`` is the
    logical (global) S that the steps and strategies size their windows
    by.  Written only by the owner writes below."""

    n_ranks: int = 1

    @property
    def capacity(self) -> int:
        return self.k.shape[-3] * self.n_ranks

    @property
    def rows(self) -> int:
        return self.k.shape[-3]


def rank_rows(tree, n_ranks: int):
    """``tree`` (a model's cache tree, S / ``n_ranks`` rows each) with
    every dense attention cache as this rank's ``RankRows``."""
    if isinstance(tree, dict):
        return {k: rank_rows(v, n_ranks) for k, v in tree.items()}
    if type(tree) is DenseCache:
        return RankRows(**{f.name: getattr(tree, f.name)
                           for f in dataclasses.fields(tree)},
                        n_ranks=n_ranks)
    return tree


def owner_append(cache, kq, vq, start: int, mesh):
    """Write the ``s`` cache-ready rows ``kq``/``vq`` (B, s, KV, D) at
    global positions [start, start + s) into this rank's rows of them;
    returns the cache (written in place)."""
    s_local = cache.rows
    lo_own = mesh.rank * s_local
    lo = max(int(start), lo_own)
    hi = min(int(start) + kq.shape[1], lo_own + s_local)
    if lo < hi:
        cache.k[:, lo - lo_own:hi - lo_own] = kq[:, lo - start:hi - start]
        cache.v[:, lo - lo_own:hi - lo_own] = vq[:, lo - start:hi - start]
    return cache


def owner_append_slots(cache, kq, vq, pos_vec, mesh, *, active=None):
    """Per-slot append: slot b writes its ``s`` rows at global positions
    ``pos_vec[b] + [0, s)`` (decode s = 1, the speculative verify window
    s > 1), each into the rank that owns it; a slot with ``active``
    False writes nothing.  Returns the cache (written in place)."""
    s_local = cache.rows
    b, s = kq.shape[0], kq.shape[1]
    dev = cache.k.device
    pos = torch.as_tensor(pos_vec, dtype=torch.long,
                          device=dev).reshape(-1).expand(b)
    local = (pos[:, None] + torch.arange(s, device=dev)[None]
             - mesh.rank * s_local)                           # (B, s)
    keep = (local >= 0) & (local < s_local)
    if active is not None:
        keep = keep & active.to(dev).reshape(-1, 1)
    rows, cols = torch.where(keep)
    cache.k[rows, local[rows, cols]] = kq[rows, cols]
    cache.v[rows, local[rows, cols]] = vq[rows, cols]
    return cache


def gathered_dense(cache, mesh, limit: int | None = None):
    """The GLOBAL dequantized (k, v) of a sequence-sharded cache: every
    rank's stored tiles gathered along S in rank order (the unsharded
    layout), cut to the first ``limit`` positions after the gather, and
    dequantized with the replicated per-head scales."""
    kg = torch.cat(all_gather(cache.k, mesh), dim=1)
    vg = torch.cat(all_gather(cache.v, mesh), dim=1)
    if limit is not None:
        kg, vg = kg[:, :limit], vg[:, :limit]
    return cache.dequantize(kg, vg)
