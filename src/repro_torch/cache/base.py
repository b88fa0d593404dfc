"""KV cache, dense layout (position p of request b lives at slot [b, p])
and the sliding-window ring (``RingCache``: slot [b, p % window]).
Quantized: int8 tiles, or int4 packed two per byte along the head dim
(``bits=4``: D/2 storage bytes, ``core/packing.py``), with per-head
dequant scales.  Float (``quantized=False``): tiles in the model's dtype,
with unit scales.

Counterpart of the dense and ring layouts of ``repro/cache/base.py``.  K/V are made
cache-ready ONCE in ``ready``: quantized against the frozen per-head
calibrated thresholds (paper §2), or cast to the storage dtype; the same
tiles are written by ``append`` and attended by the prefill kernel.
Unlike the reference's immutable pytree, every write (``append``,
``append_slots``, ``splice_slot``) goes into the cache buffers in place (a
decode step then moves only the new token's bytes) and returns the same
object.

``state_dict`` / ``from_state_dict`` snapshot a cache with the reference's
layout names, static fields and array names, for the scheduler's
snapshots; ``load_state_dict_`` restores one into an existing cache in
place (the scheduler's captured decode block keeps reading the tensors it
was captured with).

The paged layout is ``repro_torch.cache.paged``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.packing import pack_int4, unpack_int4

# int8 KV cache uses the symmetric signed-8-bit grid (paper eq. 4)
KV_LEVELS = 127.0


def kv_levels(bits: int) -> float:
    """Symmetric signed level count for a KV bit width (127 / 7)."""
    if bits not in (4, 8):
        raise ValueError(f"kv cache bits must be 4 or 8, got {bits}")
    return float(2 ** (bits - 1) - 1)


# a dead channel (zero or non-finite calibration threshold) must not turn
# the cache into inf/NaN: floor at the 1e-8 threshold floor of the matmul
# path, expressed as a dequant scale (T / 127; the same floor at int4, as
# in the reference)
_SCALE_FLOOR = 1e-8 / KV_LEVELS


def _safe_scale(scale: torch.Tensor) -> torch.Tensor:
    """Clamp per-head dequant scales to a positive finite floor; ``where``
    (not ``maximum``) so a NaN scale also takes the floor."""
    s = scale.float()
    return torch.where(s > _SCALE_FLOOR, s, _SCALE_FLOOR)


def quantize_kv(x: torch.Tensor, scale: torch.Tensor,
                bits: int = 8) -> torch.Tensor:
    """(B, S, KV, D) float -> storage tiles with per-head dequant
    ``scale`` (KV,).  Divides by the scale, as the reference does.
    ``bits == 8`` emits int8; ``bits == 4`` clips to the int4 grid (±7)
    and packs two values per byte along D (D/2 storage bytes)."""
    lv = kv_levels(bits)
    s = scale.reshape(1, 1, -1, 1)
    q = torch.clamp(torch.round(x.float() / s), -lv, lv).to(torch.int8)
    return pack_int4(q, axis=-1) if bits == 4 else q


def dequantize_kv(x_q: torch.Tensor, scale: torch.Tensor,
                  bits: int = 8) -> torch.Tensor:
    """Storage tiles -> f32 with per-head dequant ``scale`` (KV,); int4
    tiles unpack their nibbles first."""
    if bits == 4:
        x_q = unpack_int4(x_q, axis=-1)
    return x_q.float() * scale.reshape(1, 1, -1, 1)


class KernelView(NamedTuple):
    """What the fused kernels consume, layout-independently: the dense
    layout passes contiguous (B, S, KV, D) tiles with ``block_table`` None;
    the paged layout passes its (pages, page_size, KV, D) pool with a
    (B, n_blocks) int32 table.  At ``bits == 4`` the last dim holds D/2
    packed bytes."""
    k: torch.Tensor
    v: torch.Tensor
    block_table: Optional[torch.Tensor] = None
    page_size: Optional[int] = None
    bits: int = 8


def storage_shape(lead, seq, n_kv, head_dim, bits, quantized=True):
    """(lead, seq, KV, D) storage shape; D/2 bytes at ``bits == 4`` of a
    quantized cache (a float cache stores D values whatever ``bits``)."""
    kv_levels(bits)             # raises unless bits is 4 or 8
    if quantized and bits == 4:
        if head_dim % 2:
            raise ValueError(
                f"int4 KV packing needs an even head dim, got {head_dim}")
        head_dim //= 2          # two nibbles per stored byte
    return (lead, seq, n_kv, head_dim)


def storage_dtype(quantized: bool, dtype) -> torch.dtype:
    """int8 for a quantized cache, else the float ``dtype``."""
    if quantized:
        return torch.int8
    if not dtype.is_floating_point:
        raise ValueError(f"a float KV cache needs a float dtype, got {dtype}")
    return dtype


# layout name -> cache class, filled as each layout class is defined;
# ``QuantizedKV.from_state_dict`` dispatches through it
LAYOUT_REGISTRY: dict = {}


def _unbox(v):
    """A python scalar or string back from the 0-d array or tensor a
    checkpoint round trip makes of it."""
    if isinstance(v, torch.Tensor):
        return v.item()
    if isinstance(v, np.ndarray) and v.ndim == 0:
        v = v.item()
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, (bytes, np.bytes_)):
        v = v.decode()
    return v


def _as_tensor(a, device=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device) if device is not None else t


class QuantizedKV:
    """The scale half of the cache protocol, shared by every layout (a
    dataclass with ``k``, ``k_scale``, ``v_scale`` and ``bits`` fields).  A
    float cache (``quantized`` False) keeps unit scales: callers never
    install calibrated ones into it.

    Snapshots follow the reference's ``KVCache.state_dict``: the layout
    name, the static fields ``STATIC`` (``_quantized`` among them, which
    the port derives from the storage dtype) and every other field as an
    array."""

    STATIC = ("_quantized", "bits")

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        layout = cls.__dict__.get("layout")
        if layout is not None:
            LAYOUT_REGISTRY[layout] = cls

    @classmethod
    def _child_names(cls):
        return tuple(f.name for f in dataclasses.fields(cls)
                     if f.name not in cls.STATIC)

    def _static_values(self) -> dict:
        return {s: (self.quantized if s == "_quantized" else getattr(self, s))
                for s in self.STATIC}

    def state_dict(self) -> dict:
        """The cache as ``{"layout", "static", "arrays"}``, every array a
        CPU copy; round-trips bit-exactly through ``from_state_dict`` and
        ``load_state_dict_``, and through ``CheckpointManager``."""
        return {"layout": self.layout, "static": self._static_values(),
                "arrays": {n: getattr(self, n).detach().to("cpu", copy=True)
                           for n in self._child_names()}}

    @staticmethod
    def from_state_dict(sd: dict, device=None):
        """A new cache from a ``state_dict`` (tensors or numpy arrays, the
        scalars possibly boxed by a checkpoint round trip), on ``device``
        (None: where the arrays are)."""
        layout = _unbox(sd["layout"])
        cls = LAYOUT_REGISTRY.get(layout)
        if cls is None:
            raise ValueError(
                f"unknown cache layout {layout!r} in state dict "
                f"(registered: {sorted(LAYOUT_REGISTRY)})")
        static = {k: _unbox(v) for k, v in sd["static"].items()}
        # snapshots from before int4 carry no bit width: int8 by
        # construction, as in the reference
        static.setdefault("bits", 8)
        missing = set(cls.STATIC) - set(static)
        if missing:
            raise ValueError(f"{layout} cache state dict missing static "
                             f"field(s) {sorted(missing)}")
        arrays = {k: _as_tensor(v, device) for k, v in sd["arrays"].items()}
        want = set(cls._child_names())
        if set(arrays) != want:
            raise ValueError(f"{layout} cache state dict arrays mismatch: got "
                             f"{sorted(arrays)}, want {sorted(want)}")
        quantized = bool(static.pop("_quantized"))
        if quantized != (arrays["k"].dtype == torch.int8):
            raise ValueError(f"{layout} cache state dict says quantized="
                             f"{quantized} over {arrays['k'].dtype} tiles")
        return cls(**arrays, **{k: static[k] for k in cls.STATIC
                                if k != "_quantized"})

    def check_state_dict(self, sd: dict):
        """Raise unless ``sd`` has this cache's layout, static fields and
        array names, shapes and dtypes (what ``load_state_dict_`` needs)."""
        layout = _unbox(sd["layout"])
        if layout != self.layout:
            raise ValueError(f"state dict of a {layout} cache, this cache is "
                             f"{self.layout}")
        static = {k: _unbox(v) for k, v in sd["static"].items()}
        static.setdefault("bits", 8)
        own = self._static_values()
        bad = {k: (static.get(k), v) for k, v in own.items()
               if static.get(k) != v}
        if bad:
            raise ValueError(f"{layout} cache state dict static fields "
                             f"differ (saved, live): {bad}")
        if set(sd["arrays"]) != set(self._child_names()):
            raise ValueError(f"{layout} cache state dict arrays mismatch: got "
                             f"{sorted(sd['arrays'])}, want "
                             f"{sorted(self._child_names())}")
        for n in self._child_names():
            a, live = _as_tensor(sd["arrays"][n]), getattr(self, n)
            if a.shape != live.shape or a.dtype != live.dtype:
                raise ValueError(
                    f"{layout} cache state dict array {n!r} is "
                    f"{tuple(a.shape)}/{a.dtype}, the cache holds "
                    f"{tuple(live.shape)}/{live.dtype}")

    def load_state_dict_(self, sd: dict):
        """Restore a ``state_dict`` of the same layout, statics and shapes
        into this cache's tensors with ``copy_``: every tensor keeps its
        storage (a captured program reading them sees the restored
        values).  Returns self."""
        self.check_state_dict(sd)
        for n in self._child_names():
            getattr(self, n).copy_(_as_tensor(sd["arrays"][n]))
        return self

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    def scales(self):
        """Per-head dequant scales (ones for a float cache): the prefill
        kernel takes float tiles through the same code path with unit
        scales."""
        return self.k_scale, self.v_scale

    def with_scales(self, k_scale, v_scale):
        """Install calibrated per-head dequant scales (floored once here);
        the K/V buffers (and a paged table) are shared with this cache."""
        return dataclasses.replace(self, k_scale=_safe_scale(k_scale),
                                   v_scale=_safe_scale(v_scale))

    def ready(self, k, v):
        """Cache-ready tiles: quantize against the frozen per-head scales, or
        (a float cache) cast to the storage dtype."""
        if not self.quantized:
            return k.to(self.k.dtype), v.to(self.v.dtype)
        return (quantize_kv(k, self.k_scale, self.bits),
                quantize_kv(v, self.v_scale, self.bits))

    def dequantize(self, k_tiles, v_tiles):
        """Storage tiles -> float: f32 for quantized tiles (int4 unpacked),
        the tiles themselves for a float cache."""
        if not self.quantized:
            return k_tiles, v_tiles
        return (dequantize_kv(k_tiles, self.k_scale, self.bits),
                dequantize_kv(v_tiles, self.v_scale, self.bits))


@dataclasses.dataclass
class DenseCache(QuantizedKV):
    """Contiguous KV cache of one attention layer."""

    layout = "dense"

    k: torch.Tensor        # (B, S, KV, D) int8 (D/2 packed bytes at bits 4)
    v: torch.Tensor        # or float (a float cache)
    k_scale: torch.Tensor  # (KV,) f32 dequant scales (ones until prefill;
    v_scale: torch.Tensor  # always ones in a float cache)
    bits: int = 8

    @classmethod
    def init(cls, batch, max_len, n_kv, head_dim, *, device=None, bits=8,
             quantized=True, dtype=torch.bfloat16):
        """Zero tiles and unit scales: int8 (packed int4 at ``bits=4``), or
        ``dtype`` tiles when not ``quantized``."""
        shape = storage_shape(batch, max_len, n_kv, head_dim, bits,
                              quantized)
        store = storage_dtype(quantized, dtype)
        return cls(torch.zeros(shape, dtype=store, device=device),
                   torch.zeros(shape, dtype=store, device=device),
                   torch.ones((n_kv,), dtype=torch.float32, device=device),
                   torch.ones((n_kv,), dtype=torch.float32, device=device),
                   bits=bits)

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]

    def append(self, kq, vq, start: int) -> "DenseCache":
        """Write tiles at positions [start, start + len) in place."""
        s = kq.shape[1]
        if start < 0 or start + s > self.capacity:
            raise ValueError(
                f"append of {s} positions at {start} overruns the cache "
                f"capacity {self.capacity}")
        self.k[:, start:start + s] = kq
        self.v[:, start:start + s] = vq
        return self

    def append_slots(self, kq, vq, starts, active=None) -> "DenseCache":
        """Per-slot write (continuous batching): row b writes its (s, KV, D)
        tiles at positions ``starts[b] + [0, s)`` (s == 1 the decode step,
        s > 1 the speculative verify window).  A start clamps to
        [0, capacity - s], as the reference's ``dynamic_update_slice``
        does (the whole window moves, not each position).  A row with
        ``active`` False reads back the tiles of its window and writes them
        unchanged, so a masked step leaves the cache bit-for-bit as it
        was."""
        s = kq.shape[1]
        if s > self.capacity:
            raise ValueError(f"a window of {s} positions overruns the cache "
                             f"capacity {self.capacity}")
        dev = self.k.device
        rows = torch.arange(self.k.shape[0], device=dev)[:, None]
        start = torch.clamp(starts.to(torch.long), 0, self.capacity - s)
        pos = start[:, None] + torch.arange(s, device=dev)[None]
        if active is not None:
            sel = active.reshape(-1, 1, 1, 1)
            kq = torch.where(sel, kq, self.k[rows, pos])
            vq = torch.where(sel, vq, self.v[rows, pos])
        self.k[rows, pos] = kq
        self.v[rows, pos] = vq
        return self

    def rollback(self, pos, private_row=None) -> "DenseCache":
        """Logical rewind to ``pos`` valid entries: a no-op, since entries
        at positions >= pos are dead data the masks never read."""
        return self

    def splice_slot(self, slot_cache: "DenseCache", slot: int) -> "DenseCache":
        """Receive a batch-1 cache into batch row ``slot`` (scheduler
        admission); the frozen scales are copied from the slot cache into
        this cache's own, in place, so a captured decode keeps reading
        them."""
        self.k[slot] = slot_cache.k[0]
        self.v[slot] = slot_cache.v[0]
        self.k_scale.copy_(slot_cache.k_scale)
        self.v_scale.copy_(slot_cache.v_scale)
        return self

    def dense_view(self, limit: Optional[int] = None):
        """(k, v) storage tiles, (B, S', KV, D) each (D/2 at bits 4), S' =
        ``limit`` or the capacity."""
        if limit is None or limit >= self.capacity:
            return self.k, self.v
        return self.k[:, :limit], self.v[:, :limit]

    def kernel_view(self, limit: Optional[int] = None) -> KernelView:
        """The first ``limit`` positions (all by default) as contiguous
        tiles.  A cut view of a wider cache is copied contiguous, because
        the kernels stream (B, S, KV, D) rows."""
        k, v = self.dense_view(limit)
        return KernelView(k.contiguous(), v.contiguous(), bits=self.bits)


@dataclasses.dataclass
class RingCache(QuantizedKV):
    """SWA ring buffer of one sliding-window layer: capacity == window, and
    position p lives at slot ``p % window`` (the windowed decode relies on
    it).  A ring keeps one position for the whole batch (the reference's
    scalar-position contract): per-slot writes and chunked prefill need
    absolute slots, and both raise upstream.  Writes go into the buffers
    in place, as in ``DenseCache``; a single-token write takes its position
    as an int or as a device tensor (the captured decode step), never read
    on the host."""

    layout = "ring"

    k: torch.Tensor        # (B, window, KV, D) int8 (D/2 at bits 4) or float
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    bits: int = 8

    # zero tiles of ``window`` slots and unit scales; the sequence axis
    init = classmethod(DenseCache.init.__func__)
    capacity = DenseCache.capacity

    @property
    def window(self) -> int:
        return self.capacity

    def append(self, kq, vq, start) -> "RingCache":
        """A single-token write lands at slot ``start % window`` (``start``
        an int, or a 0-d or (B,) int tensor of positions, each row written
        at its own slot); a whole-prompt write (``start`` 0, s tokens)
        keeps the last ``window`` entries, rolled by ``(s - window) %
        window`` so that position p sits at slot ``p % window``."""
        s, cap = kq.shape[1], self.capacity
        if s == 1:
            if isinstance(start, torch.Tensor):
                b = self.k.shape[0]
                idx = torch.remainder(start.to(torch.long).reshape(-1),
                                      cap).expand(b)
                rows = torch.arange(b, device=self.k.device)
                self.k[rows, idx] = kq[:, 0]
                self.v[rows, idx] = vq[:, 0]
            else:
                idx = int(start) % cap
                self.k[:, idx:idx + 1] = kq
                self.v[:, idx:idx + 1] = vq
            return self
        if isinstance(start, torch.Tensor) or start != 0:
            raise ValueError(
                f"a ring buffer takes a multi-token write only as the "
                f"one-shot prompt write at position 0, got {s} tokens at "
                f"{start}")
        keep = min(s, cap)
        kk, vv = kq[:, s - keep:], vq[:, s - keep:]
        if keep == cap:
            shift = (s - keep) % cap
            kk = torch.roll(kk, shift, dims=1)
            vv = torch.roll(vv, shift, dims=1)
        self.k[:, :keep] = kk
        self.v[:, :keep] = vv
        return self

    def append_slots(self, kq, vq, starts, active=None):
        raise NotImplementedError(
            "per-slot decode needs absolute slots; the SWA ring buffer "
            "keeps the scalar-position contract (use a dense or paged "
            "cache sized >= max_len)")

    def abs_positions(self, cur_pos) -> torch.Tensor:
        """The absolute position each ring slot holds, given the newest
        token's position ``cur_pos``: (window,) for an int, (B, window) for
        a (B,) tensor; slots not yet written hold negative positions."""
        cap = self.capacity
        slot = torch.arange(cap, device=self.k.device)
        if isinstance(cur_pos, torch.Tensor):
            cur = cur_pos.to(torch.long).reshape(-1, 1)
            idx = torch.remainder(cur, cap)
        else:
            cur, idx = int(cur_pos), int(cur_pos) % cap
        return torch.where(slot <= idx, cur - (idx - slot),
                           cur - (idx + cap - slot))

    def dense_view(self, limit: Optional[int] = None):
        """The ring's storage, which is its whole attended extent."""
        return self.k, self.v

    def kernel_view(self, limit: Optional[int] = None) -> KernelView:
        return KernelView(self.k, self.v, bits=self.bits)
