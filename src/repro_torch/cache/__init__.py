"""KV caches (int8, packed int4, or float with unit scales) behind one
protocol: the dense layout and the sliding-window ring
(``repro_torch.cache.base``), and the page pool with block tables and
prefix sharing (``repro_torch.cache.paged``); beside them, an SSM
layer's decode state (``repro_torch.cache.ssm``).

``make_cache`` is the single construction point the model layers use, the
counterpart of ``repro.cache.make_cache``: ``layout`` is "dense" (dense
everywhere), "ring" (a sliding-window layer shorter than ``max_len`` gets a
window-sized ring, every other layer a dense cache) or "paged" (the same
rings, and a page pool for every other layer).
"""
import torch

from repro_torch.cache.base import (DenseCache, KernelView, KV_LEVELS,
                                    LAYOUT_REGISTRY, RingCache, dequantize_kv,
                                    kv_levels, quantize_kv)
from repro_torch.cache.paged import (PagedCache, PrefixEntry, PrefixStore,
                                     copy_pages, set_table_row,
                                     splice_dense_into_pages)
from repro_torch.cache.ssm import SSMState

LAYOUTS = ("dense", "ring", "paged")


def make_cache(batch, max_len, n_kv, head_dim, *, device=None,
               layout="dense", window=None, page_size=64, extra_pages=0,
               bits=8, quantized=True, dtype=torch.bfloat16):
    """The ``layout`` cache of one attention layer: int8 (packed int4 at
    ``bits=4``), or ``dtype`` tiles with unit scales when not ``quantized``
    (``bits`` is then ignored).  A windowed layer (``window``) shorter than
    ``max_len`` gets a ring of ``window`` slots in the "ring" and "paged"
    layouts, as in the reference."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown cache layout {layout!r} (use one of "
                         f"{LAYOUTS})")
    if not quantized:
        bits = 8
    kw = dict(device=device, bits=bits, quantized=quantized, dtype=dtype)
    if window is not None and layout != "dense" and window < max_len:
        return RingCache.init(batch, window, n_kv, head_dim, **kw)
    if layout == "paged":
        return PagedCache.init(batch, max_len, n_kv, head_dim,
                               page_size=page_size, extra_pages=extra_pages,
                               **kw)
    return DenseCache.init(batch, max_len, n_kv, head_dim, **kw)


def layer_caches(tree):
    """Every layer's KV cache in a stack's cache tree ({"layer{i}":
    {"attn": cache}}), in layer order."""
    if isinstance(tree, dict):
        for sub in tree.values():
            yield from layer_caches(sub)
    else:
        yield tree


__all__ = ["DenseCache", "KernelView", "KV_LEVELS", "LAYOUTS",
           "LAYOUT_REGISTRY", "PagedCache", "PrefixEntry", "PrefixStore",
           "RingCache", "SSMState", "copy_pages", "dequantize_kv",
           "kv_levels", "layer_caches", "make_cache", "quantize_kv",
           "set_table_row", "splice_dense_into_pages"]
