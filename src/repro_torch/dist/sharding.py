"""Tensor-parallel role rules: which leaves split over the ``tp`` shards.

Counterpart of the tensor-parallel half of ``repro/dist/sharding.py``
(``tp_param_specs``, ``tp_qparam_specs``, ``tp_cache_specs``).  The
reference returns ``PartitionSpec`` trees that ``shard_map`` cuts the
arrays by; the port applies the same rules directly: each ``*_slices``
function returns one tree per shard whose leaves are views of the input's
(torch tensors or numpy arrays alike), and raises the reference's
``ValueError`` on an axis that does not divide.

Roles come from the param tree's own keys: column-parallel projections
(``TP_COL_KEYS``) split their output (last) axis, and their per-channel
companions (``w_scale``, ``b``, ``b_q``, ``b_scale``) follow; row-parallel
ones (``TP_ROW_KEYS``) split their input axis (second to last) and keep
their per-output-channel leaves whole; everything else (embeddings, norms,
the SSM mixer's projections, routers) is replicated.  The per-KV-head
cache thresholds split with their heads, the KV cache on its KV-head axis
(axis -2 of every k/v leaf: dense (B, S, KV, D), ring (B, W, KV, D) and
paged pools (T, ps, KV, D) alike) with its (KV,) scales; block tables,
positions and SSM states are replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# column-parallel: output features split across shards (no epilogue)
TP_COL_KEYS = frozenset({"wq", "wk", "wv", "gate", "up", "fc1"})
# row-parallel: input features split; int32 reduce epilogue after the dot
TP_ROW_KEYS = frozenset({"wo", "down", "fc2"})


def _items(tree: dict):
    # the reference flattens dicts in sorted key order, so the first leaf
    # that raises is the same one
    return sorted(tree.items(), key=lambda kv: str(kv[0]))


def _map(tree: dict, fn, keys: tuple = ()) -> dict:
    return {k: _map(v, fn, keys + (k,)) if isinstance(v, dict)
            else fn(keys + (k,), v) for k, v in _items(tree)}


def _take(leaf, axis: Optional[int], i: int, tp: int):
    """Shard ``i`` of ``tp`` along ``axis`` (None: the whole leaf)."""
    if axis is None:
        return leaf
    n = leaf.shape[axis] // tp
    idx = [slice(None)] * len(leaf.shape)
    idx[axis] = slice(i * n, (i + 1) * n)
    return leaf[tuple(idx)]


def tp_param_axis(keys: tuple, shape: tuple, tp: int) -> Optional[int]:
    """The axis along which the param leaf at ``keys`` splits over ``tp``
    shards (-1 or -2), or None where it is replicated."""
    role = next((k for k in reversed(keys[:-1])
                 if k in TP_COL_KEYS or k in TP_ROW_KEYS), None)
    if role is None or tp <= 1:
        return None
    name = keys[-1]
    if role in TP_ROW_KEYS:
        if name in ("w", "w_q"):
            if shape[-2] % tp:
                raise ValueError(
                    f"{'/'.join(map(str, keys))}: input axis {shape[-2]} "
                    f"not divisible by tp={tp}")
            return -2
        return None  # w_scale/bias span the whole output axis
    if name in ("w", "w_q"):
        if shape[-1] % tp:
            raise ValueError(
                f"{'/'.join(map(str, keys))}: output axis {shape[-1]} "
                f"not divisible by tp={tp}")
        return -1
    if len(shape) >= 1 and shape[-1] > 1 and shape[-1] % tp == 0:
        # per-output-channel companions: w_scale, b, b_q, b_scale
        return -1
    return None  # scalar scales


def tp_param_slices(params: dict, *, tp: int) -> list:
    """The ``tp`` shards' param trees (views of ``params``)."""
    axes = _map(params, lambda keys, leaf: tp_param_axis(
        keys, tuple(leaf.shape), tp))
    return [_map(params, lambda keys, leaf, i=i: _take(
        leaf, _lookup(axes, keys), i, tp)) for i in range(tp)]


def tp_row_slices(key: str, k: int, tp: int) -> list:
    """The contraction range [k0, k1) that each shard of a row-parallel
    layer (a Dense whose input axis is 'heads' or 'mlp') reduces over:
    a ``TP_ROW_KEYS`` weight splits its ``k`` input rows into ``tp``
    slices; any other such weight (the SSM mixer's ``out_proj``) is
    replicated, so every shard holds all ``k`` rows."""
    if key not in TP_ROW_KEYS:
        return [(0, k)] * tp
    n = k // tp
    return [(i * n, (i + 1) * n) for i in range(tp)]


def _qparam_axis(keys: tuple, shape: tuple, tp: int,
                 n_kv: int) -> Optional[int]:
    if (tp > 1 and keys and isinstance(keys[0], str)
            and keys[0].endswith("/kv") and len(shape) >= 1
            and shape[-1] == n_kv and n_kv % tp == 0):
        return -1
    return None


def tp_qparam_slices(qparams: dict, *, tp: int, n_kv: int) -> list:
    """The ``tp`` shards' threshold trees: per-tensor activation and
    weight thresholds replicated (the frozen §2 scale is the same on every
    shard, so a shard's local quantize is a slice of the global one),
    the per-KV-head cache thresholds split with their heads."""
    return [_map(qparams, lambda keys, leaf, i=i: _take(
        leaf, _qparam_axis(keys, tuple(getattr(leaf, "shape", ())), tp,
                           n_kv), i, tp)) for i in range(tp)]


def _cache_axis(name, shape: tuple, tp: int) -> Optional[int]:
    if tp <= 1:
        return None
    if name in ("k", "v") and len(shape) >= 4:
        if shape[-2] % tp:
            raise ValueError(f"cache {name}: KV-head axis {shape[-2]} not "
                             f"divisible by tp={tp}")
        return -2
    if name in ("k_scale", "v_scale") and len(shape) >= 1 \
            and shape[-1] % tp == 0:
        return -1
    return None


def _cache_shards(node, tp: int, name=None) -> list:
    if isinstance(node, dict):
        parts = {k: _cache_shards(v, tp, k) for k, v in _items(node)}
        return [{k: p[i] for k, p in parts.items()} for i in range(tp)]
    if dataclasses.is_dataclass(node):
        fields = {f.name: getattr(node, f.name)
                  for f in dataclasses.fields(node)}
        axes = {n: _cache_axis(n, tuple(getattr(v, "shape", ())), tp)
                for n, v in fields.items()}
        return [dataclasses.replace(node, **{
            n: _take(fields[n], a, i, tp) for n, a in axes.items()
            if a is not None}) for i in range(tp)]
    if hasattr(node, "shape"):
        axis = _cache_axis(name, tuple(node.shape), tp)
        return [_take(node, axis, i, tp) for i in range(tp)]
    return [node] * tp  # SSM states: replicated


def tp_cache_slices(cache: dict, *, tp: int) -> list:
    """The ``tp`` shards' cache trees: every KV cache (a dataclass with
    ``k``/``v`` and their scales, or a tree of such leaves) cut on its
    KV-head axis; SSM states and block tables replicated."""
    return _cache_shards(cache, tp)


def check_tp_cache(cache, tp: int) -> None:
    """Raise where ``tp_cache_slices`` would: a k/v leaf whose KV-head
    axis does not divide by ``tp`` (the reference's message); slices
    nothing."""
    if isinstance(cache, dict):
        for k, v in _items(cache):
            if hasattr(v, "shape") and not isinstance(v, dict):
                _cache_axis(k, tuple(v.shape), tp)
            else:
                check_tp_cache(v, tp)
    elif dataclasses.is_dataclass(cache):
        for name in ("k", "v"):
            leaf = getattr(cache, name, None)
            if leaf is not None:
                _cache_axis(name, tuple(leaf.shape), tp)


def _lookup(tree: dict, keys: tuple):
    for k in keys:
        tree = tree[k]
    return tree
