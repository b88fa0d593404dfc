"""Sharding rules: which leaves split over which mesh axes.

Two sets of rules, the counterparts of ``repro/dist/sharding.py``'s:

  * the GSPMD rules of the production mesh (data x model, with a pod axis
    in front for two pods): ``ShardingRules``, ``multipod``,
    ``param_specs``, ``qparam_specs``, ``batch_specs`` and ``cache_specs``.
    The reference returns ``PartitionSpec`` trees; here each leaf's spec is
    a tuple with one entry per dim (a mesh-axis name, a tuple of names, or
    None: whole along that dim), and ``()`` replicates the leaf.
    ``local_shape`` gives a leaf's per-device shape under its spec and
    raises where a dim does not divide, as the reference's lowering does.
    The dry run (``launch/dryrun.py``) sizes each device by them; nothing
    is placed.
  * the tensor-parallel role rules of the sharded engine (``tp_*``).  The
    reference returns ``PartitionSpec`` trees that ``shard_map`` cuts the
    arrays by; the port applies the same rules directly: each ``*_slices``
    function returns one tree per shard whose leaves are views of the
    input's (torch tensors or numpy arrays alike), and raises the
    reference's ``ValueError`` on an axis that does not divide.

Tensor-parallel roles come from the param tree's own keys:
column-parallel projections
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
import math
from typing import Optional, Union

# column-parallel: output features split across shards (no epilogue)
TP_COL_KEYS = frozenset({"wq", "wk", "wv", "gate", "up", "fc1"})
# row-parallel: input features split; int32 reduce epilogue after the dot
TP_ROW_KEYS = frozenset({"wo", "down", "fc2"})


def _items(tree: dict):
    # the reference flattens dicts in sorted key order, so the first leaf
    # that raises is the same one
    return sorted(tree.items(), key=lambda kv: str(kv[0]))


def _map(tree, fn, keys: tuple = ()):
    """``fn(keys, leaf)`` over a nested dict, keys in sorted order (a bare
    leaf: ``fn((), leaf)``)."""
    if not isinstance(tree, dict):
        return fn(keys, tree)
    return {k: _map(v, fn, keys + (k,)) for k, v in _items(tree)}


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


# --------------------------------------------------------------------------
# The production mesh's GSPMD rules (the dry run's)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mesh-axis assignment knobs (the dry run's hillclimb surface)."""

    act_batch: Union[str, tuple] = "data"   # batch dim of activations/batches
    act_seq: Optional[str] = "model"        # residual-carry sequence axis (SP)
    tensor: str = "model"                   # tensor-parallel param axis
    kv_cache_layout: str = "batch"          # 'batch' | 'seq' cache sharding
    model_axis_size: int = 16               # divisibility guard for specs


def multipod(rules: ShardingRules) -> ShardingRules:
    """Two-pod variant: pure DP across pods, the batch over ('pod',
    'data')."""
    return dataclasses.replace(rules, act_batch=("pod", "data"))


def param_specs(model, params_a, rules: ShardingRules):
    """Spec tree for a (possibly int8-converted) param tree.

    Shape-driven, as the reference's: a weight matrix shards its last
    (output) axis over the tensor axis where it divides, a 1-d leaf
    likewise; everything else (biases, norms, scalar scales) replicates."""
    def spec(keys, leaf):
        shp = tuple(leaf.shape)
        if len(shp) >= 2 and shp[-1] % rules.model_axis_size == 0:
            return (None,) * (len(shp) - 1) + (rules.tensor,)
        if len(shp) == 1 and shp[-1] % rules.model_axis_size == 0:
            return (rules.tensor,)
        return ()

    return _map(params_a, spec)


def replicated_specs(tree):
    """The spec tree of a tree that replicates whole."""
    return _map(tree, lambda keys, leaf: ())


def qparam_specs(model, params_a, qparams_a, rules: ShardingRules):
    """Threshold state is a few floats per layer: all of it replicates."""
    return replicated_specs(qparams_a)


def batch_specs(batch_a, rules: ShardingRules):
    """Batch inputs (a dict of them, or one) shard the leading batch dim
    over the batch axis."""
    def spec(keys, leaf):
        nd = len(leaf.shape)
        return () if nd == 0 else (rules.act_batch,) + (None,) * (nd - 1)

    return _map(batch_a, spec)


def cache_tree(cache):
    """A cache tree with every cache object opened into a dict of its
    arrays, named as the caches' ``state_dict`` names them: ``k``, ``v``,
    ``k_scale``, ``v_scale`` of a KV cache, ``ssm`` and ``conv`` of an SSM
    state (the reference's leaf names)."""
    from repro_torch.cache.ssm import SSMState

    if isinstance(cache, dict):
        return {k: cache_tree(v) for k, v in cache.items()}
    if isinstance(cache, SSMState):
        return {"ssm": cache.ssm, "conv": cache.conv}
    if hasattr(cache, "_child_names"):
        return {n: getattr(cache, n) for n in cache._child_names()}
    return cache


def cache_specs(cache_a, rules: ShardingRules, model_size: int):
    """KV/SSM cache placement.

    The 'batch' layout shards a k/v leaf's batch dim over the batch axis;
    the 'seq' layout its sequence dim over the tensor axis where it
    divides (the batch dim otherwise).  Scale vectors and positions
    replicate; SSM states shard their batch dim.  Leaves are classified by
    their name (``cache_tree``): "k"/"v" are KV (the tail (B, S, KV, D)),
    any other leaf of 4 dims or more an SSM state, as in the reference, and
    a 3-d conv stream replicates."""
    def spec(keys, leaf):
        shp = tuple(leaf.shape)
        nd = len(shp)
        is_kv = bool(keys) and keys[-1] in ("k", "v")
        if nd < 3 or not (is_kv or nd >= 4):  # scales, positions
            return ()
        axes = [None] * nd
        if not is_kv:  # SSM states (B, H, N, P): batch over data
            axes[1 if nd >= 5 else 0] = rules.act_batch
            return tuple(axes)
        lead = nd - 4  # KV tail is (B, S, KV, D)
        if (rules.kv_cache_layout == "seq"
                and shp[lead + 1] % model_size == 0):
            axes[lead + 1] = rules.tensor
        else:
            axes[lead] = rules.act_batch
        return tuple(axes)

    return _map(cache_tree(cache_a), spec)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec: tuple, mesh_shape: dict) -> tuple:
    """The per-device shape of a leaf of global ``shape`` under ``spec``
    on a mesh of ``mesh_shape`` ({axis: size}).  A dim that its axes do
    not divide raises the reference's lowering error (it pads nothing)."""
    shape = tuple(shape)
    out = list(shape)
    for i, entry in enumerate(spec):
        n = math.prod(mesh_shape[a] for a in _axes(entry))
        if shape[i] % n:
            raise ValueError(
                f"the spec {spec} implies that the global size of its "
                f"dimension {i} should be divisible by {n}, but it is equal "
                f"to {shape[i]} (full shape: {shape})")
        out[i] = shape[i] // n
    return tuple(out)


def local_bytes(tree, spec_tree, mesh_shape: dict) -> int:
    """Bytes per device of a tree (nested dicts of tensors, a bare tensor)
    under its spec tree; raises where a leaf does not divide, naming the
    leaf's key path."""
    if isinstance(tree, dict):
        return sum(local_bytes(v, spec_tree[k], mesh_shape)
                   for k, v in tree.items())
    try:
        shp = local_shape(tree.shape, spec_tree, mesh_shape)
    except ValueError as e:
        raise ValueError(f"a leaf of shape {tuple(tree.shape)}: {e}") from None
    return math.prod(shp) * tree.dtype.itemsize
