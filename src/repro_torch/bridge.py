"""Weight bridge: numpy trees from the reference package <-> torch tensors.

The reference's params are a nested dict of arrays and its qparams a flat
dict (layer path -> nested dict of arrays); the port keeps both layouts
and the layer paths, so the bridge converts leaves only.  It takes numpy
and nothing else: the caller turns JAX arrays into numpy
(``np.asarray``).  bfloat16 reaches numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects, so it crosses as its uint16 bit pattern.
"""
from __future__ import annotations

import numpy as np
import torch


def to_tensor(a) -> torch.Tensor:
    """One numpy array (or numpy scalar) -> a CPU tensor with the same
    dtype and bits."""
    a = np.array(a, order="C")        # a C-contiguous copy, 0-d kept
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _convert(tree):
    if isinstance(tree, dict):
        return {k: _convert(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)):
        return to_tensor(tree)
    raise TypeError(f"the bridge takes numpy arrays, got {type(tree)}")


def params_from_jax(numpy_tree: dict) -> dict:
    """Nested dict of numpy arrays (the reference's params) -> nested dict
    of CPU tensors with identical keys, dtypes and bits."""
    return _convert(numpy_tree)


def qparams_from_jax(flat_numpy_dict: dict) -> dict:
    """Flat qparams {layer path: nested dict of numpy arrays} -> the same
    layout with CPU tensors.  Every leaf crosses, the trained ones too
    (``alpha`` scales, the KV ``log2_t`` of a fine-tune in progress), so
    thresholds trained by the reference serve in the port unchanged."""
    return {path: _convert(entry) for path, entry in flat_numpy_dict.items()}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> a numpy array with the same dtype and bits (bfloat16
    as ``ml_dtypes.bfloat16`` through its uint16 pattern)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def qparams_to_numpy(qparams: dict) -> dict:
    """The port's qparams (or any nested dict of tensors) -> the same
    layout with numpy arrays, which the reference takes (``jnp.asarray``
    per leaf): every leaf crosses, those of the asymmetric scheme, the
    pointwise scales and the 0-d scalar-mode thresholds too."""
    if isinstance(qparams, dict):
        return {k: qparams_to_numpy(v) for k, v in qparams.items()}
    return to_numpy(qparams)


def tree_to(tree, device) -> dict:
    """Move every tensor of a nested dict to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)
