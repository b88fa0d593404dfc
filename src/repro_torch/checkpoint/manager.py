"""Checkpoint manager: atomic, keep-N, restore onto an explicit device.

Counterpart of ``repro/checkpoint/manager.py``, with its on-disk format,
so either package restores the other's checkpoints:

  * ``ckpt_{step:010d}/arrays.npz`` holds every leaf of the tree under its
    path, keys joined by ``\\x1f`` (layer paths contain "/" themselves);
    ``meta.json`` the caller's metadata plus ``step``; a ``COMMITTED``
    marker is written last;
  * atomic: the directory is written under a temporary name and renamed
    with ``os.replace``, so a killed writer never corrupts the newest
    checkpoint, and ``restore_latest`` skips directories without the
    marker;
  * keep-N: older checkpoints are deleted after each save;
  * the data pipeline's position is the step, so a restored run consumes
    the exact remaining stream.

bfloat16 leaves are written through a ``uint16`` view as the 2-byte void
dtype ``|V2``: the bytes the reference writes, since ``np.savez`` stores
its ml_dtypes bfloat16 that way.  On restore ``|V2`` becomes
``torch.bfloat16`` (no other 2-byte void is written here).  The reference
hands ``|V2`` back as it is, which JAX rejects (ROADMAP Queue C).  String
leaves (a KV cache snapshot's layout name) come back as 0-d numpy arrays.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch

# separator that never occurs in tree keys: quantization-state keys are
# layer paths that contain "/" themselves
_SEP = "\x1f"
_BF16_ON_DISK = np.dtype("V2")


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(f"tree key {k!r} contains the separator")
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{i}" if prefix else str(i)))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        keys = path.split(_SEP)
        d = root
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = v
    return root


def _to_numpy(leaf) -> np.ndarray:
    """A tensor (any device) or array-like -> the numpy array written."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(_BF16_ON_DISK)
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(a: np.ndarray, device):
    """A read leaf as a tensor on ``device``; a string leaf (a cache
    snapshot's layout name) stays the numpy array it was read as."""
    if a.dtype.kind in "US":
        return a
    if a.dtype == _BF16_ON_DISK:
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write --------------------------------------------------------------
    def save(self, step: int, tree: dict, metadata: dict | None = None):
        arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            meta = dict(metadata or {})
            meta["step"] = int(step)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            # completion marker written last inside the temp dir
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            final = os.path.join(self.dir, f"ckpt_{step:010d}")
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self):
        ckpts = self.list_steps()
        for s in ckpts[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"ckpt_{s:010d}"),
                          ignore_errors=True)

    # -- read ---------------------------------------------------------------
    def list_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def restore(self, step: int, device=None):
        """(tree of tensors, metadata) of checkpoint ``step``; the tensors
        lie on ``device`` (None: the CPU)."""
        path = os.path.join(self.dir, f"ckpt_{step:010d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: _to_tensor(z[k], device) for k in z.files}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return _unflatten(flat), meta

    def restore_latest(self, device=None):
        """The newest committed checkpoint, or (None, None)."""
        steps = self.list_steps()
        if not steps:
            return None, None
        return self.restore(steps[-1], device)
