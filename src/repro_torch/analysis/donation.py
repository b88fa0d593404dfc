"""Aliasing and the freeze contract.

Counterpart of ``repro/analysis/donation.py``.  The reference donates the
KV cache into every jitted step; the port writes its caches in place
(the captured steps read and write the same tensors on every replay).
Both are sound only when no two leaves of a cache share bytes: otherwise
one leaf's write lands in another's.

``donate.duplicate-buffer``
    Two tensors of a cache tree overlap in storage (compared as byte
    ranges of their ``untyped_storage()``): the dense, ring, paged (pools,
    scales, block tables) and SSM (state, conv rows) layouts alike.

**Freeze (the TQT contract)**: after ``core.api.freeze_thresholds`` the
serving thresholds are static: no trained ``log2_t`` leaf survives, the
trainable mask of the KV entries is all False, and a serving step applies
no fake-quant (the QAT construct; serving quantizes for real).

``freeze.log2_t-leaf``
    A ``log2_t`` leaf is reachable in the serving qparams.

``freeze.trainable-mask``
    ``core.api.trainable_mask`` marks a KV serving-qparams leaf trainable.

``freeze.fake-quant-call``
    A recorded serving step called ``kernels.ops.fake_quant`` (B5 or its
    plain version), or ran a fake-quant function of the port (an op under
    a function named ``*fake_quant*``: the symmetric, asymmetric and log2
    fake-quants of ``core/quant.py``, the fake-mode KV quantizer).  The
    counterpart of ``freeze.fake-quant-eqn``.
"""
from __future__ import annotations

from collections import defaultdict

import torch

from repro_torch.analysis.report import Finding


def _leaves(tree, path=""):
    """(path, tensor) of every tensor in a cache tree: dicts, the cache
    objects' tensor attributes, tensors."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif hasattr(tree, "__dict__"):
        for k, v in vars(tree).items():
            if isinstance(v, (torch.Tensor, dict)) or hasattr(v, "__dict__"):
                yield from _leaves(v, f"{path}.{k}" if path else k)


def _byte_range(t: torch.Tensor) -> tuple:
    """[start, end) of the bytes ``t`` can address."""
    start = t.data_ptr()
    if t.numel() == 0:
        return start, start
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return start, start + span * t.element_size()


def check_duplicate_donation(tree, *, entry_point: str = "",
                             what: str = "cache") -> list[Finding]:
    """Flag tensors of ``tree`` (a cache tree) whose storage overlaps."""
    groups: dict = defaultdict(list)
    for path, t in _leaves(tree):
        key = (t.device, t.untyped_storage().data_ptr())
        groups[key].append((_byte_range(t), path))
    findings = []
    for (dev, ptr), leaves in sorted(groups.items(), key=lambda kv: kv[0][1]):
        leaves.sort()
        clash = []
        for (a, b) in zip(leaves, leaves[1:]):
            if b[0][0] < a[0][1]:
                clash += [a[1], b[1]]
        if clash:
            paths = sorted(set(clash))
            findings.append(Finding(
                analyzer="donation", code="donate.duplicate-buffer",
                entry_point=entry_point,
                message=f"{what}: leaves {paths} share bytes of one storage "
                        f"(ptr={ptr:#x} on {dev}): a write in place to one "
                        "lands in the other; give each leaf a buffer of its "
                        "own"))
    return findings


def check_frozen_qparams(qparams, *, entry_point: str = "") -> list[Finding]:
    """The contract after ``freeze_thresholds``: nothing trainable left in
    the KV thresholds."""
    from repro_torch.core import api as A

    findings: list[Finding] = []
    flat = A.flatten(qparams)
    log2_paths = ["/".join(map(str, k)) for k in flat if "log2_t" in k]
    if log2_paths:
        findings.append(Finding(
            analyzer="donation", code="freeze.log2_t-leaf",
            entry_point=entry_point,
            message=f"serving qparams still carry trained log2_t leaves "
                    f"({log2_paths[:4]}"
                    f"{'...' if len(log2_paths) > 4 else ''}): "
                    "freeze_thresholds was skipped; the engine would serve "
                    "off the raw training parameterization"))
    # scoped to the KV entries: activation and weight alphas are FAT-trained
    # scales that serve as static data; the freeze contract is about the
    # TQT KV thresholds
    mask = A.trainable_mask({p: e for p, e in qparams.items()
                             if A.is_kv_path(p)})
    live = ["/".join(map(str, k)) for k, m in A.flatten(mask).items() if m]
    if live:
        findings.append(Finding(
            analyzer="donation", code="freeze.trainable-mask",
            entry_point=entry_point,
            message=f"trainable_mask marks {len(live)} KV serving-qparams "
                    f"leaf(s) trainable (e.g. {live[0]}): frozen KV "
                    "thresholds must be invisible to the optimizer"))
    return findings


def check_no_fake_quant(rec, *, entry_point: str = "") -> list[Finding]:
    """No fake-quant in a recorded serving step: one finding per fake-quant
    function applied (``kernels.ops.fake_quant`` counted with its
    launches)."""
    launched = sum(1 for k in rec.kernels if k.kernel == "fake_quant"
                   and k.launched)
    calls = sum(1 for k in rec.kernels if k.kernel == "fake_quant")
    # located at the wrapper's caller where a wrapper was called
    where = {"fake_quant": k.location for k in rec.kernels
             if k.kernel == "fake_quant"}
    for op in rec.ops:
        if op.fake_quant:
            where.setdefault(op.fake_quant, op.location)
    findings = []
    for name, loc in sorted(where.items()):
        via = (f"kernels.ops.fake_quant: {calls} call(s), B5 launched "
               f"{launched} time(s)" if name == "fake_quant" else name)
        findings.append(Finding(
            analyzer="donation", code="freeze.fake-quant-call",
            entry_point=entry_point, location=loc,
            message=f"serving step applies a fake-quant (via {via}): "
                    "fake-quant is the QAT construct; serving quantizes for "
                    "real, so its presence means an unfrozen threshold or "
                    "the training path leaked into the hot path"))
    return findings
