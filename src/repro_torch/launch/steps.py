"""Step functions of the serving path: §2 calibration, one-shot prefill
and the greedy decode loop.

Counterparts of ``repro/launch/steps.py`` (``make_calibrate_step``, the
one-shot ``make_prefill_step``) and of the greedy strategy and
single-stream decode loop of ``repro/launch/strategies.py``.  PyTorch runs
eagerly, so the reference's ``lax.scan`` decode loop is a Python loop over
``decode_step``; ``argmax`` takes the first maximum, like ``jnp.argmax``.
Chunked prefill, sampling and speculative decoding are ROADMAP Queue A
items 9, 10 and 13.
"""
from __future__ import annotations

import torch

from repro_torch.core import api as A


def make_calibrate_step(model, policy: A.QuantPolicy):
    def calibrate_step(params, qparams, batch):
        ctx = A.make_ctx("calibrate", policy, qparams)
        model.hidden(params, batch, ctx)
        merged = dict(qparams)
        for path, obs in ctx.updates.items():
            if A.is_kv_path(path):
                merged[path] = obs
            else:
                merged[path] = {**merged[path], "act": obs}
        return merged

    return calibrate_step


def make_prefill_step(model, policy: A.QuantPolicy):
    """One-shot int8 prefill: (params, qparams, batch, cache) -> (logits of
    the last position (B, 1, Vp), cache)."""
    def prefill_step(serve_params, qparams, batch, cache):
        ctx = A.make_ctx("int8", policy, qparams)
        return model.prefill(serve_params, batch, cache, ctx)

    return prefill_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 token ids, first maximum on ties."""
    return torch.argmax(logits, dim=-1)


def make_decode_loop(model, policy: A.QuantPolicy, n_steps: int = 16):
    """Greedy int8 whole-generation decode: (params, qparams, tok0 (B,),
    cache, pos0) -> (tokens (B, n_steps), cache) with tokens[:, 0] == tok0
    and n_steps - 1 decode steps."""
    def decode_loop(serve_params, qparams, tok0, cache, pos0: int):
        ctx = A.make_ctx("int8", policy, qparams)
        toks = [tok0]
        for i in range(n_steps - 1):
            logits, cache = model.decode_step(serve_params, toks[-1][:, None],
                                              cache, pos0 + i, ctx)
            toks.append(greedy(logits[:, -1, :]))
        return torch.stack(toks, dim=1), cache

    return decode_loop
