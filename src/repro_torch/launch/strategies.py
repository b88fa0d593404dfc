"""``DecodeStrategy``: one decode-loop API, many decoding schemes.

Counterpart of ``repro/launch/strategies.py``.  A strategy supplies four
hooks over the decode carry (pending token, cache, per-slot position,
active mask, history):

  * ``propose(tok, pos, hist)`` -> draft tokens (B, W - 1);
  * ``verify(params, qparams, tok, drafts, cache, pos, active)`` ->
    (logits (B, W, V), cache);
  * ``accept(tok, drafts, logits, active)`` -> (next pending token (B,),
    toks (B, W), emitted (B, W) bool);
  * ``update_hist(hist, pos, toks, emitted)`` -> hist,

where W = ``emit_width`` is the number of tokens a step can emit, and the
loop (``make_strategy_slot_loop``) owns the capacity guard, EOS freezing,
the non-finite-logits freeze and position accounting, once for every
strategy.  The port has the greedy strategy; sampling is ROADMAP Queue A
item 10 and speculative decoding item 13.  PyTorch runs eagerly, so the
reference's scanned block is a Python loop whose carry stays on the device.
"""
from __future__ import annotations

import abc

import torch

from repro_torch.cache import layer_caches
from repro_torch.core import api as A
from repro_torch.launch.steps import attn_cache_len

STRATEGIES = ("greedy", "sample", "speculative")


class DecodeStrategy(abc.ABC):
    """One decoding scheme behind the propose / verify / accept hooks.
    ``emit_width`` is the number of token lanes a step emits into;
    ``stateful`` marks strategies that carry a history buffer."""

    emit_width: int = 1
    stateful: bool = False

    def __init__(self, model, policy: A.QuantPolicy, mode: str = "int8"):
        self.model, self.policy, self.mode = model, policy, mode

    def propose(self, tok, pos, hist):
        """Draft tokens (B, emit_width - 1) to verify this step."""
        return tok.new_zeros((tok.shape[0], 0))

    @abc.abstractmethod
    def verify(self, serve_params, qparams, tok, drafts, cache, pos, active):
        """Run the model over the pending token (and drafts): (logits (B,
        emit_width, V), cache); ``active`` is the (B,) slot mask."""

    @abc.abstractmethod
    def accept(self, tok, drafts, logits, active):
        """(next pending token (B,), toks (B, W), emitted (B, W) bool)."""

    def update_hist(self, hist, pos, toks, emitted):
        return hist


class GreedyStrategy(DecodeStrategy):
    """Argmax decoding: verify is the one-token decode step (the decode
    kernel), accept its argmax."""

    def verify(self, serve_params, qparams, tok, drafts, cache, pos, active):
        ctx = A.make_ctx(self.mode, self.policy, qparams)
        return self.model.decode_step(serve_params, tok[:, None], cache, pos,
                                      ctx, slot_mask=active)

    def accept(self, tok, drafts, logits, active):
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        return nxt, nxt[:, None], active[:, None]


def make_strategy(name, model, policy: A.QuantPolicy, *,
                  temperature: float = 0.0,
                  mode: str = "int8") -> DecodeStrategy:
    """A strategy by name, serving in ``mode`` ("int8" or "none"); ``None``
    picks "sample" when temperature > 0, else "greedy", as the reference
    does."""
    if name is None:
        name = "sample" if temperature > 0.0 else "greedy"
    if name == "greedy":
        if temperature > 0.0:
            raise ValueError("greedy decoding ignores temperature: drop the "
                             "temperature or use strategy='sample'")
        return GreedyStrategy(model, policy, mode)
    if name == "sample":
        raise NotImplementedError(
            "sampled decoding is not ported (ROADMAP Queue A item 10)")
    if name == "speculative":
        raise NotImplementedError(
            "speculative decoding is not ported (ROADMAP Queue A item 13)")
    raise ValueError(f"unknown decode strategy {name!r} (use one of "
                     f"{STRATEGIES})")


def _rollback(cache, pos):
    """The logical rewind of every layer's cache to ``pos`` (free in every
    layout: entries past pos are dead)."""
    for c in layer_caches(cache):
        c.rollback(pos)
    return cache


def make_strategy_slot_loop(model, policy: A.QuantPolicy,
                            strategy: DecodeStrategy, n_steps: int = 8,
                            eos_id: int = -1):
    """One continuous-batching decode block under ``strategy``.

    Each of the ``n_steps`` steps runs propose -> verify -> accept, then
    the loop's bookkeeping:

      * capacity guard BEFORE the write: a slot without room for a whole
        ``emit_width`` window freezes instead of clamp-writing;
      * non-finite logits freeze only the slot that produced them: it
        emits nothing from that step on and comes back flagged in ``bad``;
      * EOS (``eos_id >= 0``): the EOS lane itself is emitted, later lanes
        are cut and the slot freezes, without touching the rest of the
        batch;
      * positions advance by each slot's emitted count.

    ``(params, qparams, tok0 (B,), cache, pos0 (B,), active0 (B,), hist=None)
    -> (toks (B, n_steps * W), emitted (B, n_steps * W), cache, pos, active,
    hist, bad)``, lane j of step i at column i * W + j.  The carry stays on
    the device: the block needs no host synchronization."""
    w = strategy.emit_width
    if w != 1:
        raise NotImplementedError(
            "multi-token windows are speculative decoding (ROADMAP Queue A "
            "item 13)")

    def slot_loop(serve_params, qparams, tok0, cache, pos0, active0,
                  hist=None):
        if strategy.stateful and hist is None:
            raise ValueError("a stateful strategy needs its history buffer")
        cache_len = attn_cache_len(cache)
        tok = torch.as_tensor(tok0).to(torch.long)
        pos = torch.as_tensor(pos0).to(torch.int32)
        active = torch.as_tensor(active0).to(torch.bool)
        bad_acc = torch.zeros_like(active)
        all_toks, all_emitted = [], []
        for _ in range(n_steps):
            active = active & (pos + w <= cache_len)
            drafts = strategy.propose(tok, pos, hist)
            logits, cache = strategy.verify(serve_params, qparams, tok,
                                            drafts, cache, pos, active)
            nxt, toks, emitted = strategy.accept(tok, drafts, logits, active)
            nxt = torch.where(active, nxt, tok)       # frozen slots hold
            toks = torch.where(emitted, toks, tok[:, None])
            finite = torch.isfinite(logits.float()).all(dim=2).all(dim=1)
            bad = active & ~finite
            emitted = emitted & ~bad[:, None]
            nxt = torch.where(bad, tok, nxt)
            active = active & ~bad
            bad_acc = bad_acc | bad
            if eos_id >= 0:
                iseos = (toks == eos_id) & emitted
                before = torch.cumsum(iseos.to(torch.int32), dim=1) - iseos.to(
                    torch.int32)
                emitted = emitted & (before == 0)
                active = active & ~(iseos & emitted).any(dim=1)
            hist = strategy.update_hist(hist, pos, toks, emitted)
            pos = pos + emitted.sum(dim=1, dtype=torch.int32)
            cache = _rollback(cache, pos)
            tok = nxt
            all_toks.append(toks)
            all_emitted.append(emitted)
        return (torch.cat(all_toks, dim=1), torch.cat(all_emitted, dim=1),
                cache, pos, active, hist, bad_acc)

    return slot_loop
