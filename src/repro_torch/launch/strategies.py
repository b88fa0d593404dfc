"""``DecodeStrategy``: one decode-loop API, many decoding schemes.

Counterpart of ``repro/launch/strategies.py``.  A strategy supplies four
hooks over the decode carry (pending token, cache, per-slot position,
active mask, PRNG key, history):

  * ``propose(tok, pos, hist)`` -> draft tokens (B, W - 1);
  * ``verify(params, qparams, tok, drafts, cache, pos, active)`` ->
    (logits (B, W, V), cache);
  * ``accept(tok, drafts, logits, active, key)`` -> (next pending token
    (B,), toks (B, W), emitted (B, W) bool, key);
  * ``update_hist(hist, pos, toks, emitted)`` -> hist,

where W = ``emit_width`` is the number of tokens a step can emit, and the
loops own the capacity guard, EOS freezing, the non-finite-logits freeze
and position accounting, once for every strategy.  Three strategies ship,
as in the reference: greedy, sampled (temperature / top-p, with the
reference's PRNG key schedule through ``launch/prng.py``) and prompt-lookup
speculative decoding (drafts from an n-gram match in the token history,
verified as one window, accepted by the longest matching prefix: the
tokens are greedy's).  PyTorch runs eagerly, so the reference's scans are
Python loops whose carry stays on the device; each step reads nothing back
to the host, so ``launch/graphs.py`` captures it.
"""
from __future__ import annotations

import abc
import dataclasses

import torch

from repro_torch.cache import layer_caches
from repro_torch.core import api as A
from repro_torch.launch import prng
from repro_torch.launch.steps import attn_cache_len
from repro_torch.models.transformer import attention_only

STRATEGIES = ("greedy", "sample", "speculative")


def _check_attn_only(model, what: str):
    """The reference's refusal of SSM and hybrid stacks (their state
    stepping has no per-slot freeze or rewind); a model without a config
    (a test stub) passes."""
    cfg = getattr(model, "cfg", None)
    if cfg is None or attention_only(cfg):
        return
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    raise ValueError(
        f"{what} covers attention-only text stacks: SSM state "
        "stepping has no per-slot freeze/rewind yet "
        f"(got kinds={sorted(kinds)}, modality={cfg.modality})")


def sample_tokens(logits, key, *, temperature: float = 1.0,
                  top_p: float = 1.0):
    """Temperature / nucleus (top-p) sampling over (B, V) logits; (B,)
    int64.  ``temperature <= 0`` is greedy argmax.  ``top_p < 1`` keeps the
    smallest prefix of probability-sorted tokens whose mass reaches top_p
    (always at least the argmax).  ``key`` is one (2,) key for the batch
    (noise drawn over (B, V)) or (B, 2) keys, one a row (each row's noise
    drawn over (V,), as the reference's vmapped per-slot draw)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    lg = logits.float() / max(temperature, 1e-6)
    if top_p < 1.0:
        sorted_l = torch.sort(lg, dim=-1, descending=True).values
        e = torch.exp(sorted_l - sorted_l[..., :1])
        probs = e / torch.sum(e, dim=-1, keepdim=True)
        # exclusive cumulative mass: a token stays while the mass BEFORE it
        # is < top_p, so the argmax always survives
        cum = torch.cumsum(probs, dim=-1) - probs
        keep = cum < top_p
        thresh = torch.amin(torch.where(keep, sorted_l, torch.inf), dim=-1,
                            keepdim=True)
        lg = torch.where(lg >= thresh, lg, -torch.inf)
    return prng.categorical(key, lg)


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
        emit_width, V), cache); ``active`` is the (B,) slot mask or None."""

    @abc.abstractmethod
    def accept(self, tok, drafts, logits, active, key):
        """(next pending token (B,), toks (B, W), emitted (B, W) bool,
        key)."""

    def update_hist(self, hist, pos, toks, emitted):
        return hist


def _emitted(nxt, active):
    if active is None:
        return torch.ones(nxt.shape + (1,), dtype=torch.bool,
                          device=nxt.device)
    return active[:, None]


class GreedyStrategy(DecodeStrategy):
    """Argmax decoding: verify is the one-token decode step (the decode
    kernel), accept its argmax."""

    def verify(self, serve_params, qparams, tok, drafts, cache, pos, active):
        ctx = A.make_ctx(self.mode, self.policy, qparams)
        return self.model.decode_step(serve_params, tok[:, None], cache, pos,
                                      ctx, slot_mask=active)

    def accept(self, tok, drafts, logits, active, key):
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        return nxt, nxt[:, None], _emitted(nxt, active), key


class SamplingStrategy(GreedyStrategy):
    """Temperature / nucleus sampling, with the reference's two key
    schedules, picked by the carried key's shape:

      * one (2,) key, split once a step and shared by every slot (the
        single-stream loops);
      * (B, 2) keys, one a slot: each slot splits its own key, and a frozen
        slot keeps its key, so a request's stream depends only on its
        admission key and the tokens it has emitted (the scheduler)."""

    def __init__(self, model, policy, mode: str = "int8", *,
                 temperature: float = 1.0, top_p: float = 1.0):
        super().__init__(model, policy, mode)
        self.temperature, self.top_p = temperature, top_p

    def accept(self, tok, drafts, logits, active, key):
        last = logits[:, -1, :]
        kw = dict(temperature=self.temperature, top_p=self.top_p)
        if key.dim() == 2:
            ks = prng.split(key)                       # (B, 2, 2)
            nxt = sample_tokens(last, ks[:, 0], **kw)
            if active is None:
                key = ks[:, 1]
            else:
                key = torch.where(active[:, None], ks[:, 1], key)
            return nxt, nxt[:, None], _emitted(nxt, active), key
        ks = prng.split(key)
        nxt = sample_tokens(last, ks[1], **kw)
        return nxt, nxt[:, None], _emitted(nxt, active), ks[0]


class SpeculativeStrategy(DecodeStrategy):
    """Prompt-lookup speculative decoding (no second model).

    ``propose`` matches the trailing ``ngram`` tokens of the history
    (absolute position -> token: the prompt and everything emitted,
    including the pending token) against earlier history; the most recent
    match's continuation becomes the ``draft_k`` drafts (the pending token
    repeated when nothing matches).  ``verify`` runs [pending, drafts] as
    one (B, k+1) window through ``model.verify_step``; ``accept`` keeps the
    longest prefix of drafts equal to the model's own argmax, plus the
    model's next token after it: the emitted tokens are greedy's.  Every
    index is data, so one captured window serves every match pattern."""

    stateful = True

    def __init__(self, model, policy, mode: str = "int8", *,
                 draft_k: int = 4, ngram: int = 2):
        super().__init__(model, policy, mode)
        _check_attn_only(model, "speculative decoding")
        if draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.draft_k, self.ngram = draft_k, ngram
        self.emit_width = draft_k + 1

    def propose(self, tok, pos, hist):
        b, h = hist.shape
        g, k = self.ngram, self.draft_k
        if h < g + 1:
            raise ValueError(
                f"history buffer ({h}) shorter than ngram+1 ({g + 1})")
        dev = hist.device
        pos = pos.to(torch.long).reshape(-1)
        j = torch.arange(g, device=dev)
        # the trailing n-gram ends at the pending token (hist[pos])
        gram = torch.gather(hist, 1, torch.clamp(pos[:, None] - (g - 1)
                                                 + j[None], 0, h - 1))
        starts = torch.arange(h - g + 1, device=dev)
        wins = hist[:, starts[:, None] + j[None]]             # (B, n, g)
        hit = (wins == gram[:, None, :]).all(dim=-1)
        # a usable match ends before the trailing gram starts, so its
        # continuation (the draft source) is known history
        usable = hit & (starts[None, :] <= pos[:, None] - g)
        best = torch.amax(torch.where(usable, starts[None, :], -1), dim=1)
        src = torch.clamp_min(best, 0) + g
        didx = src[:, None] + torch.arange(k, device=dev)[None]
        # draft reads clamp to known history (correctness never depends on
        # the drafts)
        didx = torch.clamp(torch.minimum(didx, pos[:, None]), 0, h - 1)
        drafts = torch.gather(hist, 1, didx)
        return torch.where((best >= 0)[:, None], drafts, tok[:, None])

    def verify(self, serve_params, qparams, tok, drafts, cache, pos, active):
        ctx = A.make_ctx(self.mode, self.policy, qparams)
        window = torch.cat([tok[:, None], drafts], dim=1)
        return self.model.verify_step(serve_params, window, cache, pos, ctx,
                                      slot_mask=active)

    def accept(self, tok, drafts, logits, active, key):
        w = self.emit_width
        pred = torch.argmax(logits, dim=-1)                   # (B, W)
        # accepted drafts equal the model's argmax at their position, so the
        # emitted tokens are pred[:n_match + 1]
        match = (drafts == pred[:, :-1]).to(torch.int32)
        n_match = torch.cumprod(match, dim=1).sum(dim=1)
        lanes = torch.arange(w, device=pred.device)[None]
        emitted = lanes <= n_match[:, None]
        if active is not None:
            emitted = emitted & active[:, None]
        nxt = torch.gather(pred, 1, torch.clamp(n_match, 0, w - 1)[:, None])
        return nxt[:, 0], pred, emitted, key

    def update_hist(self, hist, pos, toks, emitted):
        """Record the step's emissions at their absolute positions (``pos``
        is the pre-step position; lane j lands at ``pos + 1 + j``); lanes
        not emitted, or past the buffer, are dropped."""
        b, h = hist.shape
        idx = (pos.to(torch.long)[:, None] + 1
               + torch.arange(toks.shape[1], device=hist.device)[None])
        return _scatter_drop(hist, idx, toks, emitted & (idx < h))


def _scatter_drop(buf, idx, vals, keep):
    """``buf.at[rows, idx].set(vals, mode="drop")`` for the lanes in
    ``keep``: the others write into a spare column that is cut off."""
    b, n = buf.shape
    ext = torch.cat([buf, buf.new_zeros((b, 1))], dim=1)
    ext.scatter_(1, torch.where(keep, idx, n), vals.to(buf.dtype))
    return ext[:, :n]


def make_strategy(name, model, policy: A.QuantPolicy, *,
                  temperature: float = 0.0, top_p: float = 1.0,
                  spec_k: int = 4, spec_ngram: int = 2,
                  mode: str = "int8") -> DecodeStrategy:
    """A strategy by name, serving in ``mode`` ("int8" or "none"); ``None``
    picks "sample" when temperature > 0, else "greedy", as the reference
    does, with its errors."""
    if name is None:
        name = "sample" if temperature > 0.0 else "greedy"
    if name == "greedy":
        if temperature > 0.0:
            raise ValueError("greedy decoding ignores temperature: drop the "
                             "temperature or use strategy='sample'")
        return GreedyStrategy(model, policy, mode)
    if name == "sample":
        return SamplingStrategy(model, policy, mode, temperature=temperature,
                                top_p=top_p)
    if name == "speculative":
        if temperature > 0.0:
            raise ValueError("speculative decoding uses the deterministic "
                             "(greedy) accept rule; temperature must be 0")
        return SpeculativeStrategy(model, policy, mode, draft_k=spec_k,
                                   ngram=spec_ngram)
    raise ValueError(f"unknown decode strategy {name!r} (use one of "
                     f"{STRATEGIES})")


def _rollback(cache, pos):
    """The logical rewind of every layer's cache to ``pos`` (free in every
    layout: entries past pos are dead)."""
    for c in layer_caches(cache):
        c.rollback(pos)
    return cache


def seed_hist(hist, prompt, tok0):
    """Seed a history buffer in place: ``prompt`` (B, S) at positions
    [0, S), the pending first token ``tok0`` (B,) at S, zeros after."""
    s = prompt.shape[1]
    hist.zero_()
    hist[:, :s].copy_(prompt)
    hist[:, s].copy_(tok0)
    return hist


# -- the loops (own the steps; strategies own the scheme) ---------------------

@dataclasses.dataclass
class WindowState:
    """The carry of the windowed single-stream loop, in tensors a step
    updates in place (so a captured step replays the generation): the
    pending token and position per row, the count of tokens out, the
    (B, n_steps) output buffer (its first column the first token), the
    PRNG key and the history buffer."""
    tok: torch.Tensor       # (B,) int64
    pos: torch.Tensor       # (B,) int32
    n_out: torch.Tensor     # (B,) int32
    out: torch.Tensor       # (B, n_steps) int64
    key: torch.Tensor       # (2,) int64
    hist: torch.Tensor      # (B, H) int64

    def start(self, tok0, pos0: int):
        """Begin a generation at ``tok0`` (B,), every row at ``pos0``; the
        history is the caller's to seed."""
        self.tok.copy_(tok0)
        self.pos.fill_(pos0)
        self.n_out.fill_(1)
        self.out.zero_()
        self.out[:, 0].copy_(tok0)
        return self


def make_token_step(strategy: DecodeStrategy):
    """One step of a one-token strategy over static buffers, the body that
    ``Engine.generate_batch`` captures: ``(params, qparams, tok (B,) int64,
    cache, pos (B,) int32, key (2,)) -> logits (B, 1, Vp)``.  Decodes
    ``tok`` at the positions ``pos`` (the per-slot branch of the decode:
    positions read on the device), then writes the next token into ``tok``
    (argmax, or sampled with one split of ``key``), advances ``pos`` by one
    and the key by its split, in place, so replaying the step walks the
    generation: the tokens and logits of ``make_strategy_decode_loop``'s
    steps, bit for bit."""
    def token_step(serve_params, qparams, tok, cache, pos, key):
        logits, _ = strategy.verify(serve_params, qparams, tok, None, cache,
                                    pos, None)
        nxt, _, _, new_key = strategy.accept(tok, None, logits, None, key)
        tok.copy_(nxt)
        pos.add_(1)
        if new_key is not key:
            key.copy_(new_key)
        return logits

    return token_step


def make_window_step(strategy: DecodeStrategy, n_steps: int):
    """One window of the windowed single-stream loop: ``(params, qparams,
    st: WindowState, cache) -> None``, updating ``st`` in place.  A row is
    active while it has budget left (``n_out < n_steps``) and room for a
    whole window in the cache; each window scatters its emissions at the
    row's write cursor, lanes past the budget dropped."""
    w = strategy.emit_width

    def window_step(serve_params, qparams, st: WindowState, cache):
        tok, pos = st.tok, st.pos
        active = (st.n_out < n_steps) & (pos + w <= attn_cache_len(cache))
        drafts = strategy.propose(tok, pos, st.hist)
        logits, cache = strategy.verify(serve_params, qparams, tok, drafts,
                                        cache, pos, active)
        nxt, toks, emitted, key = strategy.accept(tok, drafts, logits,
                                                  active, st.key)
        nxt = torch.where(active, nxt, tok)
        toks = torch.where(emitted, toks, tok[:, None])
        e = emitted.to(torch.int32)
        idx = (st.n_out[:, None] + torch.cumsum(e, dim=1) - e).to(torch.long)
        st.out.copy_(_scatter_drop(st.out, idx, toks,
                                   emitted & (idx < n_steps)))
        st.hist.copy_(strategy.update_hist(st.hist, pos, toks, emitted))
        n_acc = e.sum(dim=1, dtype=torch.int32)
        pos.add_(n_acc)
        st.n_out.add_(n_acc)
        _rollback(cache, pos)
        tok.copy_(nxt)
        st.key.copy_(key)

    return window_step


def make_strategy_decode_loop(model, policy: A.QuantPolicy,
                              strategy: DecodeStrategy, n_steps: int = 16):
    """Single-stream whole-generation decode: ``(params, qparams, tok0 (B,),
    cache, pos0, key=None, hist=None) -> (tokens (B, n_steps), cache)``,
    tokens[:, 0] == tok0.

    ``emit_width == 1``: n_steps - 1 steps at the host int positions
    ``pos0 + i`` (the eager ``loop=True`` driver), the key split once a
    step by a sampling strategy.  Windowed strategies (speculative) need
    their history buffer (the prompt and tok0, ``seed_hist``) and always
    run n_steps - 1 windows (``make_window_step``), as the reference's scan
    does: one token a window fills the budget, and rows that filled it
    early freeze."""
    w = strategy.emit_width

    def decode_loop(serve_params, qparams, tok0, cache, pos0, key=None,
                    hist=None):
        if key is None:
            key = prng.PRNGKey(0, tok0.device)
        if w == 1:
            toks, tok = [tok0], tok0
            for i in range(n_steps - 1):
                logits, cache = strategy.verify(serve_params, qparams, tok,
                                                None, cache, pos0 + i, None)
                tok, _, _, key = strategy.accept(tok, None, logits, None,
                                                 key)
                toks.append(tok)
            return torch.stack(toks, dim=1), cache
        if hist is None:
            raise ValueError(
                "a stateful strategy needs its history buffer (seed it with "
                "the prompt tokens + tok0; see strategies.seed_hist)")
        b, dev = tok0.shape[0], tok0.device
        st = WindowState(
            tok=torch.empty((b,), dtype=torch.long, device=dev),
            pos=torch.empty((b,), dtype=torch.int32, device=dev),
            n_out=torch.empty((b,), dtype=torch.int32, device=dev),
            out=torch.empty((b, n_steps), dtype=torch.long, device=dev),
            key=key.clone(), hist=hist.clone()).start(tok0, int(pos0))
        step = make_window_step(strategy, n_steps)
        for _ in range(n_steps - 1):
            step(serve_params, qparams, st, cache)
        return st.out, cache

    return decode_loop


def make_strategy_slot_loop(model, policy: A.QuantPolicy,
                            strategy: DecodeStrategy, n_steps: int = 8,
                            eos_id: int = -1):
    """One continuous-batching decode block under ``strategy``.

    Each of the ``n_steps`` steps runs propose -> verify -> accept, then
    the loop's bookkeeping:

      * capacity guard BEFORE the write: a slot without room for a whole
        ``emit_width`` window freezes instead of clamp-writing;
      * non-finite logits freeze only the slot that produced them: it
        emits nothing from that step on and comes back flagged in ``bad``.
        The optional ``nan_step`` ((B,) int32, -1 = never) forces a live
        slot's logits to NaN at that in-block step, the fault-injection
        hook (``launch/faults.py``): data, so a faulted block replays the
        clean block's capture;
      * EOS (``eos_id >= 0``): the EOS lane itself is emitted, later lanes
        are cut and the slot freezes, holding the EOS as its pending token,
        without touching the rest of the batch;
      * positions advance by each slot's emitted count (slots drain at
        different rates under speculation).

    ``(params, qparams, tok0 (B,), cache, pos0 (B,), active0 (B,), key=None,
    hist=None, nan_step=None) -> (toks (B, n_steps * W), emitted (B,
    n_steps * W), cache, pos, active, key, hist, bad)``, lane j of step i at
    column i * W + j.
    ``key`` is one (2,) key or (B, 2) per-slot keys.  The carry stays on the
    device: the block needs no host synchronization.  SSM and hybrid
    stacks raise, as in the reference."""
    _check_attn_only(model, "slot decode")
    w = strategy.emit_width

    def slot_loop(serve_params, qparams, tok0, cache, pos0, active0,
                  key=None, hist=None, nan_step=None):
        if strategy.stateful and hist is None:
            raise ValueError("a stateful strategy needs its history buffer")
        cache_len = attn_cache_len(cache)
        tok = torch.as_tensor(tok0).to(torch.long)
        pos = torch.as_tensor(pos0).to(torch.int32)
        active = torch.as_tensor(active0).to(torch.bool)
        if key is None:
            key = prng.PRNGKey(0, tok.device)
        if hist is None:
            hist = tok.new_zeros((tok.shape[0], 0))
        bad_acc = torch.zeros_like(active)
        all_toks, all_emitted = [], []
        for i in range(n_steps):
            active = active & (pos + w <= cache_len)
            drafts = strategy.propose(tok, pos, hist)
            logits, cache = strategy.verify(serve_params, qparams, tok,
                                            drafts, cache, pos, active)
            if nan_step is not None:
                # an injected fault: the scheduled slots' logits turn NaN
                # here and take the detection below, as a model fault would
                hit = (nan_step == i) & active
                logits = logits.masked_fill(hit[:, None, None], float("nan"))
            nxt, toks, emitted, key = strategy.accept(tok, drafts, logits,
                                                      active, key)
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
                eos_hit = (iseos & emitted).any(dim=1)
                active = active & ~eos_hit
                if w > 1:
                    # the held token of a frozen slot is its last emission
                    # (the EOS), as in the one-token loops
                    last = torch.clamp(emitted.sum(dim=1) - 1, 0, w - 1)
                    held = torch.gather(toks, 1, last[:, None])[:, 0]
                    nxt = torch.where(eos_hit, held, nxt)
            hist = strategy.update_hist(hist, pos, toks, emitted)
            pos = pos + emitted.sum(dim=1, dtype=torch.int32)
            cache = _rollback(cache, pos)
            tok = nxt
            all_toks.append(toks)
            all_emitted.append(emitted)
        return (torch.cat(all_toks, dim=1), torch.cat(all_emitted, dim=1),
                cache, pos, active, key, hist, bad_acc)

    return slot_loop
