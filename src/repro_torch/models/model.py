"""CausalLM: tied token embedding -> decoder stack -> tied readout.

Counterpart of ``repro/models/model.py::CausalLM`` for text models.  The
VLM / audio frontends and ``EncDecLM`` are ROADMAP Queue A item 17.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import Embedding
from repro_torch.models.module import Dense, Module
from repro_torch.models.transformer import Stack


class CausalLM(Module):
    def __init__(self, cfg):
        self.cfg = cfg
        self.path = cfg.name
        self.embed = Embedding(cfg.vocab, cfg.d_model,
                               path=f"{self.path}/embed", dtype=cfg.dtype,
                               vocab_padded=cfg.vocab_padded)
        self.stack = Stack(cfg, path=f"{self.path}/stack")
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_padded,
                                 path=f"{self.path}/lm_head", dtype=cfg.dtype)

    def init(self, gen: torch.Generator) -> dict:
        p = {"embed": self.embed.init(gen), "stack": self.stack.init(gen)}
        if not self.cfg.tie_embeddings:
            p["lm_head"] = self.lm_head.init(gen)
        return p

    def readout_fn(self, params, ctx=None):
        """(B, c, d) -> (B, c, Vp) logits; padded vocab entries masked.  The
        tied readout is never quantized, in any mode (as in the
        reference); an untied ``lm_head`` is a Dense and follows ``ctx``."""
        if self.cfg.tie_embeddings:
            return lambda h: self.embed.attend(params["embed"], h, ctx)

        def head(h):
            logits = self.lm_head(params["lm_head"], h, ctx)
            if self.cfg.vocab_padded != self.cfg.vocab:
                pad = torch.arange(self.cfg.vocab_padded,
                                   device=logits.device) >= self.cfg.vocab
                logits = logits.masked_fill(pad, -1e9)
            return logits

        return head

    def hidden(self, params, batch, ctx=None):
        """Backbone only: final hidden states (B, S, d)."""
        x = self.embed(params["embed"], batch["tokens"])
        return self.stack(params["stack"], x, ctx)

    def __call__(self, params, batch, ctx=None):
        return self.readout_fn(params, ctx)(self.hidden(params, batch, ctx))

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None,
                   kv_bits: int = 8):
        """Per-layer dense KV caches for ``max_len`` positions, int8 or
        packed int4 (``kv_bits=4``)."""
        return self.stack.init_cache(batch, max_len, device, kv_bits)

    def prefill(self, params, batch, cache, ctx=None):
        x = self.embed(params["embed"], batch["tokens"])
        h, cache = self.stack.prefill(params["stack"], x, cache, ctx)
        # only the last position's logits are needed to start decoding
        return self.readout_fn(params, ctx)(h[:, -1:, :]), cache

    def decode_step(self, params, tokens, cache, cur_pos: int, ctx=None):
        """tokens (B, 1) at position ``cur_pos`` -> (logits (B, 1, Vp),
        cache)."""
        x = self.embed(params["embed"], tokens)
        h, cache = self.stack.decode(params["stack"], x, cache, cur_pos, ctx)
        return self.readout_fn(params, ctx)(h), cache


def build_model(cfg):
    if cfg.family != "causal":
        raise NotImplementedError(
            f"{cfg.family} models are ROADMAP Queue A item 17")
    return CausalLM(cfg)
