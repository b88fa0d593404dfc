"""CausalLM: token embedding -> decoder stack -> tied or untied readout.

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

    def hidden(self, params, batch, ctx=None, *, with_aux: bool = False):
        """Backbone only: final hidden states (B, S, d); with ``with_aux``
        (h, aux), aux the summed MoE load-balance loss (a float32 zero
        without MoE layers), for the pretrain loss."""
        x = self.embed(params["embed"], batch["tokens"])
        h, aux = self.stack(params["stack"], x, ctx, with_aux=with_aux)
        if not with_aux:
            return h
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h, aux

    def __call__(self, params, batch, ctx=None):
        return self.readout_fn(params, ctx)(self.hidden(params, batch, ctx))

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None,
                   kv_bits: int = 8, *, layout: str = "dense",
                   page_size: int = 64, extra_pages: int = 0,
                   kv_int8: bool = True, dtype=torch.bfloat16):
        """Per-layer KV caches for ``max_len`` positions, int8 or packed
        int4 (``kv_bits=4``), or with ``kv_int8`` False float ``dtype``
        tiles with unit scales (``kv_bits`` ignored, as in the reference),
        in ``layout`` ("dense", "paged" with ``page_size`` and an
        ``extra_pages`` shared prefix region, or "ring"; in the last two a
        sliding-window layer shorter than ``max_len`` holds a ring of its
        window, so local and global layers may hold different layouts)."""
        return self.stack.init_cache(batch, max_len, device, kv_bits,
                                     layout=layout, page_size=page_size,
                                     extra_pages=extra_pages,
                                     kv_int8=kv_int8, dtype=dtype)

    def prefill(self, params, batch, cache, ctx=None):
        x = self.embed(params["embed"], batch["tokens"])
        h, cache = self.stack.prefill(params["stack"], x, cache, ctx)
        # only the last position's logits are needed to start decoding
        return self.readout_fn(params, ctx)(h[:, -1:, :]), cache

    def prefill_chunk(self, params, tokens, cache, q_offset: int, ctx=None,
                      *, lengths=None, kv_limit=None):
        """One chunk of a chunked prefill: tokens (B, chunk) at positions
        ``q_offset + arange(chunk)``, K/V appended at the same slots,
        attention masked to ``lengths`` (B,) and the first ``kv_limit``
        cache positions.  Returns the chunk's final hidden states (B,
        chunk, d) and the cache; the caller keeps each request's last
        valid position and applies the readout once
        (``launch/steps.py::make_prefill_step``)."""
        x = self.embed(params["embed"], tokens)
        return self.stack.prefill(params["stack"], x, cache, ctx,
                                  q_offset=q_offset, lengths=lengths,
                                  kv_limit=kv_limit)

    def decode_step(self, params, tokens, cache, cur_pos, ctx=None, *,
                    slot_mask=None):
        """tokens (B, 1) -> (logits (B, 1, Vp), cache).  ``cur_pos`` is an
        int, or a (B,) tensor of per-slot positions with ``slot_mask`` (B,)
        marking the live slots (the continuous-batching contract)."""
        x = self.embed(params["embed"], tokens)
        h, cache = self.stack.decode(params["stack"], x, cache, cur_pos, ctx,
                                     slot_mask)
        return self.readout_fn(params, ctx)(h), cache

    def verify_step(self, params, tokens, cache, cur_pos, ctx=None, *,
                    slot_mask=None):
        """The speculative verify pass: tokens (B, s), the pending token
        and s - 1 drafts, as one window at the per-slot positions
        ``cur_pos`` (B,).  Returns (logits (B, s, Vp), cache): position j's
        logits are the next-token distribution after token j.  The window's
        K/V append at ``cur_pos + [0, s)``; a rejected tail is dead data.
        Over a float cache, s == 1 is ``decode_step`` at vector positions,
        bit for bit."""
        x = self.embed(params["embed"], tokens)
        h, cache = self.stack.verify(params["stack"], x, cache, cur_pos, ctx,
                                     slot_mask)
        return self.readout_fn(params, ctx)(h), cache


    # -- quantization plans ---------------------------------------------------
    def fold_plan(self):
        """Pre-norm gammas fold into the projections that consume them
        (paper §3.1.2 analog): (norm path, [projection paths]) per block:
        the pre-norm into the attention's q / k / v and the SSM mixer's
        five input projections, the ffn norm into a gated MLP's gate and
        up.  Module paths, as the reference's plan names them.  An MoE
        block's ffn norm does not fold: the unquantized router reads it
        too."""
        plan = []
        for blk in self.stack.blocks:
            bp = blk.path
            targets = []
            if hasattr(blk, "attn"):
                targets += [f"{bp}/attn/wq", f"{bp}/attn/wk",
                            f"{bp}/attn/wv"]
            if hasattr(blk, "mamba"):
                mp = blk.mamba.path
                targets += [f"{mp}/z_proj", f"{mp}/x_proj", f"{mp}/b_proj",
                            f"{mp}/c_proj", f"{mp}/dt_proj"]
            plan.append((f"{bp}/pre_norm", targets))
            if blk.ffn_kind == "swiglu":
                plan.append((f"{bp}/ffn_norm", [blk.ffn.gate.path,
                                                blk.ffn.up.path]))
        return plan

    def equalization_plan(self):
        """§3.3 analog pairs: v -> o per attention, up -> down per gated
        MLP and per MoE (its expert weights rescale expert by expert); an
        SSM mixer has none."""
        plan = []
        for blk in self.stack.blocks:
            if hasattr(blk, "attn"):
                plan.append((blk.attn.wv.path, blk.attn.wo.path))
            if blk.ffn_kind != "none":
                plan.extend(blk.ffn.equalization_pairs())
            if hasattr(blk, "mamba"):
                plan.extend(blk.mamba.equalization_pairs())
        return plan


def build_model(cfg):
    if cfg.family != "causal":
        raise NotImplementedError(
            f"{cfg.family} models are ROADMAP Queue A item 17")
    return CausalLM(cfg)
