"""CausalLM: token embedding (after the projected patches of a VLM) ->
decoder stack -> tied or untied readout; EncDecLM: projected audio frames
-> bidirectional encoder, then token embedding -> causal decoder with
cross attention over the encoder's output -> tied readout.

Counterparts of ``repro/models/model.py``.  The modality frontends are the
reference's stubs: a batch carries precomputed patch embeddings
(``patches`` (B, mm_patches, mm_dim)) or frame embeddings (``frames`` (B,
S_enc, frame_dim)), and one Dense projects them to the model width.
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
        if cfg.modality == "vlm":
            # the stub projector of precomputed patch embeddings
            self.mm_proj = Dense(cfg.mm_dim, cfg.d_model,
                                 path=f"{self.path}/mm_proj", dtype=cfg.dtype)

    def init(self, gen: torch.Generator) -> dict:
        p = {"embed": self.embed.init(gen), "stack": self.stack.init(gen)}
        if not self.cfg.tie_embeddings:
            p["lm_head"] = self.lm_head.init(gen)
        if self.cfg.modality == "vlm":
            p["mm_proj"] = self.mm_proj.init(gen)
        return p

    def embed_inputs(self, params, batch, ctx=None):
        """The backbone's input (B, S, d): the token embeddings, after the
        projected patches of a VLM batch that carries them (S = P +
        S_text)."""
        x = self.embed(params["embed"], batch["tokens"])
        if self.cfg.modality == "vlm" and "patches" in batch:
            pe = self.mm_proj(params["mm_proj"], batch["patches"], ctx)
            x = torch.cat([pe.to(x.dtype), x], dim=1)
        return x

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
        without MoE layers), for the pretrain loss.  A VLM's hidden states
        include its patch positions, first."""
        x = self.embed_inputs(params, batch, ctx)
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
        x = self.embed_inputs(params, batch, ctx)
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
            elif blk.ffn_kind == "gelu":
                plan.append((f"{bp}/ffn_norm", [blk.ffn.fc1.path]))
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


class EncDecLM(Module):
    """Encoder-decoder (seamless-m4t's backbone): the projected audio
    frames through a bidirectional encoder, then a causal text decoder
    whose every layer cross-attends the encoder's output; tied readout.
    The decoder's cache tree holds each layer's KV cache and its cross
    cache (``init_cache(..., enc_len=)``)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.path = cfg.name
        self.embed = Embedding(cfg.vocab, cfg.d_model,
                               path=f"{self.path}/embed", dtype=cfg.dtype,
                               vocab_padded=cfg.vocab_padded)
        # the audio frontend's stub: frames arrive as (B, S_enc, frame_dim)
        self.frame_proj = Dense(cfg.frame_dim, cfg.d_model,
                                path=f"{self.path}/frame_proj",
                                dtype=cfg.dtype)
        self.encoder = Stack(cfg.replace(causal=False),
                             path=f"{self.path}/encoder")
        self.decoder = Stack(cfg, path=f"{self.path}/decoder", cross=True)

    def init(self, gen: torch.Generator) -> dict:
        return {"embed": self.embed.init(gen),
                "frame_proj": self.frame_proj.init(gen),
                "encoder": self.encoder.init(gen),
                "decoder": self.decoder.init(gen)}

    def encode(self, params, frames, ctx=None):
        """The encoder's output (B, S_enc, d), the memory the decoder
        attends."""
        x = self.frame_proj(params["frame_proj"], frames, ctx)
        return self.encoder(params["encoder"], x, ctx)[0]

    def readout_fn(self, params, ctx=None):
        return lambda h: self.embed.attend(params["embed"], h, ctx)

    def hidden(self, params, batch, ctx=None, *, with_aux: bool = False):
        """The decoder's final hidden states (B, S, d) over the batch's
        ``tokens``, attending the encoded ``frames``; with ``with_aux``
        (h, a float32 zero: no MoE layers)."""
        memory = self.encode(params, batch["frames"], ctx)
        x = self.embed(params["embed"], batch["tokens"])
        h, _ = self.decoder(params["decoder"], x, ctx, memory=memory)
        if not with_aux:
            return h
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    def __call__(self, params, batch, ctx=None):
        return self.readout_fn(params, ctx)(self.hidden(params, batch, ctx))

    def init_cache(self, batch: int, max_len: int, device=None,
                   kv_bits: int = 8, *, enc_len: int | None = None,
                   layout: str = "dense", page_size: int = 64,
                   extra_pages: int = 0, kv_int8: bool = True,
                   dtype=torch.bfloat16):
        """The decoder's caches (``CausalLM.init_cache``'s), each layer's
        beside a dense ``dtype`` cross cache of min(``max_len``,
        ``enc_len``) rows: the encoder positions that decode attends, as
        in the reference, which keeps the first ``max_len`` of them."""
        return self.decoder.init_cache(batch, max_len, device, kv_bits,
                                       enc_len=enc_len, layout=layout,
                                       page_size=page_size,
                                       extra_pages=extra_pages,
                                       kv_int8=kv_int8, dtype=dtype)

    def prefill(self, params, batch, cache, ctx=None):
        """Encode ``frames``, write every layer's cross cache from the
        memory, prefill the decoder over ``tokens``; the last position's
        logits (B, 1, Vp)."""
        memory = self.encode(params, batch["frames"], ctx)
        x = self.embed(params["embed"], batch["tokens"])
        h, cache = self.decoder.prefill(params["decoder"], x, cache, ctx,
                                        memory=memory)
        return self.readout_fn(params, ctx)(h[:, -1:, :]), cache

    def decode_step(self, params, tokens, cache, cur_pos, ctx=None, *,
                    slot_mask=None):
        """``CausalLM.decode_step``'s contract; each layer's cross
        attention reads its cross cache."""
        x = self.embed(params["embed"], tokens)
        h, cache = self.decoder.decode(params["decoder"], x, cache, cur_pos,
                                       ctx, slot_mask)
        return self.readout_fn(params, ctx)(h), cache

    def fold_plan(self):
        """Pre-norm gammas into q / k / v, the ffn norm into fc1, in the
        encoder's and the decoder's blocks (the cross norm does not fold:
        its attention's k and v read the memory)."""
        plan = []
        for stack in (self.encoder, self.decoder):
            for blk in stack.blocks:
                bp = blk.path
                plan.append((f"{bp}/pre_norm", [f"{bp}/attn/wq",
                                                f"{bp}/attn/wk",
                                                f"{bp}/attn/wv"]))
                plan.append((f"{bp}/ffn_norm", [blk.ffn.fc1.path]))
        return plan

    def equalization_plan(self):
        """v -> o of every self-attention; a GELU MLP has no pair."""
        return [(blk.attn.wv.path, blk.attn.wo.path)
                for stack in (self.encoder, self.decoder)
                for blk in stack.blocks]


def build_model(cfg):
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return CausalLM(cfg)
