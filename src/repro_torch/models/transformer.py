"""Decoder and encoder stacks: pre-norm residual Blocks, each an attention
mixer, an SSM mixer or both in parallel, then (in a decoder of an
encoder-decoder) a cross attention over the encoder's output, then a gated
MLP, a two-layer GELU MLP, a mixture of experts or no ffn.

Counterpart of ``repro/models/transformer.py`` for the unscanned stacks:
RMSNorm or LayerNorm (``cfg.norm``), SwiGLU or GeGLU
(``cfg.mlp_activation``), the encoder-decoder's ``GeluMLP``
(``cfg.ffn == "gelu"``) or an MoE (``cfg.ffn == "moe"``, whose
load-balance loss the training forward returns and serving drops) or none
(``"none"``, mamba2); per layer (``cfg.layer_kind(i)``) a global or a
sliding-window attention (``cfg.attn_window(i)``: gemma3's 5:1
local:global layers, mixtral's window on every layer), a Mamba2 mixer
(``"mamba"``), or hymba's ``"hybrid"``: attention and Mamba2 side by
side, each output normed, averaged.  ``cfg.causal`` False makes every
attention bidirectional (the encoder); a ``cross`` stack (the decoder)
adds a cross attention to every layer.  The reference's ``scan_layers``
stacks raise ``NotImplementedError``.

A layer's cache is ``{"attn": KV cache}``, ``{"mamba": SSMState}`` or
both, and in a cross stack ``{"cross": float DenseCache}`` beside them.
Speculative verify covers attention-only self-attention layers, as in the
reference.
"""
from __future__ import annotations

from repro_torch.models.attention import Attention
from repro_torch.models.layers import ACTIVATIONS, LayerNorm, RMSNorm
from repro_torch.models.mlp import GeluMLP, SwiGLU
from repro_torch.models.module import Module
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba2Block

ATTN_KINDS = ("attn", "attn_local")


def check_supported(cfg) -> None:
    """Raise on a config outside the reference's stacks."""
    unsupported = []
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    if kinds - {*ATTN_KINDS, "mamba", "hybrid"}:
        unsupported.append(f"layer kinds {sorted(kinds)}")
    if cfg.ffn not in ("swiglu", "gelu", "moe", "none") or (
            cfg.mlp_activation not in ACTIVATIONS):
        unsupported.append(f"ffn {cfg.ffn!r} with {cfg.mlp_activation!r}")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        unsupported.append(f"norm {cfg.norm!r}")
    if cfg.family not in ("causal", "encdec") or cfg.modality not in (
            "text", "vlm", "audio"):
        unsupported.append(f"{cfg.family}/{cfg.modality} models")
    if cfg.scan_layers:
        unsupported.append("scan_layers (the port unrolls the stack)")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: not ported: " + "; ".join(unsupported))


def attention_only(cfg) -> bool:
    """Every layer an attention layer, in a text stack: what chunked
    prefill, speculative verify and the slot decode need (SSM state
    stepping has no per-request masking, freeze or rewind)."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    return not kinds - set(ATTN_KINDS) and cfg.modality == "text"


def norm_class(cfg):
    """The stack's norm: LayerNorm or RMSNorm, by ``cfg.norm``."""
    return LayerNorm if cfg.norm == "layernorm" else RMSNorm


class Block(Module):
    """One pre-norm residual layer: norm -> mixer -> (+) -> [cross_norm ->
    cross attention -> (+)] -> norm -> ffn -> (+).  The mixer is ``attn``
    (kinds "attn" / "attn_local"), ``mamba`` ("mamba") or both ("hybrid":
    0.5 (attn_out_norm(a) + mamba_out_norm(m))); the cross attention
    (``cross``) reads the encoder's output; the ffn a gated MLP or a GELU
    MLP at ``path/mlp``, an MoE at ``path/moe``, or none (``cfg.ffn ==
    "none"``)."""

    def __init__(self, cfg, layer_idx: int, *, path: str,
                 cross: bool = False):
        self.cfg = cfg
        self.path = path
        self.cross = cross
        self.kind = cfg.layer_kind(layer_idx)
        self.ffn_kind = cfg.ffn_kind(layer_idx)
        d, dt = cfg.d_model, cfg.dtype
        norm = norm_class(cfg)
        self.pre_norm = norm(d, path=f"{path}/pre_norm", dtype=dt)
        if self.kind != "mamba":
            self.attn = Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, path=f"{path}/attn",
                                  window=cfg.attn_window(layer_idx),
                                  rope_base=cfg.rope_base,
                                  causal=cfg.causal, dtype=dt)
        if self.kind in ("mamba", "hybrid"):
            self.mamba = Mamba2Block(
                d, path=f"{path}/mamba", d_state=cfg.ssm_state,
                n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
                expand=cfg.ssm_expand, n_groups=cfg.ssm_groups,
                chunk=cfg.ssm_chunk, dtype=dt)
        if self.kind == "hybrid":
            self.attn_out_norm = norm(d, path=f"{path}/attn_out_norm",
                                      dtype=dt)
            self.mamba_out_norm = norm(d, path=f"{path}/mamba_out_norm",
                                       dtype=dt)
        if cross:
            self.cross_norm = norm(d, path=f"{path}/cross_norm", dtype=dt)
            self.cross_attn = Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim,
                                        path=f"{path}/cross_attn",
                                        rope_base=cfg.rope_base, causal=False,
                                        cross=True, dtype=dt)
        self.moe = self.ffn_kind == "moe"
        if self.ffn_kind != "none":
            self.ffn_norm = norm(d, path=f"{path}/ffn_norm", dtype=dt)
            if self.moe:
                self.ffn = MoE(d, cfg.d_ff, cfg.n_experts, cfg.top_k,
                               path=f"{path}/moe", dtype=dt,
                               capacity_factor=cfg.capacity_factor)
            elif self.ffn_kind == "gelu":
                self.ffn = GeluMLP(d, cfg.d_ff, path=f"{path}/mlp", dtype=dt,
                                   activation=cfg.mlp_activation)
            else:
                self.ffn = SwiGLU(d, cfg.d_ff, path=f"{path}/mlp", dtype=dt,
                                  activation=cfg.mlp_activation)

    def init(self, gen):
        p = {"pre_norm": self.pre_norm.init(gen)}
        if hasattr(self, "attn"):
            p["attn"] = self.attn.init(gen)
        if hasattr(self, "mamba"):
            p["mamba"] = self.mamba.init(gen)
        if self.kind == "hybrid":
            p["attn_out_norm"] = self.attn_out_norm.init(gen)
            p["mamba_out_norm"] = self.mamba_out_norm.init(gen)
        if self.cross:
            p["cross_norm"] = self.cross_norm.init(gen)
            p["cross_attn"] = self.cross_attn.init(gen)
        if self.ffn_kind != "none":
            p["ffn_norm"] = self.ffn_norm.init(gen)
            p["ffn"] = self.ffn.init(gen)
        return p

    def _fuse(self, params, a, m):
        """The hybrid mix: each branch's output normed, then averaged."""
        a = self.attn_out_norm(params["attn_out_norm"], a)
        m = self.mamba_out_norm(params["mamba_out_norm"], m)
        return 0.5 * (a + m)

    def _ffn_residual(self, params, x, ctx):
        """x + ffn(ffn_norm(x)), an MoE's load-balance loss dropped (the
        serving paths); x without an ffn."""
        if self.ffn_kind == "none":
            return x
        h = self.ffn_norm(params["ffn_norm"], x)
        if self.moe:
            return x + self.ffn(params["ffn"], h, ctx, with_aux=False)[0]
        return x + self.ffn(params["ffn"], h, ctx)

    def __call__(self, params, x, ctx=None, *, memory=None,
                 with_aux: bool = False):
        """Returns (y, aux): aux the MoE load-balance loss with
        ``with_aux``, else None.  ``memory``: the encoder's output, which a
        cross stack's layers attend."""
        h = self.pre_norm(params["pre_norm"], x)
        if self.kind == "hybrid":
            mix = self._fuse(params, self.attn(params["attn"], h, ctx),
                             self.mamba(params["mamba"], h, ctx))
        elif self.kind == "mamba":
            mix = self.mamba(params["mamba"], h, ctx)
        else:
            mix = self.attn(params["attn"], h, ctx)
        x = x + mix
        if self.cross:
            h = self.cross_norm(params["cross_norm"], x)
            x = x + self.cross_attn(params["cross_attn"], h, ctx,
                                    memory=memory)
        if not self.moe:
            return self._ffn_residual(params, x, ctx), None
        h = self.ffn_norm(params["ffn_norm"], x)
        y, aux = self.ffn(params["ffn"], h, ctx, with_aux=with_aux)
        return x + y, aux

    def init_cache(self, batch, max_len, device=None, kv_bits=8, *,
                   enc_len=None, **layout):
        """The layer's caches; a cross stack's cross cache holds
        min(``max_len``, ``enc_len``) rows of the layout's float ``dtype``
        (``max_len`` without ``enc_len``), the rows of the encoder's
        output that the reference keeps."""
        c = {}
        if hasattr(self, "attn"):
            c["attn"] = self.attn.init_cache(batch, max_len, device,
                                             kv_bits, **layout)
        if hasattr(self, "mamba"):
            c["mamba"] = self.mamba.init_cache(batch, device)
        if self.cross:
            rows = max_len if enc_len is None else min(max_len, enc_len)
            c["cross"] = self.cross_attn.init_cache(
                batch, rows, device,
                dtype=layout.get("dtype", self.cfg.dtype))
        return c

    def prefill(self, params, x, cache, ctx=None, *, memory=None, **chunk):
        """``chunk``: the chunked-prefill arguments of ``Attention.prefill``
        (``q_offset``, ``lengths``, ``kv_limit``), attention-only stacks
        (``launch/steps.py`` refuses the others).  The SSM state is the
        chunked scan's final carry, written over the layer's state; a
        cross stack writes its cross cache from ``memory``."""
        h = self.pre_norm(params["pre_norm"], x)
        new_cache = dict(cache)
        if hasattr(self, "attn"):
            a, new_cache["attn"] = self.attn.prefill(
                params["attn"], h, cache["attn"], ctx, **chunk)
        if hasattr(self, "mamba"):
            m, new_cache["mamba"] = self.mamba.prefill(
                params["mamba"], h, cache["mamba"], ctx)
        mix = (self._fuse(params, a, m) if self.kind == "hybrid"
               else m if self.kind == "mamba" else a)
        x = x + mix
        if self.cross:
            h = self.cross_norm(params["cross_norm"], x)
            y, new_cache["cross"] = self.cross_attn.prefill(
                params["cross_attn"], h, cache["cross"], ctx, memory=memory)
            x = x + y
        return self._ffn_residual(params, x, ctx), new_cache

    def decode(self, params, x, cache, cur_pos, ctx=None, slot_mask=None):
        h = self.pre_norm(params["pre_norm"], x)
        new_cache = dict(cache)
        if hasattr(self, "attn"):
            a, new_cache["attn"] = self.attn.decode(
                params["attn"], h, cache["attn"], cur_pos, ctx,
                slot_mask=slot_mask)
        if hasattr(self, "mamba"):
            m, new_cache["mamba"] = self.mamba.decode(
                params["mamba"], h, cache["mamba"], ctx)
        mix = (self._fuse(params, a, m) if self.kind == "hybrid"
               else m if self.kind == "mamba" else a)
        x = x + mix
        if self.cross:
            h = self.cross_norm(params["cross_norm"], x)
            y, _ = self.cross_attn.decode(params["cross_attn"], h,
                                          cache["cross"], cur_pos, ctx)
            x = x + y
        return self._ffn_residual(params, x, ctx), new_cache

    def verify(self, params, x, cache, cur_pos, ctx=None, slot_mask=None):
        """The speculative verify window through this layer: ``decode``'s
        residual structure around ``Attention.verify``; attention layers
        only (SSM state stepping has no rewind), as in the reference."""
        if self.kind not in ATTN_KINDS or self.cross:
            raise ValueError(
                f"{self.path}: speculative verify covers attention-only "
                f"causal stacks (got kind={self.kind!r}, "
                f"cross={self.cross})")
        h = self.pre_norm(params["pre_norm"], x)
        a, attn_cache = self.attn.verify(params["attn"], h, cache["attn"],
                                         cur_pos, ctx, slot_mask=slot_mask)
        return self._ffn_residual(params, x + a, ctx), {"attn": attn_cache}


class Stack(Module):
    """Unrolled stack of Blocks (params under ``layer{i}``) + final norm,
    each Block with a cross attention when ``cross``."""

    def __init__(self, cfg, *, path: str, cross: bool = False):
        check_supported(cfg)
        self.cfg = cfg
        self.path = path
        self.n_layers = cfg.n_layers
        self.blocks = [Block(cfg, i, path=f"{path}/layer{i}", cross=cross)
                       for i in range(self.n_layers)]
        self.final_norm = norm_class(cfg)(cfg.d_model,
                                          path=f"{path}/final_norm",
                                          dtype=cfg.dtype)

    def param_children(self):
        c = {f"layer{i}": b for i, b in enumerate(self.blocks)}
        c["final_norm"] = self.final_norm
        return c

    def init(self, gen):
        p = {f"layer{i}": b.init(gen) for i, b in enumerate(self.blocks)}
        p["final_norm"] = self.final_norm.init(gen)
        return p

    def __call__(self, params, x, ctx=None, *, memory=None,
                 with_aux: bool = False):
        """Returns (h, aux): the final-normed hidden states and, with
        ``with_aux``, the sum of the layers' MoE load-balance losses (None
        without MoE layers or ``with_aux``).  ``memory``: the encoder's
        output, for a cross stack."""
        aux_total = None
        for i, blk in enumerate(self.blocks):
            x, aux = blk(params[f"layer{i}"], x, ctx, memory=memory,
                         with_aux=with_aux)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return self.final_norm(params["final_norm"], x), aux_total

    def init_cache(self, batch, max_len, device=None, kv_bits=8, **layout):
        return {f"layer{i}": b.init_cache(batch, max_len, device, kv_bits,
                                          **layout)
                for i, b in enumerate(self.blocks)}

    def prefill(self, params, x, cache, ctx=None, *, memory=None, **chunk):
        new_cache = {}
        for i, blk in enumerate(self.blocks):
            x, new_cache[f"layer{i}"] = blk.prefill(
                params[f"layer{i}"], x, cache[f"layer{i}"], ctx,
                memory=memory, **chunk)
        return self.final_norm(params["final_norm"], x), new_cache

    def decode(self, params, x, cache, cur_pos, ctx=None, slot_mask=None):
        new_cache = {}
        for i, blk in enumerate(self.blocks):
            x, new_cache[f"layer{i}"] = blk.decode(
                params[f"layer{i}"], x, cache[f"layer{i}"], cur_pos, ctx,
                slot_mask)
        return self.final_norm(params["final_norm"], x), new_cache

    def verify(self, params, x, cache, cur_pos, ctx=None, slot_mask=None):
        new_cache = {}
        for i, blk in enumerate(self.blocks):
            x, new_cache[f"layer{i}"] = blk.verify(
                params[f"layer{i}"], x, cache[f"layer{i}"], cur_pos, ctx,
                slot_mask)
        return self.final_norm(params["final_norm"], x), new_cache
