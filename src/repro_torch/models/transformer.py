"""Decoder stack: pre-norm residual Blocks of attention + a gated MLP or a
mixture of experts.

Counterpart of ``repro/models/transformer.py`` for the unscanned attention
stacks: RMSNorm or LayerNorm (``cfg.norm``), SwiGLU or GeGLU
(``cfg.mlp_activation``) or an MoE (``cfg.ffn == "moe"``, whose
load-balance loss the training forward returns and serving drops), and per
layer a global or a sliding-window attention (``cfg.attn_window(i)``:
gemma3's 5:1 local:global layers, mixtral's window on every layer).  The
other layer kinds of the reference raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""
from __future__ import annotations

from repro_torch.models.attention import Attention
from repro_torch.models.layers import ACTIVATIONS, LayerNorm, RMSNorm
from repro_torch.models.mlp import SwiGLU
from repro_torch.models.module import Module
from repro_torch.models.moe import MoE


def check_supported(cfg) -> None:
    """Raise on a config outside the ported dense attention stacks."""
    unsupported = []
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    if kinds - {"attn", "attn_local"}:
        unsupported.append(f"layer kinds {sorted(kinds)} (mamba / hybrid)")
    if cfg.ffn not in ("swiglu", "moe") or (
            cfg.mlp_activation not in ACTIVATIONS):
        unsupported.append(f"ffn {cfg.ffn!r} with {cfg.mlp_activation!r}")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        unsupported.append(f"norm {cfg.norm!r}")
    if cfg.family != "causal" or cfg.modality != "text" or not cfg.causal:
        unsupported.append(f"{cfg.family}/{cfg.modality} models "
                           f"(causal={cfg.causal})")
    if cfg.scan_layers:
        unsupported.append("scan_layers (the port unrolls the stack)")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: not ported: " + "; ".join(unsupported)
            + ". Other architectures are ROADMAP Queue A item 17 (steps "
            "5-8: SSM, hybrid, VLM, enc-dec).")


def norm_class(cfg):
    """The stack's norm: LayerNorm or RMSNorm, by ``cfg.norm``."""
    return LayerNorm if cfg.norm == "layernorm" else RMSNorm


class Block(Module):
    """One pre-norm residual layer: norm -> attn -> (+) -> norm -> ffn -> (+);
    the ffn a gated MLP at ``path/mlp`` or an MoE at ``path/moe``."""

    def __init__(self, cfg, layer_idx: int, *, path: str):
        self.cfg = cfg
        self.path = path
        d, dt = cfg.d_model, cfg.dtype
        norm = norm_class(cfg)
        self.pre_norm = norm(d, path=f"{path}/pre_norm", dtype=dt)
        self.attn = Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              path=f"{path}/attn",
                              window=cfg.attn_window(layer_idx),
                              rope_base=cfg.rope_base, dtype=dt)
        self.ffn_norm = norm(d, path=f"{path}/ffn_norm", dtype=dt)
        self.moe = cfg.ffn_kind(layer_idx) == "moe"
        if self.moe:
            self.ffn = MoE(d, cfg.d_ff, cfg.n_experts, cfg.top_k,
                           path=f"{path}/moe", dtype=dt,
                           capacity_factor=cfg.capacity_factor)
        else:
            self.ffn = SwiGLU(d, cfg.d_ff, path=f"{path}/mlp", dtype=dt,
                              activation=cfg.mlp_activation)

    def init(self, gen):
        return {"pre_norm": self.pre_norm.init(gen),
                "attn": self.attn.init(gen),
                "ffn_norm": self.ffn_norm.init(gen),
                "ffn": self.ffn.init(gen)}

    def _ffn(self, params, h, ctx):
        """The ffn's output, an MoE's load-balance loss dropped (the
        serving paths)."""
        if self.moe:
            return self.ffn(params["ffn"], h, ctx, with_aux=False)[0]
        return self.ffn(params["ffn"], h, ctx)

    def __call__(self, params, x, ctx=None, *, with_aux: bool = False):
        """Returns (y, aux): aux the MoE load-balance loss with
        ``with_aux``, else None."""
        h = self.pre_norm(params["pre_norm"], x)
        x = x + self.attn(params["attn"], h, ctx)
        h = self.ffn_norm(params["ffn_norm"], x)
        if self.moe:
            y, aux = self.ffn(params["ffn"], h, ctx, with_aux=with_aux)
        else:
            y, aux = self.ffn(params["ffn"], h, ctx), None
        return x + y, aux

    def init_cache(self, batch, max_len, device=None, kv_bits=8, **layout):
        return {"attn": self.attn.init_cache(batch, max_len, device,
                                             kv_bits, **layout)}

    def prefill(self, params, x, cache, ctx=None, **chunk):
        """``chunk``: the chunked-prefill arguments of ``Attention.prefill``
        (``q_offset``, ``lengths``, ``kv_limit``)."""
        h = self.pre_norm(params["pre_norm"], x)
        a, attn_cache = self.attn.prefill(params["attn"], h, cache["attn"],
                                          ctx, **chunk)
        x = x + a
        h = self.ffn_norm(params["ffn_norm"], x)
        return x + self._ffn(params, h, ctx), {"attn": attn_cache}

    def decode(self, params, x, cache, cur_pos, ctx=None, slot_mask=None):
        h = self.pre_norm(params["pre_norm"], x)
        a, attn_cache = self.attn.decode(params["attn"], h, cache["attn"],
                                         cur_pos, ctx, slot_mask=slot_mask)
        x = x + a
        h = self.ffn_norm(params["ffn_norm"], x)
        return x + self._ffn(params, h, ctx), {"attn": attn_cache}

    def verify(self, params, x, cache, cur_pos, ctx=None, slot_mask=None):
        """The speculative verify window through this layer: ``decode``'s
        residual structure around ``Attention.verify``."""
        h = self.pre_norm(params["pre_norm"], x)
        a, attn_cache = self.attn.verify(params["attn"], h, cache["attn"],
                                         cur_pos, ctx, slot_mask=slot_mask)
        x = x + a
        h = self.ffn_norm(params["ffn_norm"], x)
        return x + self._ffn(params, h, ctx), {"attn": attn_cache}


class Stack(Module):
    """Unrolled stack of Blocks (params under ``layer{i}``) + final norm."""

    def __init__(self, cfg, *, path: str):
        check_supported(cfg)
        self.cfg = cfg
        self.path = path
        self.n_layers = cfg.n_layers
        self.blocks = [Block(cfg, i, path=f"{path}/layer{i}")
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

    def __call__(self, params, x, ctx=None, *, with_aux: bool = False):
        """Returns (h, aux): the final-normed hidden states and, with
        ``with_aux``, the sum of the layers' MoE load-balance losses (None
        without MoE layers or ``with_aux``)."""
        aux_total = None
        for i, blk in enumerate(self.blocks):
            x, aux = blk(params[f"layer{i}"], x, ctx, with_aux=with_aux)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return self.final_norm(params["final_norm"], x), aux_total

    def init_cache(self, batch, max_len, device=None, kv_bits=8, **layout):
        return {f"layer{i}": b.init_cache(batch, max_len, device, kv_bits,
                                          **layout)
                for i, b in enumerate(self.blocks)}

    def prefill(self, params, x, cache, ctx=None, **chunk):
        new_cache = {}
        for i, blk in enumerate(self.blocks):
            x, new_cache[f"layer{i}"] = blk.prefill(
                params[f"layer{i}"], x, cache[f"layer{i}"], ctx, **chunk)
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
