"""ModelConfig: one dataclass describing every architecture of the
reference package, with torch dtypes.

Field for field the counterpart of ``repro/configs/base.py``, for every
family of the reference: dense, mixture-of-experts, state-space and hybrid
decoders, the VLM (``mm_dim`` / ``mm_patches``) and the encoder-decoder
(``frame_dim``, ``dec_ratio``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    family: str = "causal"        # causal | encdec
    modality: str = "text"        # text | vlm | audio
    kind: str = "attn"            # attn | mamba | hybrid
    ffn: str = "swiglu"           # swiglu | gelu | moe | none
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    mlp_activation: str = "silu"
    causal: bool = True
    tie_embeddings: bool = False
    rope_base: float = 10000.0

    # --- attention window structure ---
    window: Optional[int] = None
    window_all: bool = False
    local_global_ratio: Optional[Tuple[int, int]] = None
    global_attn_layers: Tuple[int, ...] = ()

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 128
    ssm_heads: Optional[int] = None
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 128

    # --- modality frontends ---
    mm_dim: int = 0
    mm_patches: int = 0
    frame_dim: int = 0
    dec_ratio: int = 8

    # --- perf knobs ---
    dtype: torch.dtype = torch.bfloat16
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    loss_chunk: int = 256
    remat: bool = True
    scan_layers: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 128; padded logits are masked
        at readout."""
        return -(-self.vocab // 128) * 128

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- per-layer structure ----
    def layer_kind(self, i: int) -> str:
        if self.kind == "mamba":
            return "mamba"
        if self.kind == "hybrid":
            return "hybrid"
        if self.local_global_ratio:
            l, g = self.local_global_ratio
            return "attn_local" if (i % (l + g)) < l else "attn"
        return "attn"

    def attn_window(self, i: int) -> Optional[int]:
        if i in self.global_attn_layers:
            return None
        if self.local_global_ratio:
            l, g = self.local_global_ratio
            return self.window if (i % (l + g)) < l else None
        if self.window_all or self.kind == "hybrid":
            return self.window
        return None

    def ffn_kind(self, i: int) -> str:
        return self.ffn
