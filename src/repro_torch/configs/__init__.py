"""Architecture registry: arch id -> ModelConfig (+ reduced smoke).

Every architecture of the reference package is ported: the dense decoders
smollm-135m, granite-8b, stablelm-12b (LayerNorm) and gemma3-12b (GeGLU,
5:1 sliding-window layers); the mixture-of-experts decoders
granite-moe-3b-a800m and mixtral-8x7b (sliding windows on every layer);
the state-space decoders mamba2-780m (pure SSM) and hymba-1.5b (attention
and SSM heads in parallel in every layer); the encoder-decoder
seamless-m4t-medium (audio frames into a bidirectional encoder, a causal
decoder with cross attention) and the VLM llava-next-34b (projected
patches before the text)."""
from __future__ import annotations

from repro_torch.configs import (gemma3_12b, granite_8b, granite_moe_3b_a800m,
                                 hymba_1_5b, llava_next_34b, mamba2_780m,
                                 mixtral_8x7b, seamless_m4t_medium,
                                 smollm_135m, stablelm_12b)
from repro_torch.configs.base import ModelConfig

_CONFIGS = {"smollm-135m": smollm_135m, "granite-8b": granite_8b,
            "stablelm-12b": stablelm_12b, "gemma3-12b": gemma3_12b,
            "granite-moe-3b-a800m": granite_moe_3b_a800m,
            "mixtral-8x7b": mixtral_8x7b, "mamba2-780m": mamba2_780m,
            "hymba-1.5b": hymba_1_5b,
            "seamless-m4t-medium": seamless_m4t_medium,
            "llava-next-34b": llava_next_34b}

ARCHS = list(_CONFIGS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    mod = _CONFIGS[arch]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "ModelConfig", "get_config"]
