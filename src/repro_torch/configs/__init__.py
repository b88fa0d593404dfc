"""Architecture registry: arch id -> ModelConfig (+ reduced smoke).

The dense decoders are ported: smollm-135m, granite-8b, stablelm-12b
(LayerNorm) and gemma3-12b (GeGLU, 5:1 sliding-window layers); and the
mixture-of-experts decoders granite-moe-3b-a800m and mixtral-8x7b
(sliding windows on every layer); and the state-space decoders
mamba2-780m (pure SSM) and hymba-1.5b (attention and SSM heads in
parallel in every layer).  The other architectures of the reference
package (VLM, enc-dec) are ROADMAP Queue A item 17, steps 7-8."""
from __future__ import annotations

from repro_torch.configs import (gemma3_12b, granite_8b, granite_moe_3b_a800m,
                                 hymba_1_5b, mamba2_780m, mixtral_8x7b,
                                 smollm_135m, stablelm_12b)
from repro_torch.configs.base import ModelConfig

_CONFIGS = {"smollm-135m": smollm_135m, "granite-8b": granite_8b,
            "stablelm-12b": stablelm_12b, "gemma3-12b": gemma3_12b,
            "granite-moe-3b-a800m": granite_moe_3b_a800m,
            "mixtral-8x7b": mixtral_8x7b, "mamba2-780m": mamba2_780m,
            "hymba-1.5b": hymba_1_5b}

ARCHS = list(_CONFIGS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _CONFIGS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ported: {ARCHS}); the other "
            "architectures are ROADMAP Queue A item 17 (steps 7-8)")
    mod = _CONFIGS[arch]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "ModelConfig", "get_config"]
