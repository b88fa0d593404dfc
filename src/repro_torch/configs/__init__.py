"""Architecture registry: arch id -> ModelConfig (+ reduced smoke).

Only smollm-135m is ported; the other architectures of the reference
package come with ROADMAP Queue A item 17."""
from __future__ import annotations

from repro_torch.configs import smollm_135m
from repro_torch.configs.base import ModelConfig

_CONFIGS = {"smollm-135m": smollm_135m}

ARCHS = list(_CONFIGS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _CONFIGS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ported: {ARCHS}); the other "
            "architectures are ROADMAP Queue A item 17")
    mod = _CONFIGS[arch]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCHS", "ModelConfig", "get_config"]
