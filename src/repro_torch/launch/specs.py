"""Meta-tensor stand-ins for every input of a step: the dry run's contract.

Counterpart of ``repro/launch/specs.py``.  The reference builds
``ShapeDtypeStruct`` trees with ``jax.eval_shape``; here the same
functions run on the meta device (``models.module.MetaGenerator``), which
gives tensors with shapes and dtypes and no storage.  Each ``*_abstract``
function is its real builder on meta: ``model_state``, ``serve_state``,
``make_batch`` and ``make_cache`` build the same trees on a real device
(a seeded generator's), as the card check of ``chip_smoke.py`` does.
"""
from __future__ import annotations

import torch

from repro_torch.bridge import tree_to
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import api as A
from repro_torch.models.module import MetaGenerator
from repro_torch.optim.adam import adam_init

META = torch.device("meta")


def _makers(cfg: ModelConfig, gen) -> tuple:
    """(tokens(shape), floats(shape)) on ``gen``'s device: seeded tokens
    below the vocab and normal ``cfg.dtype`` values (a ``MetaGenerator``:
    meta tensors)."""
    dev = gen.device
    if dev.type == "meta":
        return (lambda shp: torch.empty(shp, dtype=torch.int32, device=META),
                lambda shp: torch.empty(shp, dtype=cfg.dtype, device=META))
    return (lambda shp: torch.randint(0, cfg.vocab, shp, generator=gen,
                                      dtype=torch.int32, device=dev),
            lambda shp: torch.randn(shp, generator=gen, device=dev
                                    ).to(cfg.dtype))


def make_batch(cfg: ModelConfig, shape: ShapeSpec, gen) -> dict:
    """The training/prefill batch (``data.pipeline``'s structure) on
    ``gen``'s device (``_makers``)."""
    tokens, floats = _makers(cfg, gen)
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        s_text = max(s // cfg.dec_ratio, 4)
        return {"frames": floats((b, s, cfg.frame_dim)),
                "tokens": tokens((b, s_text)), "labels": tokens((b, s_text))}
    if cfg.modality == "vlm":
        s_text = s - cfg.mm_patches
        return {"patches": floats((b, cfg.mm_patches, cfg.mm_dim)),
                "tokens": tokens((b, s_text)), "labels": tokens((b, s_text))}
    return {"tokens": tokens((b, s)), "labels": tokens((b, s))}


def make_tokens(cfg: ModelConfig, batch: int, gen) -> torch.Tensor:
    """One decode step's (batch, 1) int32 tokens on ``gen``'s device."""
    return _makers(cfg, gen)[0]((batch, 1))


def batch_specs_abstract(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Training/prefill batch structure on meta."""
    return make_batch(cfg, shape, MetaGenerator())


def model_state(model, policy: A.QuantPolicy, gen) -> tuple:
    """(params, qparams) on ``gen``'s device: training consumes the
    post-calibration threshold state (floats only, §3.1.3)."""
    params = tree_to(model.init(gen), gen.device)
    qparams = A.finalize_calibration(A.init_qparams(model, params, policy))
    return params, qparams


def serve_state(model, policy: A.QuantPolicy, gen) -> tuple:
    """(int8 serving params, qparams) on ``gen``'s device; the float
    weights are let go."""
    params, qparams = model_state(model, policy, gen)
    return A.convert_to_int8(model, params, qparams, policy), qparams


def model_state_abstract(model, cfg: ModelConfig, policy: A.QuantPolicy):
    """(params, qparams) on meta (nothing allocated)."""
    return model_state(model, policy, MetaGenerator())


def serve_state_abstract(model, cfg: ModelConfig, policy: A.QuantPolicy):
    """(serve_params int8, qparams) on meta."""
    return serve_state(model, policy, MetaGenerator())


def make_cache(model, cfg: ModelConfig, batch: int, max_len: int,
               kv_int8: bool = False, device=META):
    """The reference's ``init_cache(batch, max_len, cfg.dtype, kv_int8)``:
    its default ring layout (a sliding-window layer shorter than
    ``max_len`` holds a ring of its window), float ``cfg.dtype`` tiles
    unless ``kv_int8``."""
    return model.init_cache(batch, max_len, device, layout="ring",
                            kv_int8=kv_int8, dtype=cfg.dtype)


def cache_abstract(model, cfg: ModelConfig, batch: int, max_len: int,
                   kv_int8: bool = False):
    return make_cache(model, cfg, batch, max_len, kv_int8)


def opt_state_abstract(qparams_abstract):
    """Adam's state over every qparams leaf (``A.flatten``'s keys), on
    the qparams' device (meta for abstract ones)."""
    return adam_init(A.flatten(qparams_abstract))
