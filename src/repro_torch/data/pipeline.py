"""Deterministic, resumable synthetic token stream.

Counterpart of ``repro/data/pipeline.py`` for text models.  It serves the
paper's setup three ways: an unlabeled training stream for FAT
distillation (§3.2 discards labels), a small calibration set drawn from a
disjoint region of the stream (§2), and a labeled stream for the pretrain
mode.  Tokens follow a Zipf marginal (inverse-CDF sampling) with a 2-gram
mix: with p = 0.3 a token repeats its predecessor + 1 (mod V), so quantized
and full-precision outputs diverge in non-uniform ways; ``labels`` are the
tokens rolled one to the left.

A batch is a pure function of (seed, step): each draws from its own numpy
generator seeded by both, so the pipeline's state is the step, which the
checkpoint carries, and a restarted run consumes the exact remaining
stream.  The token values cannot equal the reference's, whose generator is
the JAX PRNG (``fold_in(PRNGKey(seed), step)``); parity tests hand the
same numpy batches to both packages.  The vision and audio modalities
(patches, frames) are ROADMAP Queue A item 17.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


ZIPF_A = 1.2    # the reference's Zipf exponent


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _zipf_tokens(rng, shape, vocab: int) -> np.ndarray:
    """Inverse-CDF Zipf sampling in float32: ranks u^(-1/(a-1)), truncated
    to the vocabulary."""
    u = rng.uniform(1e-6, 1.0, shape).astype(np.float32)
    r = np.floor(u ** np.float32(-1.0 / (ZIPF_A - 1.0))) % np.float32(vocab)
    return r.astype(np.int32)


def make_batch(spec: PipelineSpec, step: int) -> dict:
    """Batch ``step`` of the stream: {"tokens", "labels"} (B, S) int32 CPU
    tensors."""
    rng = np.random.default_rng([spec.seed, int(step)])
    shape = (spec.global_batch, spec.seq_len)
    toks = _zipf_tokens(rng, shape, spec.vocab)
    # 2-gram structure: with p = 0.3 repeat the previous token + 1 (mod V)
    rep = rng.random(shape) < 0.3
    shifted = np.roll(toks, 1, axis=1)
    toks = np.where(rep, (shifted + 1) % spec.vocab, toks).astype(np.int32)
    # labels for the pretrain mode; FAT distillation ignores them
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}


def spec_for(cfg, shape, seed: int = 0) -> PipelineSpec:
    """PipelineSpec from a text ModelConfig + ShapeSpec."""
    modality = cfg.modality if cfg.family != "encdec" else "audio"
    if modality != "text":
        raise NotImplementedError(
            f"the {modality!r} modality is not ported (ROADMAP Queue A "
            "item 17)")
    return PipelineSpec(vocab=cfg.vocab, seq_len=shape.seq_len,
                        global_batch=shape.global_batch, seed=seed)


def calibration_batches(spec: PipelineSpec, n: int = 4,
                        offset: int = 1 << 20) -> list:
    """The paper's calibration set (§4.1.2 uses 100 images, a few batches),
    drawn from a disjoint region of the stream (``offset``) so that
    calibration sees typical data, not the training batches."""
    return [make_batch(spec, offset + i) for i in range(n)]
