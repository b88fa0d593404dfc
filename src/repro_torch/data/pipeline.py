"""Deterministic, resumable synthetic token stream.

Counterpart of ``repro/data/pipeline.py``.  It serves the
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
same numpy batches to both packages.

A VLM batch also carries ``patches`` (B, mm_patches, mm_dim), standard
normal, and its tokens fill the rest of ``seq_len`` (S - mm_patches); an
audio batch (the encoder-decoder) carries ``frames`` (B, S, frame_dim)
and max(S // dec_ratio, 4) tokens, as in the reference.  Both are drawn in
float32 from the batch's generator and cast to the config's dtype.
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
    modality: str = "text"   # text | vlm | audio
    mm_patches: int = 0
    mm_dim: int = 0
    frame_dim: int = 0
    dec_ratio: int = 8
    dtype: torch.dtype = torch.bfloat16

    def text_len(self) -> int:
        """Tokens a row: the sequence less the patches (VLM), an eighth of
        it (audio: the decoder's text against the encoder's frames), or
        all of it."""
        if self.modality == "vlm":
            s = self.seq_len - self.mm_patches
            if s < 1:
                raise ValueError(
                    f"seq_len {self.seq_len} leaves no text beside "
                    f"{self.mm_patches} patches: a VLM batch needs seq_len > "
                    "mm_patches (the reference's default calibration length "
                    "of 32 does not reach llava-next-34b's 2880 patches)")
            return s
        if self.modality == "audio":
            return max(self.seq_len // self.dec_ratio, 4)
        return self.seq_len


def _zipf_tokens(rng, shape, vocab: int) -> np.ndarray:
    """Inverse-CDF Zipf sampling in float32: ranks u^(-1/(a-1)), truncated
    to the vocabulary."""
    u = rng.uniform(1e-6, 1.0, shape).astype(np.float32)
    r = np.floor(u ** np.float32(-1.0 / (ZIPF_A - 1.0))) % np.float32(vocab)
    return r.astype(np.int32)


def make_batch(spec: PipelineSpec, step: int) -> dict:
    """Batch ``step`` of the stream: {"tokens", "labels"} (B, S_text) int32
    CPU tensors, and a VLM's ``patches`` or an audio batch's ``frames``
    (``spec.dtype``)."""
    rng = np.random.default_rng([spec.seed, int(step)])
    b = spec.global_batch
    shape = (b, spec.text_len())
    toks = _zipf_tokens(rng, shape, spec.vocab)
    # 2-gram structure: with p = 0.3 repeat the previous token + 1 (mod V)
    rep = rng.random(shape) < 0.3
    shifted = np.roll(toks, 1, axis=1)
    toks = np.where(rep, (shifted + 1) % spec.vocab, toks).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    media = {"vlm": ("patches", (b, spec.mm_patches, spec.mm_dim)),
             "audio": ("frames", (b, spec.seq_len, spec.frame_dim))}
    if spec.modality in media:
        key, mshape = media[spec.modality]
        batch[key] = torch.from_numpy(
            rng.standard_normal(mshape, dtype=np.float32)).to(spec.dtype)
    # labels for the pretrain mode; FAT distillation ignores them
    batch["labels"] = torch.from_numpy(np.roll(toks, -1, axis=1))
    return batch


def spec_for(cfg, shape, seed: int = 0) -> PipelineSpec:
    """PipelineSpec from a ModelConfig + ShapeSpec (an encoder-decoder's
    modality is audio)."""
    return PipelineSpec(
        vocab=cfg.vocab, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        modality=cfg.modality if cfg.family != "encdec" else "audio",
        mm_patches=cfg.mm_patches, mm_dim=cfg.mm_dim,
        frame_dim=cfg.frame_dim, dec_ratio=cfg.dec_ratio, dtype=cfg.dtype)


def calibration_batches(spec: PipelineSpec, n: int = 4,
                        offset: int = 1 << 20) -> list:
    """The paper's calibration set (§4.1.2 uses 100 images, a few batches),
    drawn from a disjoint region of the stream (``offset``) so that
    calibration sees typical data, not the training batches."""
    return [make_batch(spec, offset + i) for i in range(n)]
