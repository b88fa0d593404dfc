"""Seeded data: the Engine's default calibration batches here, the
training stream in ``data.pipeline``.

The Engine's default calibration is uniform random token ids from a numpy
generator (the reference draws its default from the training pipeline,
whose JAX PRNG the port cannot reproduce).  Parity tests hand the same
numpy batches to both packages instead.
"""
from __future__ import annotations

import numpy as np


def calibration_batches(vocab: int, n: int = 2, batch: int = 4,
                        seq_len: int = 32, seed: int = 0) -> list:
    """``n`` batches {"tokens": (batch, seq_len) int32 numpy} (the
    reference Engine's default calibration shape)."""
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (batch, seq_len),
                                    dtype=np.int32)} for _ in range(n)]
