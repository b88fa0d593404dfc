"""Seeded calibration data.

The reference's ``repro/data/pipeline.py`` imports JAX, so the port makes
its own default: uniform random token ids from a numpy generator.  Parity
tests hand the same numpy batches to both packages instead.
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
