"""Unlabeled distillation loss (paper §3.2, eqs. 24-25).

Counterpart of ``repro/core/distill.py``.  Of the paper's total loss only
the teacher/student term survives (alpha = beta = 0): the RMSE between the
pre-softmax outputs,

    H(z_T, z_A) = sqrt( sum_i ||z_i^T - z_i^A||^2 / N )         (eq. 25)

``rmse_distill_loss`` is eq. 25 on whole logits.  For a language model
the pre-softmax output is the (B, S, V) logits tensor, so
``chunked_sq_err`` reads out and reduces one sequence chunk at a
time: logits exist for one chunk only.  Each chunk is recomputed in the
backward (``torch.utils.checkpoint``, the counterpart of the reference's
``jax.checkpoint`` on its scan body), so the backward does not keep every
chunk's logits either.  ``chunked_ce_loss`` is the pretrain mode's
next-token cross-entropy, chunked the same way.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def rmse_distill_loss(z_teacher: torch.Tensor,
                      z_student: torch.Tensor) -> torch.Tensor:
    """Eq. 25 on whole logits: sqrt(sum of squared error / N), N the
    product of the leading (non-logit) dims."""
    zt, za = z_teacher.float(), z_student.float()
    n = 1
    for d in zt.shape[:-1]:
        n *= d
    return torch.sqrt(torch.sum((zt - za) ** 2) / max(n, 1))


def chunked_sq_err(h_teacher: torch.Tensor, h_student: torch.Tensor,
                   readout: Callable, readout_student: Callable | None = None,
                   *, chunk: int = 256):
    """Sum of squared logit error over (B, S, d) final hidden states,
    computed chunk by chunk over the sequence; returns (sum_sq, count) with
    count = B * S as float32, so the caller applies eq. 25's sqrt(. / N).
    ``readout_student`` lets the student read out with its own head."""
    b, s, _ = h_teacher.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    ro_s = readout_student or readout

    def body(h_t, h_s):
        zt = readout(h_t).float()
        za = ro_s(h_s).float()
        return torch.sum((zt - za) ** 2)

    acc = torch.zeros((), dtype=torch.float32, device=h_teacher.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        acc = acc + checkpoint(body, h_teacher[:, sl], h_student[:, sl],
                               use_reentrant=False)
    return acc, torch.tensor(float(b * s), dtype=torch.float32,
                             device=h_teacher.device)


def chunked_ce_loss(h: torch.Tensor, labels: torch.Tensor, readout: Callable,
                    *, chunk: int = 256) -> torch.Tensor:
    """Next-token cross-entropy over (B, S, d) final hidden states and (B,
    S) labels, read out and reduced one sequence chunk at a time with
    float32 logits (the readout masks the padded vocabulary); the mean
    over the B * S positions."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")

    def body(hs, ls):
        logits = readout(hs).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ls.long()[..., None])[..., 0]
        return torch.sum(logz - gold)

    acc = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        acc = acc + checkpoint(body, h[:, sl], labels[:, sl],
                               use_reentrant=False)
    return acc / (b * s)
