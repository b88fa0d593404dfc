"""Adam + cosine annealing with warm restarts: the paper's training recipe
(§4.1.2: "Adam optimizer is used for training, and cosine annealing with
the reset of optimizer parameters -- for learning rate").

Counterpart of ``repro/optim/adam.py`` on flat dicts of tensors ({key:
tensor}, as ``core.api.flatten`` makes them).  Functional like the
reference: every call returns new tensors and leaves its inputs alone.
The arithmetic is float32 in the reference's order of operations.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class AdamState(NamedTuple):
    step: torch.Tensor    # () int32 global step
    mu: dict              # first moments, float32, keyed like the params
    nu: dict              # second moments


def adam_init(params: dict) -> AdamState:
    any_leaf = next(iter(params.values()))
    z = {k: torch.zeros_like(p, dtype=torch.float32)
         for k, p in params.items()}
    return AdamState(step=torch.zeros((), dtype=torch.int32,
                                      device=any_leaf.device),
                     mu=z, nu={k: v.clone() for k, v in z.items()})


def cosine_restarts(step, base_lr: float, period: int, t_mult: float = 1.0,
                    min_frac: float = 0.0) -> torch.Tensor:
    """Learning rate (a float32 0-d tensor) at ``step`` under SGDR cosine
    annealing: the phase resets every ``period`` steps, the period growing
    by ``t_mult`` (closed form for geometric periods)."""
    step = torch.as_tensor(step).to(torch.float32)
    if t_mult == 1.0:
        phase = torch.remainder(step, period) / period
    else:
        # the reference divides by np.log(t_mult), a float64 that its
        # float32 arithmetic rounds to float32 first
        log_mult = float(np.float32(np.log(t_mult)))
        k = torch.floor(torch.log1p((t_mult - 1.0) * step / period)
                        / log_mult)
        start = period * (t_mult ** k - 1.0) / (t_mult - 1.0)
        cur = period * t_mult ** k
        phase = (step - start) / cur
    cos = 0.5 * (1.0 + torch.cos(math.pi * phase))
    return base_lr * (min_frac + (1.0 - min_frac) * cos)


def restart_boundary(step: int, period: int, t_mult: float = 1.0) -> bool:
    """True when ``step`` begins a new annealing cycle (host-side)."""
    if t_mult == 1.0:
        return step > 0 and step % period == 0
    acc = 0
    cur = period
    while acc < step:
        acc += cur
        cur = int(round(cur * t_mult))
    return acc == step and step > 0


def reset_moments(state: AdamState) -> AdamState:
    """The paper's "reset of optimizer parameters" at each LR restart:
    zero moments, the step count kept."""
    return AdamState(step=state.step,
                     mu={k: torch.zeros_like(v) for k, v in state.mu.items()},
                     nu={k: torch.zeros_like(v) for k, v in state.nu.items()})


def adam_update(grads: dict, state: AdamState, params: dict, lr, *,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0, mask: dict | None = None):
    """One Adam step; returns (new_params, new_state).  ``mask`` ({key:
    bool}) freezes the leaves where it is False: parameter and moments
    stay as they were (§3.1.3: "All network parameters except
    quantization thresholds are fixed")."""
    step = state.step + 1
    t = step.to(torch.float32)
    new_p, new_m, new_v = {}, {}, {}
    for key, p in params.items():
        if mask is not None and not mask[key]:
            new_p[key] = p
            new_m[key], new_v[key] = state.mu[key], state.nu[key]
            continue
        g = grads[key].to(torch.float32)
        m2 = b1 * state.mu[key] + (1 - b1) * g
        v2 = b2 * state.nu[key] + (1 - b2) * g * g
        mhat = m2 / (1 - b1 ** t)
        vhat = v2 / (1 - b2 ** t)
        delta = lr * (mhat / (torch.sqrt(vhat) + eps)
                      + weight_decay * p.to(torch.float32))
        new_p[key] = (p.to(torch.float32) - delta).to(p.dtype)
        new_m[key], new_v[key] = m2, v2
    return new_p, AdamState(step=step, mu=new_m, nu=new_v)
