"""The decode state of one SSM mixer (``models/ssm.py::Mamba2Block``),
held in place beside the KV caches of a stack's cache tree."""
from __future__ import annotations

import torch


class SSMState:
    """``ssm`` (B, H, N, P) float32, the SSD state; ``conv`` (B, K - 1, C)
    float32, the conv stream's last K - 1 raw rows.  Its size does not
    depend on the sequence length.  Prefill and decode write both buffers
    in place (``write_``): a captured decode step reads and writes the
    same tensors on every replay, and a replayed prefill overwrites
    them."""

    def __init__(self, ssm: torch.Tensor, conv: torch.Tensor):
        self.ssm, self.conv = ssm, conv

    @classmethod
    def init(cls, batch: int, n_heads: int, d_state: int, head_dim: int,
             conv_width: int, channels: int, device=None) -> "SSMState":
        return cls(torch.zeros((batch, n_heads, d_state, head_dim),
                               dtype=torch.float32, device=device),
                   torch.zeros((batch, conv_width - 1, channels),
                               dtype=torch.float32, device=device))

    def write_(self, ssm: torch.Tensor, conv: torch.Tensor) -> "SSMState":
        """Copy a new state into the buffers (the arguments must not alias
        them)."""
        self.ssm.copy_(ssm)
        self.conv.copy_(conv)
        return self
