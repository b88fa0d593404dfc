"""Mixture-of-experts with sort-based dispatch; counterpart of
``repro/models/moe.py``.

Dispatch is independent per *group* (one group is one sequence: a prompt,
a prefill chunk, or one decode slot), each with its own ``capacity``
slots per expert.  A token's top-k assignments are ranked per expert in
the order of a stable sort by expert id; assignments past an expert's
capacity go to a trash slot and are **dropped**, and the expert slots no
assignment fills read a zero sentinel row.  Expert weights are
``ExpertDense`` (E, in, out) tensors quantized per (expert, output
channel); the router is a float32 Dense that is never quantized.

The port lays the dispatch buffer out expert-major, (E, G x C, d) with
expert e's rows contiguous, so the int8 forward runs the fused kernel
once per expert on a plain (G x C, d) matrix; the reference's (G, E, C, d)
holds the same rows in another order.  Every step is capturable: the
capacity is a Python int known from the shapes, nothing is read back to
the host, and no tensor is made from host data.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.models.layers import ACTIVATIONS, check_no_tf32, silu_xla
from repro_torch.models.module import Dense, ExpertDense, Module


def _seq_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a top-k axis of 2-8 entries) in float32,
    one entry after the other: the order of XLA's CPU reduction there."""
    acc = t[..., 0].float()
    for i in range(1, t.shape[-1]):
        acc = acc + t[..., i]
    return acc


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest values of the last axis, descending,
    ties in index order (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# the active ``routing_log``'s records, or None
_routing = None


@contextlib.contextmanager
def routing_log():
    """While active, every dispatch appends one record: (the device type,
    its expert choice (G, T, K) with each token's ids ascending, the
    probability gap between each token's k-th and (k+1)-th expert (G, T);
    both on the CPU).  How a check counts the tokens that two devices'
    routers send to other experts.  It reads back to the host: never
    around a captured step."""
    global _routing
    saved, _routing = _routing, []
    try:
        yield _routing
    finally:
        _routing = saved


def _routing_record(probs, top_idx):
    k = top_idx.shape[-1]
    srt = probs.sort(dim=-1, descending=True).values
    gap = (srt[..., k - 1] - srt[..., k] if k < probs.shape[-1]
           else torch.full_like(srt[..., 0], float("inf")))
    return probs.device.type, top_idx.sort(-1).values.cpu(), gap.cpu()


def _dispatch(x, logits, top_k_: int, capacity: int, num_experts: int):
    """Sort-based dispatch, one independent dispatch per group.

    x: (G, T, d); logits: (G, T, E).  Returns (the dispatch buffer (E, G x
    C, d), expert-major: slot c of expert e in group g is row g x C + c of
    expert e; the combine info (``slots`` (G, T x K) each assignment's
    row of the flattened buffer, E x G x C when dropped; ``weights`` (G, T
    x K) float32, the renormalized top-k probabilities)).  The routing is
    the reference's: float32 softmax, top-k with ties to the lower expert,
    weights over their own sum, ranks in stable-sort order by expert,
    ``rank < capacity`` kept."""
    g, t, d = x.shape
    e, k, c = num_experts, top_k_, capacity
    dev = x.device
    probs = torch.softmax(logits.float(), dim=-1)
    top_vals, top_idx = top_k(probs, k)                       # (G, T, K)
    if _routing is not None:
        _routing.append(_routing_record(probs, top_idx))
    top_vals = top_vals / _seq_sum(top_vals)[..., None]

    e_flat = top_idx.reshape(g, t * k)
    t_flat = (torch.arange(t * k, device=dev) // k).expand(g, -1)
    w_flat = top_vals.reshape(g, t * k)

    order = torch.sort(e_flat, dim=-1, stable=True).indices
    se = e_flat.gather(-1, order)
    st = t_flat.gather(-1, order)
    counts = torch.zeros((g, e), dtype=torch.long, device=dev).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=-1) - counts            # exclusive
    rank = torch.arange(t * k, device=dev) - starts.gather(-1, se)
    slot = torch.where(rank < c, se * c + rank, e * c)        # trash slot

    # slot -> source token, the trash slot last and sliced off; unfilled
    # slots point at the zero row appended to each group
    src = torch.full((g, e * c + 1), t, dtype=torch.long, device=dev)
    src = src.scatter(1, slot, st)[:, :-1]
    rows = src + torch.arange(g, device=dev)[:, None] * (t + 1)
    rows = rows.reshape(g, e, c).transpose(0, 1).reshape(-1)
    x_pad = torch.cat([x, x.new_zeros((g, 1, d))], dim=1).reshape(-1, d)
    x_disp = x_pad.index_select(0, rows).reshape(e, g * c, d)

    # (token, k) -> its row of the flattened expert-major buffer
    sorted_rows = torch.where(
        slot < e * c,
        (slot // c) * (g * c) + torch.arange(g, device=dev)[:, None] * c
        + slot % c, e * g * c)
    slots = torch.empty_like(sorted_rows).scatter_(1, order, sorted_rows)
    return x_disp, (slots, w_flat)


def _combine(y_exp, info, t: int):
    """Return path: each assignment's expert output row back in token
    order, times its weight in the activation dtype, summed over the K
    assignments in order, as the reference's compiled graph sums them: at
    bf16 the products rounded to bf16, accumulated in float32 and rounded
    once; at float32 each product fused into its add (an FMA, emulated in
    float64, where the product is exact).  A dropped assignment reads
    zeros.  y_exp: (E, G x C, d) -> (G, T, d)."""
    slots, w_flat = info
    g, tk = slots.shape
    k = tk // t
    flat = y_exp.reshape(-1, y_exp.shape[-1])
    n = flat.shape[0]
    contrib = flat.index_select(0, slots.clamp_max(n - 1).reshape(-1))
    contrib = contrib.reshape(g, tk, -1).masked_fill(
        (slots == n)[..., None], 0).reshape(g, t, k, -1)
    w = w_flat.reshape(g, t, k, 1).to(flat.dtype)
    if flat.dtype != torch.float32:
        return _seq_sum((contrib * w).transpose(-1, -2)).to(flat.dtype)
    acc = torch.zeros_like(contrib[:, :, 0], dtype=torch.float64)
    for i in range(k):
        acc = (acc + contrib[:, :, i].double() * w[:, :, i].double()).float(
            ).double()
    return acc.float()


def load_balance_loss(logits, num_experts: int) -> torch.Tensor:
    """The Switch-style auxiliary: E x sum_e f_e p_e, f_e the share of
    tokens whose top-1 expert is e, p_e the mean router probability."""
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = probs.argmax(-1)
    onehot = (top1[..., None] == torch.arange(num_experts,
                                              device=logits.device)).float()
    f = onehot.mean(dim=(0, 1))
    p = probs.mean(dim=(0, 1))
    return num_experts * torch.sum(f * p)


class MoE(Module):
    def __init__(self, d_model: int, d_ff: int, num_experts: int, top_k: int,
                 *, path: str, capacity_factor: float = 1.25,
                 activation: str = "silu", dtype=torch.bfloat16):
        self.d_model = d_model
        self.d_ff = d_ff
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.act = silu_xla if activation == "silu" else ACTIVATIONS[activation]
        self.path = path
        self.router = Dense(d_model, num_experts, path=f"{path}/router",
                            quantize=False, dtype=torch.float32)
        self.gate = ExpertDense(num_experts, d_model, d_ff,
                                path=f"{path}/gate", dtype=dtype)
        self.up = ExpertDense(num_experts, d_model, d_ff, path=f"{path}/up",
                              dtype=dtype)
        self.down = ExpertDense(num_experts, d_ff, d_model,
                                path=f"{path}/down", dtype=dtype)

    def init(self, gen):
        return {"router": self.router.init(gen), "gate": self.gate.init(gen),
                "up": self.up.init(gen), "down": self.down.init(gen)}

    def capacity(self, tokens_per_group: int) -> int:
        """Slots per expert and group: the expected assignments times the
        capacity factor, padded to a multiple of 8 (at least 8)."""
        c = math.ceil(tokens_per_group * self.top_k / self.num_experts
                      * self.capacity_factor)
        return max(8, math.ceil(c / 8) * 8)

    def __call__(self, params, x, ctx=None, *, with_aux: bool = True):
        """x: (B, S, d) -> (y (B, S, d), the load-balance loss, or None
        without ``with_aux``: the serving paths drop it).  The router's
        float32 product must not run in TF32 on the card."""
        check_no_tf32(x, f"{self.path}: the router's float32 products")
        s = x.shape[1]
        logits = self.router(params["router"], x.float(), ctx)
        xd, info = _dispatch(x, logits, self.top_k, self.capacity(s),
                             self.num_experts)
        g = self.act(self.gate(params["gate"], xd, ctx))
        u = self.up(params["up"], xd, ctx)
        if ctx is not None and ctx.mode == "int8" and ctx.enabled(self.down):
            # the reference's compiled graph quantizes the down input from
            # the float32 product, never rounded to the activation dtype
            h = g.float() * u.float()
        else:
            h = g * u
        y = _combine(self.down(params["down"], h, ctx), info, s)
        aux = (load_balance_loss(logits, self.num_experts) if with_aux
               else None)
        return y, aux

    def equalization_pairs(self):
        """Per-expert up -> down rescale (§3.3 through the gate
        product)."""
        return [(self.up.path, self.down.path)]
