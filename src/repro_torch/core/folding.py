"""Normalization folding (paper §3.1.2, eqs. 10-11).

Counterpart of ``repro/core/folding.py``.  The paper folds batch-norm into
the preceding conv before quantization:

    W_fold = gamma * W / sqrt(sigma^2 + eps)                    (eq. 10)
    b_fold = beta - gamma * mu / sqrt(sigma^2 + eps)            (eq. 11)

For pre-norm transformer blocks the analogous transform folds the norm's
diagonal scale forward into every projection that consumes the normed
activations: y = Norm(x) * gamma; q = y @ W == Norm(x) @ (diag(gamma) W).
LayerNorm's bias beta folds into the projection bias: b' = b + beta @ W
(eq. 11's additive term).
"""
from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (as XLA's and numpy's):
    torch's vectorized CPU sqrt is off by an ulp for ~0.7% of inputs; one
    float64 sqrt rounded once to float32 is exact."""
    return torch.sqrt(x.double()).to(x.dtype)


def fold_batchnorm(w, gamma, beta, mu, sigma2, eps: float = 1e-5):
    """Eqs. 10-11 for conv weights ``w`` (..., C_out) with output channels
    last; returns (w_fold, b_fold)."""
    inv = gamma / sqrt_rn(sigma2 + eps)
    return w * inv, beta - mu * inv


def fold_norm_into_projections(norm_scale, proj_weights: list,
                               norm_bias=None,
                               proj_biases: list | None = None):
    """Fold a pre-norm gamma (and beta) into the projections (d, out) that
    all consume the same normed activation (q/k/v, or gate/up).  Returns
    (new_scale, new_weights, new_biases); new_scale is all ones, and
    new_biases is None without ``norm_bias``."""
    g = norm_scale.float()
    new_ws = [(w.float() * g[:, None]).to(w.dtype) for w in proj_weights]
    new_bs = None
    if norm_bias is not None:
        extra = [norm_bias.float() @ w.float() for w in proj_weights]
        if proj_biases is None:
            new_bs = [e.to(w.dtype) for e, w in zip(extra, proj_weights)]
        else:
            new_bs = [((b.float() if b is not None else 0.0) + e).to(w.dtype)
                      for b, e, w in zip(proj_biases, extra, proj_weights)]
    return torch.ones_like(norm_scale), new_ws, new_bs


def fold_model_norms(model, params: dict) -> dict:
    """Fold every pre-norm scale of the model's declared fold plan
    (``model.fold_plan()``: (norm path, [projection paths])) into its
    consuming projections, in place; returns ``params``.  Plan entries
    whose keys the param tree does not hold are skipped, as in the
    reference, whose plans name module paths (``<config>/stack/layer0/
    mlp/up``) that its param keys (``stack/layer0/ffn/up/w``) never match:
    on the served configs the walk changes nothing."""
    plan = getattr(model, "fold_plan", lambda: [])()
    flat = flatten_ref(params)
    for norm_path, proj_paths in plan:
        scale_key, bias_key = norm_path + "/scale", norm_path + "/bias"
        if scale_key not in flat:
            continue
        gamma = _get(flat[scale_key])
        beta = _get(flat[bias_key]) if bias_key in flat else None
        if any(pp + "/w" not in flat for pp in proj_paths):
            continue
        parents = [flat[pp + "/w"] for pp in proj_paths]
        new_scale, new_ws, new_bs = fold_norm_into_projections(
            gamma, [_get(p) for p in parents], beta)
        sp, sl = flat[scale_key]
        sp[sl] = new_scale
        if beta is not None:
            bp, bl = flat[bias_key]
            bp[bl] = torch.zeros_like(beta)
        for (parent, leaf), nw in zip(parents, new_ws):
            parent[leaf] = nw
        if new_bs is not None:
            for (parent, _), nb in zip(parents, new_bs):
                parent["b"] = parent["b"] + nb if "b" in parent else nb
    return params


def _get(ref):
    parent, leaf = ref
    return parent[leaf]


def flatten_ref(params: dict, prefix: str = "") -> dict:
    """path -> (parent dict, leaf key), to rewrite leaves in place."""
    out = {}
    for k, v in params.items():
        kk = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_ref(v, kk))
        else:
            out[kk] = (params, k)
    return out
