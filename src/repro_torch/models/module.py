"""Minimal functional module system, as in the reference package.

Modules are plain Python objects built from a config; parameters live in
nested dicts of tensors that mirror the module tree, so the reference's
layer paths key the quantization state unchanged and the weight bridge
(``repro_torch.bridge``) is a plain tree conversion.  Every module has

  * ``init(generator) -> params``  seeded init with a ``torch.Generator``
    (on the CPU: the same seed gives the same weights on every device; a
    CUDA generator draws them on the card; a ``MetaGenerator`` gives
    tensors on the meta device, shapes and dtypes with no storage);
  * ``__call__(params, ..., ctx=...)``  the forward on tensors.
"""
from __future__ import annotations

import math

import torch


class Module:
    """Base class; subclasses define ``init`` and ``__call__``."""

    path: str = ""

    def init(self, gen: torch.Generator) -> dict:  # pragma: no cover
        raise NotImplementedError

    def param_children(self) -> dict:
        """Mapping param-tree key -> child Module (attribute name by
        default; containers with computed keys override)."""
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, Module)}

    def walk_with_params(self, params: dict):
        """Yield (module, params_subtree) for self and all descendants."""
        yield self, params
        for key, child in self.param_children().items():
            if isinstance(params, dict) and key in params:
                yield from child.walk_with_params(params[key])


class MetaGenerator:
    """Stands in for a ``torch.Generator`` in ``init`` where only the
    shapes are wanted (the dry run): every draw is a float32 tensor on the
    meta device, and nothing is allocated.  ``torch.Generator("meta")``
    does not exist."""

    device = torch.device("meta")


def draw(gen, shape) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` on the generator's
    device (a ``MetaGenerator``: the shape alone)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def normal_init(gen, shape, dtype, stddev=0.02):
    """Drawn on the generator's device: a CPU generator gives the same
    weights on every device, a CUDA one draws full-width weights on the
    card."""
    return (draw(gen, shape) * stddev).to(dtype)


def fan_in_init(gen, shape, dtype):
    """LeCun-normal over the penultimate (fan-in) axis."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return (draw(gen, shape) / math.sqrt(fan_in)).to(dtype)


class Dense(Module):
    """y = x @ W (+ b), the quantization unit of the paper's scheme: one set
    of thresholds per Dense.  ``bias`` adds a ``b`` leaf, int32 in int8
    mode (eq. 20); ``quantize=False`` keeps the layer in full precision in
    every mode (the MoE router); ``act_unsigned`` marks an input known to
    be non-negative (after a ReLU), which calibrates, fake-quantizes and
    serves on the unsigned range (paper eq. 9).  ``logical_axes`` name the
    weight's (in, out) axes as the reference's do; under tensor
    parallelism an input axis of 'heads' or 'mlp' makes the layer
    row-parallel (``core/api.py``)."""

    def __init__(self, in_dim: int, out_dim: int, *, path: str,
                 bias: bool = False, dtype=torch.bfloat16,
                 quantize: bool = True, act_unsigned: bool = False,
                 logical_axes: tuple = ("in", "out")):
        self.logical_axes = logical_axes
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.path = path
        self.bias = bias
        self.dtype = dtype
        self.quantize = quantize
        self.act_unsigned = act_unsigned

    def init(self, gen: torch.Generator) -> dict:
        p = {"w": fan_in_init(gen, (self.in_dim, self.out_dim), self.dtype)}
        if self.bias:
            p["b"] = torch.zeros((self.out_dim,), dtype=self.dtype,
                                 device=gen.device)
        return p

    def __call__(self, params: dict, x: torch.Tensor, ctx=None):
        from repro_torch.core import api

        return api.dense_forward(self, params, x, ctx)


class ExpertDense(Module):
    """Batched expert weights (E, in, out) of an MoE layer, quantized with
    per-(expert, output channel) thresholds: the paper's per-filter
    thresholds one level up.  Its input is a dispatch buffer (E, M, in),
    expert e's rows contiguous.  Always quantized (unless the policy skips
    its path)."""

    quantize = True

    def __init__(self, num_experts: int, in_dim: int, out_dim: int, *,
                 path: str, dtype=torch.bfloat16):
        self.num_experts = num_experts
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.path = path
        self.dtype = dtype

    @property
    def channels(self) -> int:
        """The flattened (expert, out) channel count of vector mode."""
        return self.num_experts * self.out_dim

    def init(self, gen: torch.Generator) -> dict:
        return {"w": fan_in_init(
            gen, (self.num_experts, self.in_dim, self.out_dim), self.dtype)}

    def __call__(self, params: dict, x: torch.Tensor, ctx=None):
        """x: (E, M, in) -> (E, M, out)."""
        from repro_torch.core import api

        return api.expert_dense_forward(self, params, x, ctx)
