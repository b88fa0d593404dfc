"""The serving mesh of the sharded engine.

Counterpart of ``repro/launch/mesh.py::make_serving_mesh``.  The
reference's serving mesh is a one-axis ``jax.sharding.Mesh`` over ``n``
local devices; the port's shards live on the engine's one device, so its
mesh is ``n`` shard slots on that device under the same axis name, which
``ShardedModel`` checks as the reference checks its mesh.  The production
mesh (data x model over a pod) places XLA's arrays and has no
counterpart (ROADMAP item 18).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """``n`` shard slots on ``device``, along one axis named ``axis``."""

    axis: str
    n: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {self.axis: self.n}


def make_serving_mesh(n: int, *, axis: str = "model",
                      device="cuda") -> ServingMesh:
    """The one-axis serving mesh of ``n`` tensor- or sequence-parallel
    shards on ``device``.  ``n`` < 1 raises IndexError, as the
    reference's does."""
    if n < 1:
        raise IndexError(f"a serving mesh needs n >= 1 shards, got {n}")
    return ServingMesh(axis=axis, n=n, device=torch.device(device))
