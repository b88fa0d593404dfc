"""The serving meshes of the sharded engine.

Counterpart of ``repro/launch/mesh.py::make_serving_mesh``.  The
reference's serving mesh is a one-axis ``jax.sharding.Mesh`` over ``n``
local devices, one shard each.  The port has two:

  * ``ServingMesh`` (``make_serving_mesh``): ``n`` shard slots on the
    engine's one device, which one process serves as one global model;
  * ``RankMesh`` (``make_rank_mesh``): ``n`` processes, one shard each,
    joined by a ``torch.distributed`` process group (PyTorch's idiom for
    the reference's devices): rank r serves on ``cuda:(r % the visible
    cards)``, or on the CPU where the caller asks for it.  The backend is
    the caller's choice: ``nccl`` where every rank has a card of its own,
    ``gloo`` where ranks share a card (NCCL refuses two ranks on one
    device) or run on the CPU.  A rank never moves from the card to the
    CPU by itself.

``ShardedModel`` checks either as the reference checks its mesh.  The
production mesh (data x model over a pod) places XLA's arrays and has no
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


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This process's place in a mesh of ``n`` ranks (the world size)
    along ``axis``: its ``rank``, its ``device``, the ``backend`` and the
    process ``group`` its collectives run over (None: the default
    group)."""

    axis: str
    n: int
    rank: int
    device: torch.device
    backend: str
    group: object = None

    @property
    def shape(self) -> dict:
        return {self.axis: self.n}



def make_rank_mesh(n: int, *, axis: str = "model",
                   device="cuda") -> RankMesh:
    """The rank mesh of this process, inside an initialized default process
    group of ``n`` ranks (``dist.ranks.run_ranks`` sets one up): rank r on
    ``cuda:(r % the visible cards)``, or on the CPU where ``device`` asks
    for it.  Raises where the group's size is not ``n``, and where no card
    is visible (it never falls back to the CPU)."""
    import torch.distributed as dist

    if n < 1:
        raise IndexError(f"a serving mesh needs n >= 1 shards, got {n}")
    if not dist.is_initialized():
        raise RuntimeError("make_rank_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    if dist.get_world_size() != n:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, the mesh {n}")
    rank = dist.get_rank()
    if torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        raise RuntimeError(f"rank {rank}: no CUDA device is available (ask "
                           "for device='cpu' to serve on the CPU)")
    return RankMesh(axis=axis, n=n, rank=rank, device=dev,
                    backend=dist.get_backend())
