"""Start ``n`` ranks, one process per shard, and run a function on each.

``run_ranks(fn, n, backend=..., device=...)`` spawns ``n`` processes with
``torch.multiprocessing``'s ``spawn`` start method (never ``fork``: a
forked child of a process that has touched CUDA cannot use it), sets up
the default process group in each (``tcp://localhost:<free port>``, world
size ``n``, its rank), builds the rank's ``launch.mesh.RankMesh`` and
calls ``fn(mesh, *args)``.  Rank 0's return value comes back to the
caller; a rank that raises makes the whole run raise, and the other ranks
are stopped.  ``fn`` must be a module-level function (it is pickled by
name into the children), and so must its arguments be picklable.

The kernels are built by the caller before it spawns the ranks (a call of
``kernels.build.load()``): the ranks then only load the libraries, and no
two processes run ``nvcc`` on the same files.
"""
from __future__ import annotations

import datetime
import pickle
import socket
import time
import traceback


# the process group's timeout: a collective that waits longer raises
TIMEOUT_S = 600


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_cpu(tree):
    """``tree`` with every tensor moved to the CPU (pickled by value)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _entry(rank, fn, n, backend, device, port, args, results, threads):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_rank_mesh

    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=n,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_rank_mesh(n, device=device)
        out = fn(mesh, *args)
        if rank == 0:
            # by value (plain pickle), not through shared memory: the rank
            # may exit before the caller reads it
            results.put(pickle.dumps(("ok", _to_cpu(out))))
        dist.barrier()
    except BaseException:
        if rank == 0:
            results.put(pickle.dumps(("error", traceback.format_exc())))
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, *, backend: str, device="cuda", args=(),
              threads: int | None = None, timeout: float | None = None):
    """Run ``fn(mesh, *args)`` on ``n`` spawned ranks over ``backend``
    ("gloo" or "nccl"), each on its device (``launch.mesh.make_rank_mesh``:
    a card, or the CPU where ``device`` asks for it) with ``threads``
    intra-op threads (None: torch's default); returns rank 0's result, its
    tensors on the CPU.  Raises if any rank raises (the other ranks
    are terminated), and TimeoutError where the ranks have not all ended
    ``timeout`` seconds after the spawn (every rank is terminated)."""
    import torch.multiprocessing as mp

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(
        _entry, args=(fn, n, backend, device, free_port(), tuple(args),
                      results, threads),
        nprocs=n, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    got = None
    # read while the ranks run: a result larger than the pipe's buffer
    # blocks rank 0 until it is read.  ``join`` raises (and terminates the
    # other ranks) when a rank fails.
    while True:
        if got is None and not results.empty():
            got = results.get()
        if procs.join(timeout=0.05):
            break
        if deadline is not None and time.monotonic() > deadline:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
            for p in procs.processes:
                p.join()
            raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)}"
                               f" still ran {timeout} s after the spawn")
    if got is None and not results.empty():
        got = results.get()
    if got is None:
        raise RuntimeError("rank 0 returned no result")
    status, out = pickle.loads(got)
    if status != "ok":
        raise RuntimeError(f"rank 0 raised:\n{out}")
    return out
