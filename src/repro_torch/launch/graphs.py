"""Captured serving programs: the port's counterpart of the reference's
``jax.jit(..., donate_argnums=...)`` + ``lower().compile()``.

A ``Program`` wraps a step function of no arguments that reads and writes
static tensors only: the weights, the cache, and input buffers that the
caller fills with ``copy_`` before each call.  On a CUDA device the
function is run ``WARMUP`` times on a side stream (as PyTorch's notes on
CUDA graphs prescribe: lazy initialisation, the kernels' first build and
load, the wrappers' shared buffers all happen there), then captured once
as a ``torch.cuda.CUDAGraph``; each call replays the graph and returns the
capture's outputs, which every replay rewrites in place.  The capture is
the caller's set-up: ``capture_s`` is its wall time, warm-up included,
and a serving window only replays.

On the CPU there are no graphs: each call runs the function eagerly.  The
caller asked for the CPU, so this is the route, not a fallback; on CUDA a
capture or replay that fails raises, and nothing runs the eager step
instead.

Launch accounting: the kernel wrappers count their Python calls
(``kernels.ops``).  The capture calls them but launches nothing, and a
replay launches them without a call, so a ``Program`` takes the capture's
count back out and adds it again at each replay: ``ops.launch_counts()``
keeps reporting the launches that ran on the device.  Warm-up launches
are real and count.

``builds`` counts the Programs built in this process (captures on CUDA,
eager programs on the CPU): ``repro_torch.analysis.budgets.CaptureWatch``
holds a warm serving session to zero of them.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels import ops

# eager runs of a step before its capture
WARMUP = 2
# Programs built in this process
builds = 0


class Program:
    """``fn`` captured on ``device`` (CUDA), or run eagerly (CPU, or
    ``capture`` False: a caller's explicit eager branch)."""

    def __init__(self, fn, device, *, capture: bool = True):
        global builds
        builds += 1
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.outputs = None
        self.launches: dict = {}     # the launches of one replay
        self.capture_s = 0.0
        if not capture or self.device.type != "cuda":
            return
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn()
        main.wait_stream(side)
        before = ops.launch_snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.outputs = fn()
        self.launches = ops.launch_delta(before, ops.launch_snapshot())
        ops.add_launches(self.launches, -1)
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def __call__(self):
        """Replay (CUDA) or run (CPU); returns the function's outputs."""
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.outputs
