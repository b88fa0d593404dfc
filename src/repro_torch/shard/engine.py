"""``ShardedEngine``: the Engine facade over a sequence- or
tensor-parallel model.

Counterpart of ``repro/shard/engine.py``.  An ``Engine`` whose model is a
``ShardedModel``; everything above the model surface (``generate_batch``,
the decoding strategies, the slot scheduler of ``generate``, its fault
plans, deadlines, preemption, journal and snapshots) is inherited
unchanged, as in the reference.

    engine = ShardedEngine.from_checkpoint("smollm-135m", smoke=False, sp=4)
    result = engine.generate_batch({"tokens": prompts}, gen=32)

``tp`` > 1 serves int8 weights Megatron-style, as the reference's
``ShardedEngine(tp=N)``: the heads, KV heads and FFN width split over the
shards (indivisible widths raise the reference's ``ValueError``), the
column-parallel projections and attention run as the unsharded kernels
(each column and head is computed alone), and each row-parallel layer sums
its shards' int32 partials (B3's int32-accumulator branch, once per shard
and layer) before one dequant.  Every strategy, cache layout (dense, ring,
paged) and stack the reference's tp serves; a mixture-of-experts stack
raises (ROADMAP Queue C: the reference's experts under tp are never
reduced).  Nothing on that path reads the host, so ``generate_batch`` and
the scheduler serve it through their captured programs.

``sp`` > 1 splits the dense KV cache's sequence axis into ``sp`` shards on
the engine's one device, and serves what the reference's ``ShardedEngine``
serves with it: every mode (int8 or bf16 weights, an int8, int4 or bf16
KV cache), every decoding strategy (greedy, sampled, and the speculative
verify window, in ``generate_batch`` and the scheduler), and every stack
(dense, mixture-of-experts, SSM, encoder-decoder, VLM).  Decode over a
quantized cache launches the partials kernel once per shard and layer and
merges the partials exactly; over a float cache it merges plain float32
partials.  Prefill and the verify window attend in plain attention, as
the reference's sequence-parallel branches do.  What the reference
refuses, this engine refuses with the same ``ValueError``: the paged
layout here, and a sliding-window layer's decode (hymba-1.5b,
gemma3-12b, mixtral-8x7b) at the first sp decode step.  Shards on several
devices are ROADMAP item 18.  With ``tp == sp == 1`` this is exactly an
Engine.  With ``sp`` > 1, ``generate_batch`` and the scheduler run their
programs uncaptured (``eager_reason``): the captured programs are ROADMAP
item 9d.

On a rank mesh (``mesh=launch.mesh.RankMesh``, one process per shard, as
the reference runs one device per shard) every rank builds this engine
from the same global weights and keeps its slice (``tp``: the local model
and the rank's slices of the weights, thresholds and KV heads; ``sp``: its
S / sp rows of the cache), on its own device.  Every rank runs the same
program on the same inputs (SPMD): the row layers' int32 partials are
summed by ``torch.distributed.all_reduce``, the sp ranks' decode partials
and whole-sequence reads all-gathered.  The calibrated global engine is
written once (``save_serving``) and each rank restores it
(``from_serving``), so calibration has one source.  Such an engine serves
uncaptured (``eager_reason``).

    # in each of n ranks (dist.ranks.run_ranks)
    engine = ShardedEngine.from_serving(directory, cfg, mesh=mesh, tp=n)
    result = engine.generate_batch({"tokens": prompts}, gen=32)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.bridge import tree_to
from repro_torch.dist.sharding import tp_param_slices, tp_qparam_slices
from repro_torch.kernels import ops
from repro_torch.launch.engine import Engine, resolve_device
from repro_torch.launch.mesh import RankMesh, make_serving_mesh
from repro_torch.shard.context import ShardContext
from repro_torch.shard.model import ShardedModel, check_tp


def _resident(tree, device):
    """``tree`` with every tensor on ``device`` as a contiguous copy of its
    own (a rank's slice keeps no storage of the whole)."""
    if isinstance(tree, dict):
        return {k: _resident(v, device) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return tree.to(device).clone(memory_format=torch.contiguous_format)


class ShardedEngine(Engine):
    """Engine with ``tp`` tensor or ``sp`` sequence shards on its device;
    see the module docstring."""

    def __init__(self, model, cfg, policy, serve_params, qparams, *,
                 tp: int = 1, sp: int = 1, mesh=None,
                 mesh_axis: str = "model", **engine_kw):
        self._validate(tp, sp, engine_kw.get("cache_layout", "ring"),
                       engine_kw.get("mode", "int8"))
        self.tp, self.sp = tp, sp
        self.base_model = model
        n = max(tp, sp)
        if mesh is None and n > 1:
            mesh = make_serving_mesh(n, axis=mesh_axis,
                                     device=engine_kw["device"])
        self.mesh, self.mesh_axis = mesh, mesh_axis
        if n > 1:
            # validates exclusivity, divisibility and the mesh's size
            model = ShardedModel(model, cfg, mesh, tp=tp, sp=sp,
                                 axis=mesh_axis)
        if tp > 1:
            # the role rules over the weights (the reference's specs raise
            # here on an indivisible axis)
            shards = tp_param_slices(serve_params, tp=tp)
        if isinstance(mesh, RankMesh):
            dev = resolve_device(engine_kw.get("device", mesh.device))
            if dev != mesh.device:
                raise ValueError(f"rank {mesh.rank} serves on {mesh.device},"
                                 f" not {dev}")
            engine_kw["device"] = dev
            if tp > 1:
                serve_params = shards[mesh.rank]
                qparams = tp_qparam_slices(qparams, tp=tp,
                                           n_kv=cfg.n_kv_heads)[mesh.rank]
            serve_params = _resident(serve_params, dev)
            qparams = _resident(qparams, dev)
        super().__init__(model, cfg, policy, serve_params, qparams,
                         **engine_kw)

    @staticmethod
    def _validate(tp: int, sp: int, cache_layout: str, mode: str) -> None:
        """Raise on a parallelism (or, under it, a mode or a cache layout)
        this engine does not serve."""
        if tp < 1 or sp < 1:
            raise ValueError(f"tp/sp must be >= 1, got tp={tp} sp={sp}")
        if tp > 1 and mode != "int8":
            raise ValueError(
                f"tensor-parallel serving requires mode='int8' (got "
                f"{mode!r}): the row epilogues reduce int32 accumulators "
                "— float weights have nothing exact to psum")
        if sp > 1 and cache_layout == "paged":
            raise ValueError(
                "sequence-parallel serving shards the dense cache's S "
                "axis — the paged pool has no contiguous shard slices "
                "(use cache_layout='dense' or 'ring')")
        # tp and sp share one mesh axis
        ShardContext(tp=tp, sp=sp)

    @classmethod
    def from_checkpoint(cls, arch: str = "smollm-135m", *, tp: int = 1,
                        sp: int = 1, **kw) -> "ShardedEngine":
        """``Engine.from_checkpoint`` (every other argument is its own),
        served with ``tp`` tensor or ``sp`` sequence shards.  A refusal
        (the mode, the layout, the shard counts, the config's widths or
        its experts) raises before any weight is built."""
        cls._validate(tp, sp, kw.get("cache_layout", "ring"),
                      "none" if kw.get("fp") else "int8")
        if tp > 1:
            cfg = kw.get("cfg")
            if cfg is None:
                from repro_torch.configs import get_config

                cfg = get_config(arch, smoke=kw.get("smoke", True))
            check_tp(cfg, tp)
        base = Engine.from_checkpoint(arch, **kw)
        return cls(base.model, base.cfg, base.policy, base.serve_params,
                   base.qparams, device=base.device, tp=tp, sp=sp,
                   **base._init_kw())

    @property
    def ranked(self) -> bool:
        """Whether this engine is one rank of a rank mesh."""
        return isinstance(self.mesh, RankMesh)

    def save_serving(self, directory: str) -> str:
        """Write this (global, one-process) engine's serving weights and
        thresholds, its mode and its policy under ``directory``
        (``checkpoint.manager``), for ``from_serving``; returns the
        checkpoint's path."""
        from repro_torch.checkpoint.manager import CheckpointManager

        if self.ranked:
            raise ValueError("save_serving writes the global engine; a rank "
                             "holds only its slice")
        return CheckpointManager(directory, keep=1).save(
            0, {"serve_params": self.serve_params, "qparams": self.qparams},
            metadata={"mode": self.mode,
                      "policy": dataclasses.asdict(self.policy)})

    @classmethod
    def from_serving(cls, directory: str, cfg, *, mesh: RankMesh,
                     tp: int = 1, sp: int = 1, **engine_kw):
        """This rank's engine of a rank mesh (``tp`` or ``sp`` equal to
        ``mesh.n``), from the global engine that ``save_serving`` wrote
        under ``directory`` with the global ``cfg``: read on the CPU, the
        rank's slice kept on its device.  ``engine_kw``: the Engine's
        serving knobs (``cache_layout``, ``decode_strategy``, ...)."""
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.core.api import QuantPolicy
        from repro_torch.models import build_model

        tree, meta = CheckpointManager(directory).restore_latest()
        if tree is None:
            raise FileNotFoundError(f"no committed checkpoint in "
                                    f"{directory!r}")
        pol = meta["policy"]
        pol["skip_patterns"] = tuple(pol["skip_patterns"])
        cls._validate(tp, sp, engine_kw.get("cache_layout", "ring"),
                      meta["mode"])
        return cls(build_model(cfg), cfg, QuantPolicy(**pol),
                   tree["serve_params"], tree["qparams"], tp=tp, sp=sp,
                   mesh=mesh, device=mesh.device, mode=meta["mode"],
                   **engine_kw)

    def to(self, device) -> "ShardedEngine":
        """The same sharded engine (same weights, thresholds and shard
        count) on another device; a rank stays on its rank's device."""
        if self.ranked:
            raise ValueError("a rank's engine serves on its rank's device")
        dev = resolve_device(device)
        return ShardedEngine(self.base_model, self.cfg, self.policy,
                             tree_to(self.serve_params, dev),
                             tree_to(self.qparams, dev), device=dev,
                             tp=self.tp, sp=self.sp, **self._init_kw())

    def eager_reason(self):
        """``sp`` > 1 serves eagerly, on the CPU and on CUDA:
        ``generate_batch`` runs its programs uncaptured and the scheduler
        its steps; its decode's partials and merge (B4) are not captured
        yet (ROADMAP item 9d).  ``tp`` > 1 reads nothing on the host and
        captures, as an Engine does.  A rank of a rank mesh runs uncaptured:
        its collectives (gloo's staged through the host) are not captured
        in a CUDA graph."""
        if self.ranked:
            return ("rank-per-shard serving runs its programs uncaptured: "
                    "its torch.distributed collectives are not captured in "
                    "a CUDA graph")
        if self.sp > 1:
            return ("sequence-parallel serving (sp > 1) runs its programs "
                    "uncaptured: CUDA graphs under sp are ROADMAP item 9d")
        return None

    @staticmethod
    def reduce_counts() -> dict:
        """The tensor-parallel row reduces since the last
        ``kernels.ops.reset_launches`` (process-wide, as the launch
        counts): how many, and ``wire_bytes``, the int32 payload of the
        tp - 1 other shards that each sums, what the reduces would move
        between devices (on a rank: what it received)."""
        return ops.reduce_counts()

    def dry_run_report(self, *, batch: int = 2, prompt_len: int = 32,
                       cache_len=None) -> dict:
        """Run this engine's prefill (``batch`` x ``prompt_len`` seeded
        tokens) and one decode step after it, each once under
        ``repro_torch.analysis``'s recorder, and audit their collectives:
        the reference's report (its ``dry_run_report`` compiles the two
        executables and reads their HLO; the port records the collectives
        it runs).

        Per executable: ``collective_bytes`` (what each shard receives:
        the int32 payloads of the tensor-parallel reduces, the gathered
        partials of sequence-parallel decode; on the serving paths the
        ``reduce_counts()`` / ``gather_counts()`` delta of the same step),
        ``collective_by_kind`` ("all-reduce", "all-gather"), the all-reduce
        payloads as (dtype, elements) and the integer-all-reduce verdict
        (integer payloads only, but one float scalar: the reference's
        ``launch/hlo_analysis.py`` rule) with its findings.  Top-level
        ``int8_all_reduces_ok`` is the AND over both.  Text stacks only
        (a batch of tokens), as the reference."""
        from repro_torch.analysis import entrypoints as EP
        from repro_torch.analysis.dtype_drift import (
            all_reduce_payloads, check_integer_all_reduces)
        from repro_torch.analysis.record import Recorder
        from repro_torch.core import api as A
        from repro_torch.launch import steps as ST

        if cache_len is None:
            cache_len = self._cache_len(prompt_len, 32)
        cache = self.init_cache(batch, cache_len)
        toks = EP.prompts(self, batch, prompt_len)

        def prefill():
            ST.make_prefill_step(self.model, self.policy, mode=self.mode)(
                self.serve_params, self.qparams, {"tokens": toks}, cache)

        def decode():
            self.model.decode_step(
                self.serve_params, toks[:, -1:], cache, prompt_len,
                A.make_ctx(self.mode, self.policy, self.qparams))

        report = {"tp": self.tp, "sp": self.sp, "executables": {}}
        all_ok = True
        for name, fn in (("prefill", prefill), ("decode", decode)):
            with torch.inference_mode(), Recorder() as rec:
                fn()
            by_kind: dict = {}
            for c in rec.collectives:
                kind = c.kind.replace("_", "-")
                by_kind[kind] = by_kind.get(kind, 0) + c.nbytes
            ok, findings = check_integer_all_reduces(rec.collectives)
            all_ok &= ok
            report["executables"][name] = {
                "collective_bytes": sum(by_kind.values()),
                "collective_by_kind": {k: v for k, v in by_kind.items()
                                       if v > 0},
                "all_reduce_payloads": all_reduce_payloads(rec.collectives),
                "int8_all_reduces_ok": ok,
                "findings": findings,
            }
        report["int8_all_reduces_ok"] = all_ok
        return report
