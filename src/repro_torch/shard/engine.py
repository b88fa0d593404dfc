"""``ShardedEngine``: the Engine facade over a sequence-parallel model.

Counterpart of ``repro/shard/engine.py``.  An ``Engine`` whose model is a
``ShardedModel``; everything above the model surface (``generate_batch``,
the decoding strategies, the slot scheduler of ``generate``, its fault
plans, deadlines, preemption, journal and snapshots) is inherited
unchanged, as in the reference.

    engine = ShardedEngine.from_checkpoint("smollm-135m", smoke=False, sp=4)
    result = engine.generate_batch({"tokens": prompts}, gen=32)

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
gemma3-12b, mixtral-8x7b) at the first sp decode step.  ``tp`` > 1
(tensor parallelism) and shards on several devices are ROADMAP Queue A
item 18.  With ``sp == 1`` this is exactly an Engine.  With ``sp`` > 1,
``generate_batch`` and the scheduler run their programs uncaptured
(``eager_reason``): the captured programs are ROADMAP Queue A item 9d.
"""
from __future__ import annotations

from repro_torch.bridge import tree_to
from repro_torch.launch.engine import Engine, resolve_device
from repro_torch.shard.model import ShardedModel


class ShardedEngine(Engine):
    """Engine with ``sp`` sequence shards on its device; see the module
    docstring."""

    def __init__(self, model, cfg, policy, serve_params, qparams, *,
                 tp: int = 1, sp: int = 1, **engine_kw):
        self._validate(tp, sp, engine_kw.get("cache_layout", "ring"))
        self.sp = sp
        self.base_model = model
        if sp > 1:
            model = ShardedModel(model, cfg, sp=sp)
        super().__init__(model, cfg, policy, serve_params, qparams,
                         **engine_kw)

    @staticmethod
    def _validate(tp: int, sp: int, cache_layout: str) -> None:
        """Raise on a parallelism (or, under it, a cache layout) this engine
        does not serve."""
        if tp < 1 or sp < 1:
            raise ValueError(f"tp/sp must be >= 1, got tp={tp} sp={sp}")
        if tp > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp > 1, the head/ffn split and its "
                "int32 all-reduce) is not ported (ROADMAP Queue A item 18)")
        if sp > 1 and cache_layout == "paged":
            raise ValueError(
                "sequence-parallel serving shards the dense cache's S "
                "axis — the paged pool has no contiguous shard slices "
                "(use cache_layout='dense' or 'ring')")

    @classmethod
    def from_checkpoint(cls, arch: str = "smollm-135m", *, tp: int = 1,
                        sp: int = 1, **kw) -> "ShardedEngine":
        """``Engine.from_checkpoint`` (every other argument is its own),
        served with ``sp`` sequence shards (``tp`` > 1 raises)."""
        cls._validate(tp, sp, kw.get("cache_layout", "ring"))
        base = Engine.from_checkpoint(arch, **kw)
        return cls(base.model, base.cfg, base.policy, base.serve_params,
                   base.qparams, device=base.device, sp=sp, **base._init_kw())

    def to(self, device) -> "ShardedEngine":
        """The same sharded engine (same weights, thresholds and shard
        count) on another device."""
        dev = resolve_device(device)
        return ShardedEngine(self.base_model, self.cfg, self.policy,
                             tree_to(self.serve_params, dev),
                             tree_to(self.qparams, dev), device=dev,
                             sp=self.sp, **self._init_kw())

    def eager_reason(self):
        """``sp`` > 1 serves eagerly, on the CPU and on CUDA:
        ``generate_batch`` runs its programs uncaptured and the scheduler
        its steps; its decode's partials and merge (B4) are not captured
        yet (ROADMAP Queue A item 9d).  ``sp == 1`` is an Engine."""
        if self.sp > 1:
            return ("sequence-parallel serving (sp > 1) runs its programs "
                    "uncaptured: CUDA graphs under sp are ROADMAP Queue A "
                    "item 9d")
        return None

    def dry_run_report(self, **kw):
        raise NotImplementedError(
            "dry_run_report audits XLA's compiled HLO (its all-reduce "
            "payload types); the port has no counterpart yet (ROADMAP "
            "Queue A item 19)")
