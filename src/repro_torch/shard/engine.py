"""``ShardedEngine``: the Engine facade over a sequence-parallel model.

Counterpart of ``repro/shard/engine.py``.  An ``Engine`` whose model is a
``ShardedModel``; everything above the model surface (``generate_batch``,
the slot scheduler of ``generate``, its fault plans, deadlines,
preemption, journal and snapshots) is inherited unchanged, as in the
reference.

    engine = ShardedEngine.from_checkpoint("smollm-135m", smoke=False, sp=4)
    result = engine.generate_batch({"tokens": prompts}, gen=32)

``sp`` > 1 splits the dense KV cache's sequence axis into ``sp`` shards on
the engine's one device: decode launches the partials kernel once per
shard and layer and merges the partials exactly.  ``tp`` > 1 (tensor
parallelism) and shards on several devices are ROADMAP Queue A item 18,
as are mixture-of-experts, SSM, hybrid, encoder-decoder and VLM stacks
under ``sp`` > 1 (the reference has no guard for the last four); bf16
weights or a bf16 KV cache under ``sp`` > 1 are item 20.  With ``sp == 1``
this is exactly an Engine.  With ``sp`` > 1, ``generate_batch`` and the
scheduler run their eager loops (``eager_reason``): the captured programs
are ROADMAP Queue A item 9d.  Sampling serves through those loops with the
Engine's key schedule; the speculative verify window under ``sp`` > 1 is
item 13.
"""
from __future__ import annotations

from repro_torch.bridge import tree_to
from repro_torch.configs import get_config
from repro_torch.launch.engine import Engine, resolve_device
from repro_torch.shard.model import ShardedModel


class ShardedEngine(Engine):
    """Engine with ``sp`` sequence shards on its device; see the module
    docstring."""

    def __init__(self, model, cfg, policy, serve_params, qparams, *,
                 tp: int = 1, sp: int = 1, **engine_kw):
        self._validate(tp, sp, engine_kw.get("cache_layout", "ring"),
                       fp=engine_kw.get("mode", "int8") == "none",
                       kv_int8=policy.kv_int8,
                       strategy=engine_kw.get("decode_strategy"))
        self._validate_model(cfg, sp)
        self.sp = sp
        self.base_model = model
        if sp > 1:
            model = ShardedModel(model, cfg, sp=sp)
        super().__init__(model, cfg, policy, serve_params, qparams,
                         **engine_kw)

    @staticmethod
    def _validate(tp: int, sp: int, cache_layout: str, *, fp: bool = False,
                  kv_int8: bool = True, strategy=None) -> None:
        """Raise on a parallelism (or, under it, a serving mode) this engine
        does not serve."""
        if tp < 1 or sp < 1:
            raise ValueError(f"tp/sp must be >= 1, got tp={tp} sp={sp}")
        if tp > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp > 1, the head/ffn split and its "
                "int32 all-reduce) is not ported (ROADMAP Queue A item 18)")
        if sp > 1 and cache_layout == "paged":
            raise ValueError(
                "sequence-parallel serving shards the dense cache's S axis "
                "-- the paged pool has no contiguous shard slices (use "
                "cache_layout='dense')")
        if sp > 1 and (fp or not kv_int8):
            raise NotImplementedError(
                "bf16 weights or a bf16 KV cache under sequence parallelism "
                "(sp > 1) are not ported (ROADMAP Queue A item 20)")
        if sp > 1 and strategy == "speculative":
            raise NotImplementedError(
                "the sequence-parallel speculative verify window is not "
                "ported (ROADMAP Queue A item 13, speculative decoding)")

    @staticmethod
    def _validate_model(cfg, sp: int) -> None:
        """Raise on a stack this engine does not shard."""
        if sp > 1 and cfg.ffn == "moe":
            raise NotImplementedError(
                f"{cfg.name}: mixture-of-experts stacks under sequence "
                "parallelism (sp > 1) are not ported (ROADMAP Queue A item "
                "18, MoE under ShardedEngine)")
        if sp > 1 and (cfg.family == "encdec" or cfg.modality != "text"):
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder and VLM stacks under sequence "
                "parallelism (sp > 1) are not ported (ROADMAP Queue A item "
                "18, encoder-decoder and VLM under ShardedEngine)")
        kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
        if sp > 1 and kinds & {"mamba", "hybrid"}:
            raise NotImplementedError(
                f"{cfg.name}: SSM and hybrid stacks under sequence "
                "parallelism (sp > 1) are not ported (ROADMAP Queue A item "
                "18, SSM stacks under ShardedEngine)")

    @classmethod
    def from_checkpoint(cls, arch: str = "smollm-135m", *, tp: int = 1,
                        sp: int = 1, **kw) -> "ShardedEngine":
        """``Engine.from_checkpoint`` (every other argument is its own),
        served with ``sp`` sequence shards (``tp`` > 1 raises)."""
        cls._validate(tp, sp, kw.get("cache_layout", "ring"),
                      fp=kw.get("fp", False), kv_int8=kw.get("kv_int8", True),
                      strategy=kw.get("decode_strategy"))
        cls._validate_model(kw.get("cfg") or get_config(
            arch, smoke=kw.get("smoke", True)), sp)
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
        """``sp`` > 1 serves through the eager loops, on the CPU and on
        CUDA: its decode's partials and merge (B4) are not captured yet
        (ROADMAP Queue A item 9d).  ``sp == 1`` is an Engine."""
        if self.sp > 1:
            return ("sequence-parallel serving (sp > 1) keeps its eager "
                    "loops: CUDA graphs under sp are ROADMAP Queue A item 9d")
        return None

    def dry_run_report(self, **kw):
        raise NotImplementedError(
            "dry_run_report audits XLA's compiled HLO (its all-reduce "
            "payload types); the port has no counterpart yet (ROADMAP "
            "Queue A item 19)")
