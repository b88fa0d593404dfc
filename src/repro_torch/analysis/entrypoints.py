"""The serving entry points, run under the recorder for the analyzers.

Counterpart of ``repro/analysis/entrypoints.py``: the one place that says
which steps make up the serving surface and at what shapes they run.  The
smoke grid of the reference (B 2, S 32, CHUNK 8, CACHE 64, GEN 4) is
enough: every contract checked here (dtype flow, kernel operands and
packing, launch counts, freeze state, aliasing) is shape-generic.

Entry points per variant, each run eagerly under a ``record.Recorder``
(the scheduler's Programs are held to their budgets by the sessions
below):

- ``prefill``             one-shot prefill (``steps.make_prefill_step``)
- ``chunked_prefill``     the chunked ragged-prompt prefill
- ``decode_loop``         the single-stream decode loop
- ``decode_block``        the continuous-batching slot decode block
- ``resume``              the chunked prefill at the resume buffer
                          (prompt + generated so far, re-padded)
- ``speculative_verify``  the verify window of speculative decoding

The variants are the engine's (the reference's jnp variant has no
counterpart: the port picks its kernels by device, ``core/api.py``):
int8 weights over an int8 KV cache, over an int4 one, and over a bf16 one
(``int8_w_bf16_kv``: B3 beside B2's bf16 branch).  The sharded surfaces
need no extra device in the port (one process holds every shard), so they
always run: ``[tp2]`` (prefill, chunked prefill, decode block) and
``[sp2]`` (prefill, decode block).  ``run_analysis`` is the sweep:
every analyzer over every entry point, the source pass, the freeze state
and the cache aliasing of a served engine, and the scheduler sessions'
budgets.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import budgets as BU
from repro_torch.analysis import donation as DO
from repro_torch.analysis import dtype_drift as DD
from repro_torch.analysis import kernel_contracts as KC
from repro_torch.analysis.record import Recorder
from repro_torch.analysis.report import Finding
from repro_torch.kernels import ops

# the tier-1 smoke grid (the reference's)
B, S, CHUNK, CACHE, GEN = 2, 32, 8, 64, 4
# the verify window's drafts and the slot decode block's steps
SPEC_K, BLOCK_STEPS = 4, 3
# the engine variants by tag: Engine.from_checkpoint's arguments
VARIANTS = {"int8,kv8": dict(kv_bits=8), "int8,kv4": dict(kv_bits=4),
            "int8_w_bf16_kv": dict(kv_int8=False)}
# (kind, passes) of each entry point: the launch counts it implies
PASSES = {"prefill": ("prefill", 1),
          "chunked_prefill": ("prefill", S // CHUNK),
          "decode_loop": ("decode", GEN - 1),
          "decode_block": ("decode", BLOCK_STEPS),
          "resume": ("prefill", (S + CHUNK) // CHUNK),
          "speculative_verify": ("verify", 1)}
SHARDED = {"tp2": ("prefill", "chunked_prefill", "decode_block"),
           "sp2": ("prefill", "decode_block")}


@dataclasses.dataclass
class EntryPoint:
    """One recorded serving step with what the analyzers need: the record,
    the launch counters its structure implies (None: a stack the formula
    does not reach) and, on the card, the launch counters' delta."""
    name: str
    record: Recorder
    expected: Optional[dict]
    launched: Optional[dict]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def record_step(name: str, fn, device, expected: Optional[dict]
                ) -> EntryPoint:
    """Run ``fn()`` once under a Recorder (inference mode); on CUDA keep the
    launch counters' delta around it."""
    before = ops.launch_snapshot()
    with torch.inference_mode(), Recorder() as rec:
        fn()
    _sync(device)
    on_card = torch.device(device).type == "cuda"
    delta = ops.launch_delta(before, ops.launch_snapshot())
    return EntryPoint(name, rec, expected, delta if on_card else None)


def engine_expected(engine, entry: str, passes: Optional[int] = None
                    ) -> Optional[dict]:
    """The launch counters ``entry`` (a ``PASSES`` key) on ``engine``
    advances (``kernel_contracts.expected_launches``), or None where the
    formula does not reach: a stack other than attention-only text layers
    without windows, each with a dense FFN or a mixture of experts."""
    from repro_torch.models.transformer import attention_only

    cfg = engine.cfg
    if (not attention_only(cfg) or cfg.ffn not in ("swiglu", "gelu", "moe")
            or any(cfg.attn_window(i) is not None
                   for i in range(cfg.n_layers))):
        return None
    kind, n = PASSES[entry]
    head = engine.serve_params.get("lm_head", {})
    return KC.expected_launches(
        cfg.n_layers, kind, n if passes is None else passes,
        tp=getattr(engine, "tp", 1), sp=getattr(engine, "sp", 1),
        kv_bits=engine.policy.kv_bits, kv_float=not engine.policy.kv_int8,
        f32=cfg.dtype == torch.float32, int8=engine.mode == "int8",
        # the attention's four projections and the FFN's (or the experts')
        projections={"swiglu": 7, "gelu": 6, "moe": 4}[cfg.ffn],
        experts=cfg.n_experts if cfg.ffn == "moe" else 0,
        readout="w_q" in head,
        # a one-shot prefill attends the prompt's own tiles, the other
        # entries the cache (through its block table when paged)
        paged=engine.cache_layout == "paged" and entry != "prefill")


def prompts(engine, b: int = B, s: int = S) -> torch.Tensor:
    """(b, s) seeded prompt tokens on the engine's device."""
    toks = np.random.default_rng(1).integers(0, engine.cfg.vocab, (b, s))
    return torch.from_numpy(toks).long().to(engine.device)


def _steps(engine, include: Optional[Sequence[str]] = None) -> dict:
    """{entry: step function of no arguments} over fresh caches."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch import strategies as SG

    model, policy, mode = engine.model, engine.policy, engine.mode
    params, qp, dev = engine.serve_params, engine.qparams, engine.device
    toks = prompts(engine)
    lengths = torch.tensor([S, S - CHUNK], dtype=torch.int32, device=dev)
    tok0 = torch.zeros((B,), dtype=torch.long, device=dev)
    pos0 = torch.full((B,), S, dtype=torch.int32, device=dev)
    active0 = torch.ones((B,), dtype=torch.bool, device=dev)

    def cache():
        return engine.init_cache(B, CACHE)

    builders = {
        "prefill": lambda: ST.make_prefill_step(model, policy, mode=mode)(
            params, qp, {"tokens": toks}, cache()),
        "chunked_prefill": lambda: ST.make_prefill_step(
            model, policy, prefill_chunk=CHUNK, mode=mode)(
            params, qp, {"tokens": toks}, cache(), lengths),
        "decode_loop": lambda: ST.make_decode_loop(
            model, policy, n_steps=GEN, mode=mode)(
            params, qp, tok0, cache(), S),
        "decode_block": lambda: ST.make_slot_decode_loop(
            model, policy, n_steps=BLOCK_STEPS, mode=mode)(
            params, qp, tok0, cache(), pos0, active0),
        # preemption re-admission: the chunked prefill at the resume buffer
        "resume": lambda: ST.make_prefill_step(
            model, policy, prefill_chunk=CHUNK, mode=mode)(
            params, qp, {"tokens": torch.zeros((B, S + CHUNK),
                                               dtype=torch.long, device=dev)},
            cache(), torch.tensor([S + GEN, S - 1], dtype=torch.int32,
                                  device=dev)),
        "speculative_verify": lambda: SG.SpeculativeStrategy(
            model, policy, mode).verify(
            params, qp, tok0, torch.zeros((B, SPEC_K), dtype=torch.long,
                                          device=dev), cache(), pos0,
            active0),
    }
    return {k: v for k, v in builders.items()
            if include is None or k in include}


def build_entry_points(engine, *, prefix: str = "",
                       include: Optional[Sequence[str]] = None
                       ) -> list[EntryPoint]:
    """Run the serving surface of one engine under the recorder; names get
    ``prefix`` (``sharded_`` for a ShardedEngine)."""
    return [record_step(prefix + name, fn, engine.device,
                        engine_expected(engine, name))
            for name, fn in _steps(engine, include).items()]


def analyze_entry_points(eps: Sequence[EntryPoint], *, tag: str = ""
                         ) -> list[Finding]:
    """Every run-level analyzer over each recorded entry point (named
    ``name[tag]``)."""
    findings: list[Finding] = []
    for ep in eps:
        name = f"{ep.name}[{tag}]" if tag else ep.name
        rec = ep.record
        findings += DD.check_dtype_drift(rec, entry_point=name)
        findings += KC.check_kernel_calls(rec.kernels, entry_point=name)
        if ep.expected is not None:
            findings += KC.check_launch_counts(rec, ep.expected,
                                               launched=ep.launched,
                                               entry_point=name)
        findings += DO.check_no_fake_quant(rec, entry_point=name)
    return findings


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def build_engine(arch: str = "smollm-135m", *, device="cpu", **kw):
    """A calibrated, converted engine of ``arch`` at SMOKE on ``device``
    (chunked prefill at CHUNK, for its scheduler)."""
    from repro_torch.launch.engine import Engine

    return Engine.from_checkpoint(arch, smoke=True, device=device,
                                  prefill_chunk=CHUNK, **kw)


def build_sharded_engine(arch: str = "smollm-135m", *, device="cpu",
                         tp: int = 1, sp: int = 1):
    """A ShardedEngine of ``arch`` at SMOKE: under tp its heads rounded to a
    tp-divisible grid (2 tp heads over tp KV heads, as the reference's
    sweep does), under sp a dense cache."""
    from repro_torch.configs import get_config
    from repro_torch.shard import ShardedEngine

    cfg = get_config(arch, smoke=True)
    if tp > 1:
        cfg = cfg.replace(n_heads=2 * tp, n_kv_heads=tp)
    return ShardedEngine.from_checkpoint(arch, cfg=cfg, smoke=True,
                                         device=device, tp=tp, sp=sp,
                                         cache_layout="dense",
                                         prefill_chunk=CHUNK)


# ---------------------------------------------------------------------------
# the scheduler sessions
# ---------------------------------------------------------------------------

def _requests(engine):
    from repro_torch.launch.scheduler import Request

    toks = prompts(engine).cpu().numpy()
    # ragged lengths on purpose: the no-rebuild contract is that they are
    # data
    return [Request(rid=r, tokens=toks[r % B, :n], max_gen=GEN)
            for r, n in enumerate([S, S - 12, 9])]


def scheduler_session_findings(engine, *, entry_point: str,
                               prefix: str = "") -> list[Finding]:
    """A mixed-admission scheduler session at the smoke grid, its Program
    counts held to the declared budgets; the same traffic again must build
    no Program (``CaptureWatch``); each Program's step once under the
    host-read guard."""
    sched = engine.make_scheduler(max_slots=2, prompt_cap=S,
                                  gen_cap=GEN + 2, block_steps=BLOCK_STEPS)

    def counts():
        return {prefix + k: v for k, v in sched.executable_counts().items()}

    list(sched.run(_requests(engine)))
    findings = BU.check_executable_budgets(counts(), entry_point=entry_point,
                                           require_all_ran=True)
    with BU.CaptureWatch() as w:
        list(sched.run(_requests(engine)))
    findings += w.check(max_captures=0,
                        what="repeat of an identical scheduler session",
                        entry_point=entry_point)
    findings += BU.check_executable_budgets(counts(), entry_point=entry_point)
    with torch.inference_mode():
        findings += BU.check_host_reads(sched.programs(),
                                        entry_point=entry_point)
    return findings


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def cache_findings(engine) -> list[Finding]:
    """Storage aliasing of the dense, paged and SSM cache layouts."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    ssm = build_model(get_config("mamba2-780m", smoke=True))
    trees = {"dense": engine.init_cache(B, CACHE, layout="dense"),
             "paged": engine.init_cache(B, CACHE, layout="paged",
                                        page_size=CHUNK),
             "ssm": ssm.init_cache(B, CACHE, engine.device,
                                   engine.policy.kv_bits)}
    findings = []
    for layout, tree in trees.items():
        findings += DO.check_duplicate_donation(
            tree, entry_point="cache", what=f"{layout} KV cache")
    return findings


def run_analysis(arch: str = "smollm-135m", *, device="cpu",
                 with_scheduler: bool = True,
                 entry_points: Optional[dict] = None
                 ) -> tuple[list[Finding], list[str]]:
    """The sweep on ``device``.  Returns (findings, entry point names);
    ``entry_points``, when given, receives every recorded EntryPoint by
    its name."""
    findings: list[Finding] = []
    names: list[str] = []
    served = None
    sharded = {}
    engines = [(tag, build_engine(arch, device=device, **kw), "", None)
               for tag, kw in VARIANTS.items()]
    for tag, include in SHARDED.items():
        sharded[tag] = build_sharded_engine(arch, device=device,
                                            **{tag[:2]: int(tag[2:])})
        engines.append((tag, sharded[tag], "sharded_", include))
    for tag, engine, prefix, include in engines:
        eps = build_entry_points(engine, prefix=prefix, include=include)
        names += [f"{ep.name}[{tag}]" for ep in eps]
        findings += analyze_entry_points(eps, tag=tag)
        if entry_points is not None:
            entry_points.update({f"{ep.name}[{tag}]": ep for ep in eps})
        if served is None:
            served = engine
    # repo level: the kernels' sources, the served thresholds, the caches
    findings += KC.check_kernel_sources()
    findings += DO.check_frozen_qparams(served.qparams,
                                        entry_point="served_qparams")
    findings += cache_findings(served)
    names += ["served_qparams", "cache"]
    if with_scheduler:
        findings += scheduler_session_findings(
            served, entry_point="scheduler_session")
        names += ["scheduler_session"]
        findings += scheduler_session_findings(
            sharded["tp2"], entry_point="sharded_scheduler_session",
            prefix="sharded_")
        names += ["sharded_scheduler_session"]
    return findings, names
