"""``Engine``: the serving facade over the int8 FAT pipeline.

    engine = Engine.from_checkpoint("smollm-135m", smoke=False)   # on CUDA
    result = engine.generate_batch({"tokens": prompts}, gen=32)
    result = engine.generate_one(prompt_tokens, gen=32)
    # the full-precision baseline and its ablations: bf16 weights (fp=True)
    # and/or a bf16 KV cache (kv_int8=False)
    engine = Engine.from_checkpoint("smollm-135m", smoke=False, fp=True,
                                    kv_int8=False)
    # int4 KV cache, thresholds fine-tuned for 2 epochs (paper §3):
    engine = Engine.from_checkpoint("smollm-135m", smoke=False, kv_bits=4,
                                    finetune_thresholds=2)
    # sampled (temperature / top-p, the reference's PRNG key schedule) or
    # speculative (prompt lookup; greedy's tokens) decoding:
    engine = Engine.from_checkpoint("smollm-135m", smoke=False,
                                    temperature=0.7, top_p=0.9, seed=3)
    engine = Engine.from_checkpoint("smollm-135m", smoke=False,
                                    decode_strategy="speculative", spec_k=4)
    # paged KV cache, chunked prefill, continuous batching:
    engine = Engine.from_checkpoint("smollm-135m", smoke=False,
                                    cache_layout="paged", page_size=64,
                                    prefill_chunk=128)
    completions = engine.generate(requests, max_slots=8)  # scheduler.Request
    # resilience and durability of the scheduler: a bounded queue, a fault
    # plan, a write-ahead journal (recover() after a crash) or snapshots
    engine = Engine.from_checkpoint("smollm-135m", smoke=False,
                                    queue_cap=16, fault_plan={"reject": [3]},
                                    journal="requests.jsonl")
    completions = engine.recover(max_slots=8)
    # the state-space decoders (a float32 SSM state beside any KV cache;
    # chunked prefill, speculation and the scheduler refuse them, as in the
    # reference):
    engine = Engine.from_checkpoint("mamba2-780m", smoke=False)  # hymba-1.5b
    # the encoder-decoder and the VLM: a batch carries the frontend's input
    # (frames (B, S_enc, 1024) or patches (B, 2880, 1024)); the same refusals
    engine = Engine.from_checkpoint("seamless-m4t-medium", smoke=False)
    result = engine.generate_batch({"tokens": text, "frames": frames}, 32)
    engine = Engine.from_checkpoint("llava-next-34b", smoke=False,
                                    calib_len=2944)       # > 2880 patches
    result = engine.generate_batch({"tokens": text, "patches": patches}, 32)
    # the params of a training checkpoint (python -m repro_torch.launch.train):
    engine = Engine.from_checkpoint("smollm-135m", smoke=False,
                                    checkpoint_dir="/tmp/fat_ckpt")

Counterpart of ``repro/launch/engine.py``: seeded random init (or bridged
reference params, or a training checkpoint's) -> §2 calibration ->
optional FAT threshold fine-tune (fp teacher vs fake-quant student) ->
int8 conversion -> one-shot or chunked prefill into an int8, packed-int4
or bf16 KV cache, dense or paged -> greedy, sampled or speculative decode
of a fixed batch (``generate_batch``) or continuous batching through the
slot scheduler (``generate``).  Every quantized matmul, the prefill
attention and the decode attention over a quantized cache (and the
speculative verify window over one) run through ``kernels.ops``: the
hand-written CUDA kernels when the engine's device is a GPU, their plain
versions when it is the CPU.  The reference's other three serving modes
are the engine's ``fp`` and ``kv_int8`` flags: bf16 weights (``fp``) are
plain ``x @ w`` products (the reference leaves them to XLA), and decode
over a bf16 cache (``kv_int8=False``) is plain attention, as in the
reference.

Serving runs as the reference's single-dispatch programs: on CUDA,
``generate_batch`` captures its prefill and one decode step (one verify
window, speculative) as CUDA graphs (``launch/graphs.py``) before its
timed windows, which only replay them (``GenerationResult.compile_s``
reports the capture); the scheduler captures its admission prefill and its
decode block.  Sampling draws from ``launch/prng.py``, the reference's
threefry keys as device tensors, so a replay needs no host RNG.
``loop=True`` keeps the eager per-token driver for comparison; on the CPU
the same step functions run eagerly.

Entry points run on the GPU unless the caller passes ``device="cpu"``:
``device=None`` means CUDA and raises when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.bridge import to_tensor, tree_to
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import api as A
from repro_torch.data import pipeline as DP
from repro_torch.launch import prng
from repro_torch.launch import steps as ST
from repro_torch.launch import strategies as SG
from repro_torch.launch.faults import FaultPlan
from repro_torch.launch.graphs import Program
from repro_torch.models import build_model

def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device, raising when there is none; anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port serves on the GPU by default; pass "
                "device='cpu' to run the plain versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


def media_key(cfg) -> Optional[str]:
    """The batch key of ``cfg``'s frontend input: "frames" (an
    encoder-decoder), "patches" (a VLM) or None (text)."""
    if cfg.family == "encdec":
        return "frames"
    return "patches" if cfg.modality == "vlm" else None


def model_inputs(cfg, batch: dict, device) -> dict:
    """A batch as the model reads it on ``device``: ``tokens`` (int) and the
    frontend's ``frames`` or ``patches`` (numpy, bfloat16 numpy included,
    or tensors) in ``cfg.dtype``; other keys (``labels``) dropped.  Raises
    where the frontend's input is missing or misshapen: frames (B, S_enc,
    frame_dim); patches (B, mm_patches, mm_dim), the count the decode
    positions assume."""
    tokens = batch["tokens"]
    tokens = (tokens if isinstance(tokens, torch.Tensor)
              else torch.as_tensor(np.asarray(tokens)))
    out = {"tokens": tokens.to(device)}
    key = media_key(cfg)
    if key is None:
        return out
    if key not in batch:
        raise ValueError(f"{cfg.name}: a batch needs {key!r} beside its "
                         "tokens")
    x = batch[key]
    x = x if isinstance(x, torch.Tensor) else to_tensor(np.asarray(x))
    b = tokens.shape[0]
    if key == "patches":
        ok = tuple(x.shape) == (b, cfg.mm_patches, cfg.mm_dim)
    else:
        ok = (x.ndim == 3 and x.shape[0] == b and x.shape[1] >= 1
              and x.shape[2] == cfg.frame_dim)
    if not ok:
        raise ValueError(
            f"{cfg.name}: {key} of shape {tuple(x.shape)} for {b} rows "
            f"(patches: (B, {cfg.mm_patches}, {cfg.mm_dim}); frames: (B, "
            f"S_enc >= 1, {cfg.frame_dim}))")
    out[key] = x.to(device=device, dtype=cfg.dtype)
    return out


def prepare_int8(model, policy: A.QuantPolicy, params, calib_batches, *,
                 convert: bool = True, finetune_epochs: int = 0,
                 finetune_log: dict | None = None):
    """Calibration + int8 conversion (the paper's deployment pipeline):
    observers over the calibration batches, finalized thresholds, int8
    weights.  ``convert=False`` stops after calibration and serves the
    params as they are (bf16 weights over an int8 KV cache needs the
    thresholds, not the int8 weights).  ``finetune_epochs`` > 0 inserts
    the paper's §3 threshold training between calibration and conversion:
    finalize emits trainable ``log2_t`` KV thresholds,
    ``steps.finetune_thresholds`` distills them (and the alpha scales)
    against the fp teacher over the same batches, and
    ``freeze_thresholds`` collapses the result back to the static ``t_max``
    form serving reads.  The fine-tune's per-step losses and wall times go
    into ``finetune_log`` ("losses", "step_s") if given.
    Returns (serve_params, qparams)."""
    calib_batches = list(calib_batches)
    with torch.no_grad():
        qparams = A.init_qparams(model, params, policy)
        calib = ST.make_calibrate_step(model, policy)
        for b in calib_batches:
            qparams = calib(params, qparams, b)
        qparams = A.finalize_calibration(
            qparams, train_thresholds=finetune_epochs > 0)
    if finetune_epochs > 0:
        step_s: list = []
        qparams, losses = ST.finetune_thresholds(
            model, policy, params, qparams, calib_batches,
            epochs=finetune_epochs, step_seconds=step_s)
        qparams = A.freeze_thresholds(qparams)
        if finetune_log is not None:
            finetune_log.update(losses=losses, step_s=step_s)
    if not convert:
        return params, qparams
    with torch.no_grad():
        return A.convert_to_int8(model, params, qparams, policy), qparams


@dataclasses.dataclass
class GenerationResult:
    """Output of ``generate_batch`` with its wall-clock timings (each ends
    in a device synchronize)."""
    tokens: torch.Tensor          # (B, gen) generated token ids
    prefill_logits: torch.Tensor  # (B, Vp) logits that picked tokens[:, 0]
    prefill_s: float              # prefill + first token
    decode_s: float               # the gen - 1 decode steps
    compile_s: float = 0.0        # warm-up + capture of the programs, before
    #                               both windows (0.0: nothing captured)


@dataclasses.dataclass
class BatchProgram:
    """The captured serving programs of one ``generate_batch`` shape and
    decode scheme, over their static buffers: ``tokens`` (B, S padded to
    the chunk), ``media`` the ``frames`` or ``patches`` of an
    encoder-decoder or a VLM, ``tok`` and ``pos`` (B,) the pending token
    and its position, ``rng`` the (2,) PRNG key, and the cache.
    ``prefill()`` fills the cache from ``tokens`` (and ``media``), sets
    ``tok`` to the first token (split from ``rng`` when sampling) and
    ``pos`` to S (+ a VLM's patches), and returns the
    (B, Vp) logits that picked it; each ``decode()`` advances ``tok``,
    ``pos`` and ``rng`` by a step.  Speculative: ``window`` holds the
    windowed loop's carry (its ``tok`` and ``pos`` are the ones above,
    its history seeded by the prefill), each ``decode()`` runs one verify
    window and ``window.out`` gathers the tokens."""
    key: tuple                    # (B, S, cache length, decode scheme[,
    #                               frame / patch shapes])
    tokens: torch.Tensor
    tok: torch.Tensor
    pos: torch.Tensor
    rng: torch.Tensor
    prefill: Program
    decode: Program
    window: Optional[SG.WindowState] = None
    media: dict = dataclasses.field(default_factory=dict)

    @property
    def capture_s(self) -> float:
        return self.prefill.capture_s + self.decode.capture_s


class Engine:
    """One assembled serving stack: model + serving params + finalized
    thresholds on one device, with its cache layout and prefill chunking.

    ``mode`` is "int8" (int8 weights through the quant_matmul kernel) or
    "none" (the params' full-precision weights); the KV cache is int8 (or
    packed int4) when ``policy.kv_int8``, else in the config's dtype.
    ``cache_layout`` is "ring" (the default, as in the reference: a
    sliding-window layer shorter than the cache gets a ring of its window,
    every other layer a dense cache; without windows it is "dense"),
    "dense" (dense everywhere), or "paged" (a page pool of ``page_size``
    tokens a page, read through block tables, beside the same rings);
    ``prefill_chunk`` set runs chunked ragged prefill in
    chunks of that many tokens.  ``decode_strategy`` is "greedy",
    "sample" (``temperature``, ``top_p``, keys from ``seed``) or
    "speculative" (``spec_k`` drafts from ``spec_ngram``-gram prompt
    lookup), None picking "sample" when ``temperature`` > 0, else greedy,
    as the reference does.

    The scheduler's resilience and durability knobs, as in the reference:
    ``queue_cap`` and ``shed_policy`` ("shed" | "block") bound its
    admission queue; ``fault_plan`` (a ``FaultPlan`` or anything its
    ``parse`` takes) injects deterministic faults; ``journal`` is the
    write-ahead journal's path (``recover``); ``snapshot_every`` > 0 writes
    a snapshot every N block boundaries at ``snapshot_dir``, which alone
    enables ``save_state`` / ``load_state``."""

    def __init__(self, model, cfg, policy: A.QuantPolicy, serve_params,
                 qparams, *, device, mode: str = "int8",
                 finetune_log: dict | None = None,
                 cache_layout: str = "ring", page_size: int = 64,
                 prefill_chunk: Optional[int] = None,
                 decode_strategy: Optional[str] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0, spec_k: int = 4, spec_ngram: int = 2,
                 queue_cap: Optional[int] = None, shed_policy: str = "shed",
                 fault_plan=None, journal: Optional[str] = None,
                 snapshot_every: int = 0,
                 snapshot_dir: Optional[str] = None):
        from repro_torch.cache import LAYOUTS

        if cache_layout not in LAYOUTS:
            raise ValueError(f"cache_layout must be one of {LAYOUTS}, got "
                             f"{cache_layout!r}")
        if mode not in ("none", "int8"):
            raise ValueError(f"serving mode must be 'none' or 'int8', got "
                             f"{mode!r}")
        fault_plan = self._check_serving_knobs(
            shed_policy=shed_policy, snapshot_every=snapshot_every,
            snapshot_dir=snapshot_dir, fault_plan=fault_plan)
        # validation through the single authority: a bad strategy or knob
        # raises at construction, not at the first generate
        self._strategy = SG.make_strategy(
            decode_strategy, model, policy, temperature=temperature,
            top_p=top_p, spec_k=spec_k, spec_ngram=spec_ngram, mode=mode)
        self.model, self.cfg, self.policy = model, cfg, policy
        self.mode = mode
        self.serve_params, self.qparams = serve_params, qparams
        self.device = torch.device(device)
        self.cache_layout, self.page_size = cache_layout, page_size
        self.prefill_chunk = prefill_chunk
        self.decode_strategy = decode_strategy
        self.temperature, self.top_p, self.seed = temperature, top_p, seed
        self.spec_k, self.spec_ngram = spec_k, spec_ngram
        self.queue_cap, self.shed_policy = queue_cap, shed_policy
        self.fault_plan = fault_plan
        self.journal = journal
        self.snapshot_every, self.snapshot_dir = snapshot_every, snapshot_dir
        # per-step losses and wall times of the threshold fine-tune, if
        # this engine ran one
        self.finetune_log = finetune_log or {}
        self._scheduler = None
        self._scheduler_key = None
        # the most recent generate_batch shape's programs: a second call of
        # that shape replays them
        self._program: Optional[BatchProgram] = None

    @classmethod
    def from_checkpoint(cls, arch: str = "smollm-135m", *, cfg=None,
                        smoke: bool = True, params: Optional[dict] = None,
                        checkpoint_dir: Optional[str] = None,
                        calib_batches: Optional[Sequence] = None,
                        qparams: Optional[dict] = None, init_seed: int = 0,
                        n_calib: int = 2, calib_batch: int = 4,
                        calib_len: int = 32,
                        device=None, fp: bool = False, kv_int8: bool = True,
                        kv_bits: int = 8, finetune_thresholds: int = 0,
                        cache_layout: str = "ring", page_size: int = 64,
                        prefill_chunk: Optional[int] = None,
                        decode_strategy: Optional[str] = None,
                        temperature: float = 0.0, top_p: float = 1.0,
                        seed: int = 0, spec_k: int = 4, spec_ngram: int = 2,
                        queue_cap: Optional[int] = None,
                        shed_policy: str = "shed", fault_plan=None,
                        journal: Optional[str] = None,
                        snapshot_every: int = 0,
                        snapshot_dir: Optional[str] = None) -> "Engine":
        """Build a ready-to-serve Engine.

        ``params`` is the reference's param tree as bridged tensors
        (``bridge.params_from_jax``); without it the weights are seeded
        random init (``init_seed``, a CPU ``torch.Generator``, so every
        device gets the same weights).  ``checkpoint_dir`` instead restores
        the ``params`` of the newest checkpoint there (written by
        ``python -m repro_torch.launch.train`` or by the reference's
        driver); it does not combine with ``params``.  ``calib_batches``
        are numpy token batches ({"tokens": (B, S)}, and the ``frames`` or
        ``patches`` of an encoder-decoder or a VLM); the default is
        ``n_calib`` batches of (``calib_batch``, ``calib_len``) from the
        config's pipeline (``data.pipeline.calibration_batches``, seeded by
        ``init_seed``; an encoder-decoder's with its frames, a VLM's with
        its patches), as the reference draws every config's (a VLM's
        ``calib_len`` counts its patches and must exceed them).
        ``qparams`` are finalized thresholds calibrated elsewhere (the
        reference's, through ``bridge.qparams_from_jax``): calibration is
        skipped and the weights convert against them.  ``fp`` serves the
        full-precision (bf16) weights instead of int8 ones; ``kv_int8``
        False keeps the KV cache in the config's dtype.  With both, there is
        no calibration pass; with ``fp`` alone it calibrates the KV
        thresholds and keeps the weights.  ``kv_bits`` is the quantized KV
        cache's width: 8, or 4 stored as packed nibbles (ignored without
        ``kv_int8``, as in the reference).
        ``finetune_thresholds`` > 0 trains the thresholds by distillation
        for that many epochs over the calibration batches before freezing
        them (paper §3; what makes the 7-level int4 grid usable when
        max-abs calibration over-shoots).  ``cache_layout``,
        ``page_size``, ``prefill_chunk``, ``decode_strategy`` and its knobs
        (``temperature``, ``top_p``, ``seed``, ``spec_k``, ``spec_ngram``)
        and the scheduler's resilience and durability knobs (``queue_cap``,
        ``shed_policy``, ``fault_plan``, ``journal``, ``snapshot_every``,
        ``snapshot_dir``) go to the Engine (see the class), which checks
        them before any weight is built.  ``cfg`` overrides the registry
        lookup (``arch``/``smoke`` are then ignored)."""
        serving_kw = dict(cache_layout=cache_layout, page_size=page_size,
                          prefill_chunk=prefill_chunk,
                          decode_strategy=decode_strategy,
                          temperature=temperature, top_p=top_p, seed=seed,
                          spec_k=spec_k, spec_ngram=spec_ngram,
                          queue_cap=queue_cap, shed_policy=shed_policy,
                          fault_plan=fault_plan, journal=journal,
                          snapshot_every=snapshot_every,
                          snapshot_dir=snapshot_dir)
        cls._check_serving_knobs(**serving_kw)
        if params is not None and checkpoint_dir is not None:
            raise ValueError("pass params or checkpoint_dir, not both")
        if qparams is not None and finetune_thresholds:
            raise ValueError("finetune_thresholds trains thresholds this "
                             "engine calibrates; it does not take qparams")
        dev = resolve_device(device)
        if cfg is None:
            cfg = get_config(arch, smoke=smoke)
        model = build_model(cfg)
        policy = A.QuantPolicy(kv_int8=kv_int8, kv_bits=kv_bits)
        if checkpoint_dir is not None:
            tree, _ = CheckpointManager(checkpoint_dir).restore_latest()
            if tree is None:
                raise FileNotFoundError(f"no committed checkpoint in "
                                        f"{checkpoint_dir!r}")
            params = tree["params"]
        if params is None:
            params = model.init(torch.Generator().manual_seed(init_seed))
        params = tree_to(params, dev)
        log: dict = {}
        if qparams is not None:
            qparams = tree_to(qparams, dev)
            serve_params = params
            if not fp:
                with torch.no_grad():
                    serve_params = A.convert_to_int8(model, params, qparams,
                                                     policy)
        elif fp and not kv_int8:
            # nothing is quantized: no calibration pass
            serve_params, qparams = params, A.finalize_calibration(
                A.init_qparams(model, params, policy))
        else:
            if calib_batches is None:
                spec = DP.spec_for(cfg, ShapeSpec("engine", "train",
                                                  calib_len, calib_batch),
                                   seed=init_seed)
                calib_batches = DP.calibration_batches(spec, n_calib)
            batches = [model_inputs(cfg, b, dev) for b in calib_batches]
            # int8 weights and/or an int8 KV cache need the calibration
            # pass; bf16 weights skip the conversion
            serve_params, qparams = prepare_int8(
                model, policy, params, batches, convert=not fp,
                finetune_epochs=finetune_thresholds, finetune_log=log)
        return cls(model, cfg, policy, serve_params, qparams, device=dev,
                   mode="none" if fp else "int8", finetune_log=log,
                   **serving_kw)

    @staticmethod
    def _check_serving_knobs(*, shed_policy, snapshot_every, snapshot_dir,
                             fault_plan, **_):
        """The scheduler knobs' checks of the constructor, run before
        ``from_checkpoint`` builds and calibrates the weights; returns the
        parsed fault plan (None: none)."""
        if shed_policy not in ("shed", "block"):
            raise ValueError(f"shed_policy must be 'shed' or 'block', got "
                             f"{shed_policy!r}")
        if snapshot_every < 0:
            raise ValueError(
                f"snapshot_every must be >= 0, got {snapshot_every}")
        if snapshot_every > 0 and snapshot_dir is None:
            raise ValueError(
                "snapshot_every > 0 needs a snapshot_dir to write to")
        return None if fault_plan is None else FaultPlan.parse(fault_plan)

    def _init_kw(self) -> dict:
        """The constructor's keyword arguments of this engine, other than
        its device."""
        return dict(mode=self.mode, finetune_log=self.finetune_log,
                    cache_layout=self.cache_layout, page_size=self.page_size,
                    prefill_chunk=self.prefill_chunk,
                    decode_strategy=self.decode_strategy,
                    temperature=self.temperature, top_p=self.top_p,
                    seed=self.seed, spec_k=self.spec_k,
                    spec_ngram=self.spec_ngram, queue_cap=self.queue_cap,
                    shed_policy=self.shed_policy, fault_plan=self.fault_plan,
                    journal=self.journal, snapshot_every=self.snapshot_every,
                    snapshot_dir=self.snapshot_dir)

    def to(self, device) -> "Engine":
        """The same engine (same serving weights and thresholds) on another
        device."""
        dev = resolve_device(device)
        return Engine(self.model, self.cfg, self.policy,
                      tree_to(self.serve_params, dev),
                      tree_to(self.qparams, dev), device=dev,
                      **self._init_kw())

    def n_int8_weights(self) -> int:
        def count(t):
            if isinstance(t, dict):
                return sum(count(v) for v in t.values())
            return int(t.dtype == torch.int8)

        return count(self.serve_params)

    def analyze(self, *, batch: int = 2, prompt_len: int = 32,
                cache_len: int = 64) -> list:
        """Contract checks over THIS engine's serving steps
        (``repro_torch.analysis``): its one-shot prefill of ``batch`` x
        ``prompt_len`` seeded tokens, then a 4-token decode loop over the
        cache it filled, each run once under the recorder on the engine's
        device, through the dtype-drift, kernel-contract (launch counts
        included, on an attention-only stack) and fake-quant checks; the
        freeze state of its thresholds and the aliasing of its cache.
        Returns the findings; empty means every contract holds.  Text
        stacks only (a batch of tokens)."""
        from repro_torch.analysis import entrypoints as EP
        from repro_torch.analysis.donation import (check_duplicate_donation,
                                                   check_frozen_qparams)

        toks = EP.prompts(self, batch, prompt_len)
        cache = self.init_cache(batch, cache_len)
        out = {}

        def prefill():
            out["logits"], _ = ST.make_prefill_step(
                self.model, self.policy, mode=self.mode)(
                self.serve_params, self.qparams, {"tokens": toks}, cache)

        def decode():
            tok0 = out["logits"][:, -1].argmax(-1)
            ST.make_decode_loop(self.model, self.policy, n_steps=4,
                                mode=self.mode)(
                self.serve_params, self.qparams, tok0, cache, prompt_len)

        eps = [EP.record_step("prefill", prefill, self.device,
                              EP.engine_expected(self, "prefill", 1)),
               EP.record_step("decode_loop", decode, self.device,
                              EP.engine_expected(self, "decode_loop", 3))]
        findings = EP.analyze_entry_points(eps)
        findings += check_frozen_qparams(self.qparams, entry_point="qparams")
        findings += check_duplicate_donation(cache, entry_point="cache",
                                             what="KV cache")
        return findings

    def init_cache(self, batch: int, max_len: int, **layout):
        """The engine's cache (its layout, page size, KV width, and int8 or
        the config's dtype, unless ``layout`` overrides them; an
        encoder-decoder's cross caches take ``enc_len``, the frames a
        row)."""
        layout.setdefault("layout", self.cache_layout)
        layout.setdefault("page_size", self.page_size)
        layout.setdefault("kv_int8", bool(self.policy.kv_int8))
        layout.setdefault("dtype", self.cfg.dtype)
        return self.model.init_cache(batch, max_len, self.device,
                                     self.policy.kv_bits, **layout)

    def _prefix_len(self) -> int:
        """Positions before the text: a VLM's patches."""
        return self.cfg.mm_patches if self.cfg.modality == "vlm" else 0

    def _cache_len(self, prompt_len: int, gen: int) -> int:
        """Padded prompt + generation budget (+ a VLM's patches), rounded
        up to a multiple of 128 (the reference's kernel-path rounding; it
        keeps one cache shape for a range of requests), then to whole
        pages.  Chunked prefill writes whole chunks, so the prompt counts
        padded to the chunk."""
        cap = prompt_len
        if self.prefill_chunk:
            cap = -(-prompt_len // self.prefill_chunk) * self.prefill_chunk
        max_len = -(-(cap + gen + self._prefix_len()) // 128) * 128
        if self.cache_layout == "paged":
            max_len = -(-max_len // self.page_size) * self.page_size
        return max_len

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def eager_reason(self) -> Optional[str]:
        """Why this engine runs its programs uncaptured, or None: every
        Engine captures (CUDA) or runs the same step functions eagerly
        (CPU)."""
        return None

    @torch.inference_mode()
    def generate_batch(self, batch: dict, gen: int, *,
                       loop: bool = False) -> GenerationResult:
        """Serve one fixed batch: prefill the prompts (in chunks of
        ``prefill_chunk`` tokens when set), then decode ``gen`` tokens (the
        first from the prefill logits) with the engine's strategy: greedy;
        sampled, the key ``PRNGKey(seed)`` split once for the first token
        and once a step after it, as in the reference; or speculative, in
        gen - 1 verify windows that reserve ``spec_k`` positions of cache
        headroom (greedy's tokens).

        The default is the reference's single-dispatch serving: the prefill
        and one decode step (one verify window) run as programs
        (``BatchProgram``), on CUDA captured as graphs before the timed
        windows (``compile_s``) and replayed inside them, the tokens
        gathered on the device.  The engine keeps the programs of its
        latest (B, S, cache length, scheme), so a second call of that shape
        only replays.  ``loop=True`` keeps the eager per-token driver for
        comparison (the same tokens and logits, bit for bit); it has no
        speculative variant, as in the reference.  An engine that captures
        nothing (``eager_reason``: ``ShardedEngine(sp > 1)``) runs the same
        programs uncaptured.

        An encoder-decoder's batch carries ``frames`` (B, S_enc,
        frame_dim), a VLM's ``patches`` (B, mm_patches, mm_dim) (the
        programs keep static buffers of their shapes); a VLM decodes from
        position mm_patches + S."""
        if gen < 1:
            raise ValueError(f"gen must be >= 1, got {gen}")
        speculative = self._strategy.emit_width > 1
        if speculative and loop:
            raise ValueError("the per-token loop has no speculative variant "
                             "(drop loop=True)")
        inputs = model_inputs(self.cfg, batch, self.device)
        tokens = inputs.pop("tokens")
        if tokens.ndim != 2 or tokens.shape[1] < 1:
            raise ValueError(f"tokens must be (B, S) with S >= 1, got "
                             f"{tuple(tokens.shape)}")
        b, s = tokens.shape
        # a verify window appends spec_k + 1 entries before its accept
        cache_len = self._cache_len(s, gen + (self.spec_k if speculative
                                              else 0))
        if loop:
            return self._generate_loop(tokens, inputs, gen, cache_len)
        compile_s = 0.0
        key = (b, s, cache_len, self._scheme(gen))
        if inputs:
            key += (tuple((k, tuple(v.shape)) for k, v in inputs.items()),)
        if self._program is None or self._program.key != key:
            self._program = None        # free the old programs first
            self._program = self._batch_program(key)
            compile_s = self._program.capture_s
        prog = self._program
        prog.rng.copy_(prng.PRNGKey(self.seed))
        self._sync()
        t0 = time.perf_counter()
        prog.tokens[:, :s].copy_(tokens)
        for k, v in inputs.items():
            prog.media[k].copy_(v)
        first = prog.prefill().clone()
        out = torch.empty((b, gen), dtype=torch.long, device=self.device)
        out[:, 0].copy_(prog.tok)
        self._sync()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(1, gen):
            prog.decode()
            if not speculative:
                out[:, i].copy_(prog.tok)
        if speculative:
            out.copy_(prog.window.out)
        self._sync()
        decode_s = time.perf_counter() - t0
        return GenerationResult(tokens=out, prefill_logits=first,
                                prefill_s=prefill_s, decode_s=decode_s,
                                compile_s=compile_s)

    def _scheme(self, gen: int) -> tuple:
        """What the decode programs bake in besides the shapes: the
        strategy and its knobs (and, speculative, the token budget the
        window loop fills)."""
        st = self._strategy
        if st.emit_width > 1:
            return ("speculative", st.draft_k, st.ngram, gen)
        if isinstance(st, SG.SamplingStrategy):
            return ("sample", st.temperature, st.top_p)
        return ("greedy",)

    def _first_token(self, logits, rng):
        """The first token from the prefill's last logits (B, Vp): argmax,
        or sampled with the second half of one split of ``rng``, which
        advances to the first half in place (the reference's
        ``key, sub = split(key)``)."""
        st = self._strategy
        if not isinstance(st, SG.SamplingStrategy):
            return ST.greedy(logits)
        ks = prng.split(rng)
        rng.copy_(ks[0])
        return SG.sample_tokens(logits, ks[1], temperature=st.temperature,
                                top_p=st.top_p)

    def _batch_program(self, key) -> BatchProgram:
        """Static buffers, a cache and the two programs for (B, S, cache
        length) ``key[:3]`` under the engine's strategy, with static frame
        or patch buffers of the shapes ``key[4]`` where the key has them;
        on CUDA both are warmed up and captured here, unless the engine
        captures nothing (``eager_reason``)."""
        b, s, cache_len = key[:3]
        dev, chunk = self.device, self.prefill_chunk
        s_pad = -(-s // chunk) * chunk if chunk else s
        media = {k: torch.zeros(shape, dtype=self.cfg.dtype, device=dev)
                 for k, shape in (key[4] if len(key) > 4 else ())}
        tokens = torch.zeros((b, s_pad), dtype=torch.long, device=dev)
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        tok = torch.zeros((b,), dtype=torch.long, device=dev)
        pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        rng = prng.PRNGKey(self.seed, dev)
        # speculation needs absolute slots: the ring default serves as
        # dense there (a dense cache serves a windowed layer through its
        # window mask), as in the reference
        speculative = self._strategy.emit_width > 1
        cache0 = self.init_cache(b, cache_len, **self._cache_kw(media), **(
            {"layout": "dense"} if speculative and self.cache_layout == "ring"
            else {}))
        prefill = ST.make_prefill_step(self.model, self.policy,
                                       prefill_chunk=chunk, mode=self.mode)
        window = None
        if speculative:
            gen = key[3][-1]
            window = SG.WindowState(
                tok=tok, pos=pos,
                n_out=torch.zeros((b,), dtype=torch.int32, device=dev),
                out=torch.zeros((b, gen), dtype=torch.long, device=dev),
                key=rng,
                hist=torch.zeros((b, cache_len), dtype=torch.long,
                                 device=dev))
            step = SG.make_window_step(self._strategy, gen)
        else:
            step = SG.make_token_step(self._strategy)
        # the prefill's cache tree (its scales are the prefill's outputs),
        # which the decode step reads
        state = {}

        pos0 = s + self._prefix_len()

        def run_prefill():
            args = (lengths,) if chunk else ()
            logits, state["cache"] = prefill(
                self.serve_params, self.qparams, {"tokens": tokens, **media},
                cache0, *args)
            first = logits[:, -1, :]
            tok0 = self._first_token(first, rng)
            if window is None:
                tok.copy_(tok0)
                pos.fill_(pos0)
            else:
                window.start(tok0, pos0)
                SG.seed_hist(window.hist, tokens[:, :s], tok0)
            return first

        def run_decode():
            if window is not None:
                return step(self.serve_params, self.qparams, window,
                            state["cache"])
            return step(self.serve_params, self.qparams, tok, state["cache"],
                        pos, rng)

        capture = self.eager_reason() is None
        prefill_prog = Program(run_prefill, dev, capture=capture)
        if prefill_prog.graph is not None:
            # the capture's outputs hold values only after a replay; the
            # decode step's warm-up reads them
            prefill_prog()
        return BatchProgram(key=key, tokens=tokens, tok=tok, pos=pos,
                            rng=rng, prefill=prefill_prog,
                            decode=Program(run_decode, dev, capture=capture),
                            window=window, media=media)

    def _cache_kw(self, media: dict) -> dict:
        """``init_cache``'s ``enc_len`` for a batch with ``frames``."""
        if "frames" in media:
            return {"enc_len": media["frames"].shape[1]}
        return {}

    def _generate_loop(self, tokens, media: dict, gen: int, cache_len: int):
        """The eager per-token driver (``generate_batch(loop=True)``): the
        same key schedule as the programs."""
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len, **self._cache_kw(media))
        prefill = ST.make_prefill_step(self.model, self.policy,
                                       prefill_chunk=self.prefill_chunk,
                                       mode=self.mode)
        args = ({"tokens": tokens, **media}, cache)
        if self.prefill_chunk:
            # prompts padded to a chunk multiple; the length vector masks
            # the tail
            toks, lengths = ST.pad_for_chunked_prefill(tokens,
                                                       self.prefill_chunk)
            args = ({"tokens": toks}, cache, lengths)
        decode_loop = SG.make_strategy_decode_loop(
            self.model, self.policy, self._strategy, n_steps=gen)
        rng = prng.PRNGKey(self.seed, self.device)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = prefill(self.serve_params, self.qparams, *args)
        first = logits[:, -1, :]
        tok0 = self._first_token(first, rng)
        self._sync()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, cache = decode_loop(self.serve_params, self.qparams, tok0, cache,
                                 s + self._prefix_len(), rng)
        self._sync()
        decode_s = time.perf_counter() - t0
        return GenerationResult(tokens=out, prefill_logits=first,
                                prefill_s=prefill_s, decode_s=decode_s)

    def generate_one(self, tokens, gen: int) -> GenerationResult:
        """Serve ONE prompt by delegating to ``generate_batch`` at B == 1."""
        toks = np.asarray(tokens)
        if toks.ndim != 1:
            raise ValueError(
                f"generate_one takes a single 1-D prompt, got shape "
                f"{toks.shape} (use generate_batch for batches)")
        return self.generate_batch({"tokens": toks[None, :]}, gen)

    # -- continuous batching -----------------------------------------------
    def make_scheduler(self, *, max_slots: int = 4, prompt_cap: int = 64,
                       gen_cap: int = 32, block_steps: int = 8,
                       eos_id: int = -1, prefix_pages: Optional[int] = None):
        """Build (or reuse) the slot scheduler for this engine's layout.  It
        is kept per knob set (the engine's resilience and durability knobs
        among them: a ``FaultPlan`` is hashable), so repeated ``generate``
        calls keep the paged layout's prefix store (shared pages persist
        across calls) and the captured programs."""
        from repro_torch.launch.scheduler import SlotScheduler

        key = (max_slots, prompt_cap, gen_cap, block_steps, eos_id,
               prefix_pages, self.cache_layout, self.page_size,
               self.prefill_chunk, self.decode_strategy, self.temperature,
               self.top_p, self.seed, self.spec_k, self.spec_ngram,
               self.queue_cap, self.shed_policy, self.fault_plan,
               self.journal, self.snapshot_every, self.snapshot_dir)
        if self._scheduler is None or self._scheduler_key != key:
            self._scheduler = None      # free the old programs first
            self._scheduler = SlotScheduler(
                self.model, self.cfg, self.policy, self.serve_params,
                self.qparams, mode=self.mode, device=self.device,
                capture=self.eager_reason() is None,
                max_slots=max_slots,
                prompt_cap=prompt_cap, gen_cap=gen_cap,
                prefill_chunk=self.prefill_chunk, block_steps=block_steps,
                cache_layout=self.cache_layout, page_size=self.page_size,
                prefix_pages=prefix_pages, eos_id=eos_id,
                strategy=self.decode_strategy, temperature=self.temperature,
                top_p=self.top_p, seed=self.seed, spec_k=self.spec_k,
                spec_ngram=self.spec_ngram, queue_cap=self.queue_cap,
                shed_policy=self.shed_policy, fault_plan=self.fault_plan,
                journal=self.journal, snapshot_every=self.snapshot_every,
                snapshot_dir=self.snapshot_dir)
            self._scheduler_key = key
        return self._scheduler

    def generate(self, requests, *, max_slots: int = 4,
                 prompt_cap: Optional[int] = None,
                 gen_cap: Optional[int] = None, block_steps: int = 8,
                 eos_id: int = -1, max_blocks: Optional[int] = None):
        """Continuous batching: stream ``requests`` (``scheduler.Request``)
        through ``max_slots`` cache slots; returns Completions in finish
        order.  With the paged layout, a repeated prompt admits through the
        prefix store with no prefill.  ``prompt_cap``/``gen_cap`` default
        to the queue's longest prompt and largest budget."""
        reqs = list(requests)
        if prompt_cap is None:
            prompt_cap = max((len(r.tokens) for r in reqs), default=64)
        if gen_cap is None:
            gen_cap = max((r.max_gen for r in reqs), default=32)
        sched = self.make_scheduler(
            max_slots=max_slots, prompt_cap=prompt_cap, gen_cap=gen_cap,
            block_steps=block_steps, eos_id=eos_id)
        return sched.run(reqs, max_blocks=max_blocks)

    def health_report(self) -> dict:
        """The scheduler's ``health_stats()`` (terminal statuses, retirement
        causes, preemption, re-admission, shedding and deadline counters,
        ``recoveries`` and ``replayed_tokens``), accumulated over
        ``generate`` calls; empty before the first."""
        if self._scheduler is None:
            return {}
        return self._scheduler.health_stats()

    # -- durability (launch/journal.py and the scheduler's recovery) --------
    def save_state(self) -> str:
        """Snapshot the live scheduler's serving state at ``snapshot_dir``;
        returns the checkpoint's path.  Needs a scheduler (a prior
        ``generate`` / ``make_scheduler``)."""
        if self._scheduler is None:
            raise ValueError("no scheduler to snapshot: call generate()/"
                             "make_scheduler() first")
        return self._scheduler.save_state()

    def load_state(self, **scheduler_kw) -> int:
        """Restore the newest snapshot into the scheduler of
        ``scheduler_kw`` (the crashed run's ``make_scheduler`` knobs; a
        mismatch raises); returns the restored block counter.  Follow with
        ``resume_run`` on ``make_scheduler(...)``, or use ``resume``."""
        return self.make_scheduler(**scheduler_kw).load_state()

    def recover(self, *, max_blocks: Optional[int] = None,
                **scheduler_kw) -> list:
        """Journal-replay crash recovery: the scheduler of ``scheduler_kw``
        (the crashed run's knobs; this engine built with the crashed run's
        ``journal``) replays it and drives the run to completion.  Returns
        every completion of the logical run."""
        return self.make_scheduler(**scheduler_kw).recover(
            max_blocks=max_blocks)

    def resume(self, *, max_blocks: Optional[int] = None,
               **scheduler_kw) -> list:
        """Snapshot recovery: ``load_state``, then drive the restored run
        to completion."""
        sched = self.make_scheduler(**scheduler_kw)
        sched.load_state()
        return sched.resume_run(max_blocks=max_blocks)
