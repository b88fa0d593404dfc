"""Serving CLI: an int8 FAT-quantized model, batched requests, one Engine.

Counterpart of ``repro/launch/serve.py``.  All assembly (calibration ->
int8 conversion -> step functions -> cache layout) lives in
``launch/engine.py::Engine``; this module parses flags, builds requests,
runs the engine and prints.  The resident state is int8: the weights and
the KV cache (per-head static thresholds from the same §2 calibration).

Without ``--max-slots`` it serves one fixed batch (``generate_batch``:
the prefill and the decode step run as captured CUDA graphs, ``--loop``
the eager per-token loop); with ``--max-slots N`` it streams ragged
requests through the continuous-batching slot scheduler (``generate``),
with the scheduler's resilience and durability flags (attention-only
stacks: the SSM and hybrid configs, ``--arch mamba2-780m`` and
``hymba-1.5b``, serve the fixed batch and keep a float32 SSM state beside
any KV cache, as in the reference; so do the encoder-decoder,
``--arch seamless-m4t-medium``, whose batch carries ``--prompt-len``
frames and an eighth as many tokens, and the VLM, ``--arch
llava-next-34b``, whose ``--prompt-len`` counts its patches before the
text).  Every config calibrates on the Engine's default: its pipeline's
batches of ``--requests`` x ``--prompt-len``, as the reference's CLI.
``--sp N`` serves through ``ShardedEngine(sp=N)`` every mode and
strategy that the reference's CLI takes with it (``--no-kv-int8``, the
speculative and sampled strategies, the scheduler), and refuses ``--fp``
as it does.  Every quantized
matmul and both attentions run the hand-written CUDA kernels on the GPU
and their plain versions on the CPU (``--device cpu``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --requests 4 --prompt-len 32 --gen 16 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --requests 4 --prompt-len 32 --gen 8 --max-slots 2 --block-steps 2 \\
      --journal /tmp/requests.jsonl --fault-plan '{"crash": [2]}'  # exit 3
  ... the same flags ... --restore journal --strict                # exit 0

Every request retires with a terminal ``Completion.status`` (ok |
rejected | timeout | preempted | shed | failed); the run prints the
scheduler's health report.  A simulated crash (fault plan ``crash``)
exits with code 3 once its journal or snapshot state is durable;
``--strict`` failures exit with code 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import pipeline as DP
from repro_torch.launch.engine import Engine


def ragged_requests(spec, n_requests, prompt_len, gen, *, seed=12345,
                    deadline_ms=None):
    """A ragged request queue from the data pipeline: request r's prompt
    keeps between half and all of ``prompt_len`` tokens (lengths cycle 1,
    5/6, 2/3, 1/2 of it).  ``deadline_ms`` applies one completion deadline
    to every request (None: none)."""
    from repro_torch.launch.scheduler import Request

    batch = DP.make_batch(dataclasses.replace(spec, global_batch=n_requests),
                          seed)
    toks = batch["tokens"].numpy()[:, :prompt_len]
    reqs = []
    for r in range(n_requests):
        frac = (r % 4) / 6.0
        length = max(1, prompt_len - int(frac * prompt_len))
        reqs.append(Request(rid=r, tokens=toks[r, :length].astype(np.int32),
                            max_gen=gen, deadline_ms=deadline_ms))
    return reqs


def run_continuous(args, engine: Engine):
    """--max-slots path: stream --requests ragged requests through the slot
    scheduler (or, with --restore, pick a crashed run back up from its
    journal or snapshot) and report throughput, statuses and health."""
    from repro_torch.launch.faults import SimulatedCrash

    sched_kw = dict(max_slots=args.max_slots, prompt_cap=args.prompt_len,
                    gen_cap=args.gen, block_steps=args.block_steps,
                    eos_id=args.eos_id)
    t0 = time.time()
    try:
        if args.restore == "journal":
            completions = engine.recover(**sched_kw)
        elif args.restore == "snapshot":
            completions = engine.resume(**sched_kw)
        else:
            spec = DP.spec_for(engine.cfg, ShapeSpec(
                "cli", "train", args.prompt_len, args.requests))
            reqs = ragged_requests(spec, args.requests, args.prompt_len,
                                   args.gen, deadline_ms=args.deadline_ms)
            completions = engine.generate(reqs, **sched_kw)
    except SimulatedCrash as e:
        # the boundary's journal records / snapshot landed before the
        # crash fired: a fresh process recovers the run
        print(f"[serve] {e}")
        print("[serve] state is durable: restart with --restore journal "
              "(+ --journal PATH) or --restore snapshot "
              "(+ --snapshot-dir DIR) to finish the run bit-identically")
        raise SystemExit(3)
    wall = time.time() - t0
    sched = engine.make_scheduler(**sched_kw)
    n_new = sum(len(c.tokens) for c in completions)
    n_prompt = sum(c.prompt_len for c in completions)
    print(f"[serve] continuous batching ({sched.cache_layout}): "
          f"{len(completions)} requests through {args.max_slots} slots "
          f"(block={args.block_steps}) | prompt lens "
          f"{sorted({c.prompt_len for c in completions})} | {n_new} tokens "
          f"in {wall * 1e3:.1f} ms ({n_new / max(wall, 1e-9):.0f} gen tok/s, "
          f"{(n_new + n_prompt) / max(wall, 1e-9):.0f} total tok/s)")
    print("[serve] executables: " + " ".join(
        f"{k}={v}" for k, v in sched.executable_counts().items()))
    by_status: dict = {}
    for c in completions:
        by_status[c.status] = by_status.get(c.status, 0) + 1
    health = engine.health_report()
    print("[serve] statuses: " + " ".join(
        f"{k}={v}" for k, v in sorted(by_status.items())))
    print("[serve] health: " + " ".join(
        f"{k}={v}" for k, v in health.items() if v))
    if args.restore:
        print(f"[serve] recovered via {args.restore}: "
              f"recoveries={health.get('recoveries', 0)} "
              f"replayed_tokens={health.get('replayed_tokens', 0)}")
    if sched.cache_layout == "paged":
        stats = sched.prefix_stats()
        print(f"[serve] prefix store: {stats['hits']} hits / "
              f"{stats['misses']} misses | {stats['shared_tokens']} prompt "
              "tokens served from shared pages (zero prefill FLOPs)")
    spec = sched.spec_stats()
    if spec:
        print(f"[serve] speculative: {spec['emitted_tokens']} tokens over "
              f"{spec['verify_windows']} verify windows "
              f"({spec['tokens_per_window']:.2f} tok/window, "
              f"draft acceptance {spec['acceptance_rate']:.2f})")
    for c in completions[:2]:
        print(f"  req{c.rid}: prompt_len={c.prompt_len} "
              f"finished_by={c.finished_by} -> {c.tokens}")
    if args.strict:
        bad = sorted({c.status for c in completions if c.status != "ok"})
        if bad:
            print(f"[serve] --strict: non-ok terminal statuses {bad}")
            raise SystemExit(1)
    return completions


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve an int8 FAT-quantized model on the GPU "
                    "(--device cpu: the kernels' plain versions).")
    ap.add_argument("--arch", default="smollm-135m",
                    help="architecture preset to serve")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, raising "
                         "where there is none; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--requests", type=int, default=4,
                    help="number of synthetic requests to serve")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="tokens per synthetic prompt")
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens to generate per request")
    ap.add_argument("--fp", action="store_true",
                    help="serve bf16 weights instead of int8 (baseline)")
    ap.add_argument("--no-kv-int8", action="store_true",
                    help="keep the KV cache in bf16 (kv ablation)")
    ap.add_argument("--kv-bits", type=int, default=8, choices=[8, 4],
                    help="quantized KV cache width: 8 (int8) or 4 (packed "
                         "int4 nibbles, a quarter of the bf16 cache bytes)")
    ap.add_argument("--finetune-thresholds", type=int, default=0,
                    help="train the quantization thresholds by "
                         "distillation for N epochs (<= 8) before freezing "
                         "them (paper §3); 0 = static §2 calibration only")
    ap.add_argument("--loop", action="store_true",
                    help="eager per-token loop instead of the captured "
                         "prefill and decode programs")
    ap.add_argument("--pallas", action="store_true", default=None,
                    help="accepted for the reference's command lines and "
                         "ignored: the port picks its kernels by device "
                         "(the CUDA kernels on the GPU, their plain "
                         "versions on the CPU)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked ragged prefill: fixed-size prompt chunks "
                         "with a per-request length vector (one program "
                         "for every prompt length)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (with --temperature > 0)")
    ap.add_argument("--seed", type=int, default=0,
                    help="PRNG seed for sampled decoding")
    ap.add_argument("--strategy", default=None,
                    choices=["greedy", "sample", "speculative"],
                    help="decode strategy (launch/strategies.py); default "
                         "sample when --temperature > 0, else greedy; "
                         "speculative drafts --spec-k tokens by prompt "
                         "lookup and verifies them in one batched pass "
                         "(greedy's tokens)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative draft-window length")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="prompt-lookup n-gram size for speculative "
                         "drafting")
    ap.add_argument("--max-slots", type=int, default=None,
                    help="continuous batching: serve --requests ragged "
                         "requests through N cache slots with streaming "
                         "admission (launch/scheduler.py)")
    ap.add_argument("--block-steps", type=int, default=8,
                    help="scheduler decode-block length (admission happens "
                         "at block boundaries)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="EOS token id for the scheduler (< 0 disables)")
    ap.add_argument("--cache-layout", default="ring",
                    choices=["dense", "ring", "paged"],
                    help="KV-cache layout: ring = sliding-window layers "
                         "ring-buffered, the rest dense (default); dense = "
                         "absolute slots everywhere; paged = page pool + "
                         "block tables (prompt prefix sharing under "
                         "--max-slots)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per page for --cache-layout paged")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request completion deadline in ms (scheduler "
                         "path): a request that misses it retires with "
                         "status 'timeout' at the next block boundary")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="bounded admission queue: at most N requests "
                         "waiting (default: unbounded)")
    ap.add_argument("--shed-policy", default="shed",
                    choices=["shed", "block"],
                    help="what a full admission queue does with arrivals: "
                         "shed = retire them at once with status 'shed'; "
                         "block = hold them out until the queue drains")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault injection (launch/faults.py): "
                         "inline JSON or a path to a JSON file, e.g. "
                         "'{\"reject\": [2], \"nan_decode\": [[3, 1]]}'")
    ap.add_argument("--journal", default=None,
                    help="write-ahead request journal path (scheduler "
                         "path): a crashed run restarts with --restore "
                         "journal and finishes bit-identically")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="write a serving-state snapshot every N decode-"
                         "block boundaries (0 = off; needs --snapshot-dir)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="checkpoint directory for serving-state snapshots "
                         "(enables --restore snapshot)")
    ap.add_argument("--restore", default=None,
                    choices=["journal", "snapshot"],
                    help="recover a crashed run instead of serving fresh "
                         "requests: journal = replay the --journal file; "
                         "snapshot = restore the newest --snapshot-dir "
                         "checkpoint and continue decoding")
    ap.add_argument("--strict", action="store_true",
                    help="exit with code 1 if any request retires with a "
                         "non-'ok' status")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore trained params from a "
                         "repro_torch.launch.train checkpoint directory "
                         "(default: seeded random init)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shard count: heads, KV heads and "
                         "d_ff split into N shards, each row-parallel "
                         "layer sums the shards' int32 partials exactly "
                         "(int8 mode only, as the reference)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel shard count: the KV cache's "
                         "sequence axis splits into N shards, decode merges "
                         "the per-shard flash partials exactly (dense/ring "
                         "cache layouts; not with --fp, as the reference)")
    ap.add_argument("--mesh", default="auto", choices=["auto", "dryrun"],
                    help="auto = serve; dryrun = run the sharded prefill and "
                         "one decode step under the analysis recorder, print "
                         "the collective audit (every serving-path "
                         "all-reduce must carry integer payload bytes) and "
                         "exit without serving, 1 if the audit fails")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.tp > 1 or args.sp > 1) and args.fp:
        ap.error("--tp/--sp shard the int8 engine (--fp has no integer "
                 "accumulators to reduce exactly)")
    if args.mesh == "dryrun" and args.tp <= 1 and args.sp <= 1:
        ap.error("--mesh dryrun audits the sharded executables: give it "
                 "--tp N or --sp N")
    if (args.journal or args.snapshot_dir or args.restore
            or args.strict) and not args.max_slots:
        ap.error("--journal/--snapshot-dir/--restore/--strict need "
                 "--max-slots (the continuous-batching scheduler)")
    if args.restore == "journal" and not args.journal:
        ap.error("--restore journal needs --journal PATH")
    if args.restore == "snapshot" and not args.snapshot_dir:
        ap.error("--restore snapshot needs --snapshot-dir DIR")

    fault_plan = args.fault_plan
    if fault_plan is not None:
        from repro_torch.launch.faults import FaultPlan

        fault_plan = FaultPlan.parse(fault_plan)
        if args.restore == "snapshot" and fault_plan.crash:
            # a snapshot may predate the crash boundary, so the restored run
            # would reach it and crash again; journal replay resumes at the
            # boundary, so its plan keeps later crash points live
            fault_plan = dataclasses.replace(fault_plan, crash=())

    kw = dict(
        checkpoint_dir=args.ckpt_dir, smoke=args.smoke, device=args.device,
        fp=args.fp, kv_int8=not args.no_kv_int8, kv_bits=args.kv_bits,
        finetune_thresholds=args.finetune_thresholds,
        calib_batch=args.requests, calib_len=args.prompt_len,
        cache_layout=args.cache_layout, page_size=args.page_size,
        prefill_chunk=args.prefill_chunk, temperature=args.temperature,
        top_p=args.top_p, seed=args.seed, decode_strategy=args.strategy,
        spec_k=args.spec_k, spec_ngram=args.spec_ngram,
        queue_cap=args.queue_cap, shed_policy=args.shed_policy,
        fault_plan=fault_plan, journal=args.journal,
        snapshot_every=args.snapshot_every, snapshot_dir=args.snapshot_dir)
    if args.tp > 1 or args.sp > 1:
        from repro_torch.shard import ShardedEngine

        engine = ShardedEngine.from_checkpoint(args.arch, tp=args.tp,
                                               sp=args.sp, **kw)
        kind = (f"tp={args.tp} tensor" if args.tp > 1
                else f"sp={args.sp} sequence")
        print(f"[serve] sharded serving: {kind} shards on {engine.device}")
        if args.mesh == "dryrun":
            report = engine.dry_run_report(batch=args.requests,
                                           prompt_len=args.prompt_len)
            print(json.dumps(report, indent=2, default=str))
            verdict = report["int8_all_reduces_ok"]
            print(f"[serve] dryrun: int8_all_reduces_ok={verdict}")
            raise SystemExit(0 if verdict else 1)
    else:
        engine = Engine.from_checkpoint(args.arch, **kw)
    if not args.fp:
        print(f"[serve] converted: {engine.n_int8_weights()} int8 weight "
              "tensors resident")
    if args.max_slots:
        return run_continuous(args, engine)

    # one fixed batch from the pipeline (prompt = first prompt_len tokens)
    spec = DP.spec_for(engine.cfg, ShapeSpec("cli", "train", args.prompt_len,
                                             args.requests))
    batch = DP.make_batch(spec, 12345)
    batch.pop("labels")
    tokens = batch["tokens"].numpy()
    cfg = engine.cfg
    n_attn = sum(cfg.layer_kind(i) != "mamba" for i in range(cfg.n_layers))
    n_ssm = sum(cfg.layer_kind(i) in ("mamba", "hybrid")
                for i in range(cfg.n_layers))
    if not args.no_kv_int8 and n_attn:
        kind = "packed-int4" if engine.policy.kv_bits == 4 else "int8"
        print(f"[serve] kv cache: {kind} K/V in {n_attn} layers "
              f"({engine.cache_layout} layout)")
    if n_ssm:
        print(f"[serve] ssm state: float32 in {n_ssm} layers")
    res = engine.generate_batch(batch, args.gen, loop=args.loop)
    kind = "loop" if args.loop else "programs"
    pf_kind = (f"chunked/{args.prefill_chunk}" if args.prefill_chunk
               else "one-shot")
    pf_tps = tokens.size / max(res.prefill_s, 1e-9)
    print(f"[serve] {args.requests} requests | prefill ({pf_kind}) "
          f"{res.prefill_s * 1e3:.1f} ms ({pf_tps:.0f} tok/s) | {args.gen} "
          f"tokens ({kind}) in {res.decode_s * 1e3:.1f} ms "
          f"({res.decode_s / max(args.gen - 1, 1) * 1e3:.1f} ms/tok)")
    out = res.tokens.cpu().numpy()
    for r in range(min(args.requests, 2)):
        print(f"  req{r}: prompt={tokens[r, :8].tolist()}... "
              f"-> generated={out[r].tolist()}")
    return out


if __name__ == "__main__":
    main()
