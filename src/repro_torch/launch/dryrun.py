"""The compile-only grid as a meta-device dry run: every (arch x shape) cell
sized for one H100 80 GB per device, under the reference's meshes and
sharding rules.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell with XLA on 512 placeholder devices and reads XLA's memory and cost
analyses.  Per cell this:

  1. takes the production mesh (16x16 single-pod, 2x16x16 multi-pod;
     ``launch/mesh.py``), each device one H100 80 GB;
  2. builds the cell's params, qparams, optimizer state, batch and cache
     on the meta device (``launch/specs.py``): shapes and dtypes, nothing
     allocated;
  3. assigns their specs from ``dist/sharding.py``'s rules and sums the
     per-device argument bytes (a dim that does not divide fails the
     cell, as it fails the reference's lowering);
  4. runs the cell's step once on meta at the global shapes under
     ``analysis/cost.py``'s counter: the train step with the reference's
     microbatch count, the one-shot prefill, or one decode step; the
     kernels take their meta route (``kernels/ops.py``);
  5. writes the report: the step's peak of live intermediate bytes
     divided over the devices that the rules split activations over,
     its FLOPs (dot products, and each kernel call by its own formula)
     and unfused bytes per device, and the roofline terms with H100
     constants.

What has no counterpart: the collective term (GSPMD inserts the
reference's collectives; the port's steps run on one device), so
``collective_bytes_per_device`` and ``collective_s`` are null; XLA's
CPU upcast artifacts; the reference's scanned layer stack (the port
unrolls its layers, ``models/transformer.py``).

Usage::

  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from repro_torch.analysis.cost import CostCounter
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import api as A
from repro_torch.dist import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import ProductionMesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.models.module import MetaGenerator

# --- H100 SXM constants (the roofline's denominators, per device) ---
PEAK_FLOPS_BF16 = 989e12     # dense bf16 tensor-core FLOP/s
PEAK_OPS_INT8 = 1979e12      # dense int8 tensor-core OP/s
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # bytes of device memory

COLLECTIVE_NOTE = ("GSPMD inserts the reference's collectives; the port's "
                   "steps run on one device and have no counterpart")


def n_micro_for(cfg) -> int:
    """The reference's microbatch count for a train cell: one
    microbatch's activations within HBM, scaled with width; MoE dispatch
    holds top_k copies of the tokens, a hybrid layer two branches."""
    n = (1 if cfg.d_model < 2048 else 4 if cfg.d_model < 5000 else
         8 if cfg.d_model < 6000 else 16)
    if cfg.ffn == "moe":
        n *= max(2, cfg.top_k)
    if cfg.kind == "hybrid":
        n *= 4
    if os.environ.get("REPRO_N_MICRO"):
        n = int(os.environ["REPRO_N_MICRO"])
    return n


def cell_rules(rules: SH.ShardingRules | None,
               multi_pod: bool) -> SH.ShardingRules:
    """The rules of a cell: the defaults, the hillclimb overrides from the
    environment (``REPRO_ACT_SEQ=none``, ``REPRO_KV_LAYOUT``), then the
    multi-pod batch axis."""
    rules = rules or SH.ShardingRules()
    if os.environ.get("REPRO_ACT_SEQ", "") == "none":
        rules = dataclasses.replace(rules, act_seq=None)
    if os.environ.get("REPRO_KV_LAYOUT"):
        rules = dataclasses.replace(
            rules, kv_cache_layout=os.environ["REPRO_KV_LAYOUT"])
    return SH.multipod(rules) if multi_pod else rules


def activation_split(rules: SH.ShardingRules, mesh_shape: dict) -> int:
    """The devices the rules split activations over: the batch axes, times
    the sequence axis under ``act_seq``."""
    axes = ((rules.act_batch,) if isinstance(rules.act_batch, str)
            else tuple(rules.act_batch or ()))
    n = math.prod(mesh_shape[a] for a in axes)
    return n * (mesh_shape[rules.act_seq] if rules.act_seq else 1)


def _named_bytes(named: dict, mesh_shape: dict) -> int:
    """Per-device bytes of ``{name: (tree, spec tree)}``; a leaf that does
    not divide fails with the name of its argument."""
    total = 0
    for name, (tree, spec) in named.items():
        try:
            total += SH.local_bytes(tree, spec, mesh_shape)
        except ValueError as e:
            raise ValueError(f"argument {name}: {e}") from None
    return total


def _replicated(tree) -> tuple:
    """A tree and its spec tree, every leaf replicated."""
    return tree, SH.replicated_specs(tree)


def _opt_tree(opt) -> dict:
    return {"step": opt.step, "mu": opt.mu, "nu": opt.nu}


@dataclasses.dataclass
class CellInputs:
    """What a cell's step takes: ``named`` {argument: (tree, spec tree)}
    for the argument bytes, the ``step`` and its ``args``."""

    named: dict
    step: object
    args: tuple
    n_micro: int | None = None


def cell_inputs(model, policy: A.QuantPolicy, shape: ShapeSpec,
                rules: SH.ShardingRules, model_size: int,
                gen) -> CellInputs:
    """The step of ``shape``'s kind and its arguments, built from ``gen``
    (a ``MetaGenerator`` for the dry run, a seeded ``torch.Generator`` for
    real tensors), with their spec trees: the train step with the
    reference's microbatch count; the one-shot prefill into a cache of
    the prompt's length (an encoder-decoder's decoder tokens' length);
    one decode step at the last slot of a cache of ``seq_len``."""
    cfg = model.cfg
    b = shape.global_batch
    if shape.kind == "train":
        params, qparams = SP.model_state(model, policy, gen)
        opt = SP.opt_state_abstract(qparams)
        batch = SP.make_batch(cfg, shape, gen)
        n_micro = n_micro_for(cfg)
        return CellInputs(
            {"params": (params, SH.param_specs(model, params, rules)),
             "qparams": (qparams, SH.qparam_specs(model, params, qparams,
                                                  rules)),
             "opt_state": _replicated(_opt_tree(opt)),
             "batch": (batch, SH.batch_specs(batch, rules))},
            ST.make_fat_train_step(model, policy, n_micro=n_micro),
            (params, qparams, opt, batch), n_micro)
    serve, qparams = SP.serve_state(model, policy, gen)
    named = {"serve_params": (serve, SH.param_specs(model, serve, rules)),
             "qparams": (qparams, SH.qparam_specs(model, serve, qparams,
                                                  rules))}
    if shape.kind == "prefill":
        batch = SP.make_batch(cfg, shape, gen)
        batch.pop("labels", None)
        cache_len = (shape.seq_len if cfg.family != "encdec"
                     else max(shape.seq_len // cfg.dec_ratio, 4))
        cache = SP.make_cache(model, cfg, b, cache_len, device=gen.device)
        named["batch"] = (batch, SH.batch_specs(batch, rules))
        step = ST.make_prefill_step(model, policy)
        args = (serve, qparams, batch, cache)
    else:
        cache = SP.make_cache(model, cfg, b, shape.seq_len,
                              device=gen.device)
        tok = SP.make_tokens(cfg, b, gen)
        named["tokens"] = (tok, SH.batch_specs(tok, rules))
        step = ST.make_serve_step(model, policy)
        # the last slot of the cache: every position before it written
        args = (serve, qparams, tok, cache, shape.seq_len - 1)
    named["cache"] = (SH.cache_tree(cache),
                      SH.cache_specs(cache, rules, model_size))
    return CellInputs(named, step, args)


def build_cell(arch: str, shape, *, multi_pod: bool = False,
               rules: SH.ShardingRules | None = None, verbose: bool = True,
               smoke: bool = False, mesh_shape: tuple | None = None) -> dict:
    """Size one cell and return its report.  ``shape``: a name of
    ``SHAPES`` or a ``ShapeSpec``; ``smoke``: the arch's SMOKE config;
    ``mesh_shape``: a (data, model) or (pod, data, model) mesh in place of
    the production one (the tests' and the card check's 1x1)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    mesh = make_production_mesh(multi_pod=multi_pod)
    if mesh_shape is not None:
        mesh = ProductionMesh(mesh.axes[-len(mesh_shape):], tuple(mesh_shape))
    ms = mesh.shape
    rules = cell_rules(rules, multi_pod)

    t0 = time.time()
    cell = cell_inputs(model, A.QuantPolicy(), shape, rules, ms["model"],
                       MetaGenerator())
    arg_b = _named_bytes(cell.named, ms)

    with CostCounter() as counter:
        out = cell.step(*cell.args)
    trace_s = time.time() - t0

    if shape.kind == "train":
        qp, opt, metrics = out
        out_named = {"qparams": _replicated(qp),
                     "opt_state": _replicated(_opt_tree(opt)),
                     "metrics": _replicated(metrics)}
    else:
        *front, cache = out
        out_named = {f"out{i}": (t, SH.batch_specs(t, rules))
                     for i, t in enumerate(front)}
        out_named["cache"] = cell.named["cache"]
    out_b = _named_bytes(out_named, ms)

    split = activation_split(rules, ms)
    temp_b = -(-counter.peak // split)
    peak = arg_b + temp_b
    chips = mesh.n
    flops = counter.flops / chips
    int8_flops = counter.by_kernel.get("quant_matmul", [0, 0])[1] / chips
    bytes_dev = counter.bytes / chips
    terms = {"compute_s": (flops - int8_flops) / PEAK_FLOPS_BF16
             + int8_flops / PEAK_OPS_INT8,
             "memory_s": bytes_dev / HBM_BW}
    dominant = max(terms, key=terms.get)

    n = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.global_batch * shape.seq_len)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    report = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh.name,
        "chips": chips,
        "device": "H100 80GB",
        "trace_s": round(trace_s, 2),
        "n_micro": cell.n_micro,
        "memory_analysis": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "peak_bytes_per_device": peak,
            "temp_global_bytes": counter.peak,
            "temp_split_devices": split,
            "fits_80gb": peak <= HBM_BYTES,
        },
        "flops_per_device": flops,
        "dot_flops_per_device": counter.dot_flops / chips,
        "kernel_flops_per_device": counter.kernel_flops / chips,
        "kernel_calls": {k: v[0] for k, v in sorted(
            counter.by_kernel.items())},
        "bytes_per_device_unfused": bytes_dev,
        "ops": counter.n_ops,
        "collective_bytes_per_device": None,
        "collective_note": COLLECTIVE_NOTE,
        "roofline": {
            **terms,
            "collective_s": None,
            "dominant": dominant,
            "model_flops_global": model_flops,
            "useful_flops_ratio": model_flops / max(flops * chips, 1.0),
        },
        "params": n,
        "active_params": n_active,
    }
    if verbose:
        print(f"[{arch} x {shape.name} x {mesh.name}] trace {trace_s:.1f}s"
              f" | peak {peak / 1e9:.2f} GB/dev (args {arg_b / 1e9:.2f}, "
              f"temp {temp_b / 1e9:.2f}) | flops/dev {flops:.3e} | "
              f"dominant={dominant}")
    return report


def main(argv=None, *, smoke: bool = False,
         mesh_shape: tuple | None = None) -> None:
    """The CLI (``smoke`` and ``mesh_shape``: ``build_cell``'s hooks, for
    the tests; the command line does not take them)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture preset to plan (configs.get_config)")
    ap.add_argument("--shape", default=None,
                    help="shape cell name (configs.SHAPES)")
    ap.add_argument("--all", action="store_true",
                    help="plan every applicable (arch x shape) cell")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the two-pod mesh (2x16x16)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="plan both the single- and the two-pod mesh")
    ap.add_argument("--out", default="build/dryrun",
                    help="directory for the report JSON files")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                ok, why = cell_applicable(a, s)
                if ok:
                    cells.append((a, s))
                else:
                    print(f"SKIP {a} x {s}: {why}")
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            mesh = make_production_mesh(multi_pod=mp)
            name = ("x".join(map(str, mesh_shape)) if mesh_shape
                    else mesh.name)
            tag = f"{arch}_{shape}_{name}"
            out_path = os.path.join(args.out, tag + ".json")
            if os.path.exists(out_path):
                print(f"[cached] {tag}")
                continue
            try:
                rep = build_cell(arch, shape, multi_pod=mp, smoke=smoke,
                                 mesh_shape=mesh_shape)
                with open(out_path, "w") as f:
                    json.dump(rep, f, indent=1)
            except Exception as e:  # noqa: BLE001 — report all cell failures
                traceback.print_exc()
                failures.append((tag, str(e)[:300]))
    if failures:
        print("\nFAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nDRY-RUN: all requested cells traced OK")


if __name__ == "__main__":
    main()
