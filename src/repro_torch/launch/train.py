"""Training driver: FAT QAT (the paper's mode) or pretrain.

Counterpart of ``repro/launch/train.py``.  ``fat_qat`` calibrates the
thresholds on unlabeled batches (§2), then trains their scale factors by
distillation (§3; with ``--finetune-thresholds`` also the per-head KV
``log2_t``); ``pretrain`` is plain LM training of every weight.  Every
``--ckpt-every`` steps it writes an atomic checkpoint (params, qparams,
Adam state, step: the data pipeline's position) and on restart resumes
from the newest complete one, so a killed run rerun with the same command
finishes as an uninterrupted run would.  A checkpoint's ``params`` serve
through ``Engine.from_checkpoint(checkpoint_dir=...)``; the format is the
reference's, so either package restores the other's.

    python -m repro_torch.launch.train --arch smollm-135m --mode fat_qat \\
        --finetune-thresholds --steps 200 --ckpt-dir /tmp/fat_ckpt
    python -m repro_torch.launch.train --smoke --device cpu --steps 4

Runs on the CUDA device unless ``--device`` names another (``cpu`` runs
the plain versions of the kernels).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.bridge import tree_to
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import api as A
from repro_torch.data import pipeline as DP
from repro_torch.launch import steps as ST
from repro_torch.launch.engine import resolve_device
from repro_torch.models import build_model
from repro_torch.optim.adam import AdamState, adam_init


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m",
                    help="architecture preset to train")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--mode", default="fat_qat",
                    choices=["fat_qat", "pretrain"],
                    help="fat_qat: calibrate + train threshold scale "
                         "factors; pretrain: plain LM training")
    ap.add_argument("--steps", type=int, default=100,
                    help="training steps")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch size")
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length")
    ap.add_argument("--calib-batches", type=int, default=4,
                    help="batches for threshold calibration (paper s3.1)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (None disables saving)")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints")
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="peak learning rate")
    ap.add_argument("--finetune-thresholds", action="store_true",
                    help="fat_qat: also calibrate the per-head KV cache "
                         "thresholds and train them as log2-domain scale "
                         "factors (TQT) alongside the activation alphas")
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps between loss prints")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "device, raising without one; 'cpu' runs the "
                         "plain versions of the kernels)")
    return ap


def _opt_tree(opt: AdamState) -> dict:
    """The Adam state as the checkpoint holds it: moments nested like the
    trained tree (the reference's layout)."""
    return {"step": opt.step, "mu": A.unflatten(opt.mu),
            "nu": A.unflatten(opt.nu)}


def _opt_state(tree: dict) -> AdamState:
    return AdamState(step=tree["step"], mu=A.flatten(tree["mu"]),
                     nu=A.flatten(tree["nu"]))


def _on(batch: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def main(argv=None):
    """Run the driver with ``argv`` (default: the command line); returns
    the final (params, qparams), qparams None in pretrain mode."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    # training KV thresholds needs the KV observers in the qparams tree
    policy = A.QuantPolicy(kv_int8=args.finetune_thresholds)
    spec = DP.spec_for(cfg, ShapeSpec("cli", "train", args.seq, args.batch))
    hp = ST.TrainHParams(base_lr=args.lr)
    fat = args.mode == "fat_qat"

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    params = qparams = opt = None
    if mgr:
        tree, meta = mgr.restore_latest(device=dev)
        if tree is not None:
            print(f"[train] resuming from step {meta['step']}")
            start_step = meta["step"]
            params = tree["params"]
            qparams = tree.get("qparams")
            opt = _opt_state(tree["opt"])

    if params is None:
        params = tree_to(model.init(torch.Generator().manual_seed(0)), dev)

    if fat:
        if qparams is None:
            with torch.no_grad():
                qparams = A.init_qparams(model, params, policy)
                calib = ST.make_calibrate_step(model, policy)
                for b in DP.calibration_batches(spec, args.calib_batches):
                    qparams = calib(params, qparams, _on(b, dev))
                qparams = A.finalize_calibration(
                    qparams, train_thresholds=args.finetune_thresholds)
            print(f"[train] calibrated {len(qparams)} quant points on "
                  f"{args.calib_batches} unlabeled batches")
        if opt is None:
            opt = adam_init(A.flatten(qparams))
        step_fn = ST.make_fat_train_step(model, policy, hp)
    else:
        if opt is None:
            opt = adam_init(A.flatten(params))
        step_fn = ST.make_pretrain_step(model, hp)

    t0 = time.perf_counter()
    step_s = []
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = _on(DP.make_batch(spec, step), dev)
        if fat:
            qparams, opt, metrics = step_fn(params, qparams, opt, batch)
        else:
            params, opt, metrics = step_fn(params, opt, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t_step)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.5f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.perf_counter() - t0):.1f}s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params,
                                "qparams": qparams if fat else {},
                                "opt": _opt_tree(opt)})
            print(f"[train] checkpointed step {step + 1}")
    if step_s:
        print(f"[train] {len(step_s)} steps: {step_s[0] * 1e3:.1f} ms the "
              f"first, {sum(step_s[1:]) / max(len(step_s) - 1, 1) * 1e3:.1f}"
              f" ms each after it (synchronized, checkpoints excluded)")
    print("[train] done")
    return params, qparams


if __name__ == "__main__":
    main()
