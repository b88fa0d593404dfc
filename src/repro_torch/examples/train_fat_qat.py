"""End to end: FAT-quantize a smollm-family model with a few hundred
distillation steps (the paper's §4.1.2 procedure).

The real smollm-135m architecture at a narrow width by default (``--full``
for the 135M config): calibration -> threshold training with cosine
annealing and optimizer resets -> checkpoints -> int8 export.

Run: PYTHONPATH=src python -m repro_torch.examples.train_fat_qat
     [--steps 200] [--device cpu] [--ckpt DIR]
"""
import argparse
import shutil
import tempfile

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
from repro_torch.optim.adam import adam_init, reset_moments, restart_boundary


def _count(tree, pred=lambda t: True) -> int:
    if isinstance(tree, dict):
        return sum(_count(v, pred) for v in tree.values())
    return tree.numel() if pred(tree) else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description="FAT QAT example")
    ap.add_argument("--steps", type=int, default=200,
                    help="fine-tuning steps")
    ap.add_argument("--full", action="store_true",
                    help="the real 135M config")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("smollm-135m")
    if not args.full:
        # the same family at a narrow width
        cfg = cfg.replace(n_layers=8, d_model=256, n_heads=8, n_kv_heads=4,
                          head_dim=32, d_ff=768, vocab=8192)
    model = build_model(cfg)
    params = tree_to(model.init(torch.Generator().manual_seed(0)), dev)
    n_params = _count(params)
    print(f"model: {cfg.name} ({n_params / 1e6:.1f}M params)")

    policy = A.QuantPolicy()
    spec = DP.spec_for(cfg, ShapeSpec("ex", "train", 128, 8))
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="fat_qat_ckpt_")
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(ckpt, keep=2)

    def batch(b):
        return {"tokens": b["tokens"].to(dev)}

    calibrate = ST.make_calibrate_step(model, policy)
    with torch.no_grad():
        qparams = A.init_qparams(model, params, policy)
        for b in DP.calibration_batches(spec, n=4):
            qparams = calibrate(params, qparams, batch(b))
    qparams = A.finalize_calibration(qparams)

    hp = ST.TrainHParams(base_lr=2e-3, anneal_period=50)
    train_step = ST.make_fat_train_step(model, policy, hp)
    opt = adam_init(A.flatten(qparams))
    mask = A.flatten(A.trainable_mask(qparams))
    n_train = sum(t.numel() for k, t in A.flatten(qparams).items()
                  if mask[k])
    print(f"training {n_train} threshold scales "
          f"({100 * n_train / max(n_params, 1):.4f}% of the model): the "
          "'fast' in FAT")

    first = last = None
    for step in range(args.steps):
        # the paper's cosine annealing restarts also reset Adam's moments
        if restart_boundary(step, hp.anneal_period):
            opt = reset_moments(opt)
        qparams, opt, m = train_step(params, qparams, opt,
                                     batch(DP.make_batch(spec, step)))
        loss = float(m["loss"])
        first = loss if first is None else first
        last = loss
        if step % 20 == 0:
            print(f"step {step:4d}  RMSE {loss:.5f}  lr {float(m['lr']):.2e}")
        if (step + 1) % 100 == 0:
            mgr.save(step + 1, {"qparams": qparams,
                                "opt": {"step": opt.step, "mu": opt.mu,
                                        "nu": opt.nu}})

    print(f"distill RMSE: {first:.5f} -> {last:.5f} "
          f"({100 * (1 - last / first):.1f}% better)")
    with torch.no_grad():
        serve_params = A.convert_to_int8(model, params, qparams, policy)
    n_int8 = _count(serve_params, lambda t: t.dtype == torch.int8)
    print(f"exported int8 model: {n_int8 / 1e6:.1f}M int8 weights")
    if args.ckpt is None:
        shutil.rmtree(ckpt, ignore_errors=True)
    assert last < first
    return first, last


if __name__ == "__main__":
    main()
