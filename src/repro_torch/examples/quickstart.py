"""Quickstart: quantize a model with FAT in ~40 lines.

The paper's §3 pipeline on a small model:
  1. calibrate activation thresholds on unlabeled data      (§2)
  2. fine-tune the threshold scale factors by distillation  (§3.1.3, §3.2)
  3. convert to int8 and compare against the float teacher  (§2, eq. 20)

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch.bridge import tree_to
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import api as A
from repro_torch.core.distill import rmse_distill_loss
from repro_torch.data import pipeline as DP
from repro_torch.launch import steps as ST
from repro_torch.launch.engine import resolve_device
from repro_torch.models import build_model
from repro_torch.optim.adam import adam_init


def main(argv=None):
    ap = argparse.ArgumentParser(description="FAT quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; 'cpu' runs the "
                         "kernels' plain versions)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. a model (smoke = reduced size), seeded weights
    cfg = get_config("smollm-135m", smoke=True)
    model = build_model(cfg)
    params = tree_to(model.init(torch.Generator().manual_seed(0)), dev)

    # 2. an unlabeled data stream (the paper needs no labels anywhere)
    spec = DP.spec_for(cfg, ShapeSpec("qs", "train", seq_len=64,
                                      global_batch=8))

    def batch(b):
        return {"tokens": b["tokens"].to(dev)}

    # 3. calibrate (paper: ~100 samples)
    policy = A.QuantPolicy(weight_per_channel=True)   # vector mode, §3.1.5
    calibrate = ST.make_calibrate_step(model, policy)
    with torch.no_grad():
        qparams = A.init_qparams(model, params, policy)
        for b in DP.calibration_batches(spec, n=4):
            qparams = calibrate(params, qparams, batch(b))
    qparams = A.finalize_calibration(qparams)
    print(f"calibrated {len(qparams)} quantization points")

    # 4. FAT fine-tune: train ONLY the threshold scales against the teacher
    train_step = ST.make_fat_train_step(model, policy)
    opt = adam_init(A.flatten(qparams))
    for step in range(20):
        qparams, opt, m = train_step(params, qparams, opt,
                                     batch(DP.make_batch(spec, step)))
        if step % 5 == 0:
            print(f"  step {step:3d}  distill RMSE {float(m['loss']):.4f}")

    # 5. int8 conversion + fidelity check
    with torch.no_grad():
        serve_params = A.convert_to_int8(model, params, qparams, policy)
        b = batch(DP.make_batch(spec, 999))
        teacher = model(params, b)
        student = model(serve_params, b, A.make_ctx("int8", policy, qparams))
    agree = float(torch.mean((torch.argmax(teacher, -1)
                              == torch.argmax(student, -1)).float()))
    print(f"int8 vs fp top-1 agreement: {agree:.3f}")
    print(f"int8 logit RMSE: {float(rmse_distill_loss(teacher, student)):.4f}")
    assert agree > 0.9
    print("OK")
    return agree


if __name__ == "__main__":
    main()
