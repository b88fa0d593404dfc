"""The paper's tables on the port, one function each.

Counterpart of ``benchmarks/run.py``:

  table1_scalar_modes   paper Table 1 (8-bit scalar weights: symmetric vs
                        asymmetric activations) on a reduced LM backbone
  table2_vector_modes   paper Table 2 (8-bit vector weights)
  dws_rescaling         §3.3/§4.2 sequence: scalar collapse -> rescale
                        recovery -> pointwise fine-tune recovery
  fat_convergence       §3.2/§4.1.2: the RMSE distillation loss falls when
                        only the threshold scales train
  kernels_micro         the fused int8 matmul (B3) and fake-quant (B5)
                        against their plain versions, each output equal
                        to its plain version bit for bit before it is timed

Prints ``name,us_per_call,derived`` CSV rows with the reference's row
names for the four tables, and asserts the paper's orderings.  The data
are seeded numpy draws (the reference's come from the JAX PRNG, which the
port does not reproduce); every table function takes its data and weights
as optional arguments, so a test hands both packages the same arrays.

Run: ``PYTHONPATH=src python -m repro_torch.bench.run [--quick]`` on the
GPU; ``--device cpu`` runs the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.bench.dws_model import DWSNet
from repro_torch.configs import get_config
from repro_torch.core import api as A
from repro_torch.core import quant as Q
from repro_torch.core.distill import rmse_distill_loss
from repro_torch.models import build_model
from repro_torch.optim.adam import adam_init, adam_update, cosine_restarts

# the reduced smollm backbone of the Table 1-2 analogs
LM_SHAPE = dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                head_dim=32, d_ff=384)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def agreement(teacher_logits, student_logits) -> float:
    """Top-1 agreement: the label-free analog of the paper's top-1 accuracy
    (the teacher defines the reference prediction)."""
    return float(torch.mean((torch.argmax(teacher_logits, -1)
                             == torch.argmax(student_logits, -1)).float()))


def lm_cfg(dtype=None):
    cfg = get_config("smollm-135m", smoke=True).replace(**LM_SHAPE)
    return cfg if dtype is None else cfg.replace(dtype=dtype)


def lm_batches(vocab: int, n: int = 4) -> tuple[list, np.ndarray]:
    """``n`` calibration batches and one evaluation batch of (8, 64) token
    ids, seeded per batch (100 + i, the eval batch 199)."""
    def draw(seed):
        return np.random.default_rng(seed).integers(0, vocab, (8, 64),
                                                    dtype=np.int32)

    return [draw(100 + i) for i in range(n)], draw(199)


def _tokens(a, device):
    return {"tokens": torch.as_tensor(np.asarray(a), device=device)}


def calibrate(model, params, policy, batches, device):
    """§2 calibration over token batches -> finalized qparams."""
    with torch.no_grad():
        qp = A.init_qparams(model, params, policy)
        for toks in batches:
            ctx = A.make_ctx("calibrate", policy, qp)
            model(params, _tokens(toks, device), ctx)
            for path, obs in ctx.updates.items():
                qp[path] = {**qp[path], "act": obs}
    return A.finalize_calibration(qp)


def lm_quant_quality(policy: A.QuantPolicy, *, device, params=None,
                     data=None, cfg=None, seed: int = 0, qparams=None):
    """Teacher/student fidelity of one policy on the reduced backbone:
    (rmse, top-1 agreement) of the fake-quantized student's logits against
    the full-precision teacher's on the evaluation batch.  ``params``
    default to the seeded init (a CPU generator, so every device gets the
    same weights); ``data`` to ``lm_batches``; ``qparams`` given skips the
    calibration."""
    cfg = cfg or lm_cfg()
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator().manual_seed(seed))
    params = _to(params, device)
    calib, eval_toks = data if data is not None else lm_batches(cfg.vocab)
    qp = (calibrate(model, params, policy, calib, device) if qparams is None
          else _to(qparams, device))
    with torch.no_grad():
        teacher = model(params, _tokens(eval_toks, device))
        student = model(params, _tokens(eval_toks, device),
                        A.make_ctx("fake", policy, qp))
    return float(rmse_distill_loss(teacher, student)), agreement(teacher,
                                                                 student)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _table(prefix, per_channel, device, **kw):
    rows = []
    for name, sym in (("symmetric", True), ("asymmetric", False)):
        t0 = time.perf_counter()
        rmse, agree = lm_quant_quality(
            A.QuantPolicy(act_symmetric=sym, weight_per_channel=per_channel),
            device=device, **kw)
        us = (time.perf_counter() - t0) * 1e6
        rows.append((f"{prefix}_{name}", us,
                     f"rmse={rmse:.4f};top1_agree={agree:.3f}"))
    return rows


def table1_scalar_modes(device, **kw):
    """Table 1 analog: 8-bit SCALAR weights, symmetric vs asymmetric
    activations (paper: asymmetric >= symmetric; scalar is the weak
    mode)."""
    return _table("table1_scalar", False, device, **kw)


def table2_vector_modes(device, **kw):
    """Table 2 analog: 8-bit VECTOR (per-channel) weights (paper: within
    noise of full precision, better than scalar)."""
    return _table("table2_vector", True, device, **kw)


def dws_data(channels: int = 64):
    """(x_eval (64, 16, C), x_cal (16, 16, C)) float32 normal draws."""
    return (np.random.default_rng(1).normal(size=(64, 16, channels))
            .astype(np.float32),
            np.random.default_rng(2).normal(size=(16, 16, channels))
            .astype(np.float32))


def pointwise_finetune(net, rescaled, folded, head, x_cal, *, steps=30,
                       lr=2e-2):
    """§4.2: train per-value scales in [0.75, 1.25] of the rescaled
    scalar-mode depthwise weights against the float teacher (Adam at
    ``lr``).  Returns (scales, per-step losses)."""
    pw = {str(i): torch.ones_like(c["dws_w"]) for i, c in enumerate(rescaled)}
    with torch.no_grad():
        ref = net.forward_folded(folded, head, x_cal, None)

    def loss_fn(pw):
        cells = [{**c, "dws_w": Q.apply_pointwise_scale(c["dws_w"],
                                                        pw[str(i)])}
                 for i, c in enumerate(rescaled)]
        out = net.forward_folded(cells, head, x_cal, {"mode": "scalar"})
        return rmse_distill_loss(ref, out)

    opt = adam_init(pw)
    losses = []
    for _ in range(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in pw.items()}
        loss = loss_fn(leaves)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        pw, opt = adam_update(grads, opt, pw, lr)
    return pw, losses


# the integer the reference's ``DWSNet.init(PRNGKey(0))`` draws for its
# numpy generator: the port's net then holds the reference's weights
DWS_SEED = 31327077


def dws_rescaling(device, *, np_seed: int = DWS_SEED, data=None):
    """§3.3 + §4.2 sequence on the planted-outlier DWS net (paper: scalar
    MobileNet-v2 1.6% -> +rescale 67% -> +pointwise 71%, FP 71.55%); here
    top-1 agreement with the float model."""
    net = DWSNet()
    params = net.init(np_seed, device=device)
    folded = [net.fold_cell(c) for c in params["cells"]]
    x_eval, x_cal = (torch.as_tensor(a, device=device)
                     for a in (data if data is not None
                               else dws_data(net.channels)))
    head = params["head"]
    t0 = time.perf_counter()
    with torch.no_grad():
        fp = net.forward_folded(folded, head, x_eval, None)
        a_scalar = agreement(fp, net.forward_folded(
            folded, head, x_eval, {"mode": "scalar"}))
        rescaled = net.rescale_cells(folded, x_cal)
        a_resc = agreement(fp, net.forward_folded(
            rescaled, head, x_eval, {"mode": "scalar"}))
        a_vector = agreement(fp, net.forward_folded(
            folded, head, x_eval, {"mode": "vector"}))
    pw, _ = pointwise_finetune(net, rescaled, folded, head, x_cal)
    with torch.no_grad():
        cells_ft = [{**c, "dws_w": Q.apply_pointwise_scale(c["dws_w"],
                                                           pw[str(i)])}
                    for i, c in enumerate(rescaled)]
        a_ft = agreement(fp, net.forward_folded(cells_ft, head, x_eval,
                                                {"mode": "scalar"}))
    _sync(device)
    us = (time.perf_counter() - t0) * 1e6
    derived = (f"scalar={a_scalar:.3f};rescaled={a_resc:.3f};"
               f"rescaled_ft={a_ft:.3f};vector={a_vector:.3f}")
    # the paper's ordering: collapse < rescaled, vector >= scalar
    assert a_scalar < a_resc, (a_scalar, a_resc)
    assert a_vector >= a_scalar, (a_vector, a_scalar)
    return [("dws_rescaling_sequence", us, derived)]


def fat_step_fn(model, policy, params, batch, teacher, *, base_lr=5e-3,
                period=20):
    """One FAT step of the convergence run: the RMSE of the fake-quantized
    logits against ``teacher``, its gradient to the trainable qparams
    leaves, masked Adam at the cosine-annealed rate.  ``(qp, opt) -> (qp,
    opt, loss)`` over flat qparams (``A.flatten``)."""
    def loss_fn(flat):
        ctx = A.make_ctx("fake", policy, A.unflatten(flat))
        return rmse_distill_loss(teacher, model(params, batch, ctx))

    def step(flat, opt):
        mask = A.flatten(A.trainable_mask(A.unflatten(flat)))
        leaves = {k: v.detach().requires_grad_(mask[k])
                  for k, v in flat.items()}
        loss = loss_fn(leaves)
        keys = [k for k in leaves if mask[k]]
        gs = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                 allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(keys, gs)}
        lr = cosine_restarts(opt.step, base_lr, period)
        new, opt = adam_update(grads, opt, flat, lr.to(opt.step.device),
                               mask=mask)
        return new, opt, loss.detach()

    return loss_fn, step


def fat_convergence(device, *, params=None, tokens=None, steps: int = 40):
    """§3.2: the RMSE between full-precision and quantized outputs falls
    when ONLY the threshold scale factors train (Adam + cosine annealing),
    in scalar mode (the stressed one)."""
    cfg = get_config("smollm-135m", smoke=True).replace(n_layers=2)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    params = _to(params, device)
    policy = A.QuantPolicy(weight_per_channel=False)
    if tokens is None:
        tokens = np.random.default_rng(5).integers(0, cfg.vocab, (8, 64),
                                                   dtype=np.int32)
    batch = _tokens(tokens, device)
    qp = calibrate(model, params, policy, [tokens], device)
    with torch.no_grad():
        teacher = model(params, batch)
    loss_fn, step = fat_step_fn(model, policy, params, batch, teacher)
    flat = A.flatten(qp)
    opt = adam_init(flat)
    with torch.no_grad():
        loss0 = float(loss_fn(flat))
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        flat, opt, loss = step(flat, opt)
    loss1 = float(loss)
    us = (time.perf_counter() - t0) / steps * 1e6
    assert loss1 < loss0, (loss0, loss1)
    return [(f"fat_convergence_{steps}steps", us,
             f"rmse0={loss0:.4f};rmse{steps}={loss1:.4f};"
             f"improvement={100 * (1 - loss1 / loss0):.1f}%")]


def _time_us(fn, device, iters: int):
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e6, out


def kernels_micro(device, iters: int = 20):
    """B3 (``ops.quant_matmul``, 256x512x256) and B5 (``ops.fake_quant``,
    512x256) against their plain versions in ``kernels/ref.py`` on the
    same inputs; each output must equal its plain version bit for bit
    before its time is printed.  On the CPU the wrappers run the plain
    versions themselves."""
    from repro_torch.kernels import ops, ref

    route = "cuda" if torch.device(device).type == "cuda" else "cpu_plain"
    rows = []
    rng = np.random.default_rng(0)
    m, k, n = 256, 512, 256
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32),
                        device=device)
    w = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32),
                        device=device)
    spec = Q.QuantSpec(bits=8, per_channel=True)
    t_w = Q.max_abs_threshold(w, spec)
    w_q, w_scale = Q.quantize_weights_int8(w, t_w, torch.ones_like(t_w), spec)
    act_scale = torch.tensor(127.0 / 3.0, dtype=torch.float32, device=device)
    comb = (w_scale / act_scale).float()
    us_k, y_k = _time_us(lambda: ops.quant_matmul(x, w_q, comb, act_scale),
                         device, iters)
    us_r, y_r = _time_us(lambda: ref.quant_matmul_ref(x, w_q, comb,
                                                      act_scale),
                         device, iters)
    assert torch.equal(y_k, y_r), "quant_matmul differs from its plain version"
    rows.append((f"{route}_quant_matmul", us_k, f"shape={m}x{k}x{n}"))
    rows.append(("quant_matmul_ref_torch", us_r, f"shape={m}x{k}x{n}"))

    t = torch.as_tensor(np.abs(rng.normal(size=(n,))).astype(np.float32)
                        + 0.5, device=device)
    a = torch.full((n,), 0.8, dtype=torch.float32, device=device)
    xx = torch.as_tensor(rng.normal(size=(512, n)).astype(np.float32),
                         device=device)
    with torch.no_grad():
        us_k, y_k = _time_us(lambda: ops.fake_quant(xx, t, a), device, iters)
    us_r, y_r = _time_us(lambda: ref.fake_quant_ref(xx, t, a), device, iters)
    assert torch.equal(y_k, y_r), "fake_quant differs from its plain version"
    rows.append((f"{route}_fake_quant", us_k, f"shape=512x{n}"))
    rows.append(("fake_quant_ref_torch", us_r, f"shape=512x{n}"))
    return rows


def rmse_of(rows, key: str) -> float:
    by = {r[0]: r[2] for r in rows}
    return float(by[key].split("rmse=")[1].split(";")[0])


def check_orderings(rows) -> None:
    """The paper's ordering across Tables 1-2: vector rmse <= scalar."""
    assert (rmse_of(rows, "table2_vector_symmetric")
            <= rmse_of(rows, "table1_scalar_symmetric"))
    assert (rmse_of(rows, "table2_vector_asymmetric")
            <= rmse_of(rows, "table1_scalar_asymmetric"))


def run(device, quick: bool = False) -> list:
    """Every table on ``device`` (kernels_micro unless ``quick``), the
    ordering asserts held; returns the rows."""
    rows = []
    rows += table1_scalar_modes(device)
    rows += table2_vector_modes(device)
    rows += dws_rescaling(device)
    rows += fat_convergence(device)
    if not quick:
        rows += kernels_micro(device)
    check_orderings(rows)
    return rows


def main(argv=None) -> None:
    from repro_torch.launch.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="skip kernels_micro (the tables only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, raising "
                         "where there is none; 'cpu' runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = run(device, quick=args.quick)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.0f},{derived}")
    print("paper_orderings,0,vector<=scalar rmse confirmed")


if __name__ == "__main__":
    main()
