"""The paper's tables (``repro_torch.bench.run``) against the reference's
(``benchmarks/run.py``) piece by piece, on the same numpy inputs and the
same weights (the reference's init, bridged), float32, at the reference's
reduced sizes: the Table 1-2 student (calibration, fake-quant forward,
rmse and top-1 agreement), the §3.2 convergence (a few Adam steps of the
thresholds), and the §3.3/§4.2 DWS sequence.

Tolerances: calibrated thresholds rtol 1e-5.  The Table 1-2 student is
compared on one set of thresholds (the reference's, bridged): rmse rtol
5e-4 (measured worst 1.6e-4) and top-1 agreement equal.  Not 1e-5: at the
reference's reduced size (4 layers of d_model 128, 512 tokens) the two
frameworks' float32 matmuls sum in other orders, so a few of the ~10^6
fake-quantizer inputs cross a rounding boundary and move their logits by a
quantization step (calibrating in each package apart moves the rmse by
1e-3 and the agreement by 1-2 of 512 tokens, measured).

The §3.2 run's first two Adam steps: the thresholds atol 1e-6 after one
step, 1e-4 after two (measured 6e-8 and 1.4e-5; 3.7e-5 on an AMD EPYC with
AVX-512, torch 2.13.0+cpu, jax 0.9.0).  The losses, by a near-tie rule: a
fake-quantizer input within a few float32 ulps of a rounding tie rounds
by each framework's own float order (the norms' rsqrt, the matmuls' sums:
ROADMAP Queue C), and a crossed rounding moves the student's logits by a
quantization step.  Fed the reference's input on the reference's
thresholds, each of the port's layers and its readout stays within atol
1e-5 (measured 1.4e-6: no crossing of the port's own), and each step's
loss within rtol 1e-4 of the reference's plus the rmse between the two
students and between the two teachers (the triangle inequality of the
rmse: what the crossings may move it by).  Measured: the first loss 3.2e-4
apart on that CPU (5.6e-5 on another), the student's gap 4.4e-4 rms.  Later steps part: in scalar mode one alpha sets the rounding of
every weight of a layer, and each step moves it by ~lr = 5e-3, so a leaf
1e-5 away flips many roundings (measured 0.6% apart in the loss after three
steps, 1.5% after four).  The DWS sequence's pointwise fine-tune (scalar
mode too) is held the same way: its first 10 losses rtol 1e-4, all 30
rtol 2e-2, and every stage's top-1 agreement equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.dws_model import DWSNet as JDWSNet
from repro.configs import get_config as jax_config
from repro.core import api as JA
from repro.core import quant as JQ
from repro.core.distill import rmse_distill_loss as j_rmse
from repro.launch import steps as JST
from repro.models import build_model as jax_build
from repro.optim.adam import adam_init as j_adam_init
from repro.optim.adam import adam_update as j_adam_update
from repro.optim.adam import cosine_restarts as j_cosine
from repro_torch import bridge
from repro_torch.bench import run as R
from repro_torch.core import api as TA


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j_agree(t, s):
    return float(jnp.mean((jnp.argmax(t, -1) == jnp.argmax(s, -1))
                          .astype(jnp.float32)))


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_config("smollm-135m", smoke=True).replace(**R.LM_SHAPE,
                                                         dtype=jnp.float32)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    calib, eval_toks = R.lm_batches(jcfg.vocab, n=2)
    return dict(jcfg=jcfg, jm=jm, jparams=jparams,
                tparams=bridge.params_from_jax(_np(jparams)),
                calib=calib, eval=eval_toks)


@pytest.mark.parametrize("sym,per_channel", [(True, True), (False, False)],
                         ids=["table2_vector_symmetric",
                              "table1_scalar_asymmetric"])
def test_lm_quant_quality_matches(lm, sym, per_channel):
    kw = dict(act_symmetric=sym, weight_per_channel=per_channel)
    jpol = JA.QuantPolicy(**kw)
    jm, jparams = lm["jm"], lm["jparams"]
    qp = JA.init_qparams(jm, jparams, jpol)
    calib = jax.jit(JST.make_calibrate_step(jm, lm["jcfg"], jpol))
    for toks in lm["calib"]:
        qp = calib(jparams, qp, {"tokens": jnp.asarray(toks)})
    qp = JA.finalize_calibration(qp, jpol)
    batch = {"tokens": jnp.asarray(lm["eval"])}

    @jax.jit
    def logits(params, qp):
        return (jm(params, batch)[0],
                jm(params, batch, JA.make_ctx("fake", jpol, qp))[0])

    teacher, student = logits(jparams, qp)
    want_rmse = float(j_rmse(teacher, student))
    # the port's own calibration: every threshold
    from repro_torch.models import build_model

    tpol = TA.QuantPolicy(**kw)
    tq = R.calibrate(build_model(R.lm_cfg(dtype=torch.float32)),
                     lm["tparams"], tpol, lm["calib"], "cpu")
    jq = _np(qp)
    for path, entry in jq.items():
        for key, want in entry["act"].items():
            np.testing.assert_allclose(tq[path]["act"][key].numpy(), want,
                                       rtol=1e-5, atol=0, err_msg=path)
    # the student on the reference's thresholds
    rmse, agree = R.lm_quant_quality(
        tpol, device="cpu", params=lm["tparams"],
        data=(lm["calib"], lm["eval"]), cfg=R.lm_cfg(dtype=torch.float32),
        qparams=bridge.qparams_from_jax(jq))
    assert rmse == pytest.approx(want_rmse, rel=5e-4)
    assert agree == _j_agree(teacher, student)


def test_fat_convergence_steps_match():
    """Two steps of the §3.2 run (scalar mode, Adam, cosine restarts): the
    loss at each step and the thresholds after it."""
    jcfg = jax_config("smollm-135m", smoke=True).replace(n_layers=2,
                                                         dtype=jnp.float32)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (8, 64),
                                             dtype=np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    jpol = JA.QuantPolicy(weight_per_channel=False)
    qp = JA.init_qparams(jm, jparams, jpol)
    qp = jax.jit(JST.make_calibrate_step(jm, jcfg, jpol))(jparams, qp, batch)
    qp = JA.finalize_calibration(qp, jpol)
    teacher = jm(jparams, batch)[0]

    def loss_fn(qp):
        return j_rmse(teacher, jm(jparams, batch,
                                  JA.make_ctx("fake", jpol, qp))[0])

    mask = JA.trainable_mask(qp)

    @jax.jit
    def step(qp, opt):
        loss, g = jax.value_and_grad(loss_fn)(qp)
        lr = j_cosine(opt.step, 5e-3, 20)
        qp2, opt2 = j_adam_update(g, opt, qp, lr, mask=mask)
        return qp2, opt2, loss

    # the port's run from the reference's calibrated thresholds
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    tcfg = get_config("smollm-135m", smoke=True).replace(
        n_layers=2, dtype=torch.float32)
    tm = build_model(tcfg)
    tparams = bridge.params_from_jax(_np(jparams))
    tbatch = {"tokens": torch.from_numpy(toks)}
    tpol = TA.QuantPolicy(weight_per_channel=False)
    with torch.no_grad():
        tteacher = tm(tparams, tbatch)
    _, t_step = R.fat_step_fn(tm, tpol, tparams, tbatch, tteacher)
    flat = TA.flatten(bridge.qparams_from_jax(_np(qp)))
    topt = R.adam_init(flat)
    jopt = j_adam_init(qp)
    t_np = np.asarray(teacher, np.float64)
    rms = R.rmse_distill_loss
    for atol in (1e-6, 1e-4):
        _student_stages_match(jm, jparams, tm, tparams, toks, jpol, tpol, qp)
        with torch.no_grad():
            s_port = tm(tparams, tbatch, TA.make_ctx(
                "fake", tpol, TA.unflatten(flat))).double()
        s_ref = torch.from_numpy(np.asarray(jm(
            jparams, batch, JA.make_ctx("fake", jpol, qp))[0], np.float64))
        crossed = float(rms(s_port, s_ref)) + float(
            rms(tteacher.double(), torch.from_numpy(t_np)))
        qp, jopt, jl = step(qp, jopt)
        flat, topt, tl = t_step(flat, topt)
        assert abs(float(tl) - float(jl)) <= 1e-4 * float(jl) + crossed
        jflat = TA.flatten(_np(qp))
        for k, v in flat.items():
            np.testing.assert_allclose(v.detach().numpy(), jflat[k], rtol=0,
                                       atol=atol, err_msg=str(k))


def _student_stages_match(jm, jparams, tm, tparams, toks, jpol, tpol, qp):
    """The fake-quant student stage by stage on the reference's thresholds
    ``qp``: each of the port's layers fed the reference's input to it, and
    its readout fed the reference's final hidden state, within atol
    1e-5."""
    jctx = JA.make_ctx("fake", jpol, qp)
    tctx = TA.make_ctx("fake", tpol, bridge.qparams_from_jax(_np(qp)))
    jx = jm.embed(jparams["embed"], jnp.asarray(toks))
    with torch.no_grad():
        for i, (jb, tb) in enumerate(zip(jm.stack.blocks, tm.stack.blocks)):
            name = f"layer{i}"
            jy = jax.jit(lambda p, x, b=jb: b(p, x, jctx)[0])(
                jparams["stack"][name], jx)
            ty = tb(tparams["stack"][name],
                    torch.from_numpy(np.array(jx)), tctx)[0]
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                       atol=1e-5, err_msg=name)
            jx = jy
        jh = jm.stack.final_norm(jparams["stack"]["final_norm"], jx)
        want = jm.readout_fn(jparams, jctx)(jh)
        got = tm.readout_fn(tparams, tctx)(torch.from_numpy(np.array(jh)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg="readout")


def test_dws_sequence_matches():
    """The §3.3/§4.2 sequence on the port's numpy data through both nets:
    the same top-1 agreements at every stage, and the pointwise fine-tune's
    losses (30 Adam steps at lr 2e-2)."""
    x_eval, x_cal = R.dws_data()
    net = JDWSNet()
    params = net.init(jax.random.PRNGKey(0))
    folded = [net.fold_cell(c) for c in params["cells"]]
    head = params["head"]
    jx_eval, jx_cal = jnp.asarray(x_eval), jnp.asarray(x_cal)
    fp = net.forward_folded(folded, head, jx_eval, None)
    want = {"scalar": _j_agree(fp, net.forward_folded(
        folded, head, jx_eval, {"mode": "scalar"}))}
    rescaled = net.rescale_cells(folded, jx_cal)
    want["rescaled"] = _j_agree(fp, net.forward_folded(
        rescaled, head, jx_eval, {"mode": "scalar"}))
    want["vector"] = _j_agree(fp, net.forward_folded(
        folded, head, jx_eval, {"mode": "vector"}))
    pw = [jnp.ones_like(c["dws_w"]) for c in rescaled]
    ref = net.forward_folded(folded, head, jx_cal, None)

    def cells_of(pw):
        return [{**c, "dws_w": JQ.apply_pointwise_scale(c["dws_w"], p)}
                for c, p in zip(rescaled, pw)]

    def loss_fn(pw):
        return j_rmse(ref, net.forward_folded(cells_of(pw), head, jx_cal,
                                              {"mode": "scalar"}))

    opt = j_adam_init(pw)
    j_losses = []
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    for _ in range(30):
        val, g = grad_fn(pw)
        j_losses.append(float(val))
        pw, opt = j_adam_update(g, opt, pw, 2e-2)
    want["rescaled_ft"] = _j_agree(fp, net.forward_folded(
        cells_of(pw), head, jx_eval, {"mode": "scalar"}))

    (row,) = R.dws_rescaling("cpu", data=(x_eval, x_cal))
    got = dict(kv.split("=") for kv in row[2].split(";"))
    assert {k: float(v) for k, v in got.items()} == pytest.approx(
        {k: round(v, 3) for k, v in want.items()}, abs=1e-9)
    assert want["scalar"] < want["rescaled"] <= want["vector"]

    tnet = R.DWSNet()
    tp = tnet.init(R.DWS_SEED)
    tfolded = [tnet.fold_cell(c) for c in tp["cells"]]
    tres = tnet.rescale_cells(tfolded, torch.from_numpy(x_cal))
    _, t_losses = R.pointwise_finetune(tnet, tres, tfolded, tp["head"],
                                       torch.from_numpy(x_cal))
    np.testing.assert_allclose(t_losses[:10], j_losses[:10], rtol=1e-4)
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-2)


def test_run_cli_on_the_cpu(capsys):
    """``python -m repro_torch.bench.run --quick --device cpu``: the
    reference's row names and the ordering asserts."""
    R.main(["--quick", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    names = [line.split(",")[0] for line in out]
    assert names == ["name,us_per_call,derived".split(",")[0],
                     "table1_scalar_symmetric", "table1_scalar_asymmetric",
                     "table2_vector_symmetric", "table2_vector_asymmetric",
                     "dws_rescaling_sequence", "fat_convergence_40steps",
                     "paper_orderings"]


def test_kernels_micro_on_the_cpu():
    """On the CPU the wrappers run their plain versions, so each output is
    its plain version's bits (the assert inside) and the rows are named by
    route."""
    rows = R.kernels_micro("cpu", iters=1)
    assert [r[0] for r in rows] == ["cpu_plain_quant_matmul",
                                    "quant_matmul_ref_torch",
                                    "cpu_plain_fake_quant",
                                    "fake_quant_ref_torch"]
