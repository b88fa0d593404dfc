"""The port's training side against the reference: the data pipeline, the
pretrain step (``chunked_ce_loss``, ``make_pretrain_step``), the Adam
restart helpers, the training CLI's kill-and-resume, and serving a
training checkpoint through ``Engine.from_checkpoint(checkpoint_dir=)``.

Tolerances and why:
  * The pipeline's token values cannot equal the reference's (JAX PRNG vs
    a numpy generator), so it is held to the reference's contract:
    determinism per (seed, step), calibration disjoint from training, a
    skewed Zipf marginal.  Parity tests hand the same numpy batch to both.
  * ``chunked_ce_loss`` on the same hidden states: rtol 1e-6 (logsumexp
    and the mean in another order).
  * One pretrain step on the smoke model in float32, the reference's
    params bridged: loss rtol 1e-4 (equal on these inputs) and every
    updated weight within one bf16 ulp of the reference's (they agree to
    ~1e-6).  In bfloat16 the loss holds the same rtol (1.7e-5 measured),
    but Adam's first step moves each weight by about lr times the sign of
    its gradient, and the two frameworks round their bf16 activations at
    other places: a gradient near zero may change sign and move its weight
    by 2 lr the other way.  So in bf16 at most 1% of each weight tensor
    may differ by more than one ulp, and none by more than 2 lr plus one
    ulp (0.3% measured).
  * The CLI's resumed run equals the uninterrupted one bit for bit: the
    checkpoint round trip is exact and each step deterministic on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.core.distill import chunked_ce_loss as jax_chunked_ce_loss
from repro.launch import steps as JST
from repro.models import build_model as jax_build
from repro.optim import adam as JADAM
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.core import api as TA
from repro_torch.core.distill import chunked_ce_loss
from repro_torch.data import pipeline as DP
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TRAIN
from repro_torch.launch.engine import Engine
from repro_torch.models import build_model as torch_build
from repro_torch.optim import adam as TADAM
from repro_torch.shard import ShardedEngine

LR = 1e-3


# ---------------------------------------------------------------------------
# data pipeline (test_substrate.py::TestDataPipeline)
# ---------------------------------------------------------------------------


def test_pipeline_deterministic_and_resumable():
    spec = DP.PipelineSpec(vocab=1000, seq_len=32, global_batch=4)
    a, b = DP.make_batch(spec, 7), DP.make_batch(spec, 7)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 32)
    assert not torch.equal(a["tokens"], DP.make_batch(spec, 8)["tokens"])
    other = DP.PipelineSpec(vocab=1000, seq_len=32, global_batch=4, seed=1)
    assert not torch.equal(a["tokens"], DP.make_batch(other, 7)["tokens"])
    assert torch.equal(a["labels"], torch.roll(a["tokens"], -1, dims=1))


def test_pipeline_calibration_disjoint_from_training():
    spec = DP.PipelineSpec(vocab=1000, seq_len=32, global_batch=4)
    cal = DP.calibration_batches(spec, 2)
    train = [DP.make_batch(spec, i) for i in range(2)]
    assert torch.equal(cal[1]["tokens"],
                       DP.make_batch(spec, (1 << 20) + 1)["tokens"])
    for cb in cal:
        for tb in train:
            assert not torch.equal(cb["tokens"], tb["tokens"])


def test_pipeline_zipf_marginal_and_2gram_mix():
    spec = DP.PipelineSpec(vocab=1000, seq_len=256, global_batch=8)
    toks = DP.make_batch(spec, 0)["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < 1000
    # low ids dominate (Zipf): ids 0..9 take > 30%
    assert float((toks < 10).float().mean()) > 0.3
    # with p = 0.3 a position takes its predecessor's drawn token + 1,
    # which is the predecessor's final token unless that was replaced too
    # (p = 0.7): 21% of positions, plus the Zipf draw's own coincidences
    rep = (toks[:, 1:] == (toks[:, :-1] + 1) % 1000).float().mean()
    assert 0.18 < float(rep) < 0.35


def test_pipeline_spec_for_and_media_batches():
    """The reference's modalities: a VLM batch carries (B, mm_patches,
    mm_dim) patches and seq_len - mm_patches tokens, an encoder-decoder's
    (B, seq_len, frame_dim) frames and max(seq_len // dec_ratio, 4) tokens,
    both in the config's dtype and the same for the same (seed, step); a
    VLM's seq_len must leave text beside its patches."""
    cfg = torch_config("smollm-135m", smoke=True)
    spec = DP.spec_for(cfg, ShapeSpec("t", "train", 32, 4), seed=3)
    assert (spec.vocab, spec.seq_len, spec.global_batch, spec.seed) == (
        cfg.vocab, 32, 4, 3)
    assert set(DP.make_batch(spec, 0)) == {"tokens", "labels"}
    shape = ShapeSpec("t", "train", 40, 3)
    vlm = torch_config("llava-next-34b", smoke=True)
    encdec = torch_config("seamless-m4t-medium", smoke=True)
    for c, key, media, text in (
            (vlm, "patches", (3, vlm.mm_patches, vlm.mm_dim),
             40 - vlm.mm_patches),
            (encdec, "frames", (3, 40, encdec.frame_dim), 5)):
        spec = DP.spec_for(c, shape, seed=1)
        a, b = DP.make_batch(spec, 2), DP.make_batch(spec, 2)
        assert set(a) == {"tokens", "labels", key}
        assert a["tokens"].shape == a["labels"].shape == (3, text)
        assert a[key].shape == media and a[key].dtype == c.dtype
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a[key], DP.make_batch(spec, 3)[key])
    tiny = ShapeSpec("t", "train", 12, 2)
    assert DP.spec_for(encdec, tiny).text_len() == 4
    with pytest.raises(ValueError, match="no text beside"):
        DP.make_batch(DP.spec_for(vlm.replace(mm_patches=12), tiny), 0)


def test_shapes_table_matches_the_reference():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, want in JAX_SHAPES.items():
        assert dataclasses.astuple(SHAPES[name]) == dataclasses.astuple(want)


# ---------------------------------------------------------------------------
# the pretrain step
# ---------------------------------------------------------------------------


def _pair(dtype):
    jcfg = jax_config("smollm-135m", smoke=True)
    tcfg = torch_config("smollm-135m", smoke=True)
    if dtype == "f32":
        jcfg = jcfg.replace(dtype=jnp.float32)
        tcfg = tcfg.replace(dtype=torch.float32)
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (4, 32),
                                             dtype=np.int32)
    return jcfg, jm, tm, jparams, tparams, toks, np.roll(toks, -1, axis=1)


def test_chunked_ce_loss_matches():
    jcfg, jm, tm, jparams, tparams, toks, labels = _pair("f32")
    h = np.random.default_rng(5).normal(size=(4, 32, jcfg.d_model)).astype(
        np.float32)
    want = jax_chunked_ce_loss(jnp.asarray(h), jnp.asarray(labels),
                               jm.readout_fn(jparams), chunk=16)
    got = chunked_ce_loss(torch.from_numpy(h), torch.from_numpy(labels),
                          tm.readout_fn(tparams), chunk=16)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        chunked_ce_loss(torch.from_numpy(h), torch.from_numpy(labels),
                        tm.readout_fn(tparams), chunk=24)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pretrain_step_matches(dtype):
    jcfg, jm, tm, jparams, tparams, toks, labels = _pair(dtype)
    jstep = jax.jit(JST.make_pretrain_step(jm, jcfg,
                                           JST.TrainHParams(base_lr=LR)))
    jnew, jopt, jmet = jstep(jparams, JADAM.adam_init(jparams),
                             {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)})
    tstep = TST.make_pretrain_step(tm, TST.TrainHParams(base_lr=LR))
    tnew, topt, tmet = tstep(tparams, TADAM.adam_init(TA.flatten(tparams)),
                             {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(topt.step) == int(jopt.step) == 1
    want = TA.flatten(jax.tree.map(np.asarray, jnew))
    got = TA.flatten(tnew)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert str(g.dtype).endswith(str(w.dtype)), key
        a, b = np.asarray(w, np.float32), g.float().numpy()
        mag = np.maximum(np.abs(a), np.abs(b))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
        off = np.abs(a - b) > ulp
        if dtype == "f32":
            assert not off.any(), key
        else:
            assert off.mean() <= 0.01, (key, off.mean())
            assert (np.abs(a - b) <= 2 * LR + ulp).all(), key


def test_pretrain_step_rejects_an_aux_weight_it_cannot_apply():
    """A dense stack has no load-balance loss to weigh: since MoE stacks
    are ported (their aux is held against the reference in
    ``tests/test_torch_moe.py``), every ``aux_weight`` is accepted, and on
    a dense stack it leaves the step's loss and new params unchanged (the
    test keeps its name; it pinned the raise before MoE)."""
    cfg = torch_config("smollm-135m", smoke=True).replace(dtype=torch.float32)
    tm = torch_build(cfg)
    params = tm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 17), dtype=np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    outs = []
    for w in (0.0, 0.01, 3.0):
        step = TST.make_pretrain_step(tm, TST.TrainHParams(aux_weight=w))
        new, _, metrics = step(params, TADAM.adam_init(TA.flatten(params)),
                               batch)
        outs.append((metrics["loss"], TA.flatten(new)))
    for loss, flat in outs[1:]:
        assert torch.equal(loss, outs[0][0])
        assert all(torch.equal(v, outs[0][1][k]) for k, v in flat.items())


def test_restart_boundary_and_reset_moments_match():
    for period, t_mult in ((10, 1.0), (4, 2.0), (3, 1.5)):
        for step in range(40):
            assert TADAM.restart_boundary(step, period, t_mult) == \
                JADAM.restart_boundary(step, period, t_mult), (step, period)
    st = TADAM.adam_init({("a",): torch.ones(3), ("b",): torch.ones(2, 2)})
    st = st._replace(step=torch.tensor(5, dtype=torch.int32),
                     mu={k: v + 1 for k, v in st.mu.items()},
                     nu={k: v + 2 for k, v in st.nu.items()})
    reset = TADAM.reset_moments(st)
    assert int(reset.step) == 5
    assert all(not v.any() and v.shape == st.mu[k].shape
               for k, v in reset.mu.items())
    assert all(not v.any() for v in reset.nu.values())
    assert all(bool((v == 1).all()) for v in st.mu.values())


# ---------------------------------------------------------------------------
# the CLI: kill and resume (test_substrate.py::test_restart_resumes_...)
# ---------------------------------------------------------------------------

CLI = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
       "--calib-batches", "2", "--log-every", "1"]


@pytest.mark.parametrize("mode", ["fat_qat", "pretrain"])
def test_cli_resume_equals_uninterrupted_run(tmp_path, capsys, mode):
    args = CLI + ["--mode", mode] + (
        ["--finetune-thresholds"] if mode == "fat_qat" else [])
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2"]
    p_full, q_full = TRAIN.main(args + ["--steps", "4"])
    TRAIN.main(args + ckpt + ["--steps", "2"])          # killed after 2
    assert "resuming" not in capsys.readouterr().out
    p_res, q_res = TRAIN.main(args + ckpt + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[train] resuming from step 2" in out
    assert "step     2 loss" in out and "step     0 loss" not in out
    trained = q_full if mode == "fat_qat" else p_full
    resumed = q_res if mode == "fat_qat" else p_res
    flat_full, flat_res = TA.flatten(trained), TA.flatten(resumed)
    assert set(flat_full) == set(flat_res)
    for k, v in flat_full.items():
        assert flat_res[k].dtype == v.dtype, k
        assert torch.equal(flat_res[k], v), k
    if mode == "fat_qat":
        assert any(k[-1] == "log2_t" for k in flat_full)
        # the weights do not train in FAT
        for k, v in TA.flatten(p_full).items():
            assert torch.equal(TA.flatten(p_res)[k], v), k
    tree, meta = CheckpointManager(str(tmp_path / "ckpt")).restore_latest()
    assert meta["step"] == 4 and int(tree["opt"]["step"]) == 4


def test_cli_validates_its_arguments():
    with pytest.raises(SystemExit):
        TRAIN.main(["--mode", "qat"])
    with pytest.raises(KeyError, match="unknown arch"):
        TRAIN.main(["--arch", "llava-next-35b", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "llava-next-34b"])
@pytest.mark.parametrize("mode", ["fat_qat", "pretrain"])
def test_cli_smoke_trains_the_media_families(capsys, arch, mode):
    """``launch.train --smoke`` drives the encoder-decoder and the VLM:
    batches with frames or patches from the pipeline, calibration, then the
    steps, every loss finite (the FAT run also trains its KV log2_t).  A
    sequence of 16 fits both losses' chunks of 16, as in the reference:
    FAT reads llava's 8 patches and 8 tokens, pretrain its 8 tokens."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--mode", mode,
            "--steps", "2", "--batch", "2", "--seq", "16", "--log-every",
            "1", "--calib-batches", "1"]
    params, qparams = TRAIN.main(
        args + (["--finetune-thresholds"] if mode == "fat_qat" else []))
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all(), out
    if mode == "fat_qat":
        assert any(k[-1] == "log2_t" for k in TA.flatten(qparams))
    else:
        assert qparams is None and ("mm_proj" in params
                                    or "frame_proj" in params)


# ---------------------------------------------------------------------------
# serving a training checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    d = tmp_path_factory.mktemp("pretrain_ckpt")
    TRAIN.main(CLI + ["--mode", "pretrain", "--steps", "2", "--ckpt-dir",
                      str(d), "--ckpt-every", "2", "--lr", "1e-2"])
    return str(d)


def test_engine_serves_a_training_checkpoint(pretrained):
    tree, _ = CheckpointManager(pretrained).restore_latest()
    prompts = {"tokens": np.random.default_rng(2).integers(
        0, 256, (2, 12), dtype=np.int32)}
    a = Engine.from_checkpoint("smollm-135m", smoke=True, device="cpu",
                               checkpoint_dir=pretrained)
    b = Engine.from_checkpoint("smollm-135m", smoke=True, device="cpu",
                               params=tree["params"])
    fresh = Engine.from_checkpoint("smollm-135m", smoke=True, device="cpu")
    for x, y in zip(TA.flatten(a.serve_params).values(),
                    TA.flatten(b.serve_params).values()):
        assert torch.equal(x, y)
    assert not torch.equal(a.serve_params["embed"]["table"],
                           fresh.serve_params["embed"]["table"])
    ra, rb = a.generate_batch(prompts, gen=6), b.generate_batch(prompts, gen=6)
    assert torch.equal(ra.tokens, rb.tokens)
    assert torch.equal(ra.prefill_logits, rb.prefill_logits)
    sp = ShardedEngine.from_checkpoint("smollm-135m", smoke=True,
                                       device="cpu", sp=2,
                                       checkpoint_dir=pretrained)
    assert torch.equal(sp.serve_params["embed"]["table"],
                       a.serve_params["embed"]["table"])


def test_engine_checkpoint_dir_errors(pretrained, tmp_path):
    tree, _ = CheckpointManager(pretrained).restore_latest()
    with pytest.raises(ValueError, match="not both"):
        Engine.from_checkpoint("smollm-135m", smoke=True, device="cpu",
                               params=tree["params"],
                               checkpoint_dir=pretrained)
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        Engine.from_checkpoint("smollm-135m", smoke=True, device="cpu",
                               checkpoint_dir=str(tmp_path))
