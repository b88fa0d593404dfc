"""hymba-1.5b (attention and Mamba2 heads in parallel in every layer, a
window on every layer but the global ones) against the reference at its
``SMOKE`` widths, and what the SSM and hybrid stacks share: the Block in
every mode, the refusals, the sharded engine's guard, the serve CLI and
the capture rules.  The engines are ``test_torch_ssm.py``'s
(``build_served``): the reference's with ``use_pallas=True``, weights
bridged from its init, numpy calibration batches.

What is held bit for bit: int8 weights (13 quantized Dense a layer: the
attention's 4, the SSM mixer's 6, the MLP's 3), the KV scales from the
shared thresholds in every layer and layer 0's int8 K/V tiles (global
attention, dense cache), the float32 Engines' greedy and sampled tokens
over dense caches and over the rings of the windowed layers.

Tolerances, each beside its worst value measured at these seeds:
  * thresholds rtol 1e-6 at float32 (measured 4.5e-7), 2e-2 at bfloat16
    (measured 1.5e-2: the hybrid residual's bf16 rounding, which XLA's
    fusion skips before the ffn norm, ROADMAP Queue C);
  * prefill logits atol 1e-5 at float32 (measured 1.2e-7), 0.03 at
    bfloat16 (measured 0.021), tokens at bfloat16 equal or a near-tie
    (<= 0.25, teacher-forced: greedy row 0 parts at its fourth token);
  * layer 0's Block at float32 (mamba2's and hymba's): observers rtol
    1e-6 (measured 1.9e-7), the output in none and fake modes 1e-5 of the
    largest |y| (measured 2.8e-7 / 0 and 2.5e-7 / 8.5e-8), in int8 mode
    2e-3 (measured 6.7e-4 on mamba2, where the pre-norm's rsqrt rounds
    otherwise in XLA, ROADMAP Queue C, and one activation lands an int8
    step away; 8.5e-8 on hymba);
  * one fat_qat step of hymba at float32: ``test_torch_ssm.py``'s bounds
    (measured loss 7.6e-7, gradients 2.5e-6 of the largest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import api as JA
from repro.launch.engine import Engine as JaxEngine
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.launch import serve as SERVE
from repro_torch.launch import steps as TST
from repro_torch.launch.engine import Engine
from repro_torch.models import build_model as torch_build
from test_torch_ssm import (B, GEN, PROMPT, _np, _rel, build_served,
                            check_prefill, check_refusals, check_tokens,
                            check_weights_and_thresholds, teacher_forced)

ARCH = "hymba-1.5b"


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def served(request):
    s = build_served(ARCH, request.param)
    # the default "ring" layout: the 40-token prompts pass layer 1's
    # window of 16, whose cache becomes a ring
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    ref = JaxEngine(s["ref"].model, jcfg, s["ref"].policy,
                    s["ref"].serve_params, s["ref"].qparams, mode="int8")
    ours = Engine(s["shared"].model, tcfg, s["shared"].policy,
                  s["shared"].serve_params, s["shared"].qparams,
                  device="cpu")
    s["ring_ref"] = np.asarray(ref.generate_batch(
        {"tokens": jnp.asarray(s["prompts"])}, gen=GEN).tokens)
    s["ring"] = ours.generate_batch({"tokens": s["prompts"]}, gen=GEN)
    s["ring_engine"] = ours
    return s


def test_engine_weights_and_thresholds(served):
    check_weights_and_thresholds(served, per_layer=13)


def test_engine_kv_tiles_and_prefill_logits(served):
    """Every layer's KV scales from the shared thresholds bit for bit,
    layer 0's int8 tiles too; later layers' tiles follow an SSM output
    that sums in another order; the prefill logits."""
    check_prefill(served, 1e-5 if served["dtype"] == "float32" else 0.03)
    for i in range(served["tcfg"].n_layers):
        want = served["ref_cache"][f"layer{i}"]["attn"]
        got = served["cache"][f"layer{i}"]["attn"]
        assert set(served["cache"][f"layer{i}"]) == {"attn", "mamba"}
        for name in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        if i == 0:
            for name in ("k", "v"):
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(),
                    np.asarray(getattr(want, name)))
        want_m = served["ref_cache"][f"layer{i}"]["mamba"]
        got_m = served["cache"][f"layer{i}"]["mamba"]
        if i == 0 or served["dtype"] == "float32":
            np.testing.assert_array_equal(got_m.conv.numpy(),
                                          want_m["conv"])
            assert _rel(got_m.ssm.numpy(), want_m["ssm"]) < 1e-5


def test_engine_tokens_dense_and_ring(served):
    """Greedy and sampled tokens over dense caches, and greedy over the
    default layout's rings, against the reference's; programs equal the
    eager ``loop=True`` driver bit for bit."""
    logits = teacher_forced(served)
    check_tokens(served, served["out"].tokens.numpy(), served["ref_tokens"],
                 logits)
    check_tokens(served, served["sampled"].tokens.numpy(),
                 served["ref_sampled"], logits)
    check_tokens(served, served["ring"].tokens.numpy(), served["ring_ref"],
                 logits)
    assert torch.equal(served["sampled"].tokens,
                       served["sampled_loop"].tokens)
    engine = served["ring_engine"]
    caches = engine.init_cache(B, engine._cache_len(PROMPT, GEN))
    assert [c["attn"].layout for c in caches.values()] == ["dense", "ring"]
    eager = engine.generate_batch({"tokens": served["prompts"]}, gen=GEN,
                                  loop=True)
    assert torch.equal(eager.tokens, served["ring"].tokens)


@pytest.mark.parametrize("arch", ["mamba2-780m", ARCH])
def test_block_in_every_mode(arch):
    """Layer 0's Block (mamba2's SSM mixer alone; hymba's global attention
    and SSM mixer, their output norms and the MLP) at float32 in none,
    calibrate, fake and int8 modes, the port serving the reference's
    calibrated thresholds: ``w_q`` bit for bit, observers and outputs
    within the module docstring's tolerances."""
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32,
                                                n_layers=1)
    tcfg = torch_config(arch, smoke=True).replace(dtype=torch.float32,
                                                  n_layers=1)
    jb, tb = jax_build(jcfg).stack.blocks[0], torch_build(
        tcfg).stack.blocks[0]
    jp = jb.init(jax.random.PRNGKey(3))
    tp = bridge.params_from_jax(_np(jp))
    x = np.random.default_rng(3).normal(size=(2, 40, jcfg.d_model)).astype(
        np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert _rel(tb(tp, tx)[0].numpy(), jb(jp, jx)[0]) < 1e-5
    jpol = JA.QuantPolicy(use_pallas=True)
    tpol = TA.QuantPolicy()
    jq = JA.init_qparams(jb, jp, jpol)
    ctx = JA.make_ctx("calibrate", jpol, jq)
    jb(jp, jx, ctx)
    tq = TA.init_qparams(tb, tp, tpol)
    tctx = TA.make_ctx("calibrate", tpol, tq)
    tb(tp, tx, tctx)
    n_dense = 6 if arch == "mamba2-780m" else 13
    assert len(tq) == len(jq) == n_dense and set(tq) == set(jq)
    assert set(tctx.updates) == set(ctx.updates)
    for path, obs in ctx.updates.items():
        np.testing.assert_allclose(tctx.updates[path]["t_max"].numpy(),
                                   np.asarray(obs["t_max"]), rtol=1e-6)
        jq[path] = {**jq[path], "act": obs}
    jq = JA.finalize_calibration(jq, jpol)
    bq = bridge.qparams_from_jax(_np(jq))
    jsp = JA.convert_to_int8(jb, jp, jq, jpol)
    tsp = TA.convert_to_int8(tb, tp, bq, tpol)
    flat_j, flat_t = TA.flatten(_np(jsp)), TA.flatten(tsp)
    assert set(flat_j) == set(flat_t)
    assert sum(k[-1] == "w_q" for k in flat_t) == n_dense
    for k, v in flat_j.items():
        if k[-1] in ("w_q", "w_scale"):
            np.testing.assert_array_equal(flat_t[k].numpy(), v)
    jf = jb(jp, jx, JA.make_ctx("fake", jpol, jq))[0]
    assert _rel(tb(tp, tx, TA.make_ctx("fake", tpol, bq))[0].numpy(),
                jf) < 1e-5
    ji = jax.jit(lambda p, q, x: jb(p, x, JA.make_ctx("int8", jpol, q))[0])(
        jsp, jq, jx)
    assert _rel(tb(tsp, tx, TA.make_ctx("int8", tpol, bq))[0].numpy(),
                ji) < 2e-3


def test_fat_step_loss_and_threshold_gradients():
    from test_torch_ssm import fat_step_matches

    fat_step_matches(
        jax_config(ARCH, smoke=True).replace(dtype=jnp.float32),
        torch_config(ARCH, smoke=True).replace(dtype=torch.float32))


def test_refusals_match_the_reference():
    """The reference's refusals for the hybrid stack: chunked prefill,
    speculative decoding, the slot decode and the slot scheduler (kinds
    first, then windows, as the reference checks them), verify."""
    engine = Engine.from_checkpoint(ARCH, smoke=True, device="cpu")
    check_refusals(engine, "hybrid")


@pytest.mark.parametrize("arch", ["mamba2-780m", ARCH])
def test_sharded_engine_refuses_ssm_stacks(arch):
    """Under sequence parallelism (sp=2) the SSM stack serves what it
    serves unsharded, token for token (its state has no sequence axis;
    there is no attention to shard); the hybrid stack's windowed layer 1
    raises the reference's ValueError at the first sp decode (its
    ``_sp_decode``), as ``test_torch_sharded_families.py`` holds against
    the reference's sp=2 engine."""
    from repro_torch.shard import ShardedEngine

    engine = ShardedEngine.from_checkpoint(arch, smoke=True, device="cpu",
                                           sp=1, cache_layout="dense")
    sharded = ShardedEngine(engine.base_model, engine.cfg, engine.policy,
                            engine.serve_params, engine.qparams,
                            device="cpu", sp=2, cache_layout="dense")
    prompts = {"tokens": np.arange(16, dtype=np.int32).reshape(2, 8)}
    out = engine.generate_batch(prompts, gen=4)
    assert out.tokens.shape == (2, 4)
    if arch == ARCH:
        with pytest.raises(ValueError) as got:
            sharded.generate_batch(prompts, gen=4)
        assert str(got.value) == (
            f"{engine.cfg.name}/stack/layer1/attn: sliding-window decode is "
            "local by construction — run SWA layers unsharded (sp=1)")
        return
    assert torch.equal(sharded.generate_batch(prompts, gen=4).tokens,
                       out.tokens)


def test_attn_cache_len_needs_an_attention_cache():
    model = torch_build(torch_config("mamba2-780m", smoke=True))
    with pytest.raises(ValueError, match="no attention cache"):
        TST.attn_cache_len(model.init_cache(1, 64, "cpu"))
    model = torch_build(torch_config(ARCH, smoke=True))
    assert TST.attn_cache_len(model.init_cache(1, 64, "cpu")) == 64


@pytest.mark.parametrize("arch", ["mamba2-780m", ARCH])
def test_serve_cli_serves_the_ssm_configs(arch, capsys):
    out = SERVE.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "24", "--gen", "4"])
    assert out.shape == (2, 4)
    text = capsys.readouterr().out
    assert "[serve] ssm state: float32 in 2 layers" in text
    assert ("kv cache" in text) == (arch == ARCH)


@pytest.mark.parametrize("arch", ["mamba2-780m", ARCH])
def test_steps_read_nothing_back(monkeypatch, arch):
    """generate_batch's prefill and decode step through the SSM layers
    read nothing back to the host, make no tensor from host data and
    index with no boolean mask (the capture rules of
    ``tests/test_torch_graphs.py``); a replayed prefill overwrites the
    state the decode steps advanced."""
    from repro_torch.analysis import guarded

    eng = Engine.from_checkpoint(arch, smoke=True, device="cpu")
    prompts = np.random.default_rng(2).integers(0, eng.cfg.vocab,
                                                (2, PROMPT), dtype=np.int32)
    with torch.inference_mode():
        prog = eng._batch_program((2, PROMPT, eng._cache_len(PROMPT, GEN),
                                   ("greedy",)))
        prog.tokens[:, :PROMPT].copy_(torch.from_numpy(prompts))
        first = prog.prefill().clone()
        tok0 = prog.tok.clone()
        prog.decode()
        with guarded():
            again = prog.prefill()
            prog.decode()
    assert torch.equal(first, again)
    assert torch.equal(tok0, eng.generate_batch({"tokens": prompts},
                                                gen=1).tokens[:, 0])
