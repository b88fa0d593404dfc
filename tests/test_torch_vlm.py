"""llava-next-34b, the VLM, against the reference at its ``SMOKE`` widths
(2 layers, d 64, 4 query and 2 KV heads of 16, SwiGLU, RMSNorm, an untied
lm_head, 8 patches of 32 projected by ``mm_proj`` before the text),
float32, weights from the reference's init, bridged; inputs drawn with
numpy from a seed.  One reference build for the file: its
``prepare_int8`` and its ``Engine`` (``use_pallas=True``, the kernels in
interpret mode), as ``test_torch_archs.py``.  The untied readout serves
the last block's ``wq`` thresholds in every engine
(``_readout_thresholds``, as ``test_torch_archs.py``): the reference's
calibration leaves it at the 1e-8 floor, which both packages' calibrations
give (pinned).

Held bit for bit: int8 weights and scales (32 leaves, ``mm_proj``'s
among them); the KV scales, and layer 0's KV tiles after prefill over the
patches and the text (the reference's thresholds); the greedy tokens of
``generate_batch`` with the reference's thresholds, and the port's
programs against its ``loop=True`` driver.

Float tolerances, each beside its worst value measured at these seeds:
  * logits (B, P + S, V): full precision, calibrate and fake mode atol
    1e-5; int8 (shared thresholds) 2e-4, room for one int8 step (measured
    3.5e-6 over the modes, on logits up to ~2: XLA's rsqrt in RMSNorm,
    the reference's online softmax).
  * thresholds rtol 2e-6: the calibrate pass's observers (4.5e-7), both
    packages' whole calibrations (4.6e-7).
  * prefill and teacher-forced decode logits atol 2e-4 (0: bit for bit at
    these seeds); the KV tiles past layer 0 within one int8 step.
  * one FAT step: loss rtol 1e-4 (1.2e-7), every alpha and KV ``log2_t``
    gradient rtol 2e-3, atol 1e-4 x the largest of its kind (4e-14 off);
    one pretrain step (its loss over the text positions only): loss rtol
    1e-4 (7.5e-8), every updated weight within one bf16 ulp.
  * ``generate_batch`` with each package's own calibration: the
    reference's tokens within 2e-2 of the port's argmax (16 of 16 equal).

Queue C, pinned here: the reference's default calibration (``calib_len``
32) cannot reach a VLM with 32 or more patches; the port raises a
``ValueError`` that says so (the reference fails inside its PRNG); the
port's default calibration draws a VLM's batches from the pipeline and a
text config's uniform token ids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import api as JA
from repro.core.distill import chunked_sq_err as jax_sq_err
from repro.launch import steps as JST
from repro.launch.engine import Engine as JaxEngine
from repro.launch.engine import prepare_int8 as jax_prepare
from repro.models import build_model as jax_build
from repro.optim import adam as JADAM
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.launch import steps as TST
from repro_torch.launch.engine import Engine
from repro_torch.models import build_model as torch_build
from repro_torch.optim import adam as TADAM
from repro_torch.shard import ShardedEngine

ARCH = "llava-next-34b"
B, TEXT, GEN = 2, 12, 8
LOGIT_ATOL = 1e-5
INT8_ATOL = 2e-4
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng, cfg, b, s_text):
    return {"tokens": rng.integers(0, cfg.vocab, (b, s_text), dtype=np.int32),
            "patches": rng.standard_normal((b, cfg.mm_patches, cfg.mm_dim),
                                           dtype=np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _readout_thresholds(qparams, cfg):
    """The untied lm_head's activation thresholds taken from the last
    block's ``wq`` (both inputs are a norm's output)."""
    last = f"{cfg.name}/stack/layer{cfg.n_layers - 1}/attn/wq"
    head = f"{cfg.name}/lm_head"
    return {**qparams, head: {**qparams[head], "act": qparams[last]["act"]}}


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_config(ARCH, smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config(ARCH, smoke=True).replace(dtype=torch.float32)
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(_np(jparams))
    rng = np.random.default_rng(31)
    calib = [_batch(rng, jcfg, 4, 24) for _ in range(2)]
    prompt = _batch(rng, jcfg, B, TEXT)
    jpol = JA.QuantPolicy(kv_int8=True, use_pallas=True)
    _, jq = jax_prepare(jm, jcfg, jpol, jparams, [_jax(b) for b in calib],
                        convert=False)
    ours = Engine.from_checkpoint(cfg=tcfg, params=tparams,
                                  calib_batches=calib, device="cpu",
                                  cache_layout="dense")
    calibrated = dict(ref=jq, ours=ours.qparams)
    jq = _readout_thresholds(jq, jcfg)
    ref = JaxEngine(jm, jcfg, jpol, JA.convert_to_int8(jm, jparams, jq, jpol),
                    jq, mode="int8", cache_layout="dense")
    ours = Engine(tm, tcfg, ours.policy, ours.serve_params,
                  _readout_thresholds(ours.qparams, tcfg), device="cpu",
                  cache_layout="dense")
    shared = Engine.from_checkpoint(
        cfg=tcfg, params=tparams, device="cpu", cache_layout="dense",
        qparams=bridge.qparams_from_jax(_np(jq)))
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jparams=jparams,
                tparams=tparams, calib=calib, prompt=prompt, jpol=jpol,
                ref=ref, ours=ours, shared=shared, calibrated=calibrated,
                ref_tokens=np.asarray(ref.generate_batch(
                    _jax(prompt), gen=GEN).tokens))


def test_param_tree_matches_the_reference(pair):
    want = TA.flatten(_np(pair["jparams"]))
    got = TA.flatten(pair["tm"].init(torch.Generator().manual_seed(0)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
    assert ("mm_proj", "w") in got and ("lm_head", "w") in got


@pytest.mark.parametrize("mode", ["fp", "calibrate", "fake", "int8"])
def test_forward_logits_in_every_mode(pair, mode):
    """The whole model's logits over the patches and the text: full
    precision (no context), calibrate (with the observers it feeds), fake
    (the reference's thresholds) and int8 (its serving params)."""
    jm, tm, jpol = pair["jm"], pair["tm"], pair["jpol"]
    tpol = TA.QuantPolicy(kv_int8=True)
    batch = pair["prompt"]
    jparams, tparams = pair["jparams"], pair["tparams"]
    jq = pair["ref"].qparams
    tq = bridge.qparams_from_jax(_np(jq))
    if mode == "calibrate":
        jq, tq = JA.init_qparams(jm, jparams, jpol), TA.init_qparams(
            tm, tparams, tpol)
    if mode == "int8":
        jparams, tparams = pair["ref"].serve_params, pair["shared"].serve_params
    jmode = None if mode == "fp" else mode

    def jfwd(p, b, q):
        ctx = None if jmode is None else JA.make_ctx(jmode, jpol, q)
        logits, _ = jm(p, b, ctx)
        return logits, ({} if ctx is None else ctx.updates)

    want, jup = jax.jit(jfwd)(jparams, _jax(batch), jq)
    ctx = None if jmode is None else TA.make_ctx(jmode, tpol, tq)
    with torch.no_grad():
        got = tm(tparams, _torch(batch), ctx)
    cfg = pair["tcfg"]
    assert got.shape == (B, cfg.mm_patches + TEXT, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=INT8_ATOL if mode == "int8"
                               else LOGIT_ATOL)
    if mode == "calibrate":
        want_obs = TA.flatten(_np(jup))
        got_obs = TA.flatten(ctx.updates)
        assert set(got_obs) == set(want_obs)
        assert (f"{cfg.name}/mm_proj", "t_max") in got_obs
        for key, w in want_obs.items():
            np.testing.assert_allclose(got_obs[key].numpy(), w, rtol=2e-6,
                                       err_msg=str(key))


def test_calibrated_thresholds_match(pair):
    """Both calibrations as they come: key for key, the untied readout's
    threshold at the 1e-8 floor in both (calibration runs ``hidden``,
    which never reaches the readout)."""
    ref = _np(pair["calibrated"]["ref"])
    ours = pair["calibrated"]["ours"]
    assert set(ref) == set(ours)
    cfg = pair["tcfg"]
    for qp in (ref, ours):
        assert float(qp[f"{cfg.name}/lm_head"]["act"]["t_max"]) == (
            pytest.approx(1e-8))
    for path, entry in ref.items():
        for group, leaves in entry.items():
            for name, want in leaves.items():
                np.testing.assert_allclose(
                    ours[path][group][name].numpy(), want, rtol=2e-6,
                    atol=0, err_msg=f"{path}/{group}/{name}")


def _walk_int8(a, b, path=""):
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _walk_int8(v, b[k], f"{path}/{k}")
        elif k in ("w_q", "w_scale", "b_q", "b_scale"):
            yield f"{path}/{k}", np.asarray(v), b[k].numpy()


def test_int8_weights_bit_identical(pair):
    n = 0
    for path, want, got in _walk_int8(pair["ref"].serve_params,
                                      pair["shared"].serve_params):
        np.testing.assert_array_equal(got, want, err_msg=path)
        n += 1
    # 7 Dense a layer, the lm_head and mm_proj
    assert n == 2 * (7 * pair["tcfg"].n_layers + 2)


def test_prefill_caches_and_decode_logits(pair):
    """After prefill the caches hold the patches' and the text's K/V at
    positions [0, P + S): the KV scales of every layer and layer 0's tiles
    bit for bit (later layers' within one int8 step), nothing past P + S;
    decode starts at P + S (the reference Engine's first position), and
    each step, teacher-forced on the reference's tokens, gives its
    logits."""
    ref, shared, prompt = pair["ref"], pair["shared"], pair["prompt"]
    p = pair["tcfg"].mm_patches
    cache_len = ref._cache_len(TEXT, GEN)
    assert shared._cache_len(TEXT, GEN) == cache_len == 128
    jlogits, jcache = jax.jit(JST.make_prefill_step(
        ref.model, pair["jcfg"], ref.policy, "int8"))(
        ref.serve_params, ref.qparams, _jax(prompt),
        ref.init_cache(B, cache_len))
    ctx = TA.make_ctx("int8", shared.policy, shared.qparams)
    with torch.inference_mode():
        tlogits, tcache = TST.make_prefill_step(shared.model, shared.policy)(
            shared.serve_params, shared.qparams, _torch(prompt),
            shared.init_cache(B, cache_len))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=INT8_ATOL)
    for i in range(pair["tcfg"].n_layers):
        ja, ta = jcache[f"layer{i}"]["attn"], tcache[f"layer{i}"]["attn"]
        for key in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(ta, key).numpy(),
                                          np.asarray(ja[key]))
        for key in ("k", "v"):
            want, got = np.asarray(ja[key]), getattr(ta, key).numpy()
            if i == 0:
                np.testing.assert_array_equal(got, want)
            assert np.abs(got.astype(int) - want).max() <= 1
            assert (got[:, :p + TEXT] != 0).any(axis=(2, 3)).all()
            assert not got[:, p + TEXT:].any()
    toks = pair["ref_tokens"]
    jstep = jax.jit(lambda pr, q, t, c, pos: ref.model.decode_step(
        pr, t, c, pos, JA.make_ctx("int8", ref.policy, q)))
    with torch.inference_mode():
        for i in range(GEN - 1):
            jl, jcache = jstep(ref.serve_params, ref.qparams,
                               jnp.asarray(toks[:, i:i + 1]), jcache,
                               p + TEXT + i)
            tl, tcache = shared.model.decode_step(
                shared.serve_params, torch.from_numpy(toks[:, i:i + 1]),
                tcache, p + TEXT + i, ctx)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=INT8_ATOL, err_msg=f"step {i}")
    assert (tcache["layer0"]["attn"].k[:, p + TEXT] != 0).any()


def _forced_margins(engine, prompt, tokens):
    """Per step and row: the port's max logit minus its logit of the given
    token, teacher-forcing the port with ``tokens``."""
    toks = torch.from_numpy(np.array(tokens)).long()
    p = engine.cfg.mm_patches
    ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
    with torch.inference_mode():
        cache = engine.init_cache(B, engine._cache_len(TEXT, GEN))
        logits, cache = engine.model.prefill(engine.serve_params,
                                             _torch(prompt), cache, ctx)
        margins = []
        for i in range(GEN):
            lg = logits[:, -1]
            margins.append(lg.max(-1).values
                           - lg.gather(-1, toks[:, i:i + 1])[:, 0])
            if i < GEN - 1:
                logits, cache = engine.model.decode_step(
                    engine.serve_params, toks[:, i:i + 1], cache,
                    p + TEXT + i, ctx)
    return torch.stack(margins, dim=1).numpy()


@pytest.mark.parametrize("which", ["own", "shared"])
def test_generate_batch_tokens_match(pair, which):
    """The port's generate_batch (its programs, run eagerly on the CPU)
    gives the reference Engine's greedy tokens with the reference's
    thresholds; calibrated by each package, the port teacher-forced on the
    reference's tokens puts each within 2e-2 of its argmax; its loop=True
    driver gives the programs' tokens and prefill logits bit for bit."""
    engine = pair["ours" if which == "own" else "shared"]
    res = engine.generate_batch(pair["prompt"], gen=GEN)
    if which == "shared":
        np.testing.assert_array_equal(res.tokens.numpy(), pair["ref_tokens"])
    else:
        margins = _forced_margins(engine, pair["prompt"], pair["ref_tokens"])
        assert margins.max() <= 2e-2, margins
    eager = engine.generate_batch(pair["prompt"], gen=GEN, loop=True)
    assert torch.equal(eager.tokens, res.tokens)
    assert torch.equal(eager.prefill_logits, res.prefill_logits)


def test_calibration_needs_text_beside_the_patches(pair):
    """Queue C: the reference's default calibration draws (4, 32) pipeline
    batches, whose text is 32 - mm_patches tokens; with 32 or more patches
    (llava-next-34b has 2880) it fails inside its PRNG, and the port raises
    a ValueError that names the cause.  A ``calib_len`` past the patches
    calibrates; a batch with the wrong patch count is refused."""
    jcfg = pair["jcfg"].replace(mm_patches=40)
    tcfg = pair["tcfg"].replace(mm_patches=40)
    with pytest.raises(Exception):
        JaxEngine.from_checkpoint(cfg=jcfg, use_pallas=True)
    with pytest.raises(ValueError, match="leaves no text beside 40 patches"):
        Engine.from_checkpoint(cfg=tcfg, device="cpu")
    engine = Engine.from_checkpoint(cfg=tcfg, device="cpu", calib_len=48,
                                    calib_batch=2, n_calib=1)
    assert engine.n_int8_weights() == 7 * tcfg.n_layers + 2
    with pytest.raises(ValueError, match="patches of shape"):
        pair["shared"].generate_batch(
            {"tokens": pair["prompt"]["tokens"],
             "patches": pair["prompt"]["patches"][:, :4]}, gen=2)
    with pytest.raises(ValueError, match="needs 'patches'"):
        pair["shared"].generate_batch(
            {"tokens": pair["prompt"]["tokens"]}, gen=2)


def test_default_calibration_sources(pair):
    """The Engine's default calibration has one source, as the reference's
    (``launch/engine.py``: ``DP.calibration_batches`` of
    ``DP.spec_for(cfg, ShapeSpec("engine", "train", calib_len,
    calib_batch))``): a VLM's batches from the pipeline (patches beside
    the tokens) and a text config's from the pipeline too, not
    ``repro_torch.data``'s uniform token ids: each default engine's
    thresholds equal those of the engine handed the pipeline's batches,
    and a text engine handed uniform ids calibrates otherwise."""
    from repro_torch import data as D
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import pipeline as DP

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return torch.equal(a, b)

    def pipeline(cfg, seq_len):
        spec = DP.spec_for(cfg, ShapeSpec("engine", "train", seq_len, 2))
        return DP.calibration_batches(spec, 2)

    vlm = pair["tcfg"]
    kw = dict(device="cpu", calib_batch=2, calib_len=vlm.mm_patches + 8)
    assert same(Engine.from_checkpoint(cfg=vlm, **kw).qparams,
                Engine.from_checkpoint(cfg=vlm, device="cpu", calib_batches=(
                    pipeline(vlm, kw["calib_len"]))).qparams)
    text = torch_config("smollm-135m", smoke=True)
    kw = dict(device="cpu", calib_batch=2, calib_len=16)
    default = Engine.from_checkpoint(cfg=text, **kw).qparams
    assert same(default, Engine.from_checkpoint(
        cfg=text, device="cpu", calib_batches=pipeline(text, 16)).qparams)
    assert not same(default, Engine.from_checkpoint(
        cfg=text, device="cpu", calib_batches=D.calibration_batches(
            text.vocab, batch=2, seq_len=16)).qparams)


def test_steps_read_nothing_back(pair, monkeypatch):
    """generate_batch's prefill and decode step read nothing back to the
    host, make no tensor from host data and index with no boolean mask
    (the capture rules of ``tests/test_torch_graphs.py``), with the
    patches in a static buffer of the programs; a replayed prefill gives the
    same logits after the decode steps wrote the caches."""
    from repro_torch.analysis import guarded

    eng, prompt = pair["shared"], pair["prompt"]
    shape = prompt["patches"].shape
    key = (B, TEXT, eng._cache_len(TEXT, GEN), ("greedy",),
           (("patches", shape),))
    with torch.inference_mode():
        prog = eng._batch_program(key)
        prog.tokens.copy_(torch.from_numpy(prompt["tokens"]))
        prog.media["patches"].copy_(torch.from_numpy(prompt["patches"]))
        first = prog.prefill().clone()
        prog.decode()
        with guarded():
            again = prog.prefill()
            prog.decode()
    assert torch.equal(first, again)
    assert torch.equal(first, eng.generate_batch(prompt, gen=1).prefill_logits)


def test_refusals_match_the_reference(pair):
    """Chunked prefill, speculative decoding and the slot scheduler refuse
    the VLM with the reference's messages; under sequence parallelism
    (sp=2) it serves, and speculative decoding is refused there with the
    same message (``test_torch_sharded_families.py`` holds the sp=2 engine
    against the reference's)."""
    ref, ours = pair["ref"], pair["ours"]
    jcfg, jm, tm = pair["jcfg"], pair["jm"], pair["tm"]
    with pytest.raises(ValueError) as want:
        JST.make_prefill_step(jm, jcfg, pair["jpol"], prefill_chunk=8)
    with pytest.raises(ValueError) as got:
        TST.make_prefill_step(tm, ours.policy, prefill_chunk=8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, jcfg, ref.policy, ref.serve_params, ref.qparams,
                  decode_strategy="speculative")
    with pytest.raises(ValueError) as got:
        Engine(tm, pair["tcfg"], ours.policy, ours.serve_params,
               ours.qparams, device="cpu", decode_strategy="speculative")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        ref.make_scheduler(max_slots=2)
    with pytest.raises(ValueError) as got:
        ours.make_scheduler(max_slots=2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, jcfg, ref.policy, ref.serve_params, ref.qparams,
                  decode_strategy="speculative")
    with pytest.raises(ValueError) as got:
        ShardedEngine(tm, pair["tcfg"], ours.policy, ours.serve_params,
                      ours.qparams, device="cpu", sp=2,
                      decode_strategy="speculative")
    assert str(got.value) == str(want.value)
    sharded = ShardedEngine(tm, pair["tcfg"], ours.policy, ours.serve_params,
                            ours.qparams, device="cpu", sp=2)
    out = sharded.generate_batch(pair["prompt"], gen=2)
    assert out.tokens.shape[1] == 2
    assert bool(torch.isfinite(out.prefill_logits).all())


def test_fat_step_and_pretrain_step_match(pair):
    """One FAT distillation step over the patches and the text (the
    reference's int4-KV thresholds with trainable log2_t), and one pretrain
    step, whose loss reads the text positions only, both from the
    reference's weights."""
    jcfg, jm, tm = pair["jcfg"], pair["jm"], pair["tm"]
    jparams, tparams = pair["jparams"], pair["tparams"]
    jpol = JA.QuantPolicy(kv_int8=True, kv_bits=4)
    tpol = TA.QuantPolicy(kv_int8=True, kv_bits=4)
    calib = [_jax(b) for b in pair["calib"]]
    jq = JA.init_qparams(jm, jparams, jpol)
    jstep = jax.jit(JST.make_calibrate_step(jm, jcfg, jpol))
    for b in calib:
        jq = jstep(jparams, jq, b)
    jq = JA.finalize_calibration(jq, jpol, train_thresholds=True)
    batch = calib[0]

    def loss_for(qp, params):                  # the reference's loss_for
        h_t, _ = jm.hidden(params, batch, None, remat=jcfg.remat)
        h_t = jax.lax.stop_gradient(h_t)
        ctx = JA.make_ctx("fake", jpol, qp)
        h_s, _ = jm.hidden(params, batch, ctx, remat=jcfg.remat)
        sq, n = jax_sq_err(h_t, h_s, jm.readout_fn(params, None),
                           jm.readout_fn(params, ctx), chunk=jcfg.loss_chunk)
        return jnp.sqrt(sq / n)

    want_loss, want = jax.jit(jax.value_and_grad(loss_for))(jq, jparams)
    want = TA.flatten(_np(want))
    loss, grads = TST.make_fat_grad_fn(tm, tpol)(
        tparams, bridge.qparams_from_jax(_np(jq)), _torch(pair["calib"][0]))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert sum(k[-1] == "log2_t" for k in grads) == 2 * jcfg.n_layers
    for kind in ("alpha", "log2_t"):
        keys = [k for k in grads if k[-1] == kind]
        scale = max(np.abs(want[k]).max() for k in keys)
        for k in keys:
            np.testing.assert_allclose(grads[k].numpy(), want[k], rtol=2e-3,
                                       atol=1e-4 * scale, err_msg=str(k))

    # the loss reads 32 text positions (a multiple of loss_chunk 16)
    pb = _batch(np.random.default_rng(8), jcfg, 2, 32)
    pb["labels"] = np.roll(pb["tokens"], -1, axis=1)
    jnew, _, jmet = jax.jit(JST.make_pretrain_step(
        jm, jcfg, JST.TrainHParams(base_lr=LR)))(
        jparams, JADAM.adam_init(jparams), _jax(pb))
    tnew, _, tmet = TST.make_pretrain_step(tm, TST.TrainHParams(base_lr=LR))(
        tparams, TADAM.adam_init(TA.flatten(tparams)), _torch(pb))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    for key, w in TA.flatten(_np(jnew)).items():
        a, b = np.asarray(w, np.float32), TA.flatten(tnew)[key].numpy()
        mag = np.maximum(np.abs(a), np.abs(b))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
        assert not (np.abs(a - b) > ulp).any(), key
