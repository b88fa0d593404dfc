"""seamless-m4t-medium, the encoder-decoder, against the reference at its
``SMOKE`` widths (2 encoder and 2 decoder layers, d 64, 4 heads of 16,
LayerNorm, the GELU MLP with biases, a tied readout), float32, weights
from the reference's init with random fc1 / fc2 biases, bridged; inputs
drawn with numpy from a seed.  One reference build for the file: its
``prepare_int8`` and its ``Engine`` (``use_pallas=True``, the kernels in
interpret mode), as ``test_torch_archs.py``.

Held bit for bit: int8 weights, scales, the int32 biases ``b_q`` and
their ``b_scale`` (82 leaves); the decoder's KV scales, and its layer 0
KV tiles after prefill (the reference's thresholds); the greedy tokens of
``generate_batch``, own calibration and shared thresholds, and the port's
programs against its ``loop=True`` driver; the ReLU variant's unsigned
fc2 (``act_unsigned``) in fake and int8 mode.

Float tolerances, each beside its worst value measured at these seeds:
  * logits: full precision, calibrate and fake mode atol 2e-6, int8
    (shared thresholds) 2e-4, room for one int8 step (measured 2.7e-7 in
    every mode).  The encoder's and the cross attention's plain attention
    is one softmax in the port, the reference's an online softmax over
    chunks of 16; LayerNorm's row sums and rsqrt and XLA's tanh (Queue C)
    round otherwise in the last bit.
  * thresholds rtol 2e-6: the calibrate pass's observers (6.8e-7), both
    packages' whole calibrations (4.1e-7).
  * the cross caches after prefill atol 1e-5 (0: bit for bit at these
    seeds); the decoder's KV tiles past layer 0 within one int8 step;
    prefill and teacher-forced decode logits atol 2e-4 (1.8e-7).
  * one FAT step: loss rtol 1e-4 (1.0e-7), every alpha and KV ``log2_t``
    gradient rtol 2e-3, atol 1e-4 x the largest of its kind (the archs'
    tolerances; 2.2e-8 off); one pretrain step: loss rtol 1e-4 (equal),
    every updated weight within one bf16 ulp (``test_torch_pretrain.py``'s
    float32 rule).
  * the ReLU block in fake mode atol 2e-6 (7.2e-7: its float32 products
    sum in other orders); its quantizer's output bit for bit.
  * ``generate_batch`` with each package's own calibration: the
    reference's tokens within 2e-2 of the port's argmax (15 of 16 equal,
    one near-tie 0.0033 below it).

Queue C, pinned here: the cross cache keeps the first min(cache length,
frames) rows of the encoder's memory, which decode attends, where prefill
attends every frame; the port's cross decode projects q and o only (the
reference also projects the token's k and v and drops them).
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
from repro.models import mlp as JMLP
from repro.optim import adam as JADAM
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.kernels import ops
from repro_torch.launch import steps as TST
from repro_torch.launch.engine import Engine
from repro_torch.models import build_model as torch_build
from repro_torch.models import mlp as TMLP
from repro_torch.optim import adam as TADAM
from repro_torch.shard import ShardedEngine

ARCH = "seamless-m4t-medium"
# 160 frames: past the 128 rows of the cross cache (12 + 8 tokens round up
# to a cache of 128 positions)
B, TEXT, FRAMES, GEN = 2, 12, 160, 8
LOGIT_ATOL = 2e-6
INT8_ATOL = 2e-4
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng, cfg, b, s_text, s_frames):
    return {"tokens": rng.integers(0, cfg.vocab, (b, s_text), dtype=np.int32),
            "frames": rng.standard_normal((b, s_frames, cfg.frame_dim),
                                          dtype=np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _with_biases(params, seed):
    """The reference's init with random biases on every fc1 / fc2 (its
    init leaves them zero, where b_q would be trivially zero)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif k == "b" and path[-1] in ("fc1", "fc2"):
                out[k] = jnp.asarray(rng.normal(size=v.shape) * 0.1,
                                     v.dtype)
            else:
                out[k] = v
        return out

    return walk(params)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_config(ARCH, smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config(ARCH, smoke=True).replace(dtype=torch.float32)
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    jparams = _with_biases(jm.init(jax.random.PRNGKey(0)), 3)
    tparams = bridge.params_from_jax(_np(jparams))
    rng = np.random.default_rng(29)
    calib = [_batch(rng, jcfg, 4, 8, 64) for _ in range(2)]
    prompt = _batch(rng, jcfg, B, TEXT, FRAMES)
    jpol = JA.QuantPolicy(kv_int8=True, use_pallas=True)
    jserve, jq = jax_prepare(jm, jcfg, jpol, jparams,
                             [_jax(b) for b in calib])
    ref = JaxEngine(jm, jcfg, jpol, jserve, jq, mode="int8",
                    cache_layout="dense")
    ours = Engine.from_checkpoint(cfg=tcfg, params=tparams,
                                  calib_batches=calib, device="cpu",
                                  cache_layout="dense")
    shared = Engine.from_checkpoint(
        cfg=tcfg, params=tparams, device="cpu", cache_layout="dense",
        qparams=bridge.qparams_from_jax(_np(jq)))
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jparams=jparams,
                tparams=tparams, calib=calib, prompt=prompt, jpol=jpol,
                ref=ref, ours=ours, shared=shared,
                ref_tokens=np.asarray(ref.generate_batch(
                    _jax(prompt), gen=GEN).tokens))


def test_param_tree_matches_the_reference(pair):
    want = TA.flatten(_np(pair["jparams"]))
    got = TA.flatten(pair["tm"].init(torch.Generator().manual_seed(0)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
    layers = {k[:3] for k in got if k[0] == "decoder"}
    assert ("decoder", "layer0", "cross_attn") in layers
    assert not any(k[2] == "cross_attn" for k in got if k[0] == "encoder")


@pytest.mark.parametrize("mode", ["fp", "calibrate", "fake", "int8"])
def test_forward_logits_in_every_mode(pair, mode):
    """The whole model's logits on the prompt batch: full precision (no
    context), calibrate (with the observers it feeds), fake (the
    reference's thresholds) and int8 (its serving params)."""
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
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=INT8_ATOL if mode == "int8"
                               else LOGIT_ATOL)
    if mode == "calibrate":
        want_obs = TA.flatten(_np(jup))
        got_obs = TA.flatten(ctx.updates)
        assert set(got_obs) == set(want_obs)
        for key, w in want_obs.items():
            np.testing.assert_allclose(got_obs[key].numpy(), w, rtol=2e-6,
                                       err_msg=str(key))


def test_calibrated_thresholds_match(pair):
    """Both calibrations, key for key: the decoder's self-attentions own KV
    thresholds; the encoder's bidirectional attention and the cross
    attention own none (no cache of theirs is quantized), in the reference
    and the port."""
    ref, ours = _np(pair["ref"].qparams), pair["ours"].qparams
    assert set(ref) == set(ours)
    kv = sorted(p for p in ours if p.endswith("/kv"))
    assert kv == [f"{pair['tcfg'].name}/decoder/layer{i}/attn/kv"
                  for i in range(pair["tcfg"].n_layers)]
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


def test_int8_weights_and_biases_bit_identical(pair):
    n, n_bias = 0, 0
    for path, want, got in _walk_int8(pair["ref"].serve_params,
                                      pair["shared"].serve_params):
        np.testing.assert_array_equal(got, want, err_msg=path)
        n += 1
        if path.endswith("b_q"):
            n_bias += 1
            assert got.dtype == np.int32 and (got != 0).any(), path
    layers = pair["tcfg"].n_layers
    # frame_proj; 6 Dense an encoder layer, 10 a decoder layer
    assert n == 2 * (1 + 16 * layers) + 2 * n_bias
    assert n_bias == 4 * layers


def _prefilled(pair):
    """Both packages' caches and last logits after the one-shot prefill of
    the prompt batch, the port serving the reference's thresholds."""
    ref, shared, prompt = pair["ref"], pair["shared"], pair["prompt"]
    cache_len = ref._cache_len(TEXT, GEN)
    jlogits, jcache = jax.jit(JST.make_prefill_step(
        ref.model, pair["jcfg"], ref.policy, "int8"))(
        ref.serve_params, ref.qparams, _jax(prompt),
        ref.init_cache(B, cache_len))
    with torch.inference_mode():
        tcache = shared.init_cache(B, shared._cache_len(TEXT, GEN),
                                   enc_len=FRAMES)
        tlogits, tcache = TST.make_prefill_step(shared.model, shared.policy)(
            shared.serve_params, shared.qparams, _torch(prompt), tcache)
    return jcache, tcache, np.asarray(jlogits), tlogits


def test_prefill_caches_and_decode_logits(pair):
    """After prefill: every decoder layer's KV scales and layer 0's tiles
    bit for bit, later layers' tiles within one int8 step; the cross
    caches (float) hold the first 128 of the 160 frames' K/V in both
    packages; then the decode steps, teacher-forced on the reference's
    tokens, give the reference's logits."""
    jcache, tcache, jlogits, tlogits = _prefilled(pair)
    assert pair["ref"]._cache_len(TEXT, GEN) == 128
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=0,
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
        jc, tc = jcache[f"layer{i}"]["cross"], tcache[f"layer{i}"]["cross"]
        assert tc.capacity == jc.capacity == 128 < FRAMES
        assert not tc.quantized and tc.k.dtype == torch.float32
        for key in ("k", "v"):
            np.testing.assert_allclose(getattr(tc, key).numpy(),
                                       np.asarray(jc[key]), rtol=0,
                                       atol=1e-5)
    ref, shared = pair["ref"], pair["shared"]
    toks = pair["ref_tokens"]
    jstep = jax.jit(lambda p, q, t, c, pos: ref.model.decode_step(
        p, t, c, pos, JA.make_ctx("int8", ref.policy, q)))
    ctx = TA.make_ctx("int8", shared.policy, shared.qparams)
    with torch.inference_mode():
        for i in range(GEN - 1):
            jl, jcache = jstep(ref.serve_params, ref.qparams,
                               jnp.asarray(toks[:, i:i + 1]), jcache,
                               TEXT + i)
            tl, tcache = shared.model.decode_step(
                shared.serve_params, torch.from_numpy(toks[:, i:i + 1]),
                tcache, TEXT + i, ctx)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=INT8_ATOL, err_msg=f"step {i}")


def _forced_margins(engine, prompt, tokens):
    """Per step and row: the port's max logit minus its logit of the given
    token, teacher-forcing the port with ``tokens``."""
    toks = torch.from_numpy(np.array(tokens)).long()
    ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
    with torch.inference_mode():
        cache = engine.init_cache(B, engine._cache_len(TEXT, GEN),
                                  enc_len=FRAMES)
        logits, cache = engine.model.prefill(engine.serve_params,
                                             _torch(prompt), cache, ctx)
        margins = []
        for i in range(GEN):
            lg = logits[:, -1]
            margins.append(lg.max(-1).values
                           - lg.gather(-1, toks[:, i:i + 1])[:, 0])
            if i < GEN - 1:
                logits, cache = engine.model.decode_step(
                    engine.serve_params, toks[:, i:i + 1], cache, TEXT + i,
                    ctx)
    return torch.stack(margins, dim=1).numpy()


@pytest.mark.parametrize("which", ["own", "shared"])
def test_generate_batch_tokens_match(pair, which):
    """The port's generate_batch (its programs, run eagerly on the CPU)
    gives the reference Engine's greedy tokens with the reference's
    thresholds; calibrated by each package, the port teacher-forced on the
    reference's tokens puts each within 2e-2 of its argmax (the archs'
    "own" tolerance); its loop=True driver gives the programs' tokens and
    prefill logits bit for bit."""
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


def test_cross_cache_keeps_the_first_rows(pair):
    """Queue C: the cross cache holds the K/V of the first min(cache
    length, frames) memory rows, as the reference's prefill writes them,
    and decode attends those rows only; prefill attends every frame.  The
    engine sizes it from the batch's frames (``enc_len``); a cache with
    more rows than the memory raises, where the reference would shrink it;
    the port's cross decode projects q and o only: 8 quant_matmul calls a
    decoder layer a step (the reference's 10 include the token's k and v,
    which it drops)."""
    shared, cfg = pair["shared"], pair["tcfg"]
    caches = shared.init_cache(B, 128, enc_len=FRAMES)
    assert {c["cross"].capacity for c in caches.values()} == {128}
    assert {c["cross"].capacity for c in shared.init_cache(
        B, 128, enc_len=40).values()} == {40}
    _, tcache, _, _ = _prefilled(pair)
    ctx = TA.make_ctx("int8", shared.policy, shared.qparams)
    with torch.inference_mode():
        memory = shared.model.encode(shared.serve_params,
                                     _torch(pair["prompt"])["frames"], ctx)
        cross = shared.model.decoder.blocks[0].cross_attn
        k = cross.wk(shared.serve_params["decoder"]["layer0"]["cross_attn"]
                     ["wk"], memory, ctx)
    assert memory.shape[1] == FRAMES
    np.testing.assert_array_equal(
        tcache["layer0"]["cross"].k.reshape(B, 128, -1).numpy(),
        k[:, :128].numpy())
    with pytest.raises(ValueError, match="cross cache"), \
            torch.inference_mode():
        big = shared.init_cache(B, 256, enc_len=None)
        TST.make_prefill_step(shared.model, shared.policy)(
            shared.serve_params, shared.qparams, _torch(pair["prompt"]), big)
    calls = []
    real = ops.quant_matmul

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    with torch.inference_mode():
        ops.quant_matmul = counted
        try:
            shared.model.decode_step(
                shared.serve_params, torch.zeros((B, 1), dtype=torch.long),
                tcache, TEXT, ctx)
        finally:
            ops.quant_matmul = real
    assert len(calls) == 8 * cfg.n_layers


def test_steps_read_nothing_back(pair, monkeypatch):
    """generate_batch's prefill and decode step read nothing back to the
    host, make no tensor from host data and index with no boolean mask
    (the capture rules of ``tests/test_torch_graphs.py``), with the
    frames in a static buffer of the programs; a replayed prefill gives the
    same logits after the decode steps wrote the caches."""
    from repro_torch.analysis import guarded

    eng, prompt = pair["shared"], pair["prompt"]
    shape = prompt["frames"].shape
    key = (B, TEXT, eng._cache_len(TEXT, GEN), ("greedy",),
           (("frames", shape),))
    with torch.inference_mode():
        prog = eng._batch_program(key)
        prog.tokens.copy_(torch.from_numpy(prompt["tokens"]))
        prog.media["frames"].copy_(torch.from_numpy(prompt["frames"]))
        first = prog.prefill().clone()
        prog.decode()
        with guarded():
            again = prog.prefill()
            prog.decode()
    assert torch.equal(first, again)
    assert torch.equal(first, eng.generate_batch(prompt, gen=1).prefill_logits)


def test_refusals_match_the_reference(pair):
    """Chunked prefill, speculative decoding and the slot scheduler refuse
    the encoder-decoder with the reference's messages; under sequence
    parallelism (sp=2) it serves, and speculative decoding is refused there
    with the same message (``test_torch_sharded_families.py`` holds the
    sp=2 engine against the reference's)."""
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
                            ours.qparams, device="cpu", sp=2,
                            cache_layout="dense")
    out = sharded.generate_batch(pair["prompt"], gen=2)
    assert out.tokens.shape == (B, 2)
    assert bool(torch.isfinite(out.prefill_logits).all())


def test_fat_step_and_pretrain_step_match(pair):
    """One FAT distillation step (fp teacher, fake-quant student, RMSE over
    the logits; the reference's int4-KV thresholds with trainable log2_t)
    and one pretrain step, both from the reference's weights on a batch
    with frames."""
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

    pb = dict(pair["calib"][1])
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


def test_relu_mlp_quantizes_fc2_unsigned():
    """GeluMLP(activation="relu"): fc2's input is non-negative and
    ``act_unsigned`` (the reference's ``act_spec(unsigned=True)``: 255
    levels, qmin 0) in calibration, fake and int8 mode; thresholds, the
    fake-quant output, ``w_q``, ``b_q`` and the int8 output bit for bit
    with the reference (the int8 path through the fused kernel's ±127
    clip, which saturates the unsigned input at half its threshold in
    both packages: Queue C)."""
    d, f = 32, 64
    jmlp = JMLP.GeluMLP(d, f, path="m", dtype=jnp.float32, activation="relu")
    tmlp = TMLP.GeluMLP(d, f, path="m", dtype=torch.float32,
                        activation="relu")
    assert tmlp.fc2.act_unsigned and not tmlp.fc1.act_unsigned
    jp = _with_biases({"mlp": jmlp.init(jax.random.PRNGKey(4))}, 5)["mlp"]
    tp = bridge.params_from_jax(_np(jp))
    x = np.random.default_rng(6).normal(size=(3, 20, d)).astype(np.float32)
    jpol = JA.QuantPolicy(use_pallas=True)
    tpol = TA.QuantPolicy()

    def jrun(mode, p, q):
        ctx = JA.make_ctx(mode, jpol, q)
        return jmlp(p, jnp.asarray(x), ctx), ctx.updates

    jq = JA.init_qparams(jmlp, jp, jpol)
    _, up = jax.jit(lambda p, q: jrun("calibrate", p, q))(jp, jq)
    jq = JA.finalize_calibration({k: {**jq[k], "act": v}
                                  for k, v in up.items()}, jpol)
    tq = TA.init_qparams(tmlp, tp, tpol)
    ctx = TA.make_ctx("calibrate", tpol, tq)
    tmlp(tp, torch.from_numpy(x), ctx)
    tq = TA.finalize_calibration({k: {**tq[k], "act": v}
                                  for k, v in ctx.updates.items()})
    for path in ("m/fc1", "m/fc2"):
        np.testing.assert_array_equal(tq[path]["act"]["t_max"].numpy(),
                                      np.asarray(jq[path]["act"]["t_max"]))
    tq = bridge.qparams_from_jax(_np(jq))
    # fc2's fake-quantized input on one non-negative tensor: bit for bit,
    # and not the signed grid's
    h = np.abs(np.random.default_rng(7).normal(size=(3, 20, f))).astype(
        np.float32)
    state = {k: jq["m/fc2"]["act"][k] for k in ("t_max", "alpha")}
    want_h = JA._fq_act(jnp.asarray(h), state, jpol.act_spec(True))
    got_h = TA._fq_act(torch.from_numpy(h), tq["m/fc2"]["act"],
                       tpol.act_spec(True))
    np.testing.assert_array_equal(got_h.detach().numpy(), np.asarray(want_h))
    assert not torch.equal(got_h, TA._fq_act(
        torch.from_numpy(h), tq["m/fc2"]["act"], tpol.act_spec(False)))
    # the whole block in fake mode: the float32 products sum in other
    # orders
    want, _ = jax.jit(lambda p, q: jrun("fake", p, q))(jp, jq)
    got = tmlp(tp, torch.from_numpy(x), TA.make_ctx("fake", tpol, tq))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-6)
    j8 = JA.convert_to_int8(jmlp, jp, jq, jpol)
    t8 = TA.convert_to_int8(tmlp, tp, tq, tpol)
    n = 0
    for path, want_leaf, got_leaf in _walk_int8(j8, t8):
        np.testing.assert_array_equal(got_leaf, want_leaf, err_msg=path)
        n += 1
    assert n == 8
    want, _ = jax.jit(lambda p, q: jrun("int8", p, q))(j8, jq)
    got = tmlp(t8, torch.from_numpy(x), TA.make_ctx("int8", tpol, tq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
