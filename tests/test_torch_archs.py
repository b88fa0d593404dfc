"""The dense decoders beyond smollm-135m against the reference Engine:
granite-8b (a dense llama), stablelm-12b (LayerNorm, an untied lm_head)
and gemma3-12b (GeGLU, 5:1 sliding-window layers; its ring cache), at
their ``SMOKE`` widths, and at widths with stablelm's head dim 160 and
gemma3's 256 that the reference's ``quant_matmul`` tiles.

The reference is ``repro.launch.engine.Engine`` with ``use_pallas=True``
(its kernels in interpret mode), as in ``test_torch_engine.py``.  Both
packages start from the reference's init, bridged, and calibrate on the
same numpy batches; a third engine serves with the reference's
thresholds, bridged.  Prompts of 40 tokens pass gemma3's window of 16.
stablelm's untied readout serves the last block's ``wq`` thresholds in
every engine (``_readout_thresholds``): the reference's calibration
leaves it at the floor, where its logits are ~1e-8.

Tolerances: ``test_torch_engine.py``'s, per case, restated where two
x86 CPUs of the same wheels part (worst values measured at these seeds on
an AMD EPYC with AVX-512, torch 2.13.0+cpu, jax 0.9.0):
  * int8 weights and every layer's KV scales from the shared thresholds
    are bit-identical, and so are layer 0's KV tiles (dense cache and
    ring); the port's rings hold its dense cache's last window, rolled,
    bit for bit, in every windowed layer.  Later layers' tiles may inherit
    a last-bit difference of the reference's compiled CPU arithmetic (its
    rsqrt in every norm, its row sums in LayerNorm, its tanh in GeGLU's
    gelu: ROADMAP Queue C) carried across an int8 rounding step, and such
    a crossing cascades: gemma3-12b-d256's KV codes differ in 0.6% of
    layer 1's codes and 50% of layer 5's, by up to 6 steps.  Both
    packages serve the SAME thresholds: the reference's ("shared") or the
    port's own calibration, bridged into the reference ("own"; the
    calibrations themselves are held below).  Float32 prefill logits to
    atol 1e-4, or, where larger, to the reference's own last-bit
    sensitivity: the largest move of its logits when its activation
    thresholds move by one or two float32 ulps, which is what a crossing
    of the two frameworks' float orders moves them by.  Measured: granite-8b
    4.5e-7 (sensitivity 0), stablelm-12b 0 / 0, stablelm-12b-d160 0 / 0,
    gemma3-12b 2.4e-7; gemma3-12b-d256 0.0138 shared, 0.0135 own, against
    a sensitivity of 0.0138 to 0.0267 (its first crossing: 28 of layer 0's
    5120 attention outputs one ``wo`` input step apart, fed the same
    input).  Greedy tokens identical (float32).
  * float32 (``F32``) calibrations: each threshold within 16 float32 ulps
    of the reference's (``np.spacing`` of its value: the two
    frameworks' float32 orders part by a few ulps per norm, softmax and
    tanh, and the maxima carry them through the layers); gemma3-12b within
    32 (an activation maximum past XLA's tanh: its rtol was 2e-6).
    Measured worst: gemma3-12b-d256 12 ulps (layer 5's ``down`` input),
    gemma3-12b 22 (the same), stablelm-12b-d160 8, granite-8b 6,
    stablelm-12b 5.  (An rtol of 1e-6 is 8.4 to 16.8
    ulps depending on where the value sits in its binade: 12 ulps of
    -5.7018 read as 1.004e-6.)
  * bf16 (gemma3-12b-bf16, the serving dtype): thresholds to rtol 3e-2,
    logits to atol 0.06 and the reference's tokens within 0.06 of the
    port's argmax, teacher-forced, as ``test_torch_engine.py`` (measured
    0.0144, 0.0325 shared / 0.0284 own, 0.0078).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import api as JA
from repro.core.distill import chunked_sq_err as jax_chunked_sq_err
from repro.launch import steps as JST
from repro.launch.engine import Engine as JaxEngine
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.launch import steps as TST
from repro_torch.launch.engine import Engine
from repro_torch.models import build_model as torch_build
from repro_torch.models import layers as TL

GEN, B, PROMPT = 8, 2, 40
# thresholds: rtol; threshold_ulps: float32 ulps of each threshold
F32 = dict(shared=1e-4, own=1e-4, threshold_ulps=16)
BF16 = dict(shared=0.06, own=0.06, thresholds=3e-2)
# case: (arch, config overrides, dtype, tolerances)
CASES = {
    "granite-8b": ("granite-8b", {}, "float32", F32),
    "stablelm-12b": ("stablelm-12b", {}, "float32", F32),
    "gemma3-12b": ("gemma3-12b", {}, "float32", {**F32, "threshold_ulps": 32}),
    # head dim 160 at widths the reference's quant_matmul tiles (n_heads x
    # 160 a multiple of 512, n_kv x 160 of 256): G = 2
    "stablelm-12b-d160": ("stablelm-12b",
                          dict(n_heads=16, n_kv_heads=8, head_dim=160),
                          "float32", F32),
    # head dim 256, G = 2, window 16
    "gemma3-12b-d256": ("gemma3-12b", dict(head_dim=256), "float32",
                        {**F32, "shared": 1.2e-2, "own": 1.2e-2}),
    "gemma3-12b-bf16": ("gemma3-12b", {}, "bfloat16", BF16),
}
# the layouts each case serves: gemma3 also through its rings
LAYOUTS = {name: ("dense", "ring") if arch == "gemma3-12b" else ("dense",)
           for name, (arch, *_) in CASES.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _readout_thresholds(qparams, cfg):
    """An untied lm_head's activation thresholds taken from the last
    block's ``wq`` (both inputs are a LayerNorm's output).  The reference's
    calibration never observes the readout's input, so its threshold stays
    at the 1e-8 floor and the int8 logits are ~1e-8 in both packages
    (``test_calibrated_thresholds_match`` pins that); the logit and token
    checks would hold for any readout, so they serve this one, in both
    packages alike."""
    if cfg.tie_embeddings:
        return qparams
    last = f"{cfg.name}/stack/layer{cfg.n_layers - 1}/attn/wq"
    head = f"{cfg.name}/lm_head"
    return {**qparams, head: {**qparams[head], "act": qparams[last]["act"]}}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, over, dtype, tol = CASES[request.param]
    jcfg = jax_config(arch, smoke=True).replace(**over,
                                                dtype=getattr(jnp, dtype))
    tcfg = torch_config(arch, smoke=True).replace(
        **over, dtype=getattr(torch, dtype))
    rng = np.random.default_rng(41)
    calib = [{"tokens": rng.integers(0, jcfg.vocab, (4, 32), dtype=np.int32)}
             for _ in range(2)]
    prompts = rng.integers(0, jcfg.vocab, (B, PROMPT), dtype=np.int32)
    ref = JaxEngine.from_checkpoint(
        cfg=jcfg, use_pallas=True, cache_layout="dense",
        calib_batches=[{"tokens": jnp.asarray(b["tokens"])} for b in calib])
    params = bridge.params_from_jax(_np(jax_build(jcfg).init(
        jax.random.PRNGKey(0))))
    ours = Engine.from_checkpoint(cfg=tcfg, params=params,
                                  calib_batches=calib, device="cpu",
                                  cache_layout="dense")
    calibrated = dict(ref=ref.qparams, ours=ours.qparams)
    # the port's own calibration, bridged: the reference serves it too
    own_np = _readout_thresholds(bridge.qparams_to_numpy(ours.qparams), tcfg)
    ref = JaxEngine(ref.model, ref.cfg, ref.policy, ref.serve_params,
                    _readout_thresholds(ref.qparams, jcfg), mode="int8",
                    cache_layout="dense")
    ours = Engine(ours.model, ours.cfg, ours.policy, ours.serve_params,
                  _readout_thresholds(ours.qparams, tcfg), device="cpu",
                  cache_layout="dense")
    shared = Engine.from_checkpoint(
        cfg=tcfg, params=params, device="cpu", cache_layout="dense",
        qparams=bridge.qparams_from_jax(_np(ref.qparams)))
    out = {}
    for layout in LAYOUTS[request.param]:
        r = JaxEngine(ref.model, ref.cfg, ref.policy, ref.serve_params,
                      ref.qparams, cache_layout=layout)
        o, sh = (Engine(e.model, e.cfg, e.policy, e.serve_params, e.qparams,
                        device="cpu", cache_layout=layout)
                 for e in (ours, shared))
        r_own = JaxEngine(ref.model, ref.cfg, ref.policy, ref.serve_params,
                          jax.tree.map(jnp.asarray, own_np),
                          cache_layout=layout)
        out[layout] = dict(
            ref=r, ref_own=r_own, ours=o, shared_engine=sh,
            ref_tokens=np.asarray(r.generate_batch(
                {"tokens": jnp.asarray(prompts)}, gen=GEN).tokens),
            ref_tokens_own=np.asarray(r_own.generate_batch(
                {"tokens": jnp.asarray(prompts)}, gen=GEN).tokens),
            out=o.generate_batch({"tokens": prompts}, gen=GEN),
            shared=sh.generate_batch({"tokens": prompts}, gen=GEN))
    return dict(name=request.param, ref=ref, ours=ours, jcfg=jcfg,
                prompts=prompts, tol=tol, dtype=dtype, layouts=out,
                calibrated=calibrated)


def _prefilled(case, layout):
    """Both packages' caches after the one-shot prefill of the prompts, the
    port serving the reference's thresholds."""
    lay = case["layouts"][layout]
    ref, shared, prompts = lay["ref"], lay["shared_engine"], case["prompts"]
    jcache = ref.init_cache(B, ref._cache_len(PROMPT, GEN))
    _, jcache = jax.jit(JST.make_prefill_step(
        ref.model, case["jcfg"], ref.policy, "int8"))(
        ref.serve_params, ref.qparams, {"tokens": jnp.asarray(prompts)},
        jcache)
    with torch.inference_mode():
        tcache = shared.init_cache(B, shared._cache_len(PROMPT, GEN))
        _, tcache = TST.make_prefill_step(shared.model, shared.policy)(
            shared.serve_params, shared.qparams,
            {"tokens": torch.from_numpy(prompts)}, tcache)
    return jcache, tcache


def test_int8_weights_bit_identical(case):
    n = 0
    for path, want, got in _walk_int8(case["ref"].serve_params,
                                      case["ours"].serve_params):
        np.testing.assert_array_equal(got, want, err_msg=path)
        n += 1
    untied = not case["ours"].cfg.tie_embeddings
    assert n == 2 * (7 * case["ours"].cfg.n_layers + untied)


def _walk_int8(a, b, path=""):
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _walk_int8(v, b[k], f"{path}/{k}")
        elif k in ("w_q", "w_scale"):
            yield f"{path}/{k}", np.asarray(v), b[k].numpy()


def test_calibrated_thresholds_match(case):
    """Both packages' calibrations, as they come (before
    ``_readout_thresholds``): an untied readout's activation threshold is
    the floor in both."""
    ref = _np(case["calibrated"]["ref"])
    ours = case["calibrated"]["ours"]
    assert set(ref) == set(ours)
    cfg = case["jcfg"]
    if not cfg.tie_embeddings:
        for qp in (ref, ours):
            assert float(qp[f"{cfg.name}/lm_head"]["act"]["t_max"]) == (
                pytest.approx(1e-8))
    tol = case["tol"]
    for path, entry in ref.items():
        for group, leaves in entry.items():
            for name, want in leaves.items():
                got = ours[path][group][name].numpy()
                where = f"{path}/{group}/{name}"
                if "threshold_ulps" not in tol:
                    np.testing.assert_allclose(got, want,
                                               rtol=tol["thresholds"],
                                               atol=0, err_msg=where)
                    continue
                ulps = np.abs(got.astype(np.float64) - want) / np.spacing(
                    np.abs(want).astype(np.float32))
                assert ulps.max() <= tol["threshold_ulps"], (where, ulps)


def test_kv_tiles_bit_identical_after_prefill(case):
    """KV tiles and scales after prefill, from the shared thresholds: every
    layer's layout and scales, and layer 0's tiles, equal the reference's
    (dense caches, and gemma3's rings: the last 16 of 40 positions, rolled
    so position p sits at slot p % 16, beside its dense global layers);
    each of the port's rings holds its dense cache's last 16 positions,
    rolled, bit for bit."""
    caches = {}
    for layout in case["layouts"]:
        jcache, tcache = _prefilled(case, layout)
        caches[layout] = tcache
        kinds = set()
        for i in range(case["jcfg"].n_layers):
            ja, ta = jcache[f"layer{i}"]["attn"], tcache[f"layer{i}"]["attn"]
            assert (ta.layout, ta.capacity) == (ja.layout, ja.capacity)
            kinds.add(ta.layout)
            keys = ("k_scale", "v_scale") + (("k", "v") if i == 0 else ())
            for key in keys:
                np.testing.assert_array_equal(
                    getattr(ta, key).numpy(), np.asarray(ja[key]),
                    err_msg=f"{layout} layer{i} {key}")
        assert kinds == ({"ring", "dense"} if layout == "ring"
                         else {"dense"})
    if "ring" in caches:
        for i in range(case["jcfg"].n_layers):
            ring = caches["ring"][f"layer{i}"]["attn"]
            dense = caches["dense"][f"layer{i}"]["attn"]
            if ring.layout != "ring":
                continue
            w = ring.window
            for key in ("k", "v"):
                last = getattr(dense, key)[:, PROMPT - w:PROMPT]
                assert torch.equal(getattr(ring, key),
                                   torch.roll(last, PROMPT % w, dims=1))


def _ref_logits(case, layout, which, scale=1.0):
    """The reference's prefill logits of the last position, serving the
    ``which`` thresholds (its own, "shared", or the port's own calibration,
    "own"), every activation threshold multiplied by ``scale``."""
    lay = case["layouts"][layout]
    ref = lay["ref" if which == "shared" else "ref_own"]
    qp = ref.qparams
    if scale != 1.0:
        f = np.float32(scale)
        qp = {p: {g: {n: v * f if g == "act" and n.startswith("t_") else v
                      for n, v in leaves.items()}
                  for g, leaves in entry.items()} for p, entry in qp.items()}
    cache = ref.init_cache(B, ref._cache_len(PROMPT, GEN))
    step = lay.setdefault(f"prefill_step_{which}", jax.jit(
        JST.make_prefill_step(ref.model, case["jcfg"], ref.policy, "int8")))
    logits, _ = step(ref.serve_params, qp,
                     {"tokens": jnp.asarray(case["prompts"])}, cache)
    return np.asarray(logits, np.float32)[:, -1]


# the one- and two-ulp moves of every activation threshold
ULP_SCALES = tuple(1.0 + k * 2.0 ** -23 for k in (-2, -1, 1, 2))


@pytest.mark.parametrize("which", ["shared", "own"])
def test_prefill_logits_match(case, which):
    """The port's prefill logits against the reference's, both serving the
    same thresholds (the reference's, or the port's own calibration),
    within atol ``which``, or within the reference's own last-bit
    sensitivity where that is larger: the largest move of its logits when
    its activation thresholds move by one or two float32 ulps
    (gemma3-12b-d256: 0.0138 to 0.0267; every other case 0)."""
    for layout, lay in case["layouts"].items():
        want = _ref_logits(case, layout, which)
        got = lay["shared" if which == "shared" else "out"].prefill_logits
        gap = np.abs(got.float().numpy() - want).max()
        if gap <= case["tol"][which]:
            continue
        self_gap = max(np.abs(_ref_logits(case, layout, which, f)
                              - want).max() for f in ULP_SCALES)
        assert gap <= self_gap, (layout, gap, self_gap)


def _forced_margins(engine, prompts, tokens):
    """Per step and row: the port's max logit minus its logit of the given
    token, teacher-forcing the port with ``tokens``."""
    toks = torch.tensor(tokens, dtype=torch.long)
    with torch.inference_mode():
        cache = engine.init_cache(B, engine._cache_len(PROMPT, GEN))
        ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
        logits, cache = engine.model.prefill(
            engine.serve_params, {"tokens": torch.from_numpy(prompts)},
            cache, ctx)
        margins = []
        for i in range(GEN):
            lg = logits[:, -1].float()
            margins.append(lg.max(-1).values
                           - lg.gather(-1, toks[:, i:i + 1])[:, 0])
            if i < GEN - 1:
                logits, cache = engine.model.decode_step(
                    engine.serve_params, toks[:, i:i + 1], cache,
                    PROMPT + i, ctx)
    return torch.stack(margins, dim=1).numpy()


@pytest.mark.parametrize("which", ["shared", "own"])
def test_greedy_tokens_match(case, which):
    """The port's generate_batch (its programs; on the CPU run eagerly)
    against the reference's serving the same thresholds (the reference's,
    or the port's own calibration), in every layout of the case: float32 tokens
    identical; bf16 teacher-forced with the reference's tokens, each the
    port's argmax or within the logit tolerance of it; and the port's
    eager loop=True driver against the programs bit for bit."""
    for layout, lay in case["layouts"].items():
        out = lay["shared" if which == "shared" else "out"]
        got = out.tokens.numpy()
        assert got.shape == (B, GEN)
        engine = lay["shared_engine" if which == "shared" else "ours"]
        eager = engine.generate_batch({"tokens": case["prompts"]}, gen=GEN,
                                      loop=True)
        assert torch.equal(eager.tokens, out.tokens)
        assert torch.equal(eager.prefill_logits, out.prefill_logits)
        # the reference serving the same thresholds
        want = lay["ref_tokens" if which == "shared" else "ref_tokens_own"]
        if case["dtype"] == "float32":
            np.testing.assert_array_equal(got, want, err_msg=layout)
            continue
        margins = _forced_margins(engine, case["prompts"], want)
        assert margins.max() <= case["tol"][which], (layout, margins)


def test_windowed_layers_and_caches(case):
    """The stack's layers and caches: gemma3's 5:1 local:global pattern
    (window 16 on layers 0-4, none on 5), rings of 16 slots in the "ring"
    layout only; no window elsewhere.  Its rings hold only the last window
    of positions, yet the windowed layers see no other: ring and dense
    serve the same tokens, in both packages."""
    model = case["ours"].model
    windows = [blk.attn.window for blk in model.stack.blocks]
    assert windows == [case["jcfg"].attn_window(i)
                       for i in range(case["jcfg"].n_layers)]
    for layout, lay in case["layouts"].items():
        caches = lay["ours"].init_cache(B, 128)
        for i, w in enumerate(windows):
            c = caches[f"layer{i}"]["attn"]
            ring = layout == "ring" and w is not None
            assert (c.layout, c.capacity) == (("ring", w) if ring
                                              else ("dense", 128))
    if "ring" in case["layouts"]:
        assert windows == [16] * 5 + [None]
        lay = case["layouts"]
        assert torch.equal(lay["ring"]["shared"].tokens,
                           lay["dense"]["shared"].tokens)
        np.testing.assert_array_equal(lay["ring"]["ref_tokens"],
                                      lay["dense"]["ref_tokens"])
    else:
        assert set(windows) == {None}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """LayerNorm (stablelm) against the reference's, elementwise, with a
    random scale and bias: float32 to rtol 1e-6 (the two packages' means
    sum in other orders and their rsqrt differ in the last bit; scale and
    bias are one fused multiply-add in both), bf16 output to one bf16
    step (2^-7 relative)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 7, 96)) * 3 + 1).astype(np.float32)
    params = {"scale": rng.normal(size=96).astype(np.float32),
              "bias": rng.normal(size=96).astype(np.float32)}
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(JL.LayerNorm(96, path="n")(
        {k: jnp.asarray(v) for k, v in params.items()}, jx), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = TL.LayerNorm(96, path="n")(
        {k: torch.from_numpy(v) for k, v in params.items()}, tx)
    assert got.dtype == tx.dtype
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_the_references_tanh_form(dtype):
    """gelu against ``jax.nn.gelu`` (the tanh approximation): float32 to
    atol 1e-6 over [-6, 6] (the two tanh differ by up to 2 ulps of 1, and
    x (1 + tanh) / 2 carries that, times |x| <= 6, where tanh is near -1;
    measured 5.8e-7), bf16 to one bf16 step (2^-7 relative) and atol 2^-8
    (XLA rounds each bf16 intermediate, so 1 + tanh cancels near tanh =
    -1; torch rounds once: measured 0.003); the erf form is ~1e-4 and more
    away, outside the float32 bound."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = np.asarray(JL.gelu(jnp.asarray(x).astype(getattr(jnp, dtype))),
                      np.float32)
    got = TL.gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    rtol, atol = (1e-6, 1e-6) if dtype == "float32" else (2 ** -7, 2 ** -8)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("arch", ["stablelm-12b", "gemma3-12b"])
def test_fat_step_loss_and_gradients_match(arch):
    """The paper's FAT step (fp teacher, fake-quant student, RMSE over the
    logits) through LayerNorm (stablelm) and GeGLU with sliding windows
    (gemma3) at SMOKE in float32, from the reference's init and its
    calibrated int4-KV thresholds (``train_thresholds=True``), bridged:
    the loss to rtol 1e-4 and every alpha and KV log2_t gradient to rtol
    2e-3, atol 1e-4 x the largest of its kind (``test_torch_train.py``'s
    tolerances for smollm)."""
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config(arch, smoke=True).replace(dtype=torch.float32)
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(_np(jparams))
    rng = np.random.default_rng(12)
    batches = [rng.integers(0, jcfg.vocab, (4, 32), dtype=np.int32)
               for _ in range(2)]
    jpol = JA.QuantPolicy(kv_int8=True, kv_bits=4)
    tpol = TA.QuantPolicy(kv_int8=True, kv_bits=4)
    jq = JA.init_qparams(jm, jparams, jpol)
    jstep = jax.jit(JST.make_calibrate_step(jm, jcfg, jpol))
    for toks in batches:
        jq = jstep(jparams, jq, {"tokens": jnp.asarray(toks)})
    jq = JA.finalize_calibration(jq, jpol, train_thresholds=True)
    batch = {"tokens": jnp.asarray(batches[0])}

    def loss_for(qp, params):                  # the reference's loss_for
        h_t, _ = jm.hidden(params, batch, None, remat=jcfg.remat)
        h_t = jax.lax.stop_gradient(h_t)
        ctx = JA.make_ctx("fake", jpol, qp)
        h_s, _ = jm.hidden(params, batch, ctx, remat=jcfg.remat)
        sq, n = jax_chunked_sq_err(h_t, h_s, jm.readout_fn(params, None),
                                   jm.readout_fn(params, ctx),
                                   chunk=jcfg.loss_chunk)
        return jnp.sqrt(sq / n)

    want_loss, want = jax.jit(jax.value_and_grad(loss_for))(jq, jparams)
    want = TA.flatten(_np(want))
    loss, grads = TST.make_fat_grad_fn(tm, tpol)(
        tparams, bridge.qparams_from_jax(_np(jq)),
        {"tokens": torch.from_numpy(batches[0])})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert sum(k[-1] == "log2_t" for k in grads) == 2 * jcfg.n_layers
    for kind in ("alpha", "log2_t"):
        keys = [k for k in grads if k[-1] == kind]
        scale = max(np.abs(want[k]).max() for k in keys)
        assert keys
        for k in keys:
            # a kind whose reference gradients are all zero (stablelm's
            # KV log2_t at this seed) must be all zero in the port too
            np.testing.assert_allclose(grads[k].numpy(), want[k], rtol=2e-3,
                                       atol=1e-4 * scale, err_msg=str(k))
