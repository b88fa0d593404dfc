"""Each module of the port against its counterpart in the reference.

Both packages run at float32 here: the point is the algorithm, and bf16
rounds at different places in XLA and PyTorch.  Weights and inputs are
made with numpy (or by the reference's init) and cross over through
``repro_torch.bridge``.  Integer state (int8 weights, int8 KV tiles) must
be bit-identical; float state is compared at the tolerance each test
states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import api as JA
from repro.launch import steps as JST
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.models.module import Dense as JDense
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.launch import steps as TST
from repro_torch.models import build_model as torch_build
from repro_torch.models import layers as TL
from repro_torch.models.module import Dense as TDense

# a 2-layer, narrow variant of the full config that keeps GQA (G = 3); the
# smoke config has n_heads == n_kv_heads
G3 = dict(name="smollm-135m-g3", n_layers=2, d_model=96, n_heads=6,
          n_kv_heads=2, head_dim=16, d_ff=128, vocab=200, attn_q_chunk=16,
          attn_kv_chunk=16, loss_chunk=16)
B, S = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return bridge.to_tensor(np.asarray(a))


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_field_by_field(smoke):
    jc, tc = jax_config("smollm-135m", smoke), torch_config("smollm-135m",
                                                            smoke)
    for f in dataclasses.fields(jc):
        if f.name != "dtype":
            assert getattr(jc, f.name) == getattr(tc, f.name), f.name
    assert (jc.vocab_padded, jc.head_dim) == (tc.vocab_padded, tc.head_dim)
    assert tc.dtype == torch.bfloat16


def test_bridge_keeps_bf16_bits():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(5, 7)),
                    jnp.bfloat16)
    t = bridge.params_from_jax({"a": {"w": np.asarray(x)}})["a"]["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.uint16).numpy(),
                                  np.asarray(x).view(np.uint16))


def test_rmsnorm():
    x = np.random.default_rng(1).normal(size=(3, 5, 24)).astype(np.float32)
    scale = np.random.default_rng(2).random(24).astype(np.float32) + 0.5
    want = JL.RMSNorm(24, path="n", dtype=jnp.float32)(
        {"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = TL.RMSNorm(24, path="n", dtype=torch.float32)(
        {"scale": _t(scale)}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_rotary():
    """Angles from the same float32 frequency table; rotate-half."""
    pos = np.arange(40, dtype=np.int32)
    x = np.random.default_rng(3).normal(size=(2, 40, 3, 16)).astype(
        np.float32)
    cj, sj = JL.rotary_angles(jnp.asarray(pos), 16)
    ct, st = TL.rotary_angles(torch.from_numpy(pos), 16)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)
    want = JL.apply_rotary(jnp.asarray(x), cj, sj)
    got = TL.apply_rotary(_t(x), ct, st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_embedding_readout_masks_padded_vocab():
    table = np.random.default_rng(4).normal(size=(256, 8)).astype(np.float32)
    h = np.random.default_rng(5).normal(size=(2, 3, 8)).astype(np.float32)
    je = JL.Embedding(200, 8, path="e", dtype=jnp.float32)
    te = TL.Embedding(200, 8, path="e", dtype=torch.float32)
    want = np.asarray(je.attend({"table": jnp.asarray(table)},
                                jnp.asarray(h)))
    got = te.attend({"table": _t(table)}, _t(h)).numpy()
    assert te.vocab_padded == je.vocab_padded == 256
    np.testing.assert_array_equal(got[..., 200:], -1e9)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    toks = np.array([[0, 199, 7]], np.int32)
    np.testing.assert_array_equal(
        te({"table": _t(table)}, torch.from_numpy(toks).long()).numpy(),
        np.asarray(je({"table": jnp.asarray(table)}, jnp.asarray(toks))))


@pytest.mark.parametrize("mode", ["calibrate", "int8"])
def test_dense_modes(mode):
    """One Dense through calibration and (after conversion) int8 mode."""
    rng = np.random.default_rng(6)
    w = rng.normal(size=(40, 24)).astype(np.float32) / 6
    x = rng.normal(size=(3, 7, 40)).astype(np.float32)
    jd = JDense(40, 24, path="d", dtype=jnp.float32)
    td = TDense(40, 24, path="d", dtype=torch.float32)
    # the reference's kernel path (Pallas in interpret mode): its epilogue
    # rounds to bf16 like the port's
    jpol, tpol = JA.QuantPolicy(use_pallas=True), TA.QuantPolicy()

    class One:           # a one-layer "model" for the qparams walkers
        def __init__(self, d):
            self.d = d

        def walk_with_params(self, params):
            yield self.d, params

    jq = JA.init_qparams(One(jd), {"w": jnp.asarray(w)}, jpol)
    tq = TA.init_qparams(One(td), {"w": _t(w)}, tpol)
    jctx = JA.make_ctx("calibrate", jpol, jq)
    tctx = TA.make_ctx("calibrate", tpol, tq)
    yj = jd({"w": jnp.asarray(w)}, jnp.asarray(x), jctx)
    yt = td({"w": _t(w)}, _t(x), tctx)
    if mode == "calibrate":
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-5)
        for key in ("t_max", "t_min", "t_hi", "count"):
            np.testing.assert_array_equal(
                tctx.updates["d"][key].numpy(),
                np.asarray(jctx.updates["d"][key]))
        return
    jq = JA.finalize_calibration({"d": {**jq["d"], "act":
                                        jctx.updates["d"]}}, jpol)
    tq = TA.finalize_calibration({"d": {**tq["d"], "act":
                                        tctx.updates["d"]}})
    jp = JA.convert_to_int8(One(jd), {"w": jnp.asarray(w)}, jq, jpol)
    tp = TA.convert_to_int8(One(td), {"w": _t(w)}, tq, tpol)
    np.testing.assert_array_equal(tp["w_q"].numpy(), np.asarray(jp["w_q"]))
    yj = jax.jit(lambda p, x: jd(p, x, JA.make_ctx("int8", jpol, jq)))(
        jp, jnp.asarray(x))
    yt = td(tp, _t(x), TA.make_ctx("int8", tpol, tq))
    # same int8 operands, same int32 sums, same epilogue rounding
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.fixture(scope="module")
def calibrated():
    """Both packages calibrated on the same numpy batches from the same
    weights (the reference's init, bridged)."""
    jcfg = jax_config("smollm-135m").replace(**G3, dtype=jnp.float32)
    tcfg = torch_config("smollm-135m").replace(**G3, dtype=torch.float32)
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(_np(jparams))
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, G3["vocab"], (B, S), dtype=np.int32)
               for _ in range(2)]
    jpol = JA.QuantPolicy(kv_int8=True, use_pallas=True)
    tpol = TA.QuantPolicy(kv_int8=True)
    jq = JA.init_qparams(jm, jparams, jpol)
    tq = TA.init_qparams(tm, tparams, tpol)
    jstep = jax.jit(JST.make_calibrate_step(jm, jcfg, jpol))
    tstep = TST.make_calibrate_step(tm, tpol)
    for toks in batches:
        jq = jstep(jparams, jq, {"tokens": jnp.asarray(toks)})
        tq = tstep(tparams, tq, {"tokens": torch.from_numpy(toks)})
    jq = JA.finalize_calibration(jq, jpol)
    tq = TA.finalize_calibration(tq)
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, tm=tm, jparams=jparams,
                tparams=tparams, jpol=jpol, tpol=tpol, jq=jq, tq=tq,
                prompts=rng.integers(0, G3["vocab"], (B, S), dtype=np.int32))


def test_calibrated_thresholds_match(calibrated):
    """Every threshold leaf, activation and KV, to rtol 1e-6 (float32 sums
    in another order through two layers of calibration forward)."""
    jq, tq = _np(calibrated["jq"]), calibrated["tq"]
    assert set(jq) == set(tq)
    assert sum(p.endswith("/kv") for p in tq) == G3["n_layers"]
    for path, entry in jq.items():
        for group, leaves in entry.items():
            for name, want in leaves.items():
                got = tq[path][group][name].numpy()
                assert got.dtype == want.dtype, (path, group, name)
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                           err_msg=f"{path}/{group}/{name}")


def test_convert_to_int8_bit_identical(calibrated):
    c = calibrated
    jp = _np(JA.convert_to_int8(c["jm"], c["jparams"], c["jq"], c["jpol"]))
    tp = TA.convert_to_int8(c["tm"], c["tparams"], c["tq"], c["tpol"])
    n = 0
    for (jl, jsub), (tl, tsub) in zip(c["jm"].walk_with_params(jp),
                                      c["tm"].walk_with_params(tp)):
        assert jl.path == tl.path
        if isinstance(tl, TDense):
            np.testing.assert_array_equal(tsub["w_q"].numpy(), jsub["w_q"])
            np.testing.assert_array_equal(tsub["w_scale"].numpy(),
                                          jsub["w_scale"])
            n += 1
    assert n == 7 * G3["n_layers"]


def test_prefill_writes_bit_identical_int8_cache(calibrated):
    """From the same thresholds (the reference's, bridged), one-shot
    prefill writes every layer's int8 K/V tiles and per-head scales
    exactly as the reference's kernel path (Pallas in interpret mode)
    does; the last-position logits agree to atol 1e-4."""
    c = calibrated
    tq = bridge.qparams_from_jax(_np(c["jq"]))
    jp = JA.convert_to_int8(c["jm"], c["jparams"], c["jq"], c["jpol"])
    tp = TA.convert_to_int8(c["tm"], c["tparams"], tq, c["tpol"])
    jcache = c["jm"].init_cache(B, 128, jnp.float32, kv_int8=True,
                                layout="dense")
    jl, jcache = jax.jit(JST.make_prefill_step(c["jm"], c["jcfg"], c["jpol"],
                                               "int8"))(
        jp, c["jq"], {"tokens": jnp.asarray(c["prompts"])}, jcache)
    tcache = c["tm"].init_cache(B, 128)
    tl, tcache = TST.make_prefill_step(c["tm"], c["tpol"])(
        tp, tq, {"tokens": torch.from_numpy(c["prompts"])}, tcache)
    for i in range(G3["n_layers"]):
        ja, ta = jcache[f"layer{i}"]["attn"], tcache[f"layer{i}"]["attn"]
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(ta, key).numpy(),
                                          np.asarray(ja[key]),
                                          err_msg=f"layer{i} {key}")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)


def test_kv_quantize_and_scale_floor_match_reference():
    """``with_scales`` floors zero and NaN thresholds exactly as the
    reference does, and ``ready`` writes the same int8 tiles."""
    from repro.cache import DenseCache as JCache
    from repro_torch.cache import DenseCache as TCache

    rng = np.random.default_rng(9)
    k = (rng.normal(size=(2, 8, 3, 16)) * 4).astype(np.float32)
    v = (rng.normal(size=(2, 8, 3, 16)) * 4).astype(np.float32)
    ks = np.array([0.03, 0.0, np.nan], np.float32)
    vs = np.array([1e-12, 0.02, 0.5], np.float32)
    jc = JCache.init(2, 8, 3, 16, dtype=jnp.float32, quantized=True)
    jc = jc.with_scales(jnp.asarray(ks), jnp.asarray(vs))
    tc = TCache.init(2, 8, 3, 16).with_scales(_t(ks), _t(vs))
    for got, want in zip(tc.scales(), jc.scales()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tc.ready(_t(k), _t(v)),
                         jc.ready(jnp.asarray(k), jnp.asarray(v))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tc.append(*tc.ready(_t(k[:, :3]), _t(v[:, :3])), 5)
    with pytest.raises(ValueError, match="overruns"):
        tc.append(*tc.ready(_t(k[:, :4]), _t(v[:, :4])), 5)
