"""bf16 serving: the reference's three other serving modes in the port.

The modes are the reference Engine's ``fp`` and ``kv_int8`` flags:

  * ``bf16_w_bf16_kv`` (fp, no KV quantization): no calibration pass; every
    Dense is ``x @ w``; the prompt attends its float K/V through the
    prefill kernel with unit scales; decode attends the float cache in
    plain attention (the reference's jnp ``decode_attention``);
  * ``bf16_w_int8_kv`` (fp, int8 KV): calibrated KV thresholds, the
    weights unconverted; both attention kernels over the int8 cache;
  * ``int8_w_bf16_kv`` (int8 weights, float KV): calibrated activation
    thresholds, int8 weights through quant_matmul, the float cache as in
    the first mode.

The reference is ``repro.launch.engine.Engine`` with ``use_pallas=True``
(its kernels in interpret mode), as in ``test_torch_engine.py``, whose
tolerances these are: "float32" and "bfloat16" name the config's dtype,
which is the weights' and the float cache's.  "shared" serves the port
with the reference's qparams, bridged; "own" calibrates in the port.

  * float32, shared: logits to atol 1e-4, tokens identical.  Own: a
    threshold that differs in its last bit now and then moves an int8
    activation or KV element by one step (logits ~1e-2): atol 2e-2, tokens
    identical on these seeds.  Without calibration (bf16_w_bf16_kv) own is
    shared.
  * bfloat16: logits to atol 0.06, and the port teacher-forced with the
    reference's tokens: each must be the port's argmax or within 0.06 of
    it (bf16 rounds at other places in the two frameworks).

The kernel-level checks hold ``ops.prefill_attention`` / ``_view`` over a
bf16 K/V stream, and the port's plain ``decode_attention``, against the
reference's at 1e-5 x (1 + max |out|) (float32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import DenseCache as JDense
from repro.cache import PagedCache as JPaged
from repro.cache import paged as jpaged
from repro.configs import get_config as jax_config
from repro.kernels import ops as kops
from repro.kernels import prefill_attention as jpa
from repro.launch import steps as JST
from repro.launch.engine import Engine as JaxEngine
from repro.launch.scheduler import Request as JRequest
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.bridge import to_tensor
from repro_torch.cache import DenseCache, KernelView, PagedCache
from repro_torch.cache import paged as tpaged
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.kernels import ops
from repro_torch.launch.engine import Engine
from repro_torch.launch.scheduler import Request
from repro_torch.models import attention as tattn

G3 = dict(name="smollm-135m-g3", n_layers=2, d_model=96, n_heads=6,
          n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, attn_q_chunk=16,
          attn_kv_chunk=16, loss_chunk=16)
GEN = 8
MODES = {"bf16_w_bf16_kv": dict(fp=True, kv_int8=False),
         "bf16_w_int8_kv": dict(fp=True, kv_int8=True),
         "int8_w_bf16_kv": dict(fp=False, kv_int8=False)}
TOL = {"float32": dict(shared=1e-4, own=2e-2, thresholds=1e-6),
       "bfloat16": dict(shared=0.06, own=0.06, thresholds=3e-2)}
ATTN_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(dtype, smoke=False):
    jcfg = jax_config("smollm-135m", smoke=smoke)
    tcfg = torch_config("smollm-135m", smoke=smoke)
    if not smoke:
        jcfg, tcfg = jcfg.replace(**G3), tcfg.replace(**G3)
    return (jcfg.replace(dtype=getattr(jnp, dtype)),
            tcfg.replace(dtype=getattr(torch, dtype)))


@pytest.fixture(scope="module",
                params=[(m, d) for m in MODES for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    mode, dtype = request.param
    flags = MODES[mode]
    jcfg, tcfg = _configs(dtype)
    rng = np.random.default_rng(23)
    calib = [{"tokens": rng.integers(0, jcfg.vocab, (4, 32), dtype=np.int32)}
             for _ in range(2)]
    prompts = rng.integers(0, jcfg.vocab, (2, 16), dtype=np.int32)

    ref = JaxEngine.from_checkpoint(
        cfg=jcfg, use_pallas=True, cache_layout="dense",
        calib_batches=[{"tokens": jnp.asarray(b["tokens"])} for b in calib],
        **flags)
    params = _np(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    ours = Engine.from_checkpoint(cfg=tcfg,
                                  params=bridge.params_from_jax(params),
                                  calib_batches=calib, device="cpu", **flags)
    shared = Engine.from_checkpoint(
        cfg=tcfg, params=bridge.params_from_jax(params), device="cpu",
        qparams=bridge.qparams_from_jax(_np(ref.qparams)), **flags)
    ref_out = ref.generate_batch({"tokens": jnp.asarray(prompts)}, gen=GEN)
    cache = ref.init_cache(2, ref._cache_len(prompts.shape[1], GEN))
    ref_logits, _ = jax.jit(JST.make_prefill_step(
        ref.model, jcfg, ref.policy, ref.mode))(
        ref.serve_params, ref.qparams, {"tokens": jnp.asarray(prompts)},
        cache)
    return dict(mode=mode, flags=flags, dtype=dtype, tol=TOL[dtype], ref=ref,
                ours=ours, shared_engine=shared, prompts=prompts,
                params=params, ref_tokens=np.asarray(ref_out.tokens),
                ref_logits=np.asarray(ref_logits, np.float32)[:, -1],
                out=ours.generate_batch({"tokens": prompts}, gen=GEN),
                shared=shared.generate_batch({"tokens": prompts}, gen=GEN))


def test_serving_params_and_mode(pair):
    """bf16 weights serve the params as they are (no int8 tensor); int8
    weights are the reference's bit for bit."""
    ours = pair["ours"]
    assert ours.mode == pair["ref"].mode == (
        "none" if pair["flags"]["fp"] else "int8")
    if pair["flags"]["fp"]:
        assert ours.n_int8_weights() == pair["ref"].n_int8_weights() == 0
        want = bridge.params_from_jax(pair["params"])
        got = ours.serve_params
        for name in ("wq", "wo"):
            assert torch.equal(got["stack"]["layer0"]["attn"][name]["w"],
                               want["stack"]["layer0"]["attn"][name]["w"])
        return
    ref = _np(pair["ref"].serve_params)["stack"]["layer1"]["ffn"]["down"]
    got = ours.serve_params["stack"]["layer1"]["ffn"]["down"]
    np.testing.assert_array_equal(got["w_q"].numpy(), ref["w_q"])
    np.testing.assert_array_equal(got["w_scale"].numpy(), ref["w_scale"])


def test_qparams_tree_matches_reference(pair):
    """The reference's qparams tree: KV entries only with ``kv_int8``;
    calibrated thresholds within the dtype's tolerance."""
    ref = _np(pair["ref"].qparams)
    ours = pair["ours"].qparams
    assert set(ours) == set(ref)
    assert any(TA.is_kv_path(p) for p in ours) == pair["flags"]["kv_int8"]
    for path, entry in ref.items():
        for group, leaves in entry.items():
            assert set(ours[path][group]) == set(leaves)
            for name, want in leaves.items():
                np.testing.assert_allclose(
                    ours[path][group][name].float().numpy(),
                    np.asarray(want, np.float32),
                    rtol=pair["tol"]["thresholds"], atol=0,
                    err_msg=f"{path}/{group}/{name}")


def test_cache_storage(pair):
    """An int8 cache with ``kv_int8``, else the config's dtype with unit
    scales, as the reference's ``init_cache``; dense and paged."""
    for layout in ("dense", "paged"):
        tc = pair["ours"].init_cache(2, 64, layout=layout, page_size=16)
        jc = pair["ref"].init_cache(2, 64, layout=layout, page_size=16)
        t, j = tc["layer0"]["attn"], jc["layer0"]["attn"]
        assert t.quantized == j.quantized == pair["flags"]["kv_int8"]
        assert str(t.k.dtype).split(".")[-1] == str(j.k.dtype)
        assert tuple(t.k.shape) == tuple(j.k.shape)
        np.testing.assert_array_equal(t.k_scale.numpy(),
                                      np.asarray(j.k_scale))


@pytest.mark.parametrize("which", ["shared", "own"])
def test_prefill_logits_match(pair, which):
    got = pair["out" if which == "own" else which]
    got = got.prefill_logits.float().numpy()
    assert got.shape == pair["ref_logits"].shape
    np.testing.assert_allclose(got, pair["ref_logits"], rtol=0,
                               atol=pair["tol"][which])


def _forced_margins(engine, prompts, tokens):
    """Per step and row: the port's max logit minus its logit of the given
    token, teacher-forcing the port with ``tokens``."""
    b, s = prompts.shape
    toks = torch.tensor(tokens, dtype=torch.long)
    with torch.inference_mode():
        cache = engine.init_cache(b, engine._cache_len(s, GEN))
        ctx = TA.make_ctx(engine.mode, engine.policy, engine.qparams)
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
                    engine.serve_params, toks[:, i:i + 1], cache, s + i, ctx)
    return torch.stack(margins, dim=1).numpy()


@pytest.mark.parametrize("which", ["shared", "own"])
def test_greedy_tokens_match(pair, which):
    got = pair["out" if which == "own" else which].tokens.numpy()
    assert got.shape == (2, GEN)
    if pair["dtype"] == "float32":
        np.testing.assert_array_equal(got, pair["ref_tokens"])
        return
    engine = pair["shared_engine" if which == "shared" else "ours"]
    margins = _forced_margins(engine, pair["prompts"], pair["ref_tokens"])
    assert margins.max() <= pair["tol"][which], margins


@pytest.mark.parametrize("mode", ["bf16_w_bf16_kv", "int8_w_bf16_kv"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_bf16_cache_bit_identical_to_dense(mode, dtype):
    """A paged bf16 pool is storage indirection only: chunked prefill and
    decode give the dense cache's logits and tokens bit for bit."""
    _, tcfg = _configs(dtype)
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab, (3, 21),
                                                dtype=np.int32)
    out = {}
    for layout in ("dense", "paged"):
        eng = Engine.from_checkpoint(cfg=tcfg, device="cpu", init_seed=3,
                                     cache_layout=layout, page_size=8,
                                     prefill_chunk=8, **MODES[mode])
        out[layout] = eng.generate_batch({"tokens": prompts}, gen=6)
    assert torch.equal(out["paged"].prefill_logits,
                       out["dense"].prefill_logits)
    assert torch.equal(out["paged"].tokens, out["dense"].tokens)


# ---------------------------------------------------------------------------
# the scheduler against the reference's, over a bf16 (float32 here) cache
# ---------------------------------------------------------------------------

PAGE, CHUNK, SLOTS, BLOCK = 8, 8, 2, 3
LENGTHS = (9, 20, 3, 17, 24)


def _summary(done):
    return sorted((c.rid, [int(t) for t in c.tokens], c.finished_by,
                   c.status) for c in done)


@pytest.mark.parametrize("mode", ["bf16_w_bf16_kv", "int8_w_bf16_kv"])
def test_scheduler_completions_match_reference(mode):
    """Float32 smoke config, paged float cache: the reference
    ``SlotScheduler`` and the port's give identical completions (rid,
    tokens, finished_by, status), and the port's dense layout the same."""
    jcfg, tcfg = _configs("float32", smoke=True)
    rng = np.random.default_rng(37)
    calib = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (4, 32),
                                                 dtype=np.int32))}
             for _ in range(2)]
    knobs = dict(cache_layout="paged", page_size=PAGE, prefill_chunk=CHUNK,
                 **MODES[mode])
    ref = JaxEngine.from_checkpoint(cfg=jcfg, use_pallas=True,
                                    calib_batches=calib, **knobs)
    ours = Engine.from_checkpoint(
        cfg=tcfg, device="cpu",
        params=bridge.params_from_jax(_np(jax_build(jcfg).init(
            jax.random.PRNGKey(0)))),
        qparams=bridge.qparams_from_jax(_np(ref.qparams)), **knobs)
    prompts = [rng.integers(0, jcfg.vocab, (n,), dtype=np.int32)
               for n in LENGTHS]
    kw = dict(max_slots=SLOTS, block_steps=BLOCK)
    want = _summary(ref.generate([JRequest(rid=i, tokens=p, max_gen=6)
                                  for i, p in enumerate(prompts)], **kw))
    assert all(len(t) == 6 and st == "ok" for _, t, _, st in want)
    got = _summary(ours.generate([Request(rid=i, tokens=p, max_gen=6)
                                  for i, p in enumerate(prompts)], **kw))
    assert got == want
    dense = Engine(ours.model, ours.cfg, ours.policy, ours.serve_params,
                   ours.qparams, device="cpu", mode=ours.mode,
                   cache_layout="dense", prefill_chunk=CHUNK)
    assert _summary(dense.generate([Request(rid=i, tokens=p, max_gen=6)
                                    for i, p in enumerate(prompts)],
                                   **kw)) == want
    cache = ours._scheduler._cache["layer0"]["attn"]
    assert isinstance(cache, PagedCache) and cache.k.dtype == torch.float32


# ---------------------------------------------------------------------------
# the prefill kernel's float K/V stream and the plain decode attention
# ---------------------------------------------------------------------------

def _float_kv(rng, shape, dtype):
    return rng.normal(size=shape).astype(np.float32).astype(dtype)


def _close(got, want, tol=ATTN_TOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (1 + np.abs(want).max()))


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("window", [None, 5])
def test_prefill_attention_bf16_kv_matches_reference(q_dtype, window):
    """``ops.prefill_attention`` over a bf16 K/V stream with unit scales
    against the reference's ``kops.prefill_attention`` (the Pallas kernel in
    interpret mode) on the same bits; ragged q_start and kv_len, one
    request with kv_len 0 (exact zeros)."""
    rng = np.random.default_rng(61)
    b, sq, sk, kvh, g, d = 3, 12, 30, 2, 3, 16
    q = _float_kv(rng, (b, sq, kvh, g, d), getattr(jnp, q_dtype))
    k = _float_kv(rng, (b, sk, kvh, d), jnp.bfloat16)
    v = _float_kv(rng, (b, sk, kvh, d), jnp.bfloat16)
    ones = np.ones(kvh, np.float32)
    q_start = np.array([0, 9, 18], np.int32)
    kv_len = np.array([12, 21, 0], np.int32)
    got = ops.prefill_attention(
        *(to_tensor(a) for a in (q, k, v, ones, ones, q_start, kv_len)),
        causal=True, window=window).numpy()
    want = np.asarray(kops.prefill_attention(
        *(jnp.asarray(a) for a in (q, k, v, ones, ones, q_start, kv_len)),
        causal=True, window=window))
    _close(got, want)
    np.testing.assert_array_equal(got[2], 0.0)


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_paged_prefill_attention_bf16_kv_matches_reference(q_dtype):
    """``ops.prefill_attention_view`` over a bf16 page pool read through a
    permuted table that maps one page into two rows, against the
    reference's ``prefill_attention_tiles`` in interpret mode."""
    rng = np.random.default_rng(62)
    b, sq, ps, nb, kvh, g, d = 3, 8, 8, 4, 2, 3, 16
    q = _float_kv(rng, (b, sq, kvh, g, d), getattr(jnp, q_dtype))
    kp = _float_kv(rng, (b * nb + 2, ps, kvh, d), jnp.bfloat16)
    vp = _float_kv(rng, (b * nb + 2, ps, kvh, d), jnp.bfloat16)
    table = rng.permutation(b * nb + 2)[:b * nb].reshape(b, nb).astype(
        np.int32)
    table[1, 0] = table[0, 0]
    ones = np.ones(kvh, np.float32)
    q_start = np.array([0, 8, 19], np.int32)
    kv_len = np.array([8, 16, 27], np.int32)
    view = KernelView(to_tensor(kp), to_tensor(vp), to_tensor(table), ps)
    got = ops.prefill_attention_view(
        to_tensor(q), view, to_tensor(ones), to_tensor(ones),
        to_tensor(q_start), to_tensor(kv_len), causal=True).numpy()
    want = np.asarray(jpa.prefill_attention_tiles(
        *(jnp.asarray(a) for a in (q, kp, vp, table, ones, ones, q_start,
                                   kv_len)), causal=True, interpret=True))
    _close(got, want)


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per_slot"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_attention_matches_reference(per_slot, dtype):
    """The port's plain ``decode_attention`` against the reference's jnp
    one, over the whole capacity with the valid-length mask; a row with
    ``valid`` 0 gives exact zeros; output in q's dtype."""
    rng = np.random.default_rng(63)
    b, smax, kvh, g, d = 4, 24, 2, 3, 16
    q = _float_kv(rng, (b, 1, kvh, g, d), getattr(jnp, dtype))
    k = _float_kv(rng, (b, smax, kvh, d), getattr(jnp, dtype))
    v = _float_kv(rng, (b, smax, kvh, d), getattr(jnp, dtype))
    valid = np.array([0, 1, 13, 24], np.int32) if per_slot else 17
    got = tattn.decode_attention(to_tensor(q), to_tensor(k), to_tensor(v),
                                 to_tensor(np.asarray(valid)))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(valid))
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == dtype
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        _close(got.numpy(), want)
    else:
        # one bf16 rounding of the output on either side
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2 ** -7 * (1 + np.abs(want).max()))
    if per_slot:
        assert torch.equal(got[0].float(), torch.zeros_like(got[0].float()))


def test_decode_kernels_reject_float_tiles():
    """B1 (and with it B4) reads quantized tiles only: a float cache never
    reaches it silently."""
    q = torch.zeros((2, 2, 3, 16))
    for dtype in (torch.bfloat16, torch.float32):
        kv = torch.zeros((2, 24, 2, 16), dtype=dtype)
        with pytest.raises(TypeError):
            ops.decode_attention(q, kv, kv, torch.ones(2), torch.ones(2), 5)
        with pytest.raises(TypeError):
            ops.decode_attention_partials(q, kv, kv, torch.ones(2),
                                          torch.ones(2), 5)


# ---------------------------------------------------------------------------
# float cache operations against the reference's
# ---------------------------------------------------------------------------

def test_float_cache_writes_bit_identical_to_reference():
    """``ready`` casts, ``append`` and ``append_slots`` (an inactive slot
    rewrites its own tiles: bit for bit cache-neutral) on a dense and a
    paged bf16 cache, against the reference's float caches."""
    rng = np.random.default_rng(64)
    b, cap, kvh, d = 3, 32, 2, 16
    jd = JDense.init(b, cap, kvh, d, dtype=jnp.bfloat16, quantized=False)
    td = DenseCache.init(b, cap, kvh, d, quantized=False)
    jp = JPaged.init(b, cap, kvh, d, dtype=jnp.bfloat16, quantized=False,
                     page_size=8, extra_pages=2)
    tp = PagedCache.init(b, cap, kvh, d, quantized=False, page_size=8,
                         extra_pages=2)
    perm = rng.permutation(b * 4 + 2)[:b * 4].reshape(b, 4).astype(np.int32)
    for row in range(b):
        jp = jpaged.set_table_row(jp, row, perm[row])
        tpaged.set_table_row(tp, row, perm[row])
    assert not td.quantized and not tp.quantized
    assert td.k.dtype == tp.k.dtype == torch.bfloat16
    k = rng.normal(size=(b, 11, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, 11, kvh, d)).astype(np.float32)
    starts = np.array([20, 7, 31], np.int32)
    active = np.array([True, False, True])
    k1 = rng.normal(size=(b, 1, kvh, d)).astype(np.float32)
    v1 = rng.normal(size=(b, 1, kvh, d)).astype(np.float32)
    caches = []
    for jc, tc in ((jd, td), (jp, tp)):
        jk, jv = jc.ready(jnp.asarray(k), jnp.asarray(v))
        tk, tv = tc.ready(to_tensor(k), to_tensor(v))
        assert torch.equal(tk, to_tensor(np.asarray(jk)))
        jc = jc.append(jk, jv, 4)
        tc.append(tk, tv, 4)
        before = tc.dense_view()[0][1].clone()
        jk, jv = jc.ready(jnp.asarray(k1), jnp.asarray(v1))
        tk, tv = tc.ready(to_tensor(k1), to_tensor(v1))
        jc = jc.append_slots(jk, jv, jnp.asarray(starts),
                             active=jnp.asarray(active))
        tc.append_slots(tk, tv, to_tensor(starts), active=to_tensor(active))
        for want, got in zip(jc.dense_view(), tc.dense_view()):
            assert torch.equal(got, to_tensor(np.asarray(want)))
        assert torch.equal(tc.dense_view()[0][1], before)
        assert tc.dequantize(*tc.dense_view())[0] is not None
        caches.append(tc)
    assert torch.equal(caches[0].dense_view()[0], caches[1].dense_view()[0])
