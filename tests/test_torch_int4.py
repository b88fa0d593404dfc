"""The port's int4 KV path against the reference.

Same numpy inputs through ``repro`` (JAX) and ``repro_torch``.

Tolerances and why:
  * Packing, quantized K/V tiles, per-head dequant scales, int4 tiles
    after prefill: bit-exact (integer work, or the same float32
    operations; the scale is T * (1/7), the form XLA compiles T / 7 into).
  * Attention plain versions against the Pallas kernels (interpret mode):
    1e-4 x (1 + max|out|) -- float32 sums in another order.
  * Engine with the reference's fine-tuned thresholds bridged in, float32:
    greedy tokens identical.
  * The port's own calibration + fine-tune (4 Adam steps at the engine's
    lr 1e-3) against the reference's: thresholds rtol 2e-3.  Independently
    calibrated thresholds already differ in their last bits
    (``test_torch_engine.py``), so the fine-tune starts from slightly other
    thresholds, and Adam's early steps move every leaf by about lr times
    the sign of its gradient: a gradient near zero whose sign differs moves
    its leaf up to 2 lr the other way.  Measured: 5.3e-4 at most.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import DenseCache as JCache
from repro.cache import base as jcache
from repro.configs import get_config as jax_config
from repro.core import api as JA
from repro.core import packing as jpack
from repro.kernels import decode_attention as jda
from repro.kernels import prefill_attention as jpa
from repro.launch import steps as JST
from repro.launch.engine import Engine as JaxEngine
from repro.models import build_model as jax_build
from repro.models.attention import Attention as JAttention
from repro_torch import bridge
from repro_torch.bridge import to_tensor
from repro_torch.cache import DenseCache as TCache
from repro_torch.cache import base as tcache
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.core import packing as tpack
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops
from repro_torch.kernels import prefill_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as TST
from repro_torch.launch.engine import Engine
from repro_torch.models.attention import Attention as TAttention

G3 = dict(name="smollm-135m-g3", n_layers=2, d_model=96, n_heads=6,
          n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, attn_q_chunk=16,
          attn_kv_chunk=16, loss_chunk=16)
GEN = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# packing and the cache
# ---------------------------------------------------------------------------


def test_unpack_all_256_bytes_and_pack_back():
    b = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    want = np.asarray(jpack.unpack_int4(jnp.asarray(b)))
    got = tpack.unpack_int4(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 256) and got.min() == -8 and got.max() == 7
    np.testing.assert_array_equal(tpack.pack_int4(torch.from_numpy(got)),
                                  b)


@pytest.mark.parametrize("n,axis", [(7, -1), (8, -1), (5, 0), (9, 1)])
def test_pack_int4_matches_odd_lengths_and_axes(n, axis):
    rng = np.random.default_rng(n)
    shape = [3, 4, 5]
    shape[axis] = n
    x = rng.integers(-8, 8, shape, dtype=np.int8)
    want = np.asarray(jpack.pack_int4(jnp.asarray(x), axis=axis))
    got = tpack.pack_int4(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tpack.unpack_int4(got, axis=axis, size=n).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(jpack.unpack_int4(jnp.asarray(want), axis=axis,
                                           size=n)))


def test_quantize_kv_int4_tiles_bit_exact():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 9, 3, 16)) * 4).astype(np.float32)
    scale = np.array([0.31, 0.05, 1.7], np.float32)   # some values clip
    want = np.asarray(jcache.quantize_kv(jnp.asarray(x), jnp.asarray(scale),
                                         bits=4))
    got = tcache.quantize_kv(to_tensor(x), to_tensor(scale), bits=4)
    assert got.shape == (2, 9, 3, 8) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tcache.dequantize_kv(got, to_tensor(scale), bits=4).numpy(),
        np.asarray(jcache.dequantize_kv(jnp.asarray(want),
                                        jnp.asarray(scale), bits=4)))


def test_dense_cache_int4_storage():
    c = TCache.init(2, 16, 3, 16, bits=4)
    assert c.k.shape == c.v.shape == (2, 16, 3, 8) and c.bits == 4
    assert c.kernel_view().bits == 4
    j = JCache.init(2, 16, 3, 16, quantized=True, bits=4)
    assert tuple(j.k.shape) == tuple(c.k.shape)
    with pytest.raises(ValueError, match="even head dim"):
        TCache.init(2, 16, 3, 15, bits=4)
    with pytest.raises(ValueError, match="4 or 8"):
        TCache.init(2, 16, 3, 16, bits=2)


def test_kv_scales_int4_bit_identical_to_the_compiled_reference():
    """T / 7 as the reference's compiled graph evaluates it, over 4096
    thresholds (zero and tiny ones floor at 1e-8 first).  The int8 scale
    T / 127 stays the same expression."""
    rng = np.random.default_rng(4)
    t = (np.abs(rng.normal(size=4096)) * 3).astype(np.float32)
    t[:3] = [0.0, 1e-12, 1e-8]
    for bits in (4, 8):
        qp = {"a/kv": {"k": {"t_max": t}, "v": {"t_max": t[::-1].copy()}}}
        jattn = JAttention(8, 2, 1, 4, path="a")
        jpol = JA.QuantPolicy(kv_int8=True, kv_bits=bits)
        want = jax.jit(lambda q: jattn._kv_scales(
            JA.make_ctx("int8", jpol, q)))(jax.tree.map(jnp.asarray, qp))
        tattn = TAttention(8, 2, 1, 4, path="a")
        got = tattn._kv_scales(TA.make_ctx(
            "int8", TA.QuantPolicy(kv_int8=True, kv_bits=bits),
            bridge.qparams_from_jax(qp)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# attention, plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _int4_inputs(b, sq, sk, kvh, g, d, seed, decode=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kvh, g, d) if decode else (b, sq, kvh, g, d))
    k = np.asarray(jpack.pack_int4(jnp.asarray(
        rng.integers(-7, 8, (b, sk, kvh, d), dtype=np.int8))))
    v = np.asarray(jpack.pack_int4(jnp.asarray(
        rng.integers(-7, 8, (b, sk, kvh, d), dtype=np.int8))))
    ks = (rng.random(kvh) * 0.3 + 0.05).astype(np.float32)
    vs = (rng.random(kvh) * 0.3 + 0.05).astype(np.float32)
    return q.astype(np.float32), k, v, ks, vs


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * (1 + np.abs(want).max()))


@pytest.mark.parametrize("cur_pos", [
    17, np.array([32, 9, 1], np.int32), np.array([0, 20, 5], np.int32)],
    ids=["scalar", "vector", "with_zero"])
def test_decode_attention_int4_vs_pallas(cur_pos):
    q, k, v, ks, vs = _int4_inputs(3, 1, 32, 2, 3, 16, seed=5, decode=True)
    pos_t = (cur_pos if isinstance(cur_pos, int)
             else torch.from_numpy(np.asarray(cur_pos)))
    got = ops.decode_attention(*[to_tensor(a) for a in (q, k, v, ks, vs)],
                               pos_t, kv_bits=4).numpy()
    want = np.asarray(jda.decode_attention_int8(
        *[jnp.asarray(a) for a in (q, k, v, ks, vs)],
        jnp.asarray(cur_pos, jnp.int32), interpret=True, kv_bits=4))
    _close(got, want)
    if not isinstance(cur_pos, int):
        np.testing.assert_array_equal(got[np.asarray(cur_pos) == 0], 0.0)


@pytest.mark.parametrize("q_start,kv_len,window", [
    (0, [24, 24], None),
    (5, [20, 11], None),
    (8, [24, 3], 6),
], ids=["full", "q_start_kv_len", "window"])
def test_prefill_attention_int4_vs_pallas(q_start, kv_len, window):
    q, k, v, ks, vs = _int4_inputs(2, 13, 24, 2, 3, 16, seed=6)
    got = ops.prefill_attention(
        *[to_tensor(a) for a in (q, k, v, ks, vs)], q_start,
        torch.tensor(kv_len, dtype=torch.int32), causal=True,
        window=window, kv_bits=4).numpy()
    want = np.asarray(jpa.prefill_attention_int8(
        *[jnp.asarray(a) for a in (q, k, v, ks, vs)], jnp.int32(q_start),
        jnp.asarray(kv_len, jnp.int32), causal=True, window=window,
        interpret=True, kv_bits=4))
    _close(got, want)


def test_int4_entry_points_validate_packed_width():
    q, k, v, ks, vs = [to_tensor(a) for a in
                       _int4_inputs(2, 4, 8, 2, 3, 16, seed=7)]
    unpacked = tpack.unpack_int4(k)
    with pytest.raises(ValueError, match="packed"):
        ops.prefill_attention(q, unpacked, unpacked, ks, vs, 0, 8,
                              kv_bits=4)
    with pytest.raises(ValueError, match="4 or 8"):
        ops.prefill_attention(q, k, v, ks, vs, 0, 8, kv_bits=3)
    with pytest.raises(ValueError, match="packed"):
        ops.decode_attention(q[:, 0].contiguous(), unpacked, unpacked, ks,
                             vs, 4, kv_bits=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.launch(q[:, 0].contiguous(), k, v, ks, vs,
                   torch.full((2,), 4, dtype=torch.int32), kv_bits=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpa.launch(q, k, v, ks, vs, torch.zeros(2, dtype=torch.int32),
                   torch.full((2,), 8, dtype=torch.int32), kv_bits=4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_int4_attention_kernels_match_plain(cuda_device):
    dev = cuda_device
    q, k, v, ks, vs = [to_tensor(a).to(dev) for a in
                       _int4_inputs(2, 70, 100, 3, 3, 64, seed=8)]
    qs = torch.tensor([0, 30], dtype=torch.int32, device=dev)
    kl = torch.tensor([70, 100], dtype=torch.int32, device=dev)
    want = tref.prefill_attention_ref(q, k, v, ks, vs, qs, kl, kv_bits=4)
    _close(tpa.launch(q, k, v, ks, vs, qs, kl, kv_bits=4).cpu().numpy(),
           want.cpu().numpy())
    qd = q[:, 0].contiguous()
    pos = torch.tensor([0, 77], dtype=torch.int32, device=dev)
    want = tref.decode_attention_ref(qd, k, v, ks, vs, pos, kv_bits=4)
    _close(tda.launch(qd, k, v, ks, vs, pos, kv_bits=4).cpu().numpy(),
           want.cpu().numpy())


# ---------------------------------------------------------------------------
# the engine: int4 KV serving with fine-tuned thresholds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The reference Engine (Pallas kernels in interpret mode, dense cache,
    kv_bits=4, 2 fine-tune epochs) and the port's, on the G = 3 config in
    float32 from the same weights and calibration batches; a third port
    engine serves with the reference's fine-tuned thresholds, bridged."""
    jcfg = jax_config("smollm-135m").replace(**G3, dtype=jnp.float32)
    tcfg = torch_config("smollm-135m").replace(**G3, dtype=torch.float32)
    rng = np.random.default_rng(21)
    calib = [{"tokens": rng.integers(0, G3["vocab"], (4, 32), dtype=np.int32)}
             for _ in range(2)]
    prompts = rng.integers(0, G3["vocab"], (2, 16), dtype=np.int32)
    ref = JaxEngine.from_checkpoint(
        cfg=jcfg, use_pallas=True, cache_layout="dense", kv_bits=4,
        finetune_thresholds=2,
        calib_batches=[{"tokens": jnp.asarray(b["tokens"])} for b in calib])
    params = bridge.params_from_jax(_np(jax_build(jcfg).init(
        jax.random.PRNGKey(0))))
    ours = Engine.from_checkpoint(cfg=tcfg, params=params, kv_bits=4,
                                  finetune_thresholds=2,
                                  calib_batches=calib, device="cpu")
    shared = Engine.from_checkpoint(
        cfg=tcfg, params=params, kv_bits=4, device="cpu",
        qparams=bridge.qparams_from_jax(_np(ref.qparams)))
    return dict(ref=ref, ours=ours, shared=shared, prompts=prompts,
                jcfg=jcfg)


def test_int4_tiles_bit_identical_after_prefill(engines):
    """From the reference's fine-tuned thresholds: every layer's packed K/V
    tiles and per-head scales after one-shot prefill."""
    ref, shared, prompts = engines["ref"], engines["shared"], engines[
        "prompts"]
    b, s = prompts.shape
    jcache = ref.init_cache(b, ref._cache_len(s, GEN))
    _, jcache = jax.jit(JST.make_prefill_step(
        ref.model, engines["jcfg"], ref.policy, "int8"))(
        ref.serve_params, ref.qparams, {"tokens": jnp.asarray(prompts)},
        jcache)
    with torch.inference_mode():
        tcache = shared.init_cache(b, shared._cache_len(s, GEN))
        _, tcache = TST.make_prefill_step(shared.model, shared.policy)(
            shared.serve_params, shared.qparams,
            {"tokens": torch.from_numpy(prompts)}, tcache)
    for i in range(G3["n_layers"]):
        ja, ta = jcache[f"layer{i}"]["attn"], tcache[f"layer{i}"]["attn"]
        assert ta.bits == 4 and ta.k.shape[-1] == G3["head_dim"] // 2
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(ta, key).numpy(),
                                          np.asarray(ja[key]),
                                          err_msg=f"layer{i} {key}")


def test_int4_greedy_tokens_identical_with_bridged_thresholds(engines):
    ref, shared, prompts = engines["ref"], engines["shared"], engines[
        "prompts"]
    want = np.asarray(ref.generate_batch({"tokens": jnp.asarray(prompts)},
                                         gen=GEN).tokens)
    got = shared.generate_batch({"tokens": prompts}, gen=GEN).tokens.numpy()
    np.testing.assert_array_equal(got, want)


def test_own_finetuned_thresholds_match_reference(engines):
    ref = TA.flatten(_np(engines["ref"].qparams))
    ours = TA.flatten(engines["ours"].qparams)
    assert set(ours) == set(ref)
    assert sum(k[-1] == "t_max" and k[0].endswith("/kv")
               for k in ours) == 2 * G3["n_layers"]
    for k, want in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), want, rtol=2e-3,
                                   err_msg=str(k))
    log = engines["ours"].finetune_log
    assert len(log["losses"]) == len(log["step_s"]) == 4
    assert all(np.isfinite(log["losses"]))


def test_engine_rejects_finetune_with_given_thresholds(engines):
    with pytest.raises(ValueError, match="finetune_thresholds"):
        Engine.from_checkpoint(cfg=engines["shared"].cfg, device="cpu",
                               kv_bits=4, finetune_thresholds=1,
                               qparams=engines["shared"].qparams)
