"""The state-space side against the reference: ``models/ssm.py``'s
functions and ``Mamba2Block``, and mamba2-780m at its ``SMOKE`` widths
through both packages' Engines (the reference's with ``use_pallas=True``,
its kernels in interpret mode), weights bridged from the reference's
init, inputs drawn with numpy from a seed.

What is held bit for bit:
  * ``causal_conv1d`` (the reference's chain of four products, its second
    product rounded and the others fused on as its CPU backend contracts
    them) and ``conv1d_decode`` at three rows or more (its dot's fused
    chain); the prefill's conv state (the last three raw rows);
  * int8 weights ``w_q`` / ``w_scale`` of the six projections a block,
    the calibrated thresholds at float32, the float32 leaves passed
    through unchanged.

Float tolerances, each beside its worst value measured at these seeds:
  * ``ssd_chunked``'s output: 1e-5 of the largest |y| (measured 6.8e-7);
    its final carry against the reference's sequential fold of
    ``ssd_decode_step`` (another summation order, ROADMAP Queue C): 1e-5
    of the largest |state| (measured 2.3e-7); ``ssd_decode_step`` 1e-6
    (measured 1.3e-7); ``conv1d_decode`` at one and two rows 1e-6
    (measured 7.5e-8).
  * softplus (XLA's exp and log1p against torch's): 4 ulps (measured 2);
    silu at float32 8 ulps (measured 5, near exp's underflow end).
  * ``Mamba2Block`` at float32: none mode 1e-5 of the largest |y|
    (measured 2.0e-7), fake and int8 the same (measured 0); calibrate-mode
    observers exact; its prefill state against the fold 1e-5 (measured
    3.6e-7 the SSD state, 2.4e-7 the conv rows of float32 projections).
  * the Engines: thresholds rtol 1e-6 at float32 (measured 4.3e-7),
    2e-2 at bfloat16 (measured 0 here, 1.5e-2 on hymba); prefill logits
    atol 1e-5 at float32 (measured 1.5e-7), every layer's SSD state 1e-5
    of its largest value (measured 3.5e-7), greedy and sampled tokens
    identical; at bfloat16 (the serving dtype) logits atol 0.03
    (measured 0.0078: the gate product's bf16 rounding moves one int8 step
    of ``out_proj``), tokens identical or a near-tie (<= 0.25,
    teacher-forced; measured identical).
  * one fat_qat step at float32: loss rtol 1e-4 (measured 3.6e-7), the
    threshold gradients rtol 2e-3 atol 1e-4 x the largest (measured
    7.8e-7 of the largest).
"""
import re

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
from repro.models import ssm as JS
from repro.models.layers import silu as jax_silu
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.launch import steps as TST
from repro_torch.launch.engine import Engine
from repro_torch.models import build_model as torch_build
from repro_torch.models import ssm as TS
from repro_torch.models.layers import silu_xla

ARCH = "mamba2-780m"
B, PROMPT, GEN = 2, 40, 8
NEAR_TIE = 0.25


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(got, want):
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _ulps(got, want):
    """Distance in float32 ulps of ``want``."""
    want = np.asarray(want, np.float32)
    spacing = np.spacing(np.abs(want)).astype(np.float64)
    return (np.abs(np.asarray(got, np.float64) - want) / spacing).max()


def _ssd_inputs(bsz, length, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(bsz, length, h)))).astype(
        np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    b = rng.normal(size=(bsz, length, g, n)).astype(np.float32)
    c = rng.normal(size=(bsz, length, g, n)).astype(np.float32)
    return x, dt, a_log, b, c


def _reference_fold(x, dt, a_log, b, c):
    """The reference prefill's state: its sequential scan of
    ``ssd_decode_step`` from zero (``Block._mamba_state_from_prefill``)."""
    bsz, _, h, p = x.shape
    n = b.shape[-1]

    def step(state, inp):
        return JS.ssd_decode_step(state, *inp[:1], inp[1], a_log,
                                  *inp[2:])[0], None

    state, _ = jax.lax.scan(step, jnp.zeros((bsz, h, n, p), jnp.float32),
                            tuple(jnp.moveaxis(jnp.asarray(v), 1, 0)
                                  for v in (x, dt, b, c)))
    return np.asarray(state)


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

# (B, L, H, P, G, N, chunk): ragged L (padding), a chunk longer than L,
# one group over several heads, two groups
SSD_CASES = [(2, 37, 4, 16, 1, 16, 16), (1, 10, 4, 8, 1, 8, 16),
             (2, 64, 8, 16, 1, 32, 16), (2, 48, 4, 8, 2, 16, 16)]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_and_its_final_carry(case):
    bsz, length, h, p, g, n, chunk = case
    args = _ssd_inputs(bsz, length, h, p, g, n, seed=length)
    want = np.asarray(jax.jit(JS.ssd_chunked, static_argnames="chunk")(
        *args, chunk=chunk))
    y, state = TS.ssd_chunked(*map(_t, args), chunk=chunk)
    assert y.shape == want.shape and y.dtype == torch.float32
    assert _rel(y.numpy(), want) < 1e-5
    fold = _reference_fold(*args)
    assert state.shape == (bsz, h, n, p)
    assert _rel(state.numpy(), fold) < 1e-5


def test_ssd_decode_step():
    x, dt, a_log, b, c = _ssd_inputs(3, 1, 4, 8, 1, 16, seed=4)
    state = np.random.default_rng(5).normal(size=(3, 4, 16, 8)).astype(
        np.float32)
    args = (state, x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0])
    want_s, want_y = jax.jit(JS.ssd_decode_step)(*args)
    got_s, got_y = TS.ssd_decode_step(*map(_t, args))
    assert _rel(got_s.numpy(), want_s) < 1e-6
    assert _rel(got_y.numpy(), want_y) < 1e-6


@pytest.mark.parametrize("bsz,length,ch", [(2, 40, 160), (3, 7, 96),
                                           (1, 129, 64)])
def test_causal_conv1d_bit_identical(bsz, length, ch):
    rng = np.random.default_rng(length)
    x = rng.normal(size=(bsz, length, ch)).astype(np.float32)
    w = (rng.normal(size=(4, ch)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(ch,)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(JS.causal_conv1d)(x, w, b))
    np.testing.assert_array_equal(TS.causal_conv1d(_t(x), _t(w),
                                                   _t(b)).numpy(), want)


@pytest.mark.parametrize("bsz", [1, 2, 3, 4, 8])
def test_conv1d_decode(bsz):
    """Bit for bit at three rows or more; one and two rows within 1e-6 of
    the largest |y| (the reference's dot sums them otherwise, ROADMAP
    Queue C)."""
    rng = np.random.default_rng(bsz)
    ch = 160
    state = rng.normal(size=(bsz, 3, ch)).astype(np.float32)
    x = rng.normal(size=(bsz, 1, ch)).astype(np.float32)
    w = (rng.normal(size=(4, ch)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(ch,)) * 0.1).astype(np.float32)
    want_win, want_y = jax.jit(JS.conv1d_decode)(state, x, w, b)
    got_win, got_y = TS.conv1d_decode(*map(_t, (state, x, w, b)))
    np.testing.assert_array_equal(got_win.numpy(), want_win)
    if bsz >= 3:
        np.testing.assert_array_equal(got_y.numpy(), want_y)
    else:
        assert _rel(got_y.numpy(), want_y) < 1e-6


def test_softplus_and_silu():
    """``jax.nn.softplus`` (logaddexp(x, 0)) and the reference's silu at
    float32, across the range where F.softplus's threshold bites; NaN
    passes through softplus."""
    x = np.concatenate([np.linspace(-40, 40, 20001),
                        np.random.default_rng(0).normal(size=5000) * 4]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    assert _ulps(TS.softplus(_t(x)).numpy(), want) <= 4
    assert _ulps(silu_xla(_t(x)).numpy(),
                 np.asarray(jax.jit(jax_silu)(x))) <= 8
    assert torch.isnan(TS.softplus(torch.tensor([float("nan")]))).all()


def test_ssd_chunked_gradient_is_finite():
    """The masked-exp clamp: at chunk 64 with large steps, exp(cum_i -
    cum_j) overflows at the masked entries; the gradient stays finite."""
    x, dt, a_log, b, c = _ssd_inputs(1, 128, 2, 4, 1, 4, seed=9)
    dt = dt * 8
    leaves = [_t(v).clone().requires_grad_(True) for v in (x, dt, b, c)]
    y, state = TS.ssd_chunked(leaves[0], leaves[1], _t(a_log), leaves[2],
                              leaves[3], chunk=64)
    (y.square().sum() + state.square().sum()).backward()
    for leaf in leaves:
        assert torch.isfinite(leaf.grad).all()
    # the clamp is needed: unclamped, exp overflows inside the chunk
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp(np.cumsum(dt[0, :64, 0]
                                                * np.exp(a_log[0]))
                                      .astype(np.float32))).all()


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _pair_block(dtype="float32", seed=1):
    cfg = jax_config(ARCH, smoke=True)
    kw = dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
              expand=cfg.ssm_expand, chunk=cfg.ssm_chunk)
    jb = JS.Mamba2Block(cfg.d_model, path="m", dtype=getattr(jnp, dtype),
                        **kw)
    tb = TS.Mamba2Block(cfg.d_model, path="m", dtype=getattr(torch, dtype),
                        **kw)
    jp = jb.init(jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).normal(size=(2, 40, cfg.d_model))
    jx = jnp.asarray(x.astype(np.float32)).astype(getattr(jnp, dtype))
    return jb, tb, jp, bridge.params_from_jax(_np(jp)), jx, \
        bridge.to_tensor(np.asarray(jx))


def test_block_in_every_mode():
    """none, calibrate, fake and int8 at float32, the port serving the
    reference's calibrated thresholds: the six observers exact, ``w_q`` /
    ``w_scale`` bit for bit, the float32 leaves shared unchanged, outputs
    within 1e-5 of the largest |y|."""
    jb, tb, jp, tp, jx, tx = _pair_block()
    jpol, tpol = JA.QuantPolicy(), TA.QuantPolicy()
    assert _rel(tb(tp, tx).numpy(), jb(jp, jx)) < 1e-5
    jq = JA.init_qparams(jb, jp, jpol)
    ctx = JA.make_ctx("calibrate", jpol, jq)
    jb(jp, jx, ctx)
    tq = TA.init_qparams(tb, tp, tpol)
    tctx = TA.make_ctx("calibrate", tpol, tq)
    tb(tp, tx, tctx)
    names = {f"m/{n}" for n in ("z_proj", "x_proj", "b_proj", "c_proj",
                                "dt_proj", "out_proj")}
    assert set(tq) == set(jq) == names
    assert set(tctx.updates) == set(ctx.updates) == names
    for path, obs in ctx.updates.items():
        np.testing.assert_array_equal(tctx.updates[path]["t_max"].numpy(),
                                      np.asarray(obs["t_max"]))
        jq[path] = {**jq[path], "act": obs}
    jq = JA.finalize_calibration(jq, jpol)
    bq = bridge.qparams_from_jax(_np(jq))
    mask = TA.flatten(TA.trainable_mask(bq))
    want_mask = TA.flatten(_np(JA.trainable_mask(jq)))
    assert mask == {k: bool(v) for k, v in want_mask.items()}
    assert {k[0] for k, m in mask.items() if m} == names
    jsp = JA.convert_to_int8(jb, jp, jq, jpol)
    tsp = TA.convert_to_int8(tb, tp, bq, tpol)
    for name in names:
        leaf = name.split("/")[1]
        for k in ("w_q", "w_scale"):
            np.testing.assert_array_equal(tsp[leaf][k].numpy(),
                                          np.asarray(jsp[leaf][k]))
        assert "w" not in tsp[leaf]
    for leaf in ("a_log", "d_skip", "dt_bias", "conv_w", "conv_b"):
        assert tsp[leaf] is tp[leaf] and tsp[leaf].dtype == torch.float32
    jf = jb(jp, jx, JA.make_ctx("fake", jpol, jq))
    assert _rel(tb(tp, tx, TA.make_ctx("fake", tpol, bq)).numpy(), jf) < 1e-5
    # int8 through the reference's fused kernel (interpret mode), compiled
    # with the thresholds traced, as its engine compiles them
    ppol = JA.QuantPolicy(use_pallas=True)
    ji = jax.jit(lambda p, q, x: jb(p, x, JA.make_ctx("int8", ppol, q)))(
        jsp, jq, jx)
    assert _rel(tb(tsp, tx, TA.make_ctx("int8", tpol, bq)).numpy(),
                ji) < 1e-5
    assert tb.equalization_pairs() == jb.equalization_pairs() == []


def test_block_prefill_and_decode_state():
    """The block's prefill state (the chunked scan's carry and the last
    three raw conv rows) against the reference's sequential fold, then
    four decode steps through both, at float32 in full precision: the
    conv windows, the SSD state and the outputs within 1e-5 (the float32
    projections sum in other orders; the engines below hold the int8
    projections' conv rows bit for bit); the state is written in place;
    short prompts raise."""
    jb, tb, jp, tp, jx, tx = _pair_block()
    cfg = jax_config(ARCH, smoke=True)
    jm = jax_build(cfg.replace(dtype=jnp.float32, n_layers=1))
    blk = jm.stack.blocks[0]
    jp_full = jm.init(jax.random.PRNGKey(1))["stack"]["layer0"]
    jp_full = {**jp_full, "mamba": jp}
    cache = blk.init_cache(2, 64)
    want = blk._mamba_state_from_prefill(jp_full, jx, cache)
    state = tb.init_cache(2)
    state.ssm.fill_(7.0)            # a replayed prefill overwrites it
    buffers = (state.ssm, state.conv)
    y, state = tb.prefill(tp, tx, state)
    assert state.ssm is buffers[0] and state.conv is buffers[1]
    assert _rel(y.numpy(), jb(jp, jx)) < 1e-5
    assert _rel(state.conv.numpy(), want["conv"]) < 1e-5
    assert _rel(state.ssm.numpy(), want["ssm"]) < 1e-5
    # copies: the port writes these buffers in place while the
    # reference's asynchronous dispatch may still read them
    jcache = {"ssm": jnp.asarray(state.ssm.numpy().copy()),
              "conv": jnp.asarray(state.conv.numpy().copy())}
    rng = np.random.default_rng(3)
    for _ in range(4):
        u = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = jax.jit(jb.decode)(jp, jnp.asarray(u), jcache)
        ty, state = tb.decode(tp, _t(u), state)
        assert state.ssm is buffers[0] and state.conv is buffers[1]
        assert _rel(state.conv.numpy(), jcache["conv"]) < 1e-5
        assert _rel(state.ssm.numpy(), jcache["ssm"]) < 1e-5
        assert _rel(ty.numpy(), jy) < 1e-5
    with pytest.raises(ValueError, match="shorter than the conv window"):
        tb.prefill(tp, tx[:, :2], tb.init_cache(2))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _ref_prefill(ref, jcfg, prompts):
    """The reference engine's last logits and cache after the one-shot
    prefill."""
    b, s = prompts.shape
    cache = ref.init_cache(b, ref._cache_len(s, GEN))
    logits, cache = jax.jit(JST.make_prefill_step(
        ref.model, jcfg, ref.policy, "int8"))(
        ref.serve_params, ref.qparams, {"tokens": jnp.asarray(prompts)},
        cache)
    return np.asarray(logits.astype(jnp.float32))[:, -1], cache


def build_served(arch, dtype):
    """The reference Engine and the port's from the same init and numpy
    calibration batches (each its own calibration), and the port serving
    the reference's thresholds; greedy and sampled tokens of both, prefill
    logits and states with the shared thresholds."""
    jcfg = jax_config(arch, smoke=True).replace(dtype=getattr(jnp, dtype))
    tcfg = torch_config(arch, smoke=True).replace(
        dtype=getattr(torch, dtype))
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
    tq = bridge.qparams_from_jax(_np(ref.qparams))
    shared = Engine.from_checkpoint(cfg=tcfg, params=params, device="cpu",
                                    cache_layout="dense", qparams=tq)
    out = dict(arch=arch, dtype=dtype, jcfg=jcfg, tcfg=tcfg, ref=ref,
               ours=ours, shared=shared, prompts=prompts, params=params)
    out["ref_logits"], out["ref_cache"] = _ref_prefill(ref, jcfg, prompts)
    with torch.inference_mode():
        cache = shared.init_cache(B, shared._cache_len(PROMPT, GEN))
        _, out["cache"] = TST.make_prefill_step(shared.model, shared.policy)(
            shared.serve_params, shared.qparams,
            {"tokens": torch.from_numpy(prompts)}, cache)
    jp = {"tokens": jnp.asarray(prompts)}
    out["ref_tokens"] = np.asarray(ref.generate_batch(jp, gen=GEN).tokens)
    out["out"] = shared.generate_batch({"tokens": prompts}, gen=GEN)
    sampled = dict(temperature=0.8, top_p=0.9, seed=3)
    rs = JaxEngine(ref.model, jcfg, ref.policy, ref.serve_params,
                   ref.qparams, mode="int8", cache_layout="dense", **sampled)
    ts = Engine(shared.model, tcfg, shared.policy, shared.serve_params, tq,
                device="cpu", cache_layout="dense", **sampled)
    out["ref_sampled"] = np.asarray(rs.generate_batch(jp, gen=GEN).tokens)
    out["sampled"] = ts.generate_batch({"tokens": prompts}, gen=GEN)
    out["sampled_loop"] = ts.generate_batch({"tokens": prompts}, gen=GEN,
                                            loop=True)
    return out


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def served(request):
    return build_served(ARCH, request.param)


def walk_int8(a, b, path=""):
    for k, v in a.items():
        if isinstance(v, dict):
            yield from walk_int8(v, b[k], f"{path}/{k}")
        elif k in ("w_q", "w_scale"):
            yield f"{path}/{k}", np.asarray(v), b[k].numpy()


def check_weights_and_thresholds(s, per_layer):
    """Every int8 leaf of the port's own engine equals the reference's
    (``per_layer`` quantized Dense a layer); the calibrated thresholds
    within rtol 1e-6 at float32, 2e-2 at bfloat16 (the module
    docstrings)."""
    n = 0
    for path, want, got in walk_int8(s["ref"].serve_params,
                                     s["ours"].serve_params):
        np.testing.assert_array_equal(got, want, err_msg=path)
        n += 1
    assert n == 2 * per_layer * s["tcfg"].n_layers
    ref = _np(s["ref"].qparams)
    assert set(ref) == set(s["ours"].qparams)
    rtol = 1e-6 if s["dtype"] == "float32" else 2e-2
    for path, entry in ref.items():
        for group, leaves in entry.items():
            for name, want in leaves.items():
                np.testing.assert_allclose(
                    s["ours"].qparams[path][group][name].numpy(), want,
                    rtol=rtol, err_msg=f"{path}/{group}/{name}")


def check_tokens(s, tokens, want, teacher_forced_logits):
    """Equal tokens, or at bfloat16 a near-tie: where the port's token
    differs, the reference's scores within ``NEAR_TIE`` of the port's best
    at that step (``teacher_forced_logits(prefix)`` gives them)."""
    if s["dtype"] == "float32":
        np.testing.assert_array_equal(tokens, want)
        return
    for r in range(tokens.shape[0]):
        diff = np.nonzero(tokens[r] != want[r])[0]
        if not len(diff):
            continue
        j = diff[0]
        logits = teacher_forced_logits(r, tokens[r, :j])
        assert logits.max() - logits[want[r, j]] <= NEAR_TIE, (r, j)


def teacher_forced(s):
    """The port's logits after prompt r + ``prefix`` (shared thresholds):
    one prefill of the extended prompt."""
    engine = s["shared"]

    def logits(r, prefix):
        toks = np.concatenate([s["prompts"][r], prefix])[None]
        with torch.inference_mode():
            cache = engine.init_cache(1, engine._cache_len(toks.shape[1], 1))
            out, _ = TST.make_prefill_step(engine.model, engine.policy)(
                engine.serve_params, engine.qparams,
                {"tokens": torch.from_numpy(toks)}, cache)
        return out[0, -1].float().numpy()

    return logits


def check_prefill(s, logit_atol):
    np.testing.assert_allclose(s["out"].prefill_logits.float().numpy(),
                               s["ref_logits"], atol=logit_atol, rtol=0)


def test_engine_weights_and_thresholds(served):
    check_weights_and_thresholds(served, per_layer=6)


def test_engine_prefill_logits_and_state(served):
    """Prefill logits (shared thresholds); each layer's decode state after
    the prefill against the reference's fold: conv rows bit for bit, the
    SSD state within 1e-5 of its largest value at float32 (at bfloat16 the
    layers after the first see inputs an int8 step apart)."""
    check_prefill(served, 1e-5 if served["dtype"] == "float32" else 0.03)
    for i in range(served["tcfg"].n_layers):
        want = served["ref_cache"][f"layer{i}"]["mamba"]
        got = served["cache"][f"layer{i}"]["mamba"]
        if i == 0 or served["dtype"] == "float32":
            np.testing.assert_array_equal(got.conv.numpy(), want["conv"])
            assert _rel(got.ssm.numpy(), want["ssm"]) < 1e-5
        assert set(served["cache"][f"layer{i}"]) == {"mamba"}


def test_engine_greedy_and_sampled_tokens(served):
    """Greedy and sampled (temperature 0.8, top-p 0.9, seed 3) tokens
    against the reference's; the port's programs equal its eager
    ``loop=True`` driver bit for bit."""
    logits = teacher_forced(served)
    check_tokens(served, served["out"].tokens.numpy(), served["ref_tokens"],
                 logits)
    check_tokens(served, served["sampled"].tokens.numpy(),
                 served["ref_sampled"], logits)
    assert torch.equal(served["sampled"].tokens,
                       served["sampled_loop"].tokens)
    eager = served["shared"].generate_batch(
        {"tokens": served["prompts"]}, gen=GEN, loop=True)
    assert torch.equal(eager.tokens, served["out"].tokens)
    assert torch.equal(eager.prefill_logits, served["out"].prefill_logits)


def test_state_size_does_not_depend_on_max_len():
    """The counterpart of the reference's constant-memory test: the SSM
    state of a 2^20-token cache is (B, H, N, P) and (B, 3, C)."""
    cfg = torch_config(ARCH, smoke=True)
    model = torch_build(cfg)
    cache = model.init_cache(2, 1 << 20, "cpu")
    m = model.stack.blocks[0].mamba
    state = cache["layer0"]["mamba"]
    assert state.ssm.shape == (2, m.n_heads, cfg.ssm_state, m.head_dim)
    assert state.conv.shape == (2, 3, m.conv_channels)
    assert set(cache["layer0"]) == {"mamba"}


@pytest.mark.parametrize("arch", [ARCH, "hymba-1.5b"])
def test_plans_match_the_reference(arch):
    """fold_plan (the pre-norm into the five input projections, and
    hymba's attention q / k / v) and equalization_plan (no SSM pair)."""
    jm = jax_build(jax_config(arch, smoke=True))
    tm = torch_build(torch_config(arch, smoke=True))
    assert tm.fold_plan() == jm.fold_plan()
    assert tm.equalization_plan() == jm.equalization_plan()
    assert any(p.endswith("/mamba/dt_proj") for _, ps in tm.fold_plan()
               for p in ps)


@pytest.mark.parametrize("arch", [ARCH, "hymba-1.5b"])
def test_bridge_round_trip(arch):
    """The reference's init crosses the bridge with every leaf (the float32
    SSM leaves among them) and crosses back with the same bits; its
    qparams likewise."""
    jcfg = jax_config(arch, smoke=True)
    jm = jax_build(jcfg)
    jp = _np(jm.init(jax.random.PRNGKey(2)))
    tp = bridge.params_from_jax(jp)
    want = TA.flatten(jp)
    got = TA.flatten(tp)
    assert set(got) == set(want) == set(TA.flatten(torch_build(
        torch_config(arch, smoke=True)).init(torch.Generator())))
    for k, v in want.items():
        np.testing.assert_array_equal(bridge.to_numpy(got[k]), v)
        assert bridge.to_numpy(got[k]).dtype == v.dtype
    assert any(k[-1] == "a_log" for k in got)
    jq = _np(JA.init_qparams(jm, jp, JA.QuantPolicy(kv_int8=False)))
    back = bridge.qparams_to_numpy(bridge.qparams_from_jax(jq))
    assert TA.flatten(back).keys() == TA.flatten(jq).keys()
    for k, v in TA.flatten(jq).items():
        np.testing.assert_array_equal(TA.flatten(back)[k], v)


def test_fat_step_loss_and_threshold_gradients():
    """One fat_qat distillation step at float32 (the reference's init and
    calibration bridged): the loss and every alpha's gradient against
    ``jax.value_and_grad`` of the reference's loss."""
    jcfg = jax_config(ARCH, smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config(ARCH, smoke=True).replace(dtype=torch.float32)
    fat_step_matches(jcfg, tcfg)


def fat_step_matches(jcfg, tcfg):
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(_np(jparams))
    toks = np.random.default_rng(12).integers(0, jcfg.vocab, (2, 32),
                                              dtype=np.int32)
    pol = JA.QuantPolicy()
    jq = JA.init_qparams(jm, jparams, pol)
    jq = jax.jit(JST.make_calibrate_step(jm, jcfg, pol))(
        jparams, jq, {"tokens": jnp.asarray(toks)})
    jq = JA.finalize_calibration(jq, pol)
    batch = {"tokens": jnp.asarray(toks)}

    def loss_for(qp):                          # the reference's loss_for
        h_t = jax.lax.stop_gradient(jm.hidden(jparams, batch, None)[0])
        ctx = JA.make_ctx("fake", pol, qp)
        h_s, _ = jm.hidden(jparams, batch, ctx)
        sq, n = jax_chunked_sq_err(h_t, h_s, jm.readout_fn(jparams, None),
                                   jm.readout_fn(jparams, ctx),
                                   chunk=jcfg.loss_chunk)
        return jnp.sqrt(sq / n)

    want_loss, want = jax.jit(jax.value_and_grad(loss_for))(jq)
    want = TA.flatten(_np(want))
    tq = bridge.qparams_from_jax(_np(jq))
    loss, grads = TST.make_fat_grad_fn(tm, TA.QuantPolicy())(
        tparams, tq, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert set(grads) == {k for k, m in TA.flatten(
        TA.trainable_mask(tq)).items() if m}
    assert any("mamba" in k[0] for k in grads)
    scale = max(np.abs(want[k]).max() for k in grads)
    assert scale > 0
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=2e-3,
                                   atol=1e-4 * scale, err_msg=str(k))


def test_refusals_match_the_reference():
    """Chunked prefill, speculative decoding and the slot scheduler refuse
    the SSM stack with the reference's messages; so does a block's
    speculative verify."""
    engine = Engine.from_checkpoint(ARCH, smoke=True, device="cpu")
    check_refusals(engine, "mamba")


def check_refusals(engine, kind):
    from repro_torch.launch import strategies as SG
    from repro_torch.launch.scheduler import SlotScheduler

    cfg = engine.cfg
    kinds = re.escape(f"got kinds=['{kind}'], modality=text")
    with pytest.raises(ValueError, match="chunked prefill covers "
                       "attention-only text stacks: SSM state folding has "
                       r"no per-request length masking yet \(" + kinds):
        TST.make_prefill_step(engine.model, engine.policy, prefill_chunk=8)
    with pytest.raises(ValueError, match="speculative decoding covers "
                       "attention-only text stacks: SSM state stepping has "
                       r"no per-slot freeze/rewind yet \(" + kinds):
        Engine(engine.model, cfg, engine.policy, engine.serve_params,
               engine.qparams, device="cpu", decode_strategy="speculative")
    with pytest.raises(ValueError, match=r"slot decode covers .*\(" + kinds):
        SG.make_strategy_slot_loop(engine.model, engine.policy,
                                   SG.GreedyStrategy(engine.model,
                                                     engine.policy))
    with pytest.raises(ValueError, match="slot scheduler covers "
                       r"attention-only text stacks \(" + kinds):
        SlotScheduler(engine.model, cfg, engine.policy, engine.serve_params,
                      engine.qparams, device="cpu")
    with pytest.raises(ValueError, match="speculative verify covers "
                       f"attention-only causal stacks \\(got kind='{kind}', "
                       r"cross=False\)"):
        blk = engine.model.stack.blocks[0]
        blk.verify(engine.serve_params["stack"]["layer0"],
                   torch.zeros((1, 2, cfg.d_model), dtype=cfg.dtype), {},
                   torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="shorter than the conv window"):
        engine.generate_batch({"tokens": np.zeros((1, 2), np.int32)}, gen=2)
