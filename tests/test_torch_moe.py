"""The mixture-of-experts decoders against the reference:
granite-moe-3b-a800m (40 experts top-8 at full width; 8 top-4 at SMOKE)
and mixtral-8x7b (8 experts top-2; 4 top-2 at SMOKE; a window on every
layer), at their ``SMOKE`` widths, weights bridged from the reference's
init, inputs drawn with numpy from a seed.

What is held bit for bit:
  * ``_dispatch``'s routing (expert choice with forced ties, ranks,
    drops, the trash slot, the dispatch buffer, each assignment's slot)
    and ``_combine`` (bf16 products summed over K in float32, in order),
    on router logits handed to both packages; the expert buffer is the
    port's expert-major (E, G x C, d) layout of the reference's (G, E, C,
    d) rows.  The top-k weights come from each package's float32 softmax,
    whose exp and row sum round otherwise in XLA (ROADMAP Queue C): they
    agree to 4 ulps (measured 3).
  * int8 expert weights ``w_q`` and ``w_scale``; the int32 sums of every
    expert's product (the port's per-expert calls of the fused kernel's
    plain version against the reference's einsum); an ExpertDense's int8
    output, float32 (the fused kernel's plain version with the reference
    kernel's ``out_dtype=float32``) and bf16; the MoE layer's int8 output
    at bf16 (the asymmetric scheme, 4 bits, percentile and pointwise
    variants too), the reference compiled with traced thresholds, as its
    engine compiles them.
  * the float32 engines with the reference's thresholds: greedy tokens
    over dense caches and mixtral's rings, and granite-moe's completions
    through both packages' slot schedulers.
  * Scalar-mode expert weights: the reference's int8 einsum raises on the
    0-d ``w_scale``; the port serves it and gives the reference's bits
    with the scale broadcast to (E, out).

Float tolerances, each with its worst value measured at these seeds:
  * router logits (float32 products in two orders): rtol 1e-5 of the
    row's largest |logit| (measured 5.4e-7); expert choice equal but
    where the two softmaxes' k-th and (k+1)-th probabilities lie within
    1e-6 (a near-tie; flips counted, at most 1%: measured 0 of 120 in
    each config).
  * the layer in none and fake mode: within two bf16 steps (the top-k
    weights' last float32 bits move a product's rounding; measured one
    element of 7680 two steps off) and fake mode atol 2e-2; the aux loss
    rtol 1e-6.
  * calibrated thresholds: the layer's observers exact at float32, rtol
    2e-2 at bf16 (the bf16 products of the two packages' einsums), the
    percentile variant rtol 1e-3; the engines' own calibrations rtol 1e-5
    (measured 6.6e-7 granite-moe, 3.7e-7 mixtral).
  * engine prefill logits atol 1e-4 with shared thresholds (mixtral's
    untied readout served with the last block's ``wq`` thresholds in both
    packages, as ``test_torch_archs.py``; measured 1.5e-7 and 0).
  * the pretrain loss with ``aux_weight`` rtol 1e-5, its aux rtol 1e-6,
    the gradients rtol 1e-3 atol 1e-4 x the largest of each leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import api as JA
from repro.core import equalization as JEQ
from repro.core.distill import chunked_ce_loss as jax_chunked_ce_loss
from repro.launch import steps as JST
from repro.launch.engine import Engine as JaxEngine
from repro.launch.scheduler import Request as JRequest
from repro.models import build_model as jax_build
from repro.models import moe as JM
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.core import equalization as TEQ
from repro_torch.kernels import ref
from repro_torch.launch import steps as TST
from repro_torch.launch.engine import Engine
from repro_torch.launch.scheduler import Request
from repro_torch.models import build_model as torch_build
from repro_torch.models import moe as TM
from repro_torch.models.transformer import check_supported

ARCHS = ("granite-moe-3b-a800m", "mixtral-8x7b")
B, PROMPT, GEN = 2, 40, 8
LOGIT_ATOL = 1e-4             # float32 engines, shared thresholds
WEIGHT_ULPS = 4               # top-k weights: two float32 softmaxes


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair_moe(arch, dtype, seed=1):
    """The reference's MoE layer of ``arch``'s smoke config and the port's,
    the same weights, and a (3, 40, d) input."""
    cfg = jax_config(arch, smoke=True)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = (cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k)
    jm = JM.MoE(*args, path="m", dtype=jdt)
    tm = TM.MoE(*args, path="m", dtype=tdt)
    jp = jm.init(jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).normal(size=(3, 40, cfg.d_model))
    jx = jnp.asarray(x.astype(np.float32)).astype(jdt)
    return jm, tm, jp, bridge.params_from_jax(_np(jp)), jx, \
        bridge.to_tensor(np.asarray(jx))


def _to_ref_layout(buf, g, c):
    """The port's expert-major (E, G x C, ...) buffer as the reference's
    (G, E, C, ...)."""
    e = buf.shape[0]
    return buf.reshape(e, g, c, *buf.shape[2:]).transpose(0, 1).numpy()


def _ref_slots(slots, e, g, c):
    """The reference's slot map (G, T x K) into (e x C + c) per group, as
    the port's rows of the flattened expert-major buffer."""
    gi = np.arange(g)[:, None]
    return np.where(slots < e * c, (slots // c) * g * c + gi * c + slots % c,
                    e * g * c)


# ---------------------------------------------------------------------------
# dispatch and combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,t,e,k,cap,ties", [
    (3, 24, 8, 4, 8, False), (3, 24, 8, 4, 8, True), (2, 17, 4, 2, 8, True),
    (2, 40, 40, 8, 8, False), (1, 5, 8, 4, 16, True)])
def test_dispatch_and_combine_bit_for_bit(g, t, e, k, cap, ties):
    """Routing, drops and the dispatch buffer bit for bit on shared logits
    (forced ties: logits on a grid of 1/2, so equal probabilities pick the
    lower expert, as ``lax.top_k``); the combine bit for bit on the same
    info, float32 and bf16."""
    rng = np.random.default_rng(g * 100 + t)
    x = rng.normal(size=(g, t, 16)).astype(np.float32)
    logits = rng.normal(size=(g, t, e)).astype(np.float32)
    if ties:
        logits = np.round(logits * 2) / 2
    jx, (jslots, jw) = jax.jit(JM._dispatch, static_argnums=(2, 3, 4))(
        jnp.asarray(x), jnp.asarray(logits), k, cap, e)
    tx, (tslots, tw) = TM._dispatch(torch.from_numpy(x),
                                    torch.from_numpy(logits), k, cap, e)
    jslots, jw = np.asarray(jslots), np.asarray(jw)
    np.testing.assert_array_equal(_to_ref_layout(tx, g, cap), np.asarray(jx))
    np.testing.assert_array_equal(tslots.numpy(),
                                  _ref_slots(jslots, e, g, cap))
    assert (np.abs(tw.numpy() - jw)
            <= WEIGHT_ULPS * np.spacing(np.abs(jw))).all()
    if cap * e < t * k:
        assert (jslots == e * cap).any()          # the case drops
    info = (torch.from_numpy(_ref_slots(jslots, e, g, cap)),
            torch.from_numpy(jw))
    y = rng.normal(size=(g, e, cap, 16)).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        jy = jnp.asarray(y).astype(getattr(jnp, dt))
        want = np.asarray(jax.jit(JM._combine, static_argnums=2)(
            jy, (jnp.asarray(jslots), jnp.asarray(jw)), t).astype(
                jnp.float32))
        ty = bridge.to_tensor(np.asarray(jy)).transpose(0, 1).reshape(
            e, g * cap, 16)
        got = TM._combine(ty, info, t)
        assert got.dtype == getattr(torch, dt)
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_combine_sums_k_in_float32_in_order():
    """XLA's CPU reduction of the reference's bf16 sum over K: bf16
    products, float32 accumulation in k order, one rounding.  Addends
    2^-12 to 2^30 apart tell the orders apart (a pairwise tree misses
    here)."""
    rng = np.random.default_rng(0)
    for k in (2, 4, 8):
        t, d = 64, 32
        mag = 2.0 ** rng.integers(-12, 31, size=(1, t * k, d))
        y = (mag * rng.choice([-1.0, 1.0], size=mag.shape)).astype(
            np.float32)
        jy = jnp.asarray(y).astype(jnp.bfloat16)[:, None]   # (1, E=1, C, d)
        slots = np.arange(t * k)[None]
        w = np.ones((1, t * k), np.float32)
        want = np.asarray(jax.jit(JM._combine, static_argnums=2)(
            jy, (jnp.asarray(slots), jnp.asarray(w)), t).astype(jnp.float32))
        ty = bridge.to_tensor(np.asarray(jy))[0]
        got = TM._combine(ty, (torch.from_numpy(slots), torch.from_numpy(w)),
                          t).float().numpy()
        np.testing.assert_array_equal(got, want)
        pairwise = torch.from_numpy(np.asarray(jy.astype(jnp.float32)))[0, 0]
        pairwise = pairwise.reshape(t, k, d)
        while pairwise.shape[1] > 1:
            pairwise = pairwise[:, 0::2] + pairwise[:, 1::2]
        if k > 2:
            assert (pairwise[:, 0].bfloat16().float().numpy()
                    != want[0]).any()


def test_top_k_ties_and_capacity_match():
    probs = np.array([[0.1, 0.3, 0.3, 0.3, 0.0], [0.2, 0.2, 0.2, 0.2, 0.2]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = TM.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for arch in ARCHS:
        for smoke in (True, False):
            cfg = torch_config(arch, smoke=smoke)
            for cf in (1.0, 1.25, cfg.n_experts / cfg.top_k):
                args = (cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k)
                jm = JM.MoE(*args, path="m", capacity_factor=cf)
                tm = TM.MoE(*args, path="m", capacity_factor=cf)
                for t in (1, 5, 8, 33, 128, 512, 4608):
                    assert tm.capacity(t) == jm.capacity(t), (arch, cf, t)
    full = {a: TM.MoE(*(lambda c: (c.d_model, c.d_ff, c.n_experts,
                                   c.top_k))(torch_config(a)), path="m")
            for a in ARCHS}
    # the chip's shapes: a decode step or a verify window, 4 x 512, 2 x 4608
    assert [full[a].capacity(t) for a in ARCHS for t in (1, 5, 512)] == [
        8, 8, 128, 8, 8, 160]
    assert full["mixtral-8x7b"].capacity(4608) == 1440


def test_routing_log_records_each_dispatch():
    """``routing_log`` records every dispatch while it is active: the
    device, each token's experts in ascending order (the reference's top-k
    set) and the gap between its k-th and (k+1)-th probabilities; nothing
    once it has closed."""
    rng = np.random.default_rng(12)
    g, t, e, k = 2, 5, 8, 3
    x = torch.from_numpy(rng.normal(size=(g, t, 4)).astype(np.float32))
    logits = rng.normal(size=(g, t, e)).astype(np.float32)
    tl = torch.from_numpy(logits)
    with TM.routing_log() as log:
        for _ in range(2):
            TM._dispatch(x, tl, k, 8, e)
    TM._dispatch(x, tl, k, 8, e)
    assert len(log) == 2 and TM._routing is None
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    _, ji = jax.lax.top_k(jnp.asarray(probs), k)
    srt = -np.sort(-probs, axis=-1)
    for dev, idx, gap in log:
        assert dev == "cpu"
        np.testing.assert_array_equal(idx.numpy(),
                                      np.sort(np.asarray(ji), -1))
        np.testing.assert_allclose(gap.numpy(),
                                   srt[..., k - 1] - srt[..., k],
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_router_logits_and_expert_choice(arch):
    """The router's float32 product in both packages: logits within rtol
    1e-5 of the row's largest |logit|; the top-k expert sets equal except
    where the reference's k-th and (k+1)-th probabilities lie within 1e-6
    (a near-tie the two products may flip), flips counted."""
    jm, tm, jp, tp, jx, tx = _pair_moe(arch, "float32")
    jl = np.asarray(jm.router(jp["router"], jx, None))
    tl = tm.router(tp["router"], tx, None).numpy()
    scale = np.abs(jl).max(-1, keepdims=True)
    assert (np.abs(tl - jl) <= 1e-5 * scale).all()
    k = jm.top_k
    jprob = np.asarray(jax.nn.softmax(jnp.asarray(jl), axis=-1))
    _, ji = jax.lax.top_k(jnp.asarray(jprob), k)
    _, ti = TM.top_k(torch.softmax(torch.from_numpy(tl), -1), k)
    srt = -np.sort(-jprob, axis=-1)
    gap = srt[..., k - 1] - srt[..., k]
    diff = (np.sort(np.asarray(ji), -1) != np.sort(ti.numpy(), -1)).any(-1)
    assert (gap[diff] < 1e-6).all()
    assert diff.sum() <= 0.01 * diff.size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_in_every_mode(arch, dtype):
    """none, calibrate, fake and int8 through the layer, the port serving
    the reference's calibrated thresholds (bridged): the observers equal,
    ``w_q`` and ``w_scale`` bit for bit; on the reference's dispatch each
    ExpertDense's int8 output equals the reference's, in its dtype, and
    the int32 sums of every expert's kernel call equal the reference's
    einsum; the
    whole layer in none mode within two bf16 steps of the reference
    (rtol 2^-6: the top-k weights' last float32 bits move a product's
    rounding; measured 1.02e-2 in 1 of 7680 elements), the aux within rtol
    1e-6."""
    jm, tm, jp, tp, jx, tx = _pair_moe(arch, dtype)
    jpol, tpol = JA.QuantPolicy(), TA.QuantPolicy()
    jy, jaux = jm(jp, jx, None)
    ty, taux = tm(tp, tx, None)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=2 ** -6, atol=1e-6)
    jq = JA.init_qparams(jm, jp, jpol)
    ctx = JA.make_ctx("calibrate", jpol, jq)
    jm(jp, jx, ctx)
    tq = TA.init_qparams(tm, tp, tpol)
    tctx = TA.make_ctx("calibrate", tpol, tq)
    tm(tp, tx, tctx)
    assert set(tctx.updates) == set(ctx.updates) == {"m/gate", "m/up",
                                                     "m/down"}
    for path, obs in ctx.updates.items():
        np.testing.assert_allclose(tctx.updates[path]["t_max"].numpy(),
                                   np.asarray(obs["t_max"]),
                                   rtol=2e-2 if dtype == "bfloat16" else 0)
        assert tq[path]["w"]["t_max"].shape == (jm.num_experts,
                                                jm.d_model if path == "m/down"
                                                else jm.d_ff)
    for path, obs in ctx.updates.items():
        jq[path] = {**jq[path], "act": obs}
    jq = JA.finalize_calibration(jq, jpol)
    bq = bridge.qparams_from_jax(_np(jq))
    jsp = JA.convert_to_int8(jm, jp, jq, jpol)
    tsp = TA.convert_to_int8(tm, tp, bq, tpol)
    for name in ("gate", "up", "down"):
        for leaf in ("w_q", "w_scale"):
            np.testing.assert_array_equal(tsp[name][leaf].numpy(),
                                          np.asarray(jsp[name][leaf]))
    assert tsp["router"]["w"].dtype == torch.float32     # never quantized
    # fake mode: the student's forward
    jf, _ = jm(jp, jx, JA.make_ctx("fake", jpol, jq))
    tf, _ = tm(tp, tx, TA.make_ctx("fake", tpol, bq))
    np.testing.assert_allclose(tf.float().numpy(),
                               np.asarray(jf.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2e-2)
    # int8: each ExpertDense on the reference's dispatch buffer
    s = jx.shape[1]
    jl = jm.router(jp["router"], jx.astype(jnp.float32), None)
    jxd, _ = JM._dispatch(jx, jl, jm.top_k, jm.capacity(s), jm.num_experts)
    g, e, c, d = jxd.shape
    txd = bridge.to_tensor(np.asarray(jxd)).transpose(0, 1).reshape(
        e, g * c, d).contiguous()
    jctx = JA.make_ctx("int8", jpol, jq)
    calls = []
    real = ref.quant_matmul_ref

    def spy(x, w_q, w_scale, act_scale, *args, **kw):
        calls.append((x.clone(), w_q, act_scale))
        return real(x, w_q, w_scale, act_scale, *args, **kw)

    ref.quant_matmul_ref = spy
    try:
        tg = tm.gate(tsp["gate"], txd, TA.make_ctx("int8", tpol, bq))
    finally:
        ref.quant_matmul_ref = real
    jg = jm.gate(jsp["gate"], jxd, jctx)
    assert tg.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_to_ref_layout(tg.float(), g, c),
                                  np.asarray(jg.astype(jnp.float32)))
    assert len(calls) == e
    # the int32 sums: the reference's einsum with a unit dequant scale
    # (w_scale = s_x) gives each sum exactly in float32 (|acc| < 2^24)
    s_x = float(calls[0][2])
    unit = {"w_q": jsp["gate"]["w_q"],
            "w_scale": jnp.full_like(jsp["gate"]["w_scale"], s_x)}
    want = np.asarray(JA.expert_dense_forward(
        jm.gate, unit, jxd.astype(jnp.float32), jctx))
    for i, (x, w_q, act) in enumerate(calls):
        x_q = torch.clamp(torch.round(x.float() * act), -127, 127)
        acc = (x_q.double() @ w_q.double()).numpy()
        np.testing.assert_array_equal(acc, want[:, i].reshape(g * c, -1))


VARIANTS = {"asymmetric": dict(act_symmetric=False),
            "percentile": dict(observer="percentile"),
            "pointwise": dict(pointwise_scales=True),
            "bits4": dict(bits=4)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_variants_through_the_layer(arch, variant):
    """The paper's ``QuantPolicy`` variants on the MoE layer at bf16: the
    calibrated activation thresholds (percentile: the mean of per-batch
    percentiles of the dispatch buffer, zero rows included; rtol 1e-3),
    ``w_q`` / ``w_scale`` bit for bit (pointwise: after random scales in
    [0.8, 1.2]), and the int8 layer bit for bit on shared thresholds: the
    asymmetric scheme's [0, 255] clip and saturating cast, and the 4-bit
    [-7, 7] clip, through the ±127 kernel."""
    kw = VARIANTS[variant]
    jm, tm, jp, tp, jx, tx = _pair_moe(arch, "bfloat16", seed=2)
    jpol, tpol = JA.QuantPolicy(**kw), TA.QuantPolicy(**kw)
    jq = JA.init_qparams(jm, jp, jpol)
    ctx = JA.make_ctx("calibrate", jpol, jq)
    jm(jp, jx, ctx)
    tq = TA.init_qparams(tm, tp, tpol)
    tctx = TA.make_ctx("calibrate", tpol, tq)
    tm(tp, tx, tctx)
    for path, obs in ctx.updates.items():
        jq[path] = {**jq[path], "act": obs}
        np.testing.assert_allclose(tctx.updates[path]["t_max"].numpy(),
                                   np.asarray(obs["t_max"]), rtol=1e-3)
    jq = JA.finalize_calibration(jq, jpol)
    bq = bridge.qparams_from_jax(_np(jq))
    if variant == "pointwise":
        rng = np.random.default_rng(4)
        for path in jq:
            pw = rng.uniform(0.8, 1.2, np.asarray(
                jq[path]["w"]["pointwise"]).shape).astype(np.float32)
            jq[path]["w"]["pointwise"] = jnp.asarray(pw)
            bq[path]["w"]["pointwise"] = torch.from_numpy(pw)
    jsp = JA.convert_to_int8(jm, jp, jq, jpol)
    tsp = TA.convert_to_int8(tm, tp, bq, tpol)
    for name in ("gate", "up", "down"):
        for leaf in ("w_q", "w_scale"):
            np.testing.assert_array_equal(tsp[name][leaf].numpy(),
                                          np.asarray(jsp[name][leaf]))
    jy, _ = _int8_jit(jm, jpol)(jsp, jx, jq)
    ty, _ = tm(tsp, tx, TA.make_ctx("int8", tpol, bq))
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))


def _int8_jit(jm, jpol):
    """The reference layer's int8 forward compiled as its engine compiles
    it: the thresholds are arguments (traced), not constants (XLA folds a
    constant threshold's ``w_scale / s_x`` into ``w_scale * (1 / s_x)``)."""
    return jax.jit(lambda p, x, q: jm(p, x, JA.make_ctx("int8", jpol, q)))


def test_quant_matmul_float32_output():
    """The reference kernel's ``out_dtype=float32`` (what a float32
    config's expert einsum returns): the plain version against the Pallas
    kernel in interpret mode, bit for bit.  A float32 expert product goes
    through the fused kernel's float32 output, one call per expert into
    its slice of the (E, M, N) float32 output, on every device: on the
    meta device (the dry run) it returns that output's type and shape."""
    from repro.kernels import quant_matmul as jqm

    rng = np.random.default_rng(6)
    x = (rng.normal(size=(16, 64)) * 2).astype(np.float32)
    w_q = rng.integers(-127, 128, (64, 32), dtype=np.int8)
    w_scale = (rng.random(32) * 1e-2).astype(np.float32)
    act = np.float32(127.0 / (np.abs(x).max() * 0.7))
    want = jqm.quant_matmul(jnp.asarray(x), jnp.asarray(w_q),
                            jnp.asarray(w_scale), jnp.asarray(act),
                            out_dtype=jnp.float32, interpret=True)
    args = [torch.from_numpy(a) for a in (x, w_q, w_scale, np.asarray(act))]
    got = ref.quant_matmul_ref(*args, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    meta = dict(device="meta")
    astate = {"t_max": torch.tensor(1.0, **meta),
              "alpha": torch.tensor(1.0, **meta)}
    y = TA._expert_int8(torch.empty((2, 16, 64), **meta),
                        torch.empty((2, 64, 32), dtype=torch.int8, **meta),
                        torch.empty((2, 32), **meta), astate,
                        TA.QuantPolicy().act_spec(), torch.float32)
    assert y.dtype == torch.float32 and y.shape == (2, 16, 32)


def test_scalar_weights_where_the_reference_raises():
    """Scalar-mode expert weights (one threshold per ExpertDense): the
    reference's int8 einsum indexes the 0-d ``w_scale`` as (E, out) and
    raises; the port serves it, and its output is the reference's on the
    same weights with that one scale broadcast to (E, out)."""
    jm, tm, jp, tp, jx, tx = _pair_moe("granite-moe-3b-a800m", "bfloat16")
    kw = dict(weight_per_channel=False)
    jpol, tpol = JA.QuantPolicy(**kw), TA.QuantPolicy(**kw)
    jq = JA.init_qparams(jm, jp, jpol)
    ctx = JA.make_ctx("calibrate", jpol, jq)
    jm(jp, jx, ctx)
    for path, obs in ctx.updates.items():
        jq[path] = {**jq[path], "act": obs}
    jq = JA.finalize_calibration(jq, jpol)
    jsp = JA.convert_to_int8(jm, jp, jq, jpol)
    assert jsp["gate"]["w_scale"].ndim == 0
    with pytest.raises(IndexError):
        _int8_jit(jm, jpol)(jsp, jx, jq)
    bq = bridge.qparams_from_jax(_np(jq))
    tsp = TA.convert_to_int8(tm, tp, bq, tpol)
    ty, _ = tm(tsp, tx, TA.make_ctx("int8", tpol, bq))
    wide = {n: {**jsp[n], "w_scale": jnp.broadcast_to(
        jsp[n]["w_scale"], (jm.num_experts, jsp[n]["w_q"].shape[-1]))}
        for n in ("gate", "up", "down")}
    wide["router"] = jsp["router"]
    jy, _ = _int8_jit(jm, JA.QuantPolicy())(wide, jx, jq)
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _readout_thresholds(qparams, cfg):
    """mixtral's untied lm_head served with the last block's ``wq``
    activation thresholds, in both packages: neither calibration observes
    the readout's input (its threshold stays at the 1e-8 floor, logits
    ~1e-8), as ``test_torch_archs.py`` does for stablelm-12b."""
    if cfg.tie_embeddings:
        return qparams
    last = f"{cfg.name}/stack/layer{cfg.n_layers - 1}/attn/wq"
    head = f"{cfg.name}/lm_head"
    return {**qparams, head: {**qparams[head], "act": qparams[last]["act"]}}


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The reference Engine (``use_pallas=True``) and the port's at float32
    (as ``test_torch_archs.py``'s float32 cases), the port serving the
    reference's weights and thresholds, dense caches (and mixtral's rings),
    each generating 8 tokens for 2 prompts of 40 (48 through the rings)."""
    arch = request.param
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config(arch, smoke=True).replace(dtype=torch.float32)
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
    jq = _readout_thresholds(ref.qparams, jcfg)
    tq = bridge.qparams_from_jax(_np(jq))
    out = dict(arch=arch, prompts=prompts, calibrated=(ref.qparams,
                                                       ours.qparams),
               ref_params=ref.serve_params, ours_params=ours.serve_params)
    layouts = ("dense", "ring") if jcfg.window else ("dense",)
    for layout in layouts:
        r = JaxEngine(ref.model, jcfg, ref.policy, ref.serve_params, jq,
                      mode="int8", cache_layout=layout)
        o = Engine(ours.model, tcfg, ours.policy, ours.serve_params, tq,
                   device="cpu", cache_layout=layout)
        p = prompts if layout == "dense" else rng.integers(
            0, jcfg.vocab, (B, 48), dtype=np.int32)
        out[layout] = dict(
            engine=o, prompts=p,
            ref=np.asarray(r.generate_batch({"tokens": jnp.asarray(p)},
                                            gen=GEN).tokens),
            ref_logits=_ref_prefill_logits(r, jcfg, p),
            ours=o.generate_batch({"tokens": p}, gen=GEN))
    return out


def _ref_prefill_logits(ref, jcfg, prompts):
    """The reference engine's last-position logits after the one-shot
    prefill of ``prompts``."""
    b, s = prompts.shape
    cache = ref.init_cache(b, ref._cache_len(s, GEN))
    logits, _ = jax.jit(JST.make_prefill_step(
        ref.model, jcfg, ref.policy, "int8"))(
        ref.serve_params, ref.qparams, {"tokens": jnp.asarray(prompts)},
        cache)
    return np.asarray(logits.astype(jnp.float32))[:, -1]


def test_engine_int8_weights_and_thresholds(served):
    """Both packages' own calibrations: every threshold within rtol 1e-5
    (float32 sums in other orders), every int8 weight of the port's own
    engine equal to the reference's (the weight thresholds come from the
    weights)."""
    ref, ours = served["calibrated"]
    ref = _np(ref)
    assert set(ref) == set(ours)
    for path, entry in ref.items():
        for group, leaves in entry.items():
            for name, want in leaves.items():
                np.testing.assert_allclose(ours[path][group][name].numpy(),
                                           want, rtol=1e-5, atol=0,
                                           err_msg=f"{path}/{group}/{name}")
    n = 0
    for path, want, got in _walk_int8(served["ref_params"],
                                      served["ours_params"]):
        np.testing.assert_array_equal(got, want, err_msg=path)
        n += 1
    cfg = torch_config(served["arch"], smoke=True)
    assert n == 2 * (7 * cfg.n_layers + (not cfg.tie_embeddings))


def _walk_int8(a, b, path=""):
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _walk_int8(v, b[k], f"{path}/{k}")
        elif k in ("w_q", "w_scale"):
            yield f"{path}/{k}", np.asarray(v), b[k].numpy()


def test_engine_greedy_tokens(served):
    """generate_batch over dense caches (and mixtral's rings of 32, the
    48-token prompts passing the window): prefill logits within atol 1e-4
    of the reference's (``test_torch_archs.py``'s float32 tolerance with
    shared thresholds), greedy tokens identical; the port's graphs' step
    functions == its eager ``loop=True`` driver bit for bit."""
    for layout in ("dense", "ring"):
        if layout not in served:
            continue
        lay = served[layout]
        out, engine = lay["ours"], lay["engine"]
        np.testing.assert_allclose(out.prefill_logits.float().numpy(),
                                   lay["ref_logits"], atol=LOGIT_ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(out.tokens.numpy(), lay["ref"],
                                      err_msg=layout)
        eager = engine.generate_batch({"tokens": lay["prompts"]}, gen=GEN,
                                      loop=True)
        assert torch.equal(eager.tokens, out.tokens)
        if layout == "ring":
            caches = engine.init_cache(B, engine._cache_len(48, GEN))
            assert {c["attn"].layout for c in caches.values()} == {"ring"}


def test_scheduler_against_the_reference_scheduler():
    """granite-moe through both packages' slot schedulers (paged, chunks of
    8, 2 slots, ragged requests) at float32, the port serving the
    reference's weights and thresholds: completions identical, request for
    request (the admission's chunked prefill has a capacity per chunk, in
    both; a decode group is one slot's token)."""
    jcfg = jax_config("granite-moe-3b-a800m", smoke=True).replace(
        dtype=jnp.float32)
    tcfg = torch_config("granite-moe-3b-a800m", smoke=True).replace(
        dtype=torch.float32)
    rng = np.random.default_rng(31)
    calib = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (4, 32),
                                                 dtype=np.int32))}
             for _ in range(2)]
    knobs = dict(cache_layout="paged", page_size=8, prefill_chunk=8)
    ref = JaxEngine.from_checkpoint(cfg=jcfg, use_pallas=True,
                                    calib_batches=calib, **knobs)
    params = bridge.params_from_jax(_np(jax_build(jcfg).init(
        jax.random.PRNGKey(0))))
    ours = Engine.from_checkpoint(
        cfg=tcfg, params=params, device="cpu",
        qparams=bridge.qparams_from_jax(_np(ref.qparams)), **knobs)
    prompts = [rng.integers(0, jcfg.vocab, (n,), dtype=np.int32)
               for n in (9, 20, 3, 17, 24)]
    kw = dict(max_slots=2, block_steps=3)
    want = {c.rid: c for c in ref.generate(
        [JRequest(rid=i, tokens=p, max_gen=6) for i, p in enumerate(prompts)],
        **kw)}
    got = {c.rid: c for c in ours.generate(
        [Request(rid=i, tokens=p, max_gen=6) for i, p in enumerate(prompts)],
        **kw)}
    assert set(got) == set(want) == set(range(len(prompts)))
    for rid, c in got.items():
        assert (c.status, c.finished_by, len(c.tokens)) == (
            want[rid].status, want[rid].finished_by, 6) == ("ok", "budget",
                                                             6)
        assert [int(t) for t in c.tokens] == [int(t) for t in
                                              want[rid].tokens], rid


# ---------------------------------------------------------------------------
# training, plans, equalization, refusals
# ---------------------------------------------------------------------------

def test_pretrain_step_weighs_the_aux_loss():
    """The pretrain loss ce + aux_weight x aux at float32 (granite-moe
    smoke, aux_weight 0.5): loss, aux and the gradient of every leaf (the
    router's and the experts' included) against ``jax.value_and_grad`` of
    the reference's loss; the step's loss equals the one computed here."""
    arch = "granite-moe-3b-a800m"
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config(arch, smoke=True).replace(dtype=torch.float32)
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(_np(jparams))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 32),
                                             dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    w = 0.5
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}

    def loss_fn(params):                      # the reference's loss_fn
        h, aux = jm.hidden(params, jbatch, None, remat=jcfg.remat)
        ce = jax_chunked_ce_loss(h, jbatch["labels"], jm.readout_fn(params),
                                 chunk=jcfg.loss_chunk)
        return ce + w * aux, aux

    (want_loss, want_aux), want = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams)
    want = TA.flatten(_np(want))
    flat = TA.flatten(tparams)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    p = TA.unflatten(leaves)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    h, aux = tm.hidden(p, batch, None, with_aux=True)
    from repro_torch.core.distill import chunked_ce_loss
    loss = chunked_ce_loss(h, batch["labels"], tm.readout_fn(p),
                           chunk=tcfg.loss_chunk) + w * aux
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(grads) == set(want)
    assert any("router" in k for k in grads)
    for k, g in grads.items():
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=str(k))
    step = TST.make_pretrain_step(tm, TST.TrainHParams(aux_weight=w))
    from repro_torch.optim.adam import adam_init
    _, _, metrics = step(tparams, adam_init(flat), batch)
    assert torch.equal(metrics["loss"], loss.detach())


@pytest.mark.parametrize("arch", ARCHS)
def test_plans_match_the_reference(arch):
    """fold_plan (an MoE block's ffn norm does not fold: the router reads
    it) and equalization_plan (up -> down per MoE) equal the
    reference's."""
    jm = jax_build(jax_config(arch, smoke=True))
    tm = torch_build(torch_config(arch, smoke=True))
    assert tm.fold_plan() == jm.fold_plan()
    assert tm.equalization_plan() == jm.equalization_plan()
    assert any(up.endswith("/moe/up") for up, _ in tm.equalization_plan())


def test_equalization_rescales_expert_by_expert():
    """``equalize_model``'s per-expert rescale over (E, in, out) weights on
    a tree keyed by the plan's module paths (the reference's walk matches
    no param key on the served configs, ROADMAP Queue C): the rescaled
    weights and the report against the reference's, float32 rtol 1e-6."""
    arch = "granite-moe-3b-a800m"
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32)
    jm = jax_build(jcfg)
    tm = torch_build(torch_config(arch, smoke=True).replace(
        dtype=torch.float32))
    rng = np.random.default_rng(8)
    tree = {}
    e, dm, f = jcfg.n_experts, jcfg.d_model, jcfg.d_ff
    for up, down in jm.equalization_plan():
        if not up.endswith("/moe/up"):
            continue        # the attention pairs: not in the tree, skipped
        for path, shape in ((up, (e, dm, f)), (down, (e, f, dm))):
            node = tree
            for part in path.split("/"):
                node = node.setdefault(part, {})
            node["w"] = (rng.normal(size=shape) * rng.uniform(
                0.2, 3, size=shape[-1])).astype(np.float32)
    jout, jrep = JEQ.equalize_model(jm, jax.tree.map(jnp.asarray, tree))
    tout, trep = TEQ.equalize_model(tm, bridge.params_from_jax(tree))
    jflat, tflat = TA.flatten(_np(jout)), TA.flatten(tout)
    assert set(jflat) == set(tflat)
    moved = 0
    for k, want in jflat.items():
        np.testing.assert_allclose(tflat[k].numpy(), want, rtol=1e-6,
                                   err_msg=str(k))
        moved += not np.array_equal(want, tree_get(tree, k))
    assert moved == len(jflat) == 2 * jcfg.n_layers
    assert set(trep) == set(jrep)
    for k, res in jrep.items():
        np.testing.assert_allclose(trep[k].scales.numpy(),
                                   np.asarray(res.scales), rtol=1e-6)


def tree_get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_moe_is_supported_and_sp_refuses_it():
    """Both configs build; under sequence parallelism (sp=2) granite-moe
    serves (``test_torch_sharded_families.py`` holds it against the
    reference's sp=2), and mixtral, windowed in every layer, raises the
    reference's ValueError at its first sp decode over dense caches (its
    ``_sp_decode``: "sliding-window decode is local by construction")."""
    from repro_torch.shard import ShardedEngine

    for arch in ARCHS:
        check_supported(torch_config(arch))
    prompts = np.arange(16, dtype=np.int32).reshape(2, 8)
    eng = ShardedEngine.from_checkpoint("granite-moe-3b-a800m", smoke=True,
                                        device="cpu", sp=2)
    assert eng.generate_batch({"tokens": prompts}, gen=3).tokens.shape == (
        2, 3)
    eng = Engine.from_checkpoint("mixtral-8x7b", smoke=True, device="cpu")
    sharded = ShardedEngine(eng.model, eng.cfg, eng.policy, eng.serve_params,
                            eng.qparams, device="cpu", sp=2,
                            cache_layout="dense")
    with pytest.raises(ValueError) as got:
        sharded.generate_batch({"tokens": prompts}, gen=3)
    assert str(got.value) == (
        f"{eng.cfg.name}/stack/layer0/attn: sliding-window decode is local "
        "by construction — run SWA layers unsharded (sp=1)")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_steps_read_nothing_back(monkeypatch, arch):
    """The captured programs through MoE layers read nothing back to the
    host, make no tensor from host data and index with no boolean mask
    (the capture rules of ``tests/test_torch_graphs.py``): generate_batch's
    prefill and decode step, and granite-moe's scheduler admission and
    decode block over a paged cache."""
    from repro_torch.analysis import guarded

    eng = Engine.from_checkpoint(arch, smoke=True, device="cpu",
                                 cache_layout="dense")
    prompts = np.random.default_rng(2).integers(0, eng.cfg.vocab,
                                                (2, PROMPT), dtype=np.int32)
    with torch.inference_mode():
        prog = eng._batch_program((2, PROMPT, eng._cache_len(PROMPT, GEN)))
        prog.tokens[:, :PROMPT].copy_(torch.from_numpy(prompts))
        prog.prefill()
        prog.decode()
        with guarded():
            prog.prefill()
            prog.decode()
    if eng.cfg.window:
        return                  # the slot scheduler refuses windows
    paged = Engine(eng.model, eng.cfg, eng.policy, eng.serve_params,
                   eng.qparams, device="cpu", cache_layout="paged",
                   page_size=8, prefill_chunk=8)
    sched = paged.make_scheduler(max_slots=3, prompt_cap=16, gen_cap=8,
                                 block_steps=3)
    with torch.inference_mode():
        sched._programs()
        sched._adm_toks[0, :12].copy_(torch.from_numpy(prompts[0, :12]))
        sched._adm_len.fill_(12)
        sched._tok.copy_(torch.tensor([3, 4, 5]))
        sched._pos.copy_(torch.tensor([12, 5, 0], dtype=torch.int32))
        sched._active.copy_(torch.tensor([True, True, False]))
        sched._admission()
        sched._block()
        with guarded():
            sched._admission()
            sched._block()
