"""The paper's FAT variants in the port against the reference: the
asymmetric scheme (§3.1.4), scalar weights (§3.1.5), the §4.2 pointwise
scales, the percentile and min-max observers, the int32 bias (eq. 20),
and every ``QuantPolicy`` of the paper's grid through calibration, the
fake-quant student and the int8 conversion.

Same numpy inputs through ``repro`` (JAX) and ``repro_torch``, float32
unless a test says otherwise.

Tolerances and why:
  * Integer tensors (``w_q`` in scalar and vector mode, with and without
    pointwise scales, int32 biases) and the max-abs and min-max thresholds
    are bit-identical: the same float32 operations in the same order.
  * Fake-quant forwards are bit-identical for the same reason (round half
    to even, one IEEE division each).
  * Percentile thresholds: rtol 1e-6.  Both interpolate linearly between
    the same two sorted values with the same float32 weights, but XLA may
    fuse the weighted sum or the running mean into a multiply-add
    (measured worst 9.2e-8, one ulp).
  * Gradients to ``alpha``, ``alpha_t``, ``alpha_r`` and ``pointwise``:
    rtol 1e-5 with an absolute floor of 1e-5 of the largest gradient of
    the leaf (per-channel sums add the same terms in another order; a sum
    that cancels keeps the absolute error of its terms).  The asymmetric
    scheme's alpha_t / alpha_r gradients take a floor of 1e-4: each
    element contributes +-x / width terms that cancel to the rounding
    residual, most of all on a one-sided range (measured worst 2.7e-5 of
    the largest gradient, per-channel alpha_r on [2.6, 3.4]); the input
    gradient is bit-identical.  Through a Dense layer (1024 activations
    into one alpha_r, after a float32 matmul that each framework sums in
    its own order) those terms cancel to 1/75 of their absolute sum, so
    the asymmetric activation leaves there are held to rtol 1e-3
    (measured worst 3.6e-4, alpha_r; 1.1e-5 of the terms' absolute sum).
    A scalar-mode weight alpha (0-d) sums all 3072 weights' rounding
    residuals, of both signs: rtol 1e-4 (measured worst 5.2e-5).
  * int8 matmuls are bit-identical to the reference path they copy:
    ``use_pallas=True`` for vector weights (any activation scheme or
    width), the XLA path for scalar weights at bfloat16 activations (the
    int32 sums are exact, and both round the float32 product once to
    bf16).
  * The model-level fake-mode logits (2 layers, float32): rtol 1e-5, atol
    1e-5 (the two frameworks' float32 matmuls sum in other orders; no
    fake-quantizer input crossed a rounding boundary on these inputs).

Three standing differences of the reference are pinned here (ROADMAP
Queue C): its fused matmul cannot take scalar-mode weights, its XLA and
fused paths disagree for asymmetric activations in int8 mode (the port
copies the fused path), and it cannot serve per-channel activation
thresholds in int8 mode (both raise).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import api as JA
from repro.core import calibration as JC
from repro.core import quant as JQ
from repro.launch import steps as JST
from repro.models import build_model as jax_build
from repro.models.module import Dense as JDense
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.core import calibration as TC
from repro_torch.core import quant as TQ
from repro_torch.launch import steps as TST
from repro_torch.launch.engine import prepare_int8
from repro_torch.models import build_model as torch_build
from repro_torch.models.module import Dense as TDense


def _t(a):
    return bridge.to_tensor(np.asarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_grad(got, want, floor=1e-5, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# quant primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("symmetric,unsigned", [(True, False), (True, True),
                                                (False, False),
                                                (False, True)])
def test_quant_spec_ranges_match(bits, symmetric, unsigned):
    kw = dict(bits=bits, symmetric=symmetric, unsigned=unsigned)
    j, t = JQ.QuantSpec(**kw), TQ.QuantSpec(**kw)
    assert (t.levels, t.qmin, t.qmax) == (j.levels, j.qmin, j.qmax)
    assert t.signed_alpha_t_range() == j.signed_alpha_t_range()


def test_kv_and_default_specs_keep_their_bits():
    """Every existing ``QuantSpec(...)`` call of the port defaults to
    symmetric signed: levels 127 at int8, 7 at int4."""
    for kv_bits, levels in ((8, 127.0), (4, 7.0)):
        spec = TA.QuantPolicy(kv_int8=True, kv_bits=kv_bits).kv_spec()
        assert (spec.levels, spec.qmin, spec.symmetric) == (levels, -levels,
                                                            True)
    assert TA.QuantPolicy().act_spec().levels == 127.0
    assert TA.QuantPolicy(act_symmetric=False).act_spec().levels == 255.0


@pytest.mark.parametrize("per_channel,axis", [(False, -1), (True, -1),
                                              (True, 0)])
def test_thresholds_bit_identical(per_channel, axis):
    x = np.random.default_rng(0).normal(size=(6, 5, 7)).astype(np.float32)
    kw = dict(per_channel=per_channel, channel_axis=axis)
    j, t = JQ.QuantSpec(**kw), TQ.QuantSpec(**kw)
    np.testing.assert_array_equal(TQ.max_abs_threshold(_t(x), t).numpy(),
                                  np.asarray(JQ.max_abs_threshold(
                                      jnp.asarray(x), j)))
    for got, want in zip(TQ.min_max_threshold(_t(x), t),
                         JQ.min_max_threshold(jnp.asarray(x), j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("one_sided", [False, True])
def test_fake_quant_asymmetric_matches(unsigned, per_channel, one_sided):
    """Forward bit for bit; gradients to x, alpha_t and alpha_r, with
    alpha values inside, on and outside their clip ranges.  A one-sided
    range ([2.6, 3.4]) puts the zero point far outside [0, 255]."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    if one_sided:
        x = 3.0 + 0.4 * np.tanh(x)
    g = rng.normal(size=x.shape).astype(np.float32)
    kw = dict(symmetric=False, unsigned=unsigned, per_channel=per_channel)
    jspec, tspec = JQ.QuantSpec(**kw), TQ.QuantSpec(**kw)
    if per_channel:
        t_l, t_r = x.min(axis=0), x.max(axis=0)
        a_t = np.array([-0.3, -0.2, 0.0, 0.1, 0.4, 0.5], np.float32)
        a_r = np.array([0.4, 0.5, 0.7, 0.9, 1.0, 1.1], np.float32)
    else:
        t_l, t_r = np.float32(x.min()), np.float32(x.max())
        a_t, a_r = np.float32(0.05), np.float32(0.9)

    def jf(x, a_t, a_r):
        y = JQ.fake_quant_asymmetric(x, jnp.asarray(t_l), jnp.asarray(t_r),
                                     a_t, a_r, jspec)
        return jnp.sum(y * g), y

    (_, jy), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(a_t), jnp.asarray(a_r))
    xs, ats, ars = (_t(v).requires_grad_(True) for v in (x, a_t, a_r))
    ty = TQ.fake_quant_asymmetric(xs, _t(t_l), _t(t_r), ats, ars, tspec)
    (ty * _t(g)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(xs.grad.numpy(), np.asarray(jg[0]))
    for got, want in zip((ats, ars), jg[1:]):
        _close_grad(got.grad.numpy(), want, floor=1e-4)


@pytest.mark.parametrize("unsigned", [False, True])
def test_fake_quant_symmetric_scalar_and_unsigned(unsigned):
    """The per-tensor (scalar-mode) symmetric fake-quant, signed and on the
    unsigned [0, 255] grid: forward bit for bit, alpha's gradient."""
    rng = np.random.default_rng(2)
    x = np.abs(rng.normal(size=(16, 8))).astype(np.float32) * (
        1 if unsigned else np.sign(rng.normal(size=(16, 8))))
    x = x.astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    j, t = (m.QuantSpec(unsigned=unsigned) for m in (JQ, TQ))
    t_max = np.float32(np.abs(x).max())
    jf = lambda a: JQ.fake_quant_symmetric(jnp.asarray(x), t_max, a, j)
    jy = jf(jnp.float32(0.8))
    jda = jax.grad(lambda a: jnp.sum(jf(a) * g))(jnp.float32(0.8))
    a = torch.tensor(0.8, requires_grad=True)
    ty = TQ.fake_quant_symmetric(_t(x), _t(t_max), a, t)
    (ty * _t(g)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    _close_grad(a.grad.numpy(), jda)


def test_pointwise_scale_matches():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(8, 5)).astype(np.float32)
    p = rng.uniform(0.6, 1.4, size=(8, 5)).astype(np.float32)
    p[0, :3] = [0.75, 1.25, 1.0]
    g = rng.normal(size=w.shape).astype(np.float32)
    jy = JQ.apply_pointwise_scale(jnp.asarray(w), jnp.asarray(p))
    jdp = jax.grad(lambda p: jnp.sum(JQ.apply_pointwise_scale(
        jnp.asarray(w), p) * g))(jnp.asarray(p))
    ps = _t(p).requires_grad_(True)
    ty = TQ.apply_pointwise_scale(_t(w), ps)
    (ty * _t(g)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ps.grad.numpy(), np.asarray(jdp))


def test_quantize_bias_int32_matches_and_saturates():
    rng = np.random.default_rng(4)
    b = rng.normal(size=16).astype(np.float32)
    b[:4] = [1e6, -1e6, 1e3, -1e3]         # the first two saturate
    act = np.float32(0.02)
    w_s = rng.uniform(1e-5, 1e-2, 16).astype(np.float32)
    w_s[:2] = 1e-3
    want = np.asarray(JQ.quantize_bias_int32(jnp.asarray(b),
                                             jnp.asarray(act),
                                             jnp.asarray(w_s)))
    got = TQ.quantize_bias_int32(_t(b), _t(act), _t(w_s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == 2**31 - 1 and want.min() == -2**31


# ---------------------------------------------------------------------------
# observers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["max_abs", "percentile", "min_max"])
@pytest.mark.parametrize("per_channel", [False, True])
def test_observer_kinds_match(kind, per_channel):
    """Three batches folded into each observer kind; every state leaf."""
    rng = np.random.default_rng(5)
    xs = [(rng.standard_t(3, size=(4, 33, 12)) * (i + 1)).astype(np.float32)
          for i in range(3)]
    kw = dict(per_channel=per_channel)
    jspec, tspec = JQ.QuantSpec(**kw), TQ.QuantSpec(**kw)
    ch = 12 if per_channel else None
    js, ts = JC.init_observer(jspec, ch), TC.init_observer(tspec, ch)
    for x in xs:
        js = JC.update_observer(js, jnp.asarray(x), jspec, kind=kind,
                                percentile=99.9)
        ts = TC.update_observer(ts, _t(x), tspec, kind=kind, percentile=99.9)
    for key in ("t_min", "t_hi", "count"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    if kind == "percentile":
        np.testing.assert_allclose(ts["t_max"].numpy(),
                                   np.asarray(js["t_max"]), rtol=1e-6)
        assert not np.array_equal(ts["t_max"].numpy(),
                                  np.abs(np.stack(xs)).max(axis=(0, 1, 2)
                                                           if per_channel
                                                           else None))
    else:
        np.testing.assert_array_equal(ts["t_max"].numpy(),
                                      np.asarray(js["t_max"]))
    jt = _np(JC.observer_thresholds(js, jspec))
    tt = TC.observer_thresholds(ts)
    assert set(jt) == set(tt)


def test_percentile_takes_inputs_beyond_torch_quantile():
    """The linear-interpolation percentile on 2^24 + 5 elements (where
    ``torch.quantile`` refuses), against numpy's linear method."""
    x = np.random.default_rng(6).normal(size=(2**24 + 5,)).astype(np.float32)
    got = float(TC.percentile_linear(_t(np.abs(x)), 99.99, (0,)))
    want = np.percentile(np.abs(x).astype(np.float64), 99.99)
    assert got == pytest.approx(want, rel=1e-6)


def test_unknown_observer_raises():
    with pytest.raises(ValueError, match="observer"):
        TA.QuantPolicy(observer="mse")


# ---------------------------------------------------------------------------
# one Dense through every policy of the grid
# ---------------------------------------------------------------------------


class One:
    """A one-layer "model" for the qparams walkers."""

    def __init__(self, d):
        self.d = d

    def walk_with_params(self, params):
        yield self.d, params


POLICIES = {
    "vector_sym": dict(),
    "scalar_sym": dict(weight_per_channel=False),
    "vector_asym": dict(act_symmetric=False),
    "scalar_asym": dict(weight_per_channel=False, act_symmetric=False),
    "pointwise": dict(pointwise_scales=True),
    "scalar_pointwise": dict(weight_per_channel=False, pointwise_scales=True),
    "percentile": dict(observer="percentile", percentile=99.0),
    "int4": dict(bits=4),
    "act_per_channel": dict(act_per_channel=True),
}
K, N = 64, 48


@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_specs_match(name, unsigned):
    """``weight_spec()`` and ``act_spec(unsigned)`` of every policy: the
    reference's ranges, scheme and channel layout."""
    jpol, tpol = JA.QuantPolicy(**POLICIES[name]), TA.QuantPolicy(
        **POLICIES[name])
    for j, t in ((jpol.weight_spec(), tpol.weight_spec()),
                 (jpol.act_spec(unsigned), tpol.act_spec(unsigned))):
        assert ((t.levels, t.qmin, t.qmax, t.symmetric, t.unsigned,
                 t.per_channel, t.channel_axis)
                == (j.levels, j.qmin, j.qmax, j.symmetric, j.unsigned,
                    j.per_channel, j.channel_axis))


def _dense_case(name, bias=False, share=True):
    """Both packages' Dense, calibrated on two numpy batches; qparams after
    finalize (pointwise scales, where the policy has them, moved off 1 by
    the same numpy draw in both).  ``share`` hands the reference's
    activation thresholds to the port, so the tests after calibration see
    one set (a percentile may differ in its last bit)."""
    kw = POLICIES[name]
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(K, N)) / 8).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32) if bias else None
    xs = [rng.normal(size=(2, 8, K)).astype(np.float32) for _ in range(2)]
    jd = JDense(K, N, path="d", dtype=jnp.float32, bias=bias)
    td = TDense(K, N, path="d", dtype=torch.float32, bias=bias)
    jpol, tpol = JA.QuantPolicy(**kw), TA.QuantPolicy(**kw)
    jp, tp = {"w": jnp.asarray(w)}, {"w": _t(w)}
    if bias:
        jp["b"], tp["b"] = jnp.asarray(b), _t(b)
    jq = JA.init_qparams(One(jd), jp, jpol)
    tq = TA.init_qparams(One(td), tp, tpol)
    for x in xs:
        jctx = JA.make_ctx("calibrate", jpol, jq)
        tctx = TA.make_ctx("calibrate", tpol, tq)
        jd(jp, jnp.asarray(x), jctx)
        td(tp, _t(x), tctx)
        jq = {"d": {**jq["d"], "act": jctx.updates["d"]}}
        tq = {"d": {**tq["d"], "act": tctx.updates["d"]}}
    jq, tq = JA.finalize_calibration(jq, jpol), TA.finalize_calibration(tq)
    if share:
        tq["d"]["act"] = bridge.qparams_from_jax({"a": _np(jq["d"]["act"])})[
            "a"]
    if "pointwise" in jq["d"]["w"]:
        pw = rng.uniform(0.7, 1.3, size=(K, N)).astype(np.float32)
        jq["d"]["w"]["pointwise"] = jnp.asarray(pw)
        tq["d"]["w"]["pointwise"] = _t(pw)
    return dict(jd=jd, td=td, jpol=jpol, tpol=tpol, jp=jp, tp=tp, jq=jq,
                tq=tq, rng=rng)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_qparams_layout_and_calibration_match(name):
    """Every qparams leaf after init and calibration: same keys, shapes
    (scalar-mode weight thresholds are 0-d; pointwise scales take the
    weight's shape) and values; the same trainable mask."""
    c = _dense_case(name, share=False)
    jq, tq = _np(c["jq"]), c["tq"]
    for group in ("w", "act"):
        assert set(jq["d"][group]) == set(tq["d"][group]), group
        for key, want in jq["d"][group].items():
            got = tq["d"][group][key].numpy()
            assert got.shape == want.shape, (group, key)
            if name == "percentile" and group == "act" and key == "t_max":
                np.testing.assert_allclose(got, want, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
    assert _np(JA.trainable_mask(c["jq"])) == TA.trainable_mask(tq)


@pytest.mark.parametrize("name", sorted(set(POLICIES) - {"act_per_channel"}))
def test_fake_mode_forward_and_threshold_gradients(name):
    """The student's forward (activation and weight fake-quant) and the
    gradient of every trainable leaf: alpha (weights, symmetric acts),
    alpha_t / alpha_r (asymmetric acts), pointwise."""
    c = _dense_case(name)
    x = c["rng"].normal(size=(2, 8, K)).astype(np.float32) * 1.2
    g = c["rng"].normal(size=(2, 8, N)).astype(np.float32)

    def jloss(qp):
        y = c["jd"](c["jp"], jnp.asarray(x), JA.make_ctx("fake", c["jpol"],
                                                         qp))
        return jnp.sum(y * g), y

    (_, jy), jgrad = jax.value_and_grad(jloss, has_aux=True)(c["jq"])
    mask = TA.flatten(TA.trainable_mask(c["tq"]))
    leaves = {k: v.clone().requires_grad_(mask[k])
              for k, v in TA.flatten(c["tq"]).items()}
    ty = c["td"](c["tp"], _t(x), TA.make_ctx("fake", c["tpol"],
                                             TA.unflatten(leaves)))
    keys = [k for k in leaves if mask[k]]
    grads = torch.autograd.grad((ty * _t(g)).sum(),
                                [leaves[k] for k in keys], allow_unused=True)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    jflat = TA.flatten(_np(jgrad))
    asym = not c["tpol"].act_symmetric
    for k, got in zip(keys, grads):
        if got is None:      # a leaf this scheme's forward does not read
            np.testing.assert_array_equal(jflat[k], 0)
        elif k[-1] in ("alpha_t", "alpha_r"):
            _close_grad(got.numpy(), jflat[k], floor=1e-4, rtol=1e-3)
        elif got.ndim == 0:
            _close_grad(got.numpy(), jflat[k], rtol=1e-4)
        else:
            _close_grad(got.numpy(), jflat[k])
    read = {k[-1] for k, g in zip(keys, grads) if g is not None}
    assert ({"alpha_t", "alpha_r"} <= read) == asym
    assert ("pointwise" in read) == c["tpol"].pointwise_scales


@pytest.mark.parametrize("name", sorted(set(POLICIES) - {"act_per_channel"}))
def test_convert_to_int8_bit_identical(name):
    """w_q and w_scale (per channel, or 0-d in scalar mode), after the
    pointwise scales where the policy has them, and the int32 bias with
    its scale (eq. 20)."""
    c = _dense_case(name, bias=True)
    jp = JA.convert_to_int8(One(c["jd"]), c["jp"], c["jq"], c["jpol"])
    tp = TA.convert_to_int8(One(c["td"]), c["tp"], c["tq"], c["tpol"])
    assert set(tp) == set(jp) == {"w_q", "w_scale", "b_q", "b_scale"}
    for key in jp:
        assert tp[key].dtype == bridge.to_tensor(np.asarray(jp[key])).dtype
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]),
                                      err_msg=key)
    assert tp["w_scale"].ndim == (1 if c["tpol"].weight_per_channel else 0)


def _int8_case(name, dtype=jnp.bfloat16, bias=True):
    c = _dense_case(name, bias=bias)
    jp = JA.convert_to_int8(One(c["jd"]), c["jp"], c["jq"], c["jpol"])
    tp = TA.convert_to_int8(One(c["td"]), c["tp"], c["tq"], c["tpol"])
    x = (c["rng"].normal(size=(2, 8, K)) * 1.3).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return c, jp, tp, jx, bridge.to_tensor(np.asarray(jx))


def _jax_int8(c, jp, jx, use_pallas):
    """The reference's int8 forward, compiled, on one of its two paths."""
    pol = dataclasses.replace(c["jpol"], use_pallas=use_pallas)
    return jax.jit(lambda p, x: c["jd"](p, x, JA.make_ctx("int8", pol,
                                                           c["jq"])))(jp, jx)


@pytest.mark.parametrize("name", ["vector_sym", "vector_asym", "int4",
                                  "pointwise", "percentile"])
def test_int8_vector_weights_match_the_fused_reference(name):
    """Vector weights in int8 mode: the port's B3 path (plain version on
    the CPU) gives the bits of the reference's fused path
    (``use_pallas=True``, interpret mode), for asymmetric and int4
    activations too: s_x = levels / T_adj with the kernel's +-127 clip."""
    c, jp, tp, jx, tx = _int8_case(name)
    want = _jax_int8(c, jp, jx, use_pallas=True)
    got = c["td"](tp, tx, TA.make_ctx("int8", c["tpol"], c["tq"]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  np.asarray(want).view(np.uint16))


@pytest.mark.parametrize("name", ["scalar_sym", "scalar_pointwise"])
def test_int8_scalar_weights_match_the_xla_reference(name):
    """Scalar-mode weights through B3 with the one dequant scale
    broadcast over the output channels give the bits of the reference's
    XLA path; its fused path raises on the 0-d scale (``reshape`` to (1,
    N)), so that is the target."""
    c, jp, tp, jx, tx = _int8_case(name)
    want = _jax_int8(c, jp, jx, use_pallas=False)
    got = c["td"](tp, tx, TA.make_ctx("int8", c["tpol"], c["tq"]))
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  np.asarray(want).view(np.uint16))
    with pytest.raises(TypeError, match="reshape"):
        _jax_int8(c, jp, jx, use_pallas=True)


def test_int8_asymmetric_reference_paths_disagree():
    """With asymmetric activations (levels 255, clip [0, 255])
    the reference's XLA path casts to int8 after clipping to [0, 255]
    (every negative input becomes 0, everything above 127 saturates),
    while its fused path clips to +-127.  The port copies the fused path,
    and the two reference paths give other outputs."""
    c, jp, tp, jx, tx = _int8_case("vector_asym")
    fused = np.asarray(_jax_int8(c, jp, jx, use_pallas=True), np.float32)
    xla = np.asarray(_jax_int8(c, jp, jx, use_pallas=False), np.float32)
    got = c["td"](tp, tx, TA.make_ctx("int8", c["tpol"], c["tq"])).float()
    np.testing.assert_array_equal(got.numpy(), fused)
    assert np.abs(fused - xla).max() > 0.1
    # scalar weights with asymmetric acts: the fused reference raises
    # (its 0-d scale); the port holds to the fused reference's math, the
    # plain kernel with the broadcast scale
    c, jp, tp, jx, tx = _int8_case("scalar_asym")
    from repro.kernels import ops as jops

    astate, aspec = c["jq"]["d"]["act"], c["jpol"].act_spec()
    t_adj = jnp.maximum(JQ.adjusted_threshold(astate["t_max"],
                                              astate["alpha"], aspec), 1e-8)
    s_x = aspec.levels / t_adj
    comb = jnp.broadcast_to(jp["w_scale"] / s_x, (N,)).astype(jnp.float32)
    want = jops.quant_matmul_ref(jx.reshape(-1, K), jp["w_q"], comb, s_x)
    want = np.asarray(want, np.float32).reshape(2, 8, N) + np.asarray(
        jp["b_q"].astype(jnp.float32) * jp["b_scale"], np.float32)
    got = c["td"](tp, tx, TA.make_ctx("int8", c["tpol"], c["tq"])).float()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


def test_int8_act_per_channel_raises_in_both():
    """Per-channel activation thresholds (K,) do not broadcast
    against the weight scale (N,): the reference raises TypeError, the
    port ValueError naming the broadcast."""
    c, jp, tp, jx, tx = _int8_case("act_per_channel", bias=False)
    with pytest.raises(TypeError, match="incompatible shapes"):
        _jax_int8(c, jp, jx, use_pallas=False)
    with pytest.raises(ValueError, match="does not broadcast"):
        c["td"](tp, tx, TA.make_ctx("int8", c["tpol"], c["tq"]))


def test_skip_patterns_leave_layers_in_full_precision():
    c = _dense_case("vector_sym")
    pol = TA.QuantPolicy(skip_patterns=(r"^d$",))
    assert pol.skips("d") and not pol.skips("dd")
    assert TA.init_qparams(One(c["td"]), c["tp"], pol) == {}
    out = TA.convert_to_int8(One(c["td"]), c["tp"], {}, pol)
    assert set(out) == {"w"}
    x = torch.ones(2, K)
    torch.testing.assert_close(
        c["td"](c["tp"], x, TA.make_ctx("int8", pol, {})), x @ c["tp"]["w"],
        rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the slice as a whole: a 2-layer smoke model through each variant
# ---------------------------------------------------------------------------


MODEL_POLICIES = ["scalar_asym", "percentile", "pointwise"]


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("smollm-135m", smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config("smollm-135m", smoke=True).replace(
        dtype=torch.float32)
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    return dict(jcfg=jcfg, jm=jm, tm=tm, jparams=jparams,
                tparams=bridge.params_from_jax(_np(jparams)),
                batches=[rng.integers(0, jcfg.vocab, (2, 16), dtype=np.int32)
                         for _ in range(3)])


@pytest.mark.parametrize("name", MODEL_POLICIES)
def test_model_calibrate_fake_and_convert_match(models, name):
    """Calibration through the model (every activation threshold), the
    fake-quant student's logits, and the int8 weights of every layer."""
    m = models
    jpol = JA.QuantPolicy(**POLICIES[name], use_pallas=True)
    tpol = TA.QuantPolicy(**POLICIES[name])
    jq = JA.init_qparams(m["jm"], m["jparams"], jpol)
    tq = TA.init_qparams(m["tm"], m["tparams"], tpol)
    jstep = jax.jit(JST.make_calibrate_step(m["jm"], m["jcfg"], jpol))
    tstep = TST.make_calibrate_step(m["tm"], tpol)
    for toks in m["batches"][:2]:
        jq = jstep(m["jparams"], jq, {"tokens": jnp.asarray(toks)})
        with torch.no_grad():
            tq = tstep(m["tparams"], tq, {"tokens": torch.from_numpy(toks)})
    jq, tq = JA.finalize_calibration(jq, jpol), TA.finalize_calibration(tq)
    jqn = _np(jq)
    for path, entry in jqn.items():
        for key, want in entry["act"].items():
            np.testing.assert_allclose(tq[path]["act"][key].numpy(), want,
                                       rtol=1e-5, atol=0, err_msg=path)
    # share the thresholds, so the comparisons below see one set
    tq = bridge.qparams_from_jax(jqn)
    toks = m["batches"][2]
    jy = jax.jit(lambda p, q, t: m["jm"](p, {"tokens": t},
                                         JA.make_ctx("fake", jpol, q))[0])(
        m["jparams"], jq, jnp.asarray(toks))
    with torch.no_grad():
        ty = m["tm"](m["tparams"], {"tokens": torch.from_numpy(toks)},
                     TA.make_ctx("fake", tpol, tq))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    jp = _np(JA.convert_to_int8(m["jm"], m["jparams"], jq, jpol))
    tp = TA.convert_to_int8(m["tm"], m["tparams"], tq, tpol)
    jflat, tflat = TA.flatten(jp), TA.flatten(tp)
    assert set(jflat) == set(tflat)
    n_q = 0
    for k, want in jflat.items():
        if k[-1] in ("w_q", "w_scale"):
            n_q += k[-1] == "w_q"
            np.testing.assert_array_equal(tflat[k].numpy(), want,
                                          err_msg=str(k))
    assert n_q == 7 * 2


def test_pointwise_finetune_through_prepare_int8_matches(models):
    """The pointwise policy (with int8 KV) through the port's fine-tune,
    ``prepare_int8(finetune_epochs=3)`` over one batch, against the
    reference's calibration, ``finetune_thresholds`` and
    ``freeze_thresholds``: each step's loss rtol 1e-5 (measured worst
    6.4e-7), the frozen thresholds and alphas (the KV ``t_max`` among
    them) rtol 1e-5 atol 1e-6 (measured worst 1.9e-6 absolute, on
    a KV ``t_max``), the pointwise scales atol 2e-4 (measured worst
    1.1e-4: Adam divides each gradient by its own magnitude, so a scale
    whose gradient sums to nearly zero moves by a fraction of the rate
    that the last bits of that sum decide), and no ``log2_t`` left.  At
    the default rate (1e-3) the second step's loss is above the first in
    both packages, on the same batch: Adam's first update moves every
    pointwise scale by about the rate at once, and that overshoots."""
    m = models
    toks = m["batches"][0]
    kw = dict(pointwise_scales=True, kv_int8=True)
    jpol = JA.QuantPolicy(**kw, use_pallas=True)
    jq = JA.init_qparams(m["jm"], m["jparams"], jpol)
    jq = jax.jit(JST.make_calibrate_step(m["jm"], m["jcfg"], jpol))(
        m["jparams"], jq, {"tokens": jnp.asarray(toks)})
    jq = JA.finalize_calibration(jq, jpol, train_thresholds=True)
    jq, jl = JST.finetune_thresholds(m["jm"], m["jcfg"], jpol, m["jparams"],
                                     jq, [{"tokens": jnp.asarray(toks)}],
                                     epochs=3)
    jflat = TA.flatten(_np(JA.freeze_thresholds(jq)))
    log = {}
    _, tq = prepare_int8(m["tm"], TA.QuantPolicy(**kw), m["tparams"],
                         [{"tokens": torch.from_numpy(toks)}], convert=False,
                         finetune_epochs=3, finetune_log=log)
    np.testing.assert_allclose(log["losses"], jl, rtol=1e-5)
    assert jl[1] > jl[0] and log["losses"][1] > log["losses"][0]
    tflat = TA.flatten(tq)
    assert set(tflat) == set(jflat)
    assert not any(k[-1] == "log2_t" for k in tflat)
    for k, want in jflat.items():
        tol = (dict(atol=2e-4, rtol=0) if k[-1] == "pointwise"
               else dict(atol=1e-6, rtol=1e-5))
        np.testing.assert_allclose(tflat[k].numpy(), want, err_msg=str(k),
                                   **tol)


def test_bridge_carries_the_variant_leaves_both_ways():
    """qparams with every new leaf (t_l, t_r, alpha_t, alpha_r, pointwise,
    a 0-d scalar-mode t_max and alpha) cross from the port to numpy and
    serve in the reference: its int8 conversion gives the port's bits."""
    c = _dense_case("scalar_pointwise")
    back = bridge.qparams_to_numpy(c["tq"])
    leaves = TA.flatten(back)
    assert {k[-1] for k in leaves} >= {"t_l", "t_r", "alpha_t", "alpha_r",
                                       "pointwise", "t_max", "alpha"}
    assert back["d"]["w"]["t_max"].shape == ()
    jq = jax.tree.map(jnp.asarray, back)
    jp = JA.convert_to_int8(One(c["jd"]), c["jp"], jq, c["jpol"])
    tp = TA.convert_to_int8(One(c["td"]), c["tp"], c["tq"], c["tpol"])
    np.testing.assert_array_equal(tp["w_q"].numpy(), np.asarray(jp["w_q"]))
    again = bridge.qparams_from_jax(back)
    for k, v in TA.flatten(c["tq"]).items():
        assert torch.equal(TA.flatten(again)[k], v), k
