"""Folding (§3.1.2) and equalization (§3.3) in the port against the
reference: the primitives bit for bit, the DWS net of the paper's tables,
and the model-level walks on the four served configs.

Tolerances: the primitives are bit-identical.  They are elementwise
float32 in the reference's order; the square roots are correctly rounded
on both sides (``folding.sqrt_rn``: torch's vectorized CPU sqrt is an ulp
off for ~0.7% of inputs), and the mean threshold T0 sums in XLA's CPU
order (sequential up to 32 channels, as here).  A LayerNorm bias folded
through a matmul (``beta @ W``) is summed by each framework in its own
order: rtol 1e-6, atol 1e-6 there (measured: equal on these inputs).  The DWS forward sums a 3-tap conv, a 64-wide matmul and a mean in
each framework's order: rtol 1e-5, atol 1e-5; top-1 agreements equal.

ROADMAP Queue C: the reference's model-level walks
(``fold_model_norms``, ``equalize_model``) match no parameter: its plans
name module paths (``smollm-135m-smoke/stack/layer0/mlp/up``) while its
params flatten to ``stack/layer0/ffn/up/w``.  On smollm-135m,
granite-8b, stablelm-12b and gemma3-12b at ``SMOKE`` both packages
return the params unchanged and an empty report; the port keeps that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.dws_model import DWSNet as JDWSNet
from repro.configs import get_config as jax_config
from repro.core import equalization as JE
from repro.core import folding as JF
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.bench.dws_model import DWSNet as TDWSNet
from repro_torch.core import api as TA
from repro_torch.core import equalization as TE
from repro_torch.core import folding as TF
from repro_torch.configs import get_config as torch_config
from repro_torch.models import build_model as torch_build

# the integer the reference's DWSNet.init(PRNGKey(0)) draws for its numpy
# generator (checked below); the port's bench takes it as its default
DWS_SEED = 31327077


def _t(a):
    return bridge.to_tensor(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_fold_batchnorm_bit_identical():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 16)).astype(np.float32)
    gamma, beta, mu = (rng.normal(size=16).astype(np.float32)
                       for _ in range(3))
    var = rng.uniform(0.1, 2.0, 16).astype(np.float32)
    jw, jb = JF.fold_batchnorm(*(jnp.asarray(a)
                                 for a in (w, gamma, beta, mu, var)))
    tw, tb = TF.fold_batchnorm(*(_t(a) for a in (w, gamma, beta, mu, var)))
    _eq(tw, jw)
    _eq(tb, jb)


@pytest.mark.parametrize("with_bias", [False, True])
def test_fold_norm_into_projections(with_bias):
    rng = np.random.default_rng(1)
    g = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    beta = rng.normal(size=24).astype(np.float32) if with_bias else None
    ws = [rng.normal(size=(24, n)).astype(np.float32) for n in (8, 12)]
    bs = [rng.normal(size=8).astype(np.float32), None]
    js, jws, jbs = JF.fold_norm_into_projections(
        jnp.asarray(g), [jnp.asarray(w) for w in ws],
        None if beta is None else jnp.asarray(beta),
        [jnp.asarray(bs[0]), None] if with_bias else None)
    ts, tws, tbs = TF.fold_norm_into_projections(
        _t(g), [_t(w) for w in ws], None if beta is None else _t(beta),
        [_t(bs[0]), None] if with_bias else None)
    _eq(ts, js)
    for a, b in zip(tws, jws):
        _eq(a, b)
    if not with_bias:
        assert tbs is None and jbs is None
        return
    for a, b in zip(tbs, jbs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("target", ["mean", "joint"])
def test_pair_rescale(target):
    rng = np.random.default_rng(2)
    w_up = (rng.normal(size=(16, 32)) * rng.uniform(0.1, 5, 32)).astype(
        np.float32)
    w_down = rng.normal(size=(32, 16)).astype(np.float32)
    ju, jd, jr = JE.pair_rescale(jnp.asarray(w_up), jnp.asarray(w_down),
                                 target=target)
    tu, td, tr = TE.pair_rescale(_t(w_up), _t(w_down), target=target)
    for got, want in ((tr.scales, jr.scales), (tu, ju), (td, jd),
                      (tr.t_before, jr.t_before)):
        _eq(got, want)
    assert not tr.locked.any()
    # the composite is unchanged: up @ down through the scaled channels
    np.testing.assert_allclose((tu @ td).numpy(), w_up @ w_down, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["some_locked", "none_locked",
                                  "cap_binds"])
def test_dws_relu6_rescale(case):
    """Steps 1-6 of §3.3.1: locked channels keep scale 1, T0 is their mean
    threshold (of all when none is locked), and the ReLU6 cap binds."""
    rng = np.random.default_rng(3)
    c = 12
    w = (rng.normal(size=(3, c)) * rng.uniform(0.1, 3, c)).astype(np.float32)
    b = rng.normal(size=c).astype(np.float32)
    conv = rng.normal(size=(c, 10)).astype(np.float32)
    act = rng.uniform(0.5, 5.0, c).astype(np.float32)
    if case == "some_locked":
        act[[1, 4]] = [5.95, 6.5]
    if case == "cap_binds":
        act[:] = 5.5
        act[[0]] = 6.2
    jout = JE.dws_relu6_rescale(jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(conv), jnp.asarray(act))
    tout = TE.dws_relu6_rescale(_t(w), _t(b), _t(conv), _t(act))
    for got, want in zip(tout[:3], jout[:3]):
        _eq(got, want)
    _eq(tout[3].locked, jout[3].locked)
    _eq(tout[3].scales, jout[3].scales)
    if case != "none_locked":
        assert tout[3].locked.any()
        assert torch.all(tout[3].scales[tout[3].locked] == 1.0)
    if case == "cap_binds":
        free = ~tout[3].locked
        assert torch.all(_t(act)[free] * tout[3].scales[free]
                         <= 6.0 * (1 + 1e-6))


def test_dws_seed_is_the_references():
    assert int(jax.random.randint(jax.random.PRNGKey(0), (), 0,
                                  1 << 30)) == DWS_SEED
    import inspect

    from repro_torch.bench import run

    assert inspect.signature(run.dws_rescaling).parameters[
        "np_seed"].default == DWS_SEED


@pytest.fixture(scope="module")
def dws():
    jnet, tnet = JDWSNet(), TDWSNet()
    jp = jnet.init(jax.random.PRNGKey(0))
    tp = tnet.init(DWS_SEED)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 16, 64)).astype(np.float32)
    return jnet, tnet, jp, tp, x


def test_dws_net_init_and_fold_bit_identical(dws):
    jnet, tnet, jp, tp, _ = dws
    jflat = TA.flatten({str(i): c for i, c in enumerate(jp["cells"])})
    tflat = TA.flatten({str(i): c for i, c in enumerate(tp["cells"])})
    assert set(jflat) == set(tflat)
    for k, v in jflat.items():
        _eq(tflat[k], v)
    _eq(tp["head"], jp["head"])
    for jc, tc in zip(jp["cells"], tp["cells"]):
        jf, tf = jnet.fold_cell(jc), tnet.fold_cell(tc)
        for k in jf:
            _eq(tf[k], jf[k])


@pytest.mark.parametrize("mode", [None, "scalar", "vector"])
def test_dws_forward_and_rescale(dws, mode):
    """The folded forward in float32 and both quantized modes, and the
    §3.3 rescale; the same top-1 agreements with the float model."""
    jnet, tnet, jp, tp, x = dws
    jf = [jnet.fold_cell(c) for c in jp["cells"]]
    tf = [tnet.fold_cell(c) for c in tp["cells"]]
    quant = None if mode is None else {"mode": mode}
    jy = jnet.forward_folded(jf, jp["head"], jnp.asarray(x), quant)
    ty = tnet.forward_folded(tf, tp["head"], _t(x), quant)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    jr, tr = jnet.rescale_cells(jf, jnp.asarray(x)), tnet.rescale_cells(
        tf, _t(x))
    for jc, tc in zip(jr, tr):
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-5, atol=1e-6)
    jyr = jnet.forward_folded(jr, jp["head"], jnp.asarray(x), quant)
    tyr = tnet.forward_folded(tr, tp["head"], _t(x), quant)
    assert np.array_equal(np.argmax(np.asarray(jyr), -1),
                          tyr.argmax(-1).numpy())


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-8b",
                                  "stablelm-12b", "gemma3-12b"])
def test_model_walks_are_noops_as_in_the_reference(arch):
    """The no-op walks (ROADMAP Queue C): both packages' plans are equal and match no parameter
    key, so the walks return every parameter unchanged and an empty
    report."""
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config(arch, smoke=True).replace(dtype=torch.float32)
    jm, tm = jax_build(jcfg), torch_build(tcfg)
    assert tm.fold_plan() == [(n, list(p)) for n, p in jm.fold_plan()]
    assert tm.equalization_plan() == list(jm.equalization_plan())
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams))
    before = {k: v.clone() for k, v in TA.flatten(tparams).items()}
    jp2, jrep = JE.equalize_model(jm, JF.fold_model_norms(jm, jparams))
    tp2, trep = TE.equalize_model(tm, TF.fold_model_norms(tm, tparams))
    assert jrep == {} and trep == {}
    jflat = TA.flatten(jax.tree.map(np.asarray, jp2))
    for k, v in TA.flatten(tp2).items():
        assert torch.equal(v, before[k]), k
        np.testing.assert_array_equal(bridge.to_numpy(v), jflat[k])
    keys = {"/".join(k) for k in TA.flatten(tparams)}
    planned = {p + "/w" for _, ps in tm.fold_plan() for p in ps}
    assert not planned & keys


def test_walks_fold_and_equalize_when_the_keys_match():
    """The walks themselves, on a tree keyed by the plans' paths: the
    folded norm scale becomes ones, the projections take gamma, and an
    equalized up -> down pair keeps its product."""
    rng = np.random.default_rng(5)

    class Plans:
        def fold_plan(self):
            return [("n", ["q", "k"])]

        def equalization_plan(self):
            return [("up", "down")]

    def tree(mod):
        conv = (lambda a: jnp.asarray(a)) if mod is jnp else _t
        return {"n": {"scale": conv(rng_vals["g"])},
                "q": {"w": conv(rng_vals["q"])},
                "k": {"w": conv(rng_vals["k"])},
                "up": {"w": conv(rng_vals["up"])},
                "down": {"w": conv(rng_vals["down"])}}

    rng_vals = {"g": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                "q": rng.normal(size=(8, 4)).astype(np.float32),
                "k": rng.normal(size=(8, 4)).astype(np.float32),
                "up": rng.normal(size=(8, 6)).astype(np.float32),
                "down": rng.normal(size=(6, 8)).astype(np.float32)}
    jp, jrep = JE.equalize_model(Plans(), JF.fold_model_norms(
        Plans(), tree(jnp)))
    tp, trep = TE.equalize_model(Plans(), TF.fold_model_norms(
        Plans(), tree(torch)))
    assert set(jrep) == set(trep) == {"up"}
    jflat = TA.flatten(jax.tree.map(np.asarray, jp))
    for k, v in TA.flatten(tp).items():
        _eq(v, jflat[k])
    np.testing.assert_array_equal(tp["n"]["scale"].numpy(), np.ones(8))
    np.testing.assert_allclose((tp["up"]["w"] @ tp["down"]["w"]).numpy(),
                               rng_vals["up"] @ rng_vals["down"], rtol=1e-4,
                               atol=1e-5)
