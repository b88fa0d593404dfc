"""The ported slice end to end against the reference Engine.

The reference is ``repro.launch.engine.Engine`` built with
``use_pallas=True`` (its kernels in interpret mode) and a dense cache:
that is the path whose semantics the port has (int8 K/V attended by the
prefill kernel, cache length rounded to 128); its jnp path attends exact
bf16 K/V and drifts from it.  Both engines start from the same weights
(the reference's init, bridged) and calibrate on the same numpy batches.
A third engine serves with the reference's own thresholds, bridged, which
isolates the serving path from calibration.

Tolerances:
  * int8 weights are bit-identical (their thresholds come from the weights).
  * float32, shared thresholds: logits to atol 1e-4, tokens identical.
  * float32, own calibration: thresholds to rtol 1e-6 (the calibration
    forward's float32 matmuls sum in another order in XLA and PyTorch).  A
    threshold that differs in its last bit now and then moves an activation
    across an int8 rounding step, which moves the logits by ~1e-2: logits to
    atol 2e-2, tokens identical on the seeds below.
  * bf16, the serving dtype: bf16 keeps 8 bits (one step is ~0.004 at the
    logits' scale of ~0.7) and the two frameworks round at different places
    in the norms, rotary, SiLU and readout, so thresholds agree to rtol 3e-2
    and logits to atol 0.06.  A random-weight model has near-ties that this
    noise may flip, so the port is teacher-forced with the reference's
    tokens: at every step the reference's token must be the port's argmax
    or within 0.06 of its logit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as JST
from repro.launch.engine import Engine as JaxEngine
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.launch.engine import Engine

G3 = dict(name="smollm-135m-g3", n_layers=2, d_model=96, n_heads=6,
          n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, attn_q_chunk=16,
          attn_kv_chunk=16, loss_chunk=16)
GEN = 8
# case: (config variant, dtype, {check: tolerance})
F32 = dict(shared=1e-4, own=2e-2, thresholds=1e-6)
CASES = {
    "g3-f32": (G3, "float32", F32),
    "g3-bf16": (G3, "bfloat16", dict(shared=0.06, own=0.06, thresholds=3e-2)),
    "smoke-f32": (None, "float32", F32),
}


def _walk_int8(a, b, path=""):
    """(path, reference leaf, port leaf) for every w_q / w_scale."""
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _walk_int8(v, b[k], f"{path}/{k}")
        elif k in ("w_q", "w_scale"):
            yield f"{path}/{k}", np.asarray(v), b[k].numpy()


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    variant, dtype, tol = CASES[request.param]
    jcfg = jax_config("smollm-135m", smoke=variant is None)
    tcfg = torch_config("smollm-135m", smoke=variant is None)
    if variant is not None:
        jcfg, tcfg = jcfg.replace(**variant), tcfg.replace(**variant)
    jcfg = jcfg.replace(dtype=getattr(jnp, dtype))
    tcfg = tcfg.replace(dtype=getattr(torch, dtype))
    rng = np.random.default_rng(11)
    calib = [{"tokens": rng.integers(0, jcfg.vocab, (4, 32), dtype=np.int32)}
             for _ in range(2)]
    prompts = rng.integers(0, jcfg.vocab, (2, 16), dtype=np.int32)

    ref = JaxEngine.from_checkpoint(
        cfg=jcfg, use_pallas=True, cache_layout="dense",
        calib_batches=[{"tokens": jnp.asarray(b["tokens"])} for b in calib])
    params = jax.tree.map(np.asarray, jax_build(jcfg).init(
        jax.random.PRNGKey(0)))
    ours = Engine.from_checkpoint(cfg=tcfg,
                                  params=bridge.params_from_jax(params),
                                  calib_batches=calib, device="cpu")
    shared = Engine.from_checkpoint(
        cfg=tcfg, params=bridge.params_from_jax(params), device="cpu",
        qparams=bridge.qparams_from_jax(jax.tree.map(np.asarray,
                                                     ref.qparams)))
    ref_out = ref.generate_batch({"tokens": jnp.asarray(prompts)}, gen=GEN)
    cache = ref.init_cache(2, ref._cache_len(prompts.shape[1], GEN))
    ref_logits, _ = jax.jit(JST.make_prefill_step(
        ref.model, jcfg, ref.policy, "int8"))(
        ref.serve_params, ref.qparams, {"tokens": jnp.asarray(prompts)},
        cache)
    return dict(ref=ref, ours=ours, shared_engine=shared, prompts=prompts,
                tol=tol, dtype=dtype,
                ref_tokens=np.asarray(ref_out.tokens),
                ref_logits=np.asarray(ref_logits, np.float32)[:, -1],
                out=ours.generate_batch({"tokens": prompts}, gen=GEN),
                shared=shared.generate_batch({"tokens": prompts}, gen=GEN))


def test_int8_weights_bit_identical(pair):
    leaves = list(_walk_int8(pair["ref"].serve_params,
                             pair["ours"].serve_params))
    assert len(leaves) == 2 * 7 * pair["ours"].cfg.n_layers
    for path, want, got in leaves:
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_calibrated_thresholds_match(pair):
    ref = jax.tree.map(np.asarray, pair["ref"].qparams)
    ours = pair["ours"].qparams
    assert set(ref) == set(ours)
    for path, entry in ref.items():
        for group, leaves in entry.items():
            for name, want in leaves.items():
                np.testing.assert_allclose(
                    ours[path][group][name].numpy(), want,
                    rtol=pair["tol"]["thresholds"], atol=0,
                    err_msg=f"{path}/{group}/{name}")


@pytest.mark.parametrize("which", ["shared", "own"])
def test_prefill_logits_match(pair, which):
    out = pair["shared" if which == "shared" else "out"]
    got = out.prefill_logits.float().numpy()
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
                    engine.serve_params, toks[:, i:i + 1], cache, s + i, ctx)
    return torch.stack(margins, dim=1).numpy()


@pytest.mark.parametrize("which", ["shared", "own"])
def test_greedy_tokens_match(pair, which):
    out = pair["shared" if which == "shared" else "out"]
    got = out.tokens.numpy()
    assert got.shape == (2, GEN)
    if pair["dtype"] == "float32":
        np.testing.assert_array_equal(got, pair["ref_tokens"])
        return
    engine = pair["shared_engine" if which == "shared" else "ours"]
    margins = _forced_margins(engine, pair["prompts"], pair["ref_tokens"])
    assert margins.max() <= pair["tol"][which], margins


def test_generate_one_is_generate_batch_at_b1(pair):
    one = pair["ours"].generate_one(pair["prompts"][1], gen=GEN)
    np.testing.assert_array_equal(one.tokens.numpy()[0],
                                  pair["out"].tokens.numpy()[1])
