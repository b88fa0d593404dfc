"""Tensor-parallel serving of every family the reference's
``ShardedEngine(tp=2, use_pallas=True)`` serves, its refusals, and the
reference's mixture-of-experts fault.

Served at ``SMOKE`` in float32 with the reference's weights (drawn from
``PRNGKey(0)``) and its thresholds (calibrated on shared numpy batches),
bridged, as ``test_torch_sharded_families.py`` serves them under sp:
  * granite-8b and stablelm-12b (LayerNorm, an untied lm_head served, in
    both packages, on the last block's ``wq`` thresholds), dense caches;
  * gemma3-12b (GeGLU, windowed layers) over the default layout's rings;
  * hymba-1.5b (attention beside a Mamba2 mixer): the mixer's weights are
    replicated, but its ``out_proj`` reads 'heads' as its input axis, so the
    reference reduces it too and sums tp copies of the whole product (its
    ``mamba_out_norm`` then rescales them); the port sums the same copies;
  * seamless-m4t-medium (encoder-decoder: fc1 / fc2 with biases, cross
    attention) on 160 frames;
  * llava-next-34b (patches before the text).
mamba2-780m (one attention head in its config) raises the reference's
divisibility ``ValueError``.  granite-moe-3b-a800m: the reference's tp
splits each expert's d_ff (its ``down`` weight's input axis) but its expert
product has no reduce, so its tp=2 tokens part from its own unsharded
engine's; the test below pins that and the port refuses MoE under tp
(ROADMAP Queue C).

The reference needs two JAX devices: ONE subprocess builds every case with
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` and writes what it
served to an ``.npz`` that a module fixture shares.

Tolerances: greedy tokens identical; teacher-forced logits within
``LOGIT_ATOL`` = 1e-4 (``test_torch_sharded_families.py``'s; measured
2.4e-7 granite-8b, 0 stablelm-12b and llava-next-34b, whose int8 readouts
sum exactly, 1.8e-7 gemma3-12b and hymba-1.5b), except seamless's, 2e-2
(one int8 step of slack for XLA's CPU rounding in its encoder, ROADMAP
Queue C; the same as under sp; measured 0.0098, largest |logit| 0.51).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.shard import ShardedEngine
from repro_torch.shard.model import MOE_TP_REFUSAL
from test_torch_sharded import _flat, _unflat
from test_torch_sharded_families import (_cfg, _data, _forced,
                                         _readout_thresholds)
from test_torch_sharded_modes import _qparams

B, S, GEN, TP = 2, 16, 8, 2
LOGIT_ATOL = 1e-4
ATOL = {"seamless-m4t-medium": 2e-2}
SERVED = ("granite-8b", "stablelm-12b", "gemma3-12b", "hymba-1.5b",
          "seamless-m4t-medium", "llava-next-34b")
LAYOUT = {"gemma3-12b": "ring"}
MOE = "granite-moe-3b-a800m"


def _reference_main(out_path):
    """The subprocess: the reference's ShardedEngine(tp=2, use_pallas=True)
    for each served family (its weights, thresholds, greedy tokens and
    teacher-forced logits); mamba2's refusal; granite-moe's tp=2 and
    unsharded tokens on the same thresholds, and one expert ``down``
    product per shard under ``shard_map`` against the unsharded one."""
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core import api as JA
    from repro.dist import compat
    from repro.launch import steps as JST
    from repro.launch.engine import Engine as JEngine
    from repro.models import build_model
    from repro.models.module import ExpertDense
    from repro.shard.context import ShardContext, shard_scope
    from repro.shard.engine import ShardedEngine as JShardedEngine

    assert jax.device_count() >= TP, jax.devices()
    out = {}

    def jax_batch(batch):
        return {k: jnp.asarray(v) for k, v in batch.items()}

    def forced(eng, prompt, toks):
        cfg = eng.cfg
        prefill = jax.jit(JST.make_prefill_step(eng.model, cfg, eng.policy,
                                                "int8"))
        step = jax.jit(JST.make_serve_step(eng.model, cfg, eng.policy,
                                           "int8"))
        cache = eng.init_cache(B, eng._cache_len(S, GEN))
        logits, cache = prefill(eng.serve_params, eng.qparams,
                                jax_batch(prompt), cache)
        got = [np.asarray(logits[:, -1], np.float32)]
        pos0 = S + (cfg.mm_patches if cfg.modality == "vlm" else 0)
        for i in range(GEN - 1):
            _, logits, cache = step(eng.serve_params, eng.qparams,
                                    jnp.asarray(toks[:, i:i + 1]), cache,
                                    jnp.int32(pos0 + i))
            got.append(np.asarray(logits[:, -1], np.float32))
        return np.stack(got)

    for arch in SERVED:
        cfg = get_config(arch, smoke=True).replace(dtype=jnp.float32)
        calib, prompt = _data(cfg, arch)
        layout = LAYOUT.get(arch, "dense")
        eng = JShardedEngine.from_checkpoint(
            cfg=cfg, tp=TP, cache_layout=layout, use_pallas=True,
            calib_batches=[jax_batch(c) for c in calib])
        qparams = _readout_thresholds(eng.qparams, cfg)
        eng = JShardedEngine(build_model(cfg), cfg, eng.policy,
                             eng.serve_params, qparams, tp=TP, mode="int8",
                             cache_layout=layout)
        toks = np.asarray(eng.generate_batch(jax_batch(prompt), GEN).tokens)
        _flat(f"{arch}:params:", build_model(cfg).init(
            jax.random.PRNGKey(0)), out)
        for path, entry in qparams.items():
            _flat(f"{arch}:qparams:{path}|", entry, out)
        out[f"{arch}:tokens"] = toks
        out[f"{arch}:logits"] = forced(eng, prompt, toks)
    cfg = get_config("mamba2-780m", smoke=True).replace(dtype=jnp.float32)
    calib, _ = _data(cfg, "mamba2-780m")
    try:
        JShardedEngine.from_checkpoint(
            cfg=cfg, tp=TP, cache_layout="dense", use_pallas=True,
            calib_batches=[jax_batch(c) for c in calib])
        out["mamba2:refusal"] = np.asarray("served")
    except ValueError as err:
        out["mamba2:refusal"] = np.asarray(str(err))
    # the mixture of experts
    cfg = get_config(MOE, smoke=True).replace(dtype=jnp.float32)
    calib, prompt = _data(cfg, MOE)
    eng = JShardedEngine.from_checkpoint(
        cfg=cfg, tp=TP, cache_layout="dense", use_pallas=True,
        calib_batches=[jax_batch(c) for c in calib])
    one = JEngine(build_model(cfg), cfg, eng.policy, eng.serve_params,
                  eng.qparams, mode="int8", cache_layout="dense")
    out["moe:tp_tokens"] = np.asarray(
        eng.generate_batch(jax_batch(prompt), GEN).tokens)
    out["moe:tokens"] = np.asarray(
        one.generate_batch(jax_batch(prompt), GEN).tokens)
    # layer 0's expert down, each shard's product over its d_ff slice as
    # the reference's tp computes it, beside the unsharded product
    layer, lp = next((m, p) for m, p in eng.model._inner.walk_with_params(
        eng.serve_params) if isinstance(m, ExpertDense)
        and m.path.endswith("/down"))
    full = next(p for m, p in one.model.walk_with_params(eng.serve_params)
                if m.path == layer.path)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(
        (cfg.n_experts, 4, cfg.d_ff)).astype(np.float32))
    ctx = JA.make_ctx("int8", eng.policy, eng.qparams)

    def shard_down(w_q, w_scale, x_loc):
        with shard_scope(ShardContext(axis="model", tp=TP)):
            y = JA.expert_dense_forward(
                layer, {"w_q": w_q, "w_scale": w_scale}, x_loc, ctx)
        return y[None]

    fn = compat.shard_map(shard_down, mesh=eng.mesh,
                          in_specs=(P(None, "model", None), P(),
                                    P(None, None, "model")),
                          out_specs=P("model"))
    out["moe:shard_down"] = np.asarray(fn(full["w_q"], full["w_scale"], x))
    out["moe:down"] = np.asarray(JA.expert_dense_forward(layer, full, x, ctx))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_families") / "reference.npz"
    src = os.path.dirname(os.path.dirname(bridge.__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=src)
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module", params=SERVED)
def served(request, reference):
    """The port's ShardedEngine(tp=2) on the CPU from the reference's
    weights and thresholds, and what it serves."""
    arch, ref = request.param, reference
    cfg = _cfg(arch)
    engine = ShardedEngine.from_checkpoint(
        cfg=cfg,
        params=bridge.params_from_jax(_unflat(ref, f"{arch}:params:")),
        qparams=bridge.qparams_from_jax(_qparams(ref, f"{arch}:qparams:")),
        device="cpu", tp=TP, cache_layout=LAYOUT.get(arch, "dense"))
    _, prompt = _data(cfg, arch)
    toks = torch.from_numpy(ref[f"{arch}:tokens"]).long()
    return dict(arch=arch, ref=ref, engine=engine,
                out=engine.generate_batch(prompt, gen=GEN),
                logits=_forced(engine, prompt, toks))


def test_tokens_and_logits_match(served):
    arch, ref = served["arch"], served["ref"]
    np.testing.assert_array_equal(served["out"].tokens.numpy(),
                                  ref[f"{arch}:tokens"])
    want = ref[f"{arch}:logits"]
    assert served["logits"].shape == want.shape
    np.testing.assert_allclose(served["logits"], want, rtol=0,
                               atol=ATOL.get(arch, LOGIT_ATOL))


def test_mamba2_heads_refuse_as_the_reference(reference):
    """mamba2-780m's config has one (unused) attention head: tp=2 raises
    the reference's ValueError, word for word, before any weight is
    built."""
    with pytest.raises(ValueError) as got:
        ShardedEngine.from_checkpoint("mamba2-780m", smoke=True, tp=TP,
                                      device="cpu")
    assert str(got.value) == str(reference["mamba2:refusal"])


def test_reference_moe_under_tp_is_not_reduced(reference):
    """The reference's fault, pinned: each shard's expert ``down`` product
    over its half of d_ff is a partial sum (no reduce), which the
    unsharded product equals only summed over the shards; its tp=2 tokens
    part from its own unsharded engine's on the same thresholds.  The port
    refuses tp on a mixture-of-experts stack, naming ROADMAP Queue C."""
    ref = reference
    shards, full = ref["moe:shard_down"], ref["moe:down"]
    scale = np.abs(full).max()
    for part in shards:
        assert np.abs(part - full).max() > 0.1 * scale
    np.testing.assert_allclose(shards.sum(0), full, rtol=0,
                               atol=1e-5 * scale)
    differ = (ref["moe:tp_tokens"] != ref["moe:tokens"]).sum()
    assert differ >= ref["moe:tokens"].size // 2, differ
    with pytest.raises(ValueError) as got:
        ShardedEngine.from_checkpoint(MOE, smoke=True, tp=TP, device="cpu")
    assert str(got.value) == MOE_TP_REFUSAL
    assert "ROADMAP Queue C" in MOE_TP_REFUSAL


if __name__ == "__main__":
    _reference_main(sys.argv[1])
