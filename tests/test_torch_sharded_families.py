"""Sequence-parallel serving of every model family the reference's
``ShardedEngine(sp=2, use_pallas=True)`` serves, and its refusals.

Served at ``SMOKE`` in float32, each with the reference's weights (drawn
from ``PRNGKey(0)``) and its thresholds (calibrated on shared numpy
batches), bridged:
  * granite-moe-3b-a800m (mixture of experts: the router and the experts
    run replicated, as inside the reference's ``shard_map``);
  * mamba2-780m (SSM: its state has no sequence axis, no attention cache
    to shard);
  * seamless-m4t-medium (encoder-decoder) on 160 frames: the reference's
    cross prefill writes the first min(S_local, frames) rows of the
    encoder's memory into each shard's slice of the cross cache, and its
    cross decode attends that slice only, 64 of the 128 rows that its
    unsharded engine attends (ROADMAP Queue C); the port sizes its cross
    cache to those rows, and its sp=2 differs from its sp=1 as the
    reference's does;
  * llava-next-34b (VLM: patches before the text);
  * stablelm-12b (LayerNorm, head dim 160 at full width, an untied
    lm_head served, in both packages, on the last block's ``wq``
    thresholds: calibration leaves the readout's at its 1e-8 floor).
hymba-1.5b and gemma3-12b raise the reference's ``ValueError`` with its
message in the same call: a windowed layer's first sp decode over dense
caches, the prefill over the default layout's rings.

The reference needs two JAX devices: ONE subprocess builds every case with
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` and writes what it
served to an ``.npz`` that a module fixture shares.

Tolerances: greedy tokens identical; teacher-forced logits at prefill and
every decode step within ``LOGIT_ATOL`` = 1e-4 (``test_torch_sharded.py``'s
and ``test_torch_moe.py``'s float32 engine tolerance with shared
thresholds; measured 1.8e-7 granite-moe, 1.5e-7 mamba2, 0 llava and
stablelm, whose int8 readouts sum exactly), except seamless's, 2e-2: one
int8 step of slack (``test_torch_archs.py``'s rule for XLA's CPU
rounding, ROADMAP Queue C).  At these seeds the two packages' encoder
outputs part in row 0 from position 5 on (0.018 of a largest |value|
3.6, the size of one int8 activation step; row 1 within 4.8e-7), as
when a float32 rounding moves an int8 activation by a step; the logits
then part by up to 0.0090 in row 0, at sp=2 and at sp=1 alike, and
1.8e-7 in row 1.
seamless's sp=2 logits differ from its sp=1 logits by up to 0.078 in
both packages: 0.015 at prefill (the sp prefill attends exact K/V) and
0.058-0.078 at each decode step (the cross decode's rows).
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
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.launch.engine import model_inputs
from repro_torch.shard import ShardedEngine
from test_torch_sharded import _flat, _unflat
from test_torch_sharded_modes import _qparams

B, S, GEN, SP = 2, 16, 8, 2
FRAMES = 160            # past the 64 rows a shard of the 128-row cache keeps
LOGIT_ATOL = 1e-4
ATOL = {"seamless-m4t-medium": 2e-2}
SERVED = ("granite-moe-3b-a800m", "mamba2-780m", "seamless-m4t-medium",
          "llava-next-34b", "stablelm-12b")
REFUSED = ("hymba-1.5b", "gemma3-12b")
LAYOUTS = ("dense", "ring")


def _batch(rng, cfg, b, s, frames):
    """``b`` requests of ``s`` tokens, with an encoder-decoder's frames or
    a VLM's patches (standard normal float32)."""
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, frames, cfg.frame_dim),
                                            dtype=np.float32)
    if cfg.modality == "vlm":
        out["patches"] = rng.standard_normal((b, cfg.mm_patches, cfg.mm_dim),
                                             dtype=np.float32)
    return out


def _data(cfg, arch):
    rng = np.random.default_rng(sum(map(ord, arch)))
    calib = [_batch(rng, cfg, 2, 32, 64) for _ in range(2)]
    return calib, _batch(rng, cfg, B, S, FRAMES)


def _readout_thresholds(qparams, cfg):
    """An untied lm_head's activation thresholds taken from the last
    block's ``wq`` (``test_torch_archs.py``'s rule)."""
    if cfg.tie_embeddings:
        return qparams
    last = f"{cfg.name}/stack/layer{cfg.n_layers - 1}/attn/wq"
    head = f"{cfg.name}/lm_head"
    return {**qparams, head: {**qparams[head], "act": qparams[last]["act"]}}


def _reference_main(out_path):
    """The subprocess: the reference's ShardedEngine(sp=2, use_pallas=True)
    for each served family (its weights, thresholds, greedy tokens and
    teacher-forced logits; seamless's also through its unsharded engine on
    the same thresholds), and the refusals' messages."""
    from repro.configs import get_config
    from repro.launch import steps as JST
    from repro.models import build_model
    from repro.shard.engine import ShardedEngine as JShardedEngine

    assert jax.device_count() >= SP, jax.devices()
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

    for arch in SERVED + REFUSED:
        cfg = get_config(arch, smoke=True).replace(dtype=jnp.float32)
        calib, prompt = _data(cfg, arch)
        eng = JShardedEngine.from_checkpoint(
            cfg=cfg, sp=SP, cache_layout="dense", use_pallas=True,
            calib_batches=[jax_batch(c) for c in calib])
        if arch in REFUSED:
            for layout in LAYOUTS:
                twin = JShardedEngine(build_model(cfg), cfg, eng.policy,
                                      eng.serve_params, eng.qparams, sp=SP,
                                      mode="int8", cache_layout=layout)
                try:
                    twin.generate_batch(jax_batch(prompt), GEN)
                    msg = "served"
                except ValueError as err:
                    msg = str(err)
                out[f"{arch}:{layout}:refusal"] = np.asarray(msg)
            continue
        qparams = _readout_thresholds(eng.qparams, cfg)
        eng = JShardedEngine(build_model(cfg), cfg, eng.policy,
                             eng.serve_params, qparams, sp=SP, mode="int8",
                             cache_layout="dense")
        toks = np.asarray(eng.generate_batch(jax_batch(prompt), GEN).tokens)
        _flat(f"{arch}:params:", build_model(cfg).init(
            jax.random.PRNGKey(0)), out)
        for path, entry in qparams.items():
            _flat(f"{arch}:qparams:{path}|", entry, out)
        out[f"{arch}:tokens"] = toks
        out[f"{arch}:logits"] = forced(eng, prompt, toks)
        if cfg.family == "encdec":
            one = JShardedEngine(build_model(cfg), cfg, eng.policy,
                                 eng.serve_params, qparams, sp=1,
                                 mode="int8", cache_layout="dense")
            out[f"{arch}:sp1_logits"] = forced(one, prompt, toks)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_families") / "reference.npz"
    src = os.path.dirname(os.path.dirname(bridge.__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=src)
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def _cfg(arch):
    return torch_config(arch, smoke=True).replace(dtype=torch.float32)


def _forced(engine, prompt, toks):
    """Teacher-forced float32 logits: prefill, then GEN - 1 decode steps
    fed the reference's tokens."""
    with torch.inference_mode():
        inputs = model_inputs(engine.cfg, prompt, "cpu")
        cache = engine.init_cache(B, engine._cache_len(S, GEN),
                                  **engine._cache_kw(inputs))
        ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
        logits, cache = engine.model.prefill(engine.serve_params, inputs,
                                             cache, ctx)
        out = [logits[:, -1].float()]
        pos0 = S + engine._prefix_len()
        for i in range(GEN - 1):
            logits, cache = engine.model.decode_step(
                engine.serve_params, toks[:, i:i + 1], cache, pos0 + i, ctx)
            out.append(logits[:, -1].float())
    return torch.stack(out).numpy()


@pytest.fixture(scope="module", params=SERVED)
def served(request, reference):
    """The port's ShardedEngine(sp=2) on the CPU from the reference's
    weights and thresholds, and what it serves."""
    arch, ref = request.param, reference
    cfg = _cfg(arch)
    engine = ShardedEngine.from_checkpoint(
        cfg=cfg,
        params=bridge.params_from_jax(_unflat(ref, f"{arch}:params:")),
        qparams=bridge.qparams_from_jax(_qparams(ref, f"{arch}:qparams:")),
        device="cpu", sp=SP, cache_layout="dense")
    _, prompt = _data(cfg, arch)
    toks = torch.from_numpy(ref[f"{arch}:tokens"]).long()
    return dict(arch=arch, ref=ref, engine=engine, prompt=prompt, toks=toks,
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


def test_caches_under_sp(served):
    """What each family's cache tree holds under sp=2: an attention cache
    split into two equal shards; an SSM state (no sequence axis); a cross
    cache of the 64 rows (of 160 frames) a shard of the 128-row cache
    keeps."""
    engine, cfg = served["engine"], served["engine"].cfg
    inputs = model_inputs(cfg, served["prompt"], "cpu")
    layer = engine.init_cache(B, engine._cache_len(S, GEN),
                              **engine._cache_kw(inputs))["layer0"]
    if "attn" in layer:
        assert layer["attn"].layout == "dense"
        assert layer["attn"].capacity % SP == 0
    assert ("mamba" in layer) == (cfg.kind == "mamba")
    if cfg.family == "encdec":
        assert layer["cross"].capacity == layer["attn"].capacity // SP < (
            FRAMES)


def test_seamless_cross_decode_attends_a_shards_rows(reference):
    """The port's seamless at sp=1, on the same weights and thresholds,
    against the reference's unsharded engine, teacher-forced on the sp=2
    tokens: equal logits, so the port's sp=2 differs from its sp=1 as the
    reference's does (the cross decode of sp=2 attends the first 64 of
    the 128 rows)."""
    arch = "seamless-m4t-medium"
    ref = reference
    sharded = ShardedEngine.from_checkpoint(
        cfg=_cfg(arch),
        params=bridge.params_from_jax(_unflat(ref, f"{arch}:params:")),
        qparams=bridge.qparams_from_jax(_qparams(ref, f"{arch}:qparams:")),
        device="cpu", sp=1, cache_layout="dense")
    _, prompt = _data(sharded.cfg, arch)
    toks = torch.from_numpy(ref[f"{arch}:tokens"]).long()
    one = _forced(sharded, prompt, toks)
    np.testing.assert_allclose(one, ref[f"{arch}:sp1_logits"], rtol=0,
                               atol=ATOL[arch])
    gap = np.abs(ref[f"{arch}:logits"] - ref[f"{arch}:sp1_logits"])
    # every decode step moves past the tolerance: the rows cut apart
    assert (gap[1:].max(axis=(1, 2)) > 2 * ATOL[arch]).all()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", REFUSED)
def test_windowed_stacks_raise_the_references_error(arch, layout,
                                                    reference):
    """A windowed layer under sp=2: over dense caches its first decode
    raises "sliding-window decode is local by construction"; over the
    default layout's rings the prefill raises that the layout is not
    dense; each the reference's ValueError, word for word."""
    cfg = _cfg(arch)
    calib, prompt = _data(cfg, arch)
    engine = ShardedEngine.from_checkpoint(
        cfg=cfg, calib_batches=calib, device="cpu", sp=SP,
        cache_layout=layout)
    want = str(reference[f"{arch}:{layout}:refusal"])
    assert "sliding-window" in want or "unsupported" in want
    with pytest.raises(ValueError) as got:
        engine.generate_batch(prompt, gen=GEN)
    assert str(got.value) == want


if __name__ == "__main__":
    _reference_main(sys.argv[1])
