"""Sequence-parallel serving in the reference's other modes and with the
speculative strategy, held against the reference's ``ShardedEngine(sp=2,
use_pallas=True)``.

The modes are the reference's bf16 serving modes: bf16 weights over an
int8 cache (``fp``), bf16 weights over a float cache (``fp``,
``kv_int8=False``) and int8 weights over a float cache (``kv_int8=False``);
the strategy is the speculative verify window (``spec_k`` 4, a 2-gram
lookup), in ``generate_batch`` and in the slot scheduler.  Under sp a float
cache decodes through per-shard float32 partials and the exact merge (the
reference's ``local_decode_partials``), an int8 one through the partials
kernel (its plain version here); prefill and the verify window attend in
plain attention, as the reference's sp branches do.

The reference needs two JAX devices: ONE subprocess builds every case with
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` and writes what it
served to an ``.npz`` that a module fixture shares.  Each case is a float32
smollm-135m at ``SMOKE`` (the reference's weights, drawn from
``PRNGKey(0)``, and its thresholds, calibrated on shared numpy batches,
cross over through the bridge), so a float cache is a float32 one.

Tolerances: greedy and speculative tokens and scheduler completions
identical; teacher-forced logits at prefill and every decode step, and the
verify window's logits, within ``LOGIT_ATOL`` = 1e-4 (``test_torch_
sharded.py``'s; measured worst 3.0e-7, largest |logit| 0.50); the float
partials (acc, l) within 1e-5 of their scale and m within 1e-5 (measured
2.5e-7 of the scale), the merge within 1e-5 of its scale (measured 3.6e-7
absolute).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.shard import partial_softmax as JPS
from repro_torch import bridge
from repro_torch.cache import DenseCache
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.kernels import ops
from repro_torch.launch.scheduler import Request
from repro_torch.shard import ShardedEngine
from repro_torch.shard import partial_softmax as TPS
from test_torch_sharded import _flat, _stack, _unflat

S, GEN, SP, WINDOW = 16, 8, 2, 5
LOGIT_ATOL = 1e-4
SPEC = dict(decode_strategy="speculative", spec_k=WINDOW - 1, spec_ngram=2)
CASES = {"bf16_w_int8_kv": dict(fp=True),
         "bf16_w_bf16_kv": dict(fp=True, kv_int8=False),
         "int8_w_bf16_kv": dict(kv_int8=False),
         "speculative": SPEC}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (1 + np.abs(want).max()))


def _qparams(arrs, prefix):
    flat = {}
    for key, a in arrs.items():
        if key.startswith(prefix):
            path, leaf = key[len(prefix):].split("|")
            flat.setdefault(path, {})[leaf] = a
    return {path: _unflat(leaves, "") for path, leaves in flat.items()}


def _requests(toks):
    """Three ragged requests: prompts of 16, 11 and 9 tokens."""
    return [(r, toks[r, :n]) for r, n in enumerate([S, S - 5, 9])]


def _reference_main(out_path):
    """The subprocess: the reference's ShardedEngine(sp=2, use_pallas=True)
    for each case; writes the weights, each case's thresholds, its greedy
    (or speculative) tokens, its teacher-forced logits, and for the
    speculative case one verify window's logits and its scheduler's
    completions."""
    from repro.configs import get_config
    from repro.core import api as JA
    from repro.launch import steps as JST
    from repro.launch.scheduler import Request as JRequest
    from repro.models import build_model
    from repro.shard.engine import ShardedEngine as JShardedEngine

    assert jax.device_count() >= SP, jax.devices()
    cfg = get_config("smollm-135m", smoke=True).replace(dtype=jnp.float32)
    rng = np.random.default_rng(23)
    calib = [rng.integers(0, cfg.vocab, (4, 32), dtype=np.int32)
             for _ in range(2)]
    prompts = rng.integers(0, cfg.vocab, (2, S), dtype=np.int32)
    sched_toks = rng.integers(0, cfg.vocab, (3, S), dtype=np.int32)
    out = dict(prompts=prompts, sched_toks=sched_toks)
    _flat("params:", build_model(cfg).init(jax.random.PRNGKey(0)), out)
    for name, flags in CASES.items():
        eng = JShardedEngine.from_checkpoint(
            cfg=cfg, sp=SP, cache_layout="dense", use_pallas=True,
            calib_batches=[{"tokens": jnp.asarray(c)} for c in calib],
            **flags)
        toks = np.asarray(eng.generate_batch(
            {"tokens": jnp.asarray(prompts)}, GEN).tokens)
        prefill = jax.jit(JST.make_prefill_step(eng.model, cfg, eng.policy,
                                                eng.mode))
        step = jax.jit(JST.make_serve_step(eng.model, cfg, eng.policy,
                                           eng.mode))
        cache = eng.init_cache(2, eng._cache_len(S, GEN))
        logits, cache = prefill(eng.serve_params, eng.qparams,
                                {"tokens": jnp.asarray(prompts)}, cache)
        forced = [np.asarray(logits[:, -1], np.float32)]
        for i in range(GEN - 1):
            _, logits, cache = step(eng.serve_params, eng.qparams,
                                    jnp.asarray(toks[:, i:i + 1]), cache,
                                    jnp.int32(S + i))
            forced.append(np.asarray(logits[:, -1], np.float32))
        for path, entry in eng.qparams.items():
            _flat(f"{name}:qparams:{path}|", entry, out)
        out[f"{name}:tokens"] = toks
        out[f"{name}:logits"] = np.stack(forced)
        if name != "speculative":
            continue

        @jax.jit
        def verify(serve_params, qparams, window, cache, pos, active):
            ctx = JA.make_ctx(eng.mode, eng.policy, qparams)
            return eng.model.verify_step(serve_params, window, cache, pos,
                                         ctx, slot_mask=active)

        cache = eng.init_cache(2, eng._cache_len(S, GEN))
        _, cache = prefill(eng.serve_params, eng.qparams,
                           {"tokens": jnp.asarray(prompts)}, cache)
        v_logits, _ = verify(eng.serve_params, eng.qparams,
                             jnp.asarray(toks[:, :WINDOW]), cache,
                             jnp.full((2,), S, jnp.int32),
                             jnp.asarray([True, False]))
        out[f"{name}:verify_logits"] = np.asarray(v_logits, np.float32)
        done = eng.generate([JRequest(rid=r, tokens=t, max_gen=GEN)
                             for r, t in _requests(sched_toks)],
                            max_slots=2, block_steps=3)
        for c in done:
            out[f"{name}:done:{c.rid}"] = np.asarray(c.tokens, np.int64)
            out[f"{name}:status:{c.rid}"] = np.asarray(c.status)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_modes") / "reference.npz"
    src = os.path.dirname(os.path.dirname(bridge.__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=src)
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


def _cfg():
    return torch_config("smollm-135m", smoke=True).replace(
        dtype=torch.float32)


def _forced(engine, prompts, toks):
    """Teacher-forced float32 logits: prefill, then GEN - 1 decode steps
    fed the reference's tokens."""
    with torch.inference_mode():
        cache = engine.init_cache(2, engine._cache_len(S, GEN))
        ctx = TA.make_ctx(engine.mode, engine.policy, engine.qparams)
        logits, cache = engine.model.prefill(
            engine.serve_params, {"tokens": torch.from_numpy(prompts)},
            cache, ctx)
        out = [logits[:, -1].float()]
        for i in range(GEN - 1):
            logits, cache = engine.model.decode_step(
                engine.serve_params, toks[:, i:i + 1], cache, S + i, ctx)
            out.append(logits[:, -1].float())
    return torch.stack(out).numpy()


@pytest.fixture(scope="module", params=list(CASES))
def served(request, reference):
    """The port's ShardedEngine(sp=2) on the CPU in one case, from the
    reference's weights and that case's thresholds, and what it serves."""
    name = request.param
    ref = reference
    engine = ShardedEngine.from_checkpoint(
        cfg=_cfg(), params=bridge.params_from_jax(_unflat(ref, "params:")),
        qparams=bridge.qparams_from_jax(_qparams(ref, f"{name}:qparams:")),
        device="cpu", sp=SP, cache_layout="dense", **CASES[name])
    toks = torch.from_numpy(ref[f"{name}:tokens"]).long()
    return dict(name=name, ref=ref, engine=engine,
                out=engine.generate_batch({"tokens": ref["prompts"]},
                                          gen=GEN),
                logits=_forced(engine, ref["prompts"], toks))


def test_tokens_and_logits_match(served):
    name, ref = served["name"], served["ref"]
    np.testing.assert_array_equal(served["out"].tokens.numpy(),
                                  ref[f"{name}:tokens"])
    want = ref[f"{name}:logits"]
    assert served["logits"].shape == want.shape
    np.testing.assert_allclose(served["logits"], want, rtol=0,
                               atol=LOGIT_ATOL)


def test_mode_and_cache_are_the_cases(served):
    """fp serves bf16 weights (no int8 weight tensor), ``kv_int8=False`` a
    float cache with unit scales; the speculative engine its window."""
    engine, flags = served["engine"], CASES[served["name"]]
    assert engine.mode == ("none" if flags.get("fp") else "int8")
    assert (engine.n_int8_weights() == 0) == bool(flags.get("fp"))
    cache = engine.init_cache(2, 128)["layer0"]["attn"]
    assert cache.quantized == flags.get("kv_int8", True)
    assert cache.capacity % SP == 0
    assert engine.decode_strategy == flags.get("decode_strategy")


def test_decode_runs_the_partials_kernel_on_a_quantized_cache_only(
        served, monkeypatch):
    """One partials call per shard and layer a decode step over an int8
    cache (its plain version on the CPU); none over a float cache, whose
    shards go through ``local_decode_partials``; never the normalized
    decode attention or the prefill attention (the reference's sp prefill
    and verify window are plain)."""
    engine, calls = served["engine"], []
    # each wrapper records its calls, then runs
    for name in ("decode_attention_partials", "decode_attention_view",
                 "prefill_attention", "prefill_attention_view"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    engine.generate_batch({"tokens": served["ref"]["prompts"]}, gen=3)
    per_step = SP * engine.cfg.n_layers if engine.policy.kv_int8 else 0
    # 2 decode steps; the speculative engine decodes in verify windows
    steps = 0 if engine.decode_strategy == "speculative" else 2
    assert calls == ["decode_attention_partials"] * (per_step * steps)


@pytest.fixture(scope="module")
def speculative(reference):
    ref = reference
    return ShardedEngine.from_checkpoint(
        cfg=_cfg(), params=bridge.params_from_jax(_unflat(ref, "params:")),
        qparams=bridge.qparams_from_jax(
            _qparams(ref, "speculative:qparams:")),
        device="cpu", sp=SP, cache_layout="dense", **SPEC)


def test_speculative_verify_window_matches(speculative, reference):
    """One verify window of the reference's first tokens after the prompt,
    row 1 inactive: the window's logits through the sharded verify_step
    (plain verify attention over the whole dequantized cache)."""
    engine, ref = speculative, reference
    with torch.inference_mode():
        cache = engine.init_cache(2, engine._cache_len(S, GEN))
        ctx = TA.make_ctx(engine.mode, engine.policy, engine.qparams)
        _, cache = engine.model.prefill(
            engine.serve_params, {"tokens": torch.from_numpy(
                ref["prompts"])}, cache, ctx)
        ops.reset_launches()
        logits, _ = engine.model.verify_step(
            engine.serve_params,
            torch.from_numpy(ref["speculative:tokens"][:, :WINDOW]).long(),
            cache, torch.full((2,), S, dtype=torch.int32), ctx,
            slot_mask=torch.tensor([True, False]))
    assert ops.launch_counts()["prefill_attention"] == 0
    want = ref["speculative:verify_logits"]
    assert tuple(logits.shape) == want.shape
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=LOGIT_ATOL)


def test_speculative_scheduler_completions_match(speculative, reference):
    done = speculative.generate(
        [Request(rid=r, tokens=t, max_gen=GEN)
         for r, t in _requests(reference["sched_toks"])],
        max_slots=2, block_steps=3)
    got = {c.rid: (c.status, list(c.tokens)) for c in done}
    want = {r: (str(reference[f"speculative:status:{r}"]),
                reference[f"speculative:done:{r}"].tolist())
            for r in range(3)}
    assert got == want
    assert speculative._scheduler.spec_stats()["verify_windows"] > 0


def test_speculative_tokens_equal_greedy(speculative, reference):
    """The accept rule keeps greedy's tokens: the speculative engine's
    tokens equal a greedy engine's on the same weights and thresholds."""
    greedy = ShardedEngine(speculative.base_model, speculative.cfg,
                           speculative.policy, speculative.serve_params,
                           speculative.qparams, device="cpu", sp=SP,
                           cache_layout="dense")
    prompts = reference["prompts"]
    np.testing.assert_array_equal(
        speculative.generate_batch({"tokens": prompts}, gen=GEN).tokens,
        greedy.generate_batch({"tokens": prompts}, gen=GEN).tokens)


# ---------------------------------------------------------------------------
# the float partials against the reference's under jax.vmap(axis_name=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sp", [2, 4])
def test_float_partials_match_the_reference(sp, dtype):
    """Each shard's ``local_decode_partials`` over a float cache's view
    against the reference's over the same slice, per shard under
    ``jax.vmap(..., axis_name="model")``; the merge against the
    reference's ``sp_partial_combine``; ``sp_decode_attention`` over the
    whole float cache is that merge, with exact zeros for a row that sees
    no key."""
    b, s, kvh, g, d = 4, 32, 2, 3, 16
    rng = np.random.default_rng(90 + sp)
    q = rng.normal(size=(b, kvh, g, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kvh, d)).astype(np.float32)
            for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    s_local = s // sp
    valid = np.array([s, 13, s_local, 0], np.int32)

    def shard(k_loc, v_loc):
        idx = jax.lax.axis_index("model")
        vl = jnp.clip(jnp.asarray(valid) - idx * s_local, 0, s_local)
        m, l, acc = JPS.local_decode_partials(
            jnp.asarray(q[:, None]).astype(jdt), k_loc, v_loc, vl)
        return JPS.sp_partial_combine(m, l, acc, "model"), (m, l, acc)

    j_out, (jm, jl, jacc) = jax.vmap(shard, axis_name="model")(
        jnp.asarray(_stack(k, sp)).astype(jdt),
        jnp.asarray(_stack(v, sp)).astype(jdt))
    tq = torch.from_numpy(q).to(tdt)
    tk, tv = (torch.from_numpy(x).to(tdt) for x in (k, v))
    parts = []
    for i in range(sp):
        vl = torch.clamp(torch.from_numpy(valid) - i * s_local, 0, s_local)
        m, l, acc = TPS.local_decode_partials(
            tq[:, None], tk[:, i * s_local:(i + 1) * s_local],
            tv[:, i * s_local:(i + 1) * s_local], vl)
        assert m.dtype == l.dtype == acc.dtype == torch.float32
        _close(acc.numpy(), np.asarray(jacc[i]))
        _close(l.numpy(), np.asarray(jl[i]))
        np.testing.assert_allclose(m.numpy(), np.asarray(jm[i]), rtol=0,
                                   atol=1e-5)
        parts.append((m, l, acc))
    out = TPS.sp_partial_combine(*zip(*parts)).numpy()
    for i in range(sp):
        _close(out, np.asarray(j_out[i]))
    cache = DenseCache(tk, tv, torch.ones(kvh), torch.ones(kvh))
    assert not cache.quantized
    ops.reset_launches()
    sp_out = TPS.sp_decode_attention(tq, cache, torch.from_numpy(valid), sp)
    assert ops.launch_counts()["decode_attention_partials"] == 0
    np.testing.assert_array_equal(sp_out.numpy(), out[:, 0])
    np.testing.assert_array_equal(out[valid == 0], 0.0)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
