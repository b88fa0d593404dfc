"""Sequence-parallel serving of the port against the reference.

On the CPU the partials kernel runs its plain version; it is held against
the Pallas kernel in interpret mode (dense entry and a permuted block
table) and against the reference's per-shard ``local_decode_partials``.
The port's sequence-parallel cache is the global cache, so its writes are
the unsharded cache methods; those and the merge are held against the
reference's owner writes and merge, which run per shard under
``jax.vmap(..., axis_name="model")``: ``axis_index`` and ``all_gather``
work under ``vmap``, so one CPU device suffices.  The engine is held
against the reference's ``ShardedEngine(sp=2, use_pallas=True)``, which
needs two JAX devices: one subprocess builds it with
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` and writes what it
served to an ``.npz``.

Tolerances: cache tiles are copies (bit-identical); the partials and the
merge sum float32 terms in another order than XLA (acc and l to 1e-5 of
their scale, m to 1e-5); the engine in float32 with shared weights and
thresholds: logits to atol 1e-4 and tokens identical, as in
``test_torch_engine.py``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import DenseCache as JCache
from repro.core import packing as jpack
from repro.kernels import decode_attention as jda
from repro.kernels import ref as jref
from repro.shard import partial_softmax as JPS
from repro.shard import seq_cache as JSC
from repro_torch import bridge
from repro_torch.bridge import to_tensor
from repro_torch.cache import DenseCache, KernelView, dequantize_kv
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.kernels import decode_attention_partials as tdap
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch.scheduler import Request
from repro_torch.shard import ShardedEngine
from repro_torch.shard import partial_softmax as TPS

NEG_INF = np.float32(-1e30)
G3 = dict(name="smollm-135m-g3", n_layers=2, d_model=96, n_heads=6,
          n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, attn_q_chunk=16,
          attn_kv_chunk=16, loss_chunk=16)
CONFIGS = {"smoke": None, "g3": G3}
S, GEN, SP = 16, 8, 2


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (1 + np.abs(want).max()))


def _tiles(rng, shape, bits):
    lv = 127 if bits == 8 else 7
    t = rng.integers(-lv, lv + 1, shape, dtype=np.int8)
    return np.asarray(jpack.pack_int4(jnp.asarray(t), axis=-1)) \
        if bits == 4 else t


# ---------------------------------------------------------------------------
# the partials kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def _partials_inputs(b, s, kvh, g, d, bits, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kvh, g, d)).astype(np.float32)
    k, v = (_tiles(rng, (b, s, kvh, d), bits) for _ in range(2))
    ks = (rng.random(kvh) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random(kvh) * 0.05 + 0.01).astype(np.float32)
    return q, k, v, ks, vs


def _check_partials(got, want, cur):
    """acc and l to 1e-5 of their scale, m to 1e-5; rows with nothing
    visible exactly (0, -1e30, 0)."""
    (acc, m, l), (wacc, wm, wl) = got, (np.asarray(w) for w in want)
    assert acc.shape == wacc.shape and m.shape == l.shape == wm.shape
    _close(acc, wacc)
    _close(l, wl)
    np.testing.assert_allclose(m, wm, rtol=0, atol=1e-5)
    empty = np.asarray(cur) == 0
    np.testing.assert_array_equal(acc[empty], 0.0)
    np.testing.assert_array_equal(m[empty], NEG_INF)
    np.testing.assert_array_equal(l[empty], 0.0)
    np.testing.assert_array_equal(wm[empty], NEG_INF)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("g", [1, 3])
def test_partials_plain_matches_pallas(bits, g):
    """Dense entry: per-row local counts 0, mid-tile and full."""
    q, k, v, ks, vs = _partials_inputs(4, 40, 2, g, 16, bits, seed=50 + g)
    cur = np.array([0, 13, 40, 27], np.int32)
    got = ops.decode_attention_partials(
        *(to_tensor(a) for a in (q, k, v, ks, vs)), to_tensor(cur),
        kv_bits=bits)
    want = jda.decode_attention_partials(
        *(jnp.asarray(a) for a in (q, k, v, ks, vs, cur)), interpret=True,
        kv_bits=bits)
    _check_partials([t.numpy() for t in got], want, cur)


@pytest.mark.parametrize("bits", [8, 4])
def test_paged_partials_plain_matches_pallas(bits):
    """A permuted block table in which rows 0 and 1 share a page."""
    rng = np.random.default_rng(60 + bits)
    b, nb, ps, kvh, g, d = 3, 4, 8, 2, 3, 16
    pages = b * nb + 2
    kp, vp = (_tiles(rng, (pages, ps, kvh, d), bits) for _ in range(2))
    table = rng.permutation(pages)[:b * nb].reshape(b, nb).astype(np.int32)
    table[1, 0] = table[0, 0]
    q = rng.normal(size=(b, kvh, g, d)).astype(np.float32)
    ks = (rng.random(kvh) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random(kvh) * 0.05 + 0.01).astype(np.float32)
    cur = np.array([0, 21, 32], np.int32)
    view = KernelView(to_tensor(kp), to_tensor(vp), to_tensor(table), ps,
                      bits)
    got = ops.decode_attention_partials_view(
        to_tensor(q), view, to_tensor(ks), to_tensor(vs), to_tensor(cur))
    want = jda.decode_attention_partials_tiles(
        *(jnp.asarray(a) for a in (q, kp, vp, table, ks, vs, cur)),
        interpret=True, kv_bits=bits)
    _check_partials([t.numpy() for t in got], want, cur)


@pytest.mark.parametrize("bits", [8, 4])
def test_single_shard_invariant(bits):
    """acc / max(l, 1e-30) is the decode attention: bit for bit against the
    port's plain version (the kernel's epilogue, in the same order), to
    1e-5 against the reference's oracle."""
    q, k, v, ks, vs = _partials_inputs(3, 24, 2, 3, 16, bits, seed=70)
    cur = np.array([24, 0, 11], np.int32)
    args = [to_tensor(a) for a in (q, k, v, ks, vs, cur)]
    acc, m, l = ops.decode_attention_partials(*args, kv_bits=bits)
    norm = acc / torch.clamp_min(l, 1e-30)[..., None]
    np.testing.assert_array_equal(
        norm.numpy(), tref.decode_attention_ref(*args, kv_bits=bits).numpy())
    want = jref.decode_attention_ref(
        *(jnp.asarray(a) for a in (q, k, v, ks, vs, cur)), kv_bits=bits)
    _close(norm.numpy(), np.asarray(want))


def test_partials_read_a_shard_view_in_place():
    """A shard's slice of the global cache is a strided view: the entry
    takes it as it lies (no copy), and gives what a contiguous copy
    gives."""
    q, k, v, ks, vs = _partials_inputs(2, 48, 2, 3, 16, 8, seed=71)
    kt, vt = to_tensor(k), to_tensor(v)
    kl, vl = kt[:, 16:32], vt[:, 16:32]
    assert not kl.is_contiguous()
    args = (to_tensor(q), kl, vl, to_tensor(ks), to_tensor(vs),
            torch.tensor([16, 5], dtype=torch.int32))
    tdap.check(*args)
    got = ops.decode_attention_partials(*args)
    want = ops.decode_attention_partials(args[0], kl.contiguous(),
                                         vl.contiguous(), *args[3:])
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), w.numpy())
    wide = torch.zeros((2, 16, 2, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="not a slice along S"):
        ops.decode_attention_partials(args[0], wide[..., :16],
                                      wide[..., 16:], *args[3:])
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention(args[0], kl, vl, *args[3:])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdap.launch(*args)


# ---------------------------------------------------------------------------
# local partials, the merge and the owner writes against the reference
# under vmap over the shard axis
# ---------------------------------------------------------------------------


def _stack(x, sp):
    """(B, S, ...) -> (sp, B, S/sp, ...): the shards' slices."""
    b, s = x.shape[:2]
    return np.moveaxis(x.reshape((b, sp, s // sp) + x.shape[2:]), 1, 0)


def _tcache(k, v, ks, vs, bits):
    return DenseCache(to_tensor(k), to_tensor(v), to_tensor(ks),
                      to_tensor(vs), bits=bits)


@pytest.mark.parametrize("sp", [2, 4])
def test_local_partials_and_combine_match(sp):
    """Each shard's partials (the partials kernel's plain version over the
    shard's view of the int8 cache) against the reference's
    ``local_decode_partials`` over the same view dequantized, and the
    merge against the reference's ``sp_partial_combine``."""
    b, s, kvh, g, d = 4, 32, 2, 3, 16
    q, k, v, ks, vs = _partials_inputs(b, s, kvh, g, d, 8, seed=80 + sp)
    kd, vd = k.astype(np.float32) * ks[:, None], v.astype(np.float32) * vs[
        :, None]
    s_local = s // sp
    # a row in every shard, one that ends mid-shard, one shard-aligned and
    # one with nothing visible (an inactive slot)
    valid = np.array([s, 13, s_local, 0], np.int32)

    def shard(k_loc, v_loc):
        idx = jax.lax.axis_index("model")
        vl = jnp.clip(jnp.asarray(valid) - idx * s_local, 0, s_local)
        m, l, acc = JPS.local_decode_partials(jnp.asarray(q[:, None]), k_loc,
                                              v_loc, vl)
        return JPS.sp_partial_combine(m, l, acc, "model"), (m, l, acc)

    j_out, (jm, jl, jacc) = jax.vmap(shard, axis_name="model")(
        jnp.asarray(_stack(kd, sp)), jnp.asarray(_stack(vd, sp)))
    tq, tk, tv, tks, tvs = (to_tensor(a) for a in (q, k, v, ks, vs))
    parts = []
    for i in range(sp):
        vl = torch.clamp(torch.from_numpy(valid) - i * s_local, 0, s_local)
        acc, m, l = tref.decode_attention_partials_ref(
            tq, tk[:, i * s_local:(i + 1) * s_local],
            tv[:, i * s_local:(i + 1) * s_local], tks, tvs, vl)
        _close(acc.numpy(), np.asarray(jacc[i])[..., 0, :])
        _close(l.numpy(), np.asarray(jl[i])[..., 0])
        np.testing.assert_allclose(m.numpy(), np.asarray(jm[i])[..., 0],
                                   rtol=0, atol=1e-5)
        parts.append((m[..., None], l[..., None], acc[..., None, :]))
    out = TPS.sp_partial_combine(*zip(*parts)).numpy()
    assert out.shape == (b, 1, kvh, g, d)
    for i in range(sp):                     # the merge is replicated
        _close(out, np.asarray(j_out[i]))
    np.testing.assert_array_equal(out[valid == 0], 0.0)
    # the decode path's loop over the shard views is that merge, and it is
    # the unsharded softmax
    cache = _tcache(k, v, ks, vs, 8)
    sp_out = TPS.sp_decode_attention(tq, cache, torch.from_numpy(valid), sp)
    np.testing.assert_array_equal(sp_out.numpy(), out[:, 0])
    whole = tref.decode_attention_ref(tq, tk, tv, tks, tvs,
                                      torch.from_numpy(valid))
    _close(out[:, 0], whole.numpy())


def _jcache(k_loc, v_loc, ks, vs, bits):
    return JCache(k=k_loc, v=v_loc, k_scale=jnp.asarray(ks),
                  v_scale=jnp.asarray(vs), _quantized=True, bits=bits)


def _global(x):
    """(sp, B, S_local, ...) -> (B, sp * S_local, ...)."""
    x = np.asarray(x)
    return np.moveaxis(x, 0, 1).reshape((x.shape[1], -1) + x.shape[3:])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("sp", [2, 4])
def test_owner_writes_and_gather_match(bits, sp):
    """The port writes a sequence-split cache with the unsharded cache
    methods: a prefill chunk straddling a shard boundary (``append``), a
    decode token on a shard's last row and an inactive slot
    (``append_slots``), then the dequantized view of the first positions
    (``dense_view``).  Bit for bit the union of the reference's owner
    writes over its shards, and its ``gathered_dense``.

    Positions at or beyond ``sp * S_local`` are where the two differ: the
    reference's owner writes drop them, while ``append`` raises and
    ``append_slots`` clamps to the last row, as the unsharded cache does.
    No caller writes there (``ShardedModel.init_cache`` sizes the cache
    for every position served); both behaviours are pinned below.  A
    window of several rows a slot (the speculative verify window's write)
    takes each slot's rows from its start, the start clamped so the
    window ends at the capacity, as the unsharded cache's does."""
    rng = np.random.default_rng(90 + sp + bits)
    b, s_local, kvh, d = 3, 8, 2, 16
    cap = sp * s_local
    dp = d // 2 if bits == 4 else d
    k0, v0 = (_tiles(rng, (b, cap, kvh, d), bits) for _ in range(2))
    ks = (rng.random(kvh) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random(kvh) * 0.05 + 0.01).astype(np.float32)
    chunk = 6
    start = s_local - 3                     # straddles shards 0 and 1
    kc, vc = (_tiles(rng, (b, chunk, kvh, d), bits) for _ in range(2))
    k1, v1 = (_tiles(rng, (b, 1, kvh, d), bits) for _ in range(2))
    # shard 0's last row, shard 1's first row, an inactive slot
    pos = np.array([s_local - 1, s_local, cap - 1], np.int32)
    active = np.array([True, True, False])

    def shard(k_loc, v_loc):
        c = _jcache(k_loc, v_loc, ks, vs, bits)
        c = JSC.owner_append(c, jnp.asarray(kc), jnp.asarray(vc), start,
                             "model")
        c = JSC.owner_append_slots(c, jnp.asarray(k1), jnp.asarray(v1),
                                   jnp.asarray(pos), "model",
                                   active=jnp.asarray(active))
        return c.k, c.v, JSC.gathered_dense(c, "model", limit=cap - 3)

    jk, jv, (gk, gv) = jax.vmap(shard, axis_name="model")(
        jnp.asarray(_stack(k0, sp)), jnp.asarray(_stack(v0, sp)))
    cache = _tcache(k0, v0, ks, vs, bits)
    cache.append(to_tensor(kc), to_tensor(vc), start)
    cache.append_slots(to_tensor(k1), to_tensor(v1), to_tensor(pos),
                       active=torch.from_numpy(active))
    assert cache.k.shape == (b, cap, kvh, dp)
    np.testing.assert_array_equal(cache.k.numpy(), _global(jk))
    np.testing.assert_array_equal(cache.v.numpy(), _global(jv))
    # what the writes did, independently of the reference
    want = k0.copy()
    want[:, start:start + chunk] = kc
    want[0, s_local - 1] = k1[0, 0]
    want[1, s_local] = k1[1, 0]
    np.testing.assert_array_equal(cache.k.numpy(), want)
    tk, tv = (dequantize_kv(t, sc, bits) for t, sc in
              zip(cache.dense_view(cap - 3), cache.scales()))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(gk[0]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(gv[sp - 1]))
    # beyond the capacity, and several rows a slot
    with pytest.raises(ValueError, match="overruns"):
        cache.append(to_tensor(kc), to_tensor(vc), cap - 2)
    cache.append_slots(to_tensor(k1), to_tensor(v1),
                       torch.tensor([cap + 2, 0, 1], dtype=torch.int32),
                       active=torch.tensor([True, False, False]))
    want[0, cap - 1] = k1[0, 0]
    np.testing.assert_array_equal(cache.k.numpy(), want)
    cache.append_slots(to_tensor(kc[:, :2]), to_tensor(vc[:, :2]),
                       to_tensor(pos))
    for r, p in enumerate(np.minimum(pos, cap - 2)):
        want[r, p:p + 2] = kc[r, :2]
    np.testing.assert_array_equal(cache.k.numpy(), want)


# ---------------------------------------------------------------------------
# the engine against the reference ShardedEngine(sp=2) in a subprocess
# ---------------------------------------------------------------------------


def _requests(toks):
    """The reference suite's three ragged requests (tests/test_sharded.py):
    prompts of 16, 11 and 9 tokens, 8 generated each."""
    return [(r, toks[r % toks.shape[0], :n]) for r, n in
            enumerate([S, S - 5, 9])]


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}/", v, out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def _unflat(arrs, prefix):
    tree = {}
    for key, a in arrs.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _reference_main(out_path):
    """The subprocess: the reference's ShardedEngine(sp=2, use_pallas=True)
    in float32 for each config; writes params, qparams, prompts, its greedy
    tokens and teacher-forced logits, and its scheduler completions."""
    from repro.configs import get_config
    from repro.launch import steps as JST
    from repro.launch.scheduler import Request as JRequest
    from repro.models import build_model
    from repro.shard.engine import ShardedEngine as JShardedEngine

    assert jax.device_count() >= SP, jax.devices()
    out = {}
    for name, variant in CONFIGS.items():
        cfg = get_config("smollm-135m", smoke=True)
        if variant is not None:
            cfg = cfg.replace(**variant)
        cfg = cfg.replace(dtype=jnp.float32)
        rng = np.random.default_rng(21)
        calib = [rng.integers(0, cfg.vocab, (4, 32), dtype=np.int32)
                 for _ in range(2)]
        prompts = rng.integers(0, cfg.vocab, (2, S), dtype=np.int32)
        sched_toks = rng.integers(0, cfg.vocab, (3, S), dtype=np.int32)
        eng = JShardedEngine.from_checkpoint(
            cfg=cfg, sp=SP, cache_layout="dense", use_pallas=True,
            calib_batches=[{"tokens": jnp.asarray(c)} for c in calib])
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        toks = np.asarray(eng.generate_batch(
            {"tokens": jnp.asarray(prompts)}, GEN).tokens)
        cache = eng.init_cache(2, eng._cache_len(S, GEN))
        prefill = jax.jit(JST.make_prefill_step(eng.model, cfg, eng.policy,
                                                "int8"))
        step = jax.jit(JST.make_serve_step(eng.model, cfg, eng.policy,
                                           "int8"))
        logits, cache = prefill(eng.serve_params, eng.qparams,
                                {"tokens": jnp.asarray(prompts)}, cache)
        forced = [np.asarray(logits[:, -1], np.float32)]
        for i in range(GEN - 1):
            _, logits, cache = step(eng.serve_params, eng.qparams,
                                    jnp.asarray(toks[:, i:i + 1]), cache,
                                    jnp.int32(S + i))
            forced.append(np.asarray(logits[:, -1], np.float32))
        done = eng.generate([JRequest(rid=r, tokens=t, max_gen=GEN)
                             for r, t in _requests(sched_toks)],
                            max_slots=2, block_steps=3)
        _flat(f"{name}:params:", params, out)
        for path, entry in eng.qparams.items():
            _flat(f"{name}:qparams:{path}|", entry, out)
        out[f"{name}:calib"] = np.stack(calib)
        out[f"{name}:prompts"] = prompts
        out[f"{name}:sched_toks"] = sched_toks
        out[f"{name}:tokens"] = toks
        out[f"{name}:logits"] = np.stack(forced)
        for c in done:
            out[f"{name}:done:{c.rid}"] = np.asarray(c.tokens, np.int64)
            out[f"{name}:status:{c.rid}"] = np.asarray(c.status)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded") / "reference.npz"
    src = os.path.dirname(os.path.dirname(bridge.__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=src)
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module", params=list(CONFIGS))
def served(request, reference):
    """The port's ShardedEngine(sp=2) on the CPU from the reference's
    weights and thresholds, and what it serves."""
    name = request.param
    arrs = {k[len(name) + 1:]: v for k, v in reference.items()
            if k.startswith(f"{name}:")}
    cfg = torch_config("smollm-135m", smoke=True)
    if CONFIGS[name] is not None:
        cfg = cfg.replace(**CONFIGS[name])
    cfg = cfg.replace(dtype=torch.float32)
    qflat = {}
    for key, a in arrs.items():
        if key.startswith("qparams:"):
            path, leaf = key[len("qparams:"):].split("|")
            qflat.setdefault(path, {})[leaf] = a
    qparams = {path: _unflat(leaves, "") for path, leaves in qflat.items()}
    engine = ShardedEngine.from_checkpoint(
        cfg=cfg, params=bridge.params_from_jax(_unflat(arrs, "params:")),
        qparams=bridge.qparams_from_jax(qparams), device="cpu", sp=SP)
    prompts = arrs["prompts"]
    out = engine.generate_batch({"tokens": prompts}, gen=GEN)
    with torch.inference_mode():
        cache = engine.init_cache(2, engine._cache_len(S, GEN))
        ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
        toks = torch.from_numpy(arrs["tokens"]).long()
        logits, cache = engine.model.prefill(
            engine.serve_params, {"tokens": torch.from_numpy(prompts)},
            cache, ctx)
        forced = [logits[:, -1].float()]
        for i in range(GEN - 1):
            logits, cache = engine.model.decode_step(
                engine.serve_params, toks[:, i:i + 1], cache, S + i, ctx)
            forced.append(logits[:, -1].float())
    done = engine.generate([Request(rid=r, tokens=t, max_gen=GEN)
                            for r, t in _requests(arrs["sched_toks"])],
                           max_slots=2, block_steps=3)
    return dict(ref=arrs, engine=engine, out=out,
                logits=torch.stack(forced).numpy(), done=done)


def test_engine_tokens_and_logits_match(served):
    ref = served["ref"]
    np.testing.assert_array_equal(served["out"].tokens.numpy(),
                                  ref["tokens"])
    assert served["logits"].shape == ref["logits"].shape
    np.testing.assert_allclose(served["logits"], ref["logits"], rtol=0,
                               atol=1e-4)


def test_engine_scheduler_completions_match(served):
    ref = served["ref"]
    got = {c.rid: (c.status, list(c.tokens)) for c in served["done"]}
    want = {r: (str(ref[f"status:{r}"]), ref[f"done:{r}"].tolist())
            for r in range(3)}
    assert got == want


def test_engine_decode_runs_the_partials_per_shard(served):
    """Decode launches no normalized decode attention: one partials call
    per shard and layer (the plain version on the CPU), merged."""
    engine, calls = served["engine"], []
    real = ops.decode_attention_partials

    def counted(*a, **kw):
        calls.append(a[1].shape[1])
        return real(*a, **kw)

    ops.decode_attention_partials = counted
    try:
        with torch.inference_mode():
            cache = engine.init_cache(2, engine._cache_len(S, 2))
            ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
            _, cache = engine.model.prefill(
                engine.serve_params,
                {"tokens": torch.from_numpy(served["ref"]["prompts"])},
                cache, ctx)
            engine.model.decode_step(engine.serve_params,
                                     torch.zeros((2, 1), dtype=torch.long),
                                     cache, S, ctx)
    finally:
        ops.decode_attention_partials = real
    cap = cache["layer0"]["attn"].capacity
    assert calls == [cap // SP] * (SP * engine.cfg.n_layers)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def test_sp_rejects_paged_layout():
    """The reference's own refusal, word for word (it raises before it
    reads any other argument)."""
    from repro.shard.engine import ShardedEngine as JShardedEngine

    with pytest.raises(ValueError) as want:
        JShardedEngine(None, None, None, None, None, sp=2,
                       cache_layout="paged")
    with pytest.raises(ValueError, match="paged") as got:
        ShardedEngine.from_checkpoint("smollm-135m", smoke=True, sp=2,
                                      cache_layout="paged", device="cpu")
    assert str(got.value) == str(want.value)


def test_tp_raises_naming_its_item():
    """tp and sp together: the reference's exclusivity ValueError (its
    ShardContext's: the two share the one 'model' mesh axis), word for
    word, before any weight is built."""
    from repro.shard.context import ShardContext as JShardContext

    with pytest.raises(ValueError) as want:
        JShardContext(tp=2, sp=2)
    with pytest.raises(ValueError) as got:
        ShardedEngine.from_checkpoint("smollm-135m", smoke=True,
                                      device="cpu", tp=2, sp=2)
    assert str(got.value) == str(want.value)
    assert "mesh axis" in str(got.value)


@pytest.mark.parametrize("kw", [dict(sp=0), dict(tp=0)], ids=["sp0", "tp0"])
def test_shard_counts_must_be_positive(kw):
    with pytest.raises(ValueError, match=">= 1"):
        ShardedEngine.from_checkpoint("smollm-135m", smoke=True,
                                      device="cpu", **kw)


def test_sp_cache_checks():
    engine = ShardedEngine.from_checkpoint("smollm-135m", smoke=True, sp=3,
                                           device="cpu")
    assert engine.sp == 3 and engine.model.sp == 3
    # an indivisible length is rounded up to a shard multiple
    cache = engine.init_cache(2, 128)
    assert cache["layer0"]["attn"].capacity == 129
    assert engine._cache_len(S, GEN) == 128
    with pytest.raises(ValueError, match="not divisible by sp=3"):
        engine.model.decode_step(
            engine.serve_params, torch.zeros((2, 1), dtype=torch.long),
            engine.base_model.init_cache(2, 128, torch.device("cpu")), 0,
            TA.make_ctx("int8", engine.policy, engine.qparams))
    # the speculative verify window checks its cache as decode does, and
    # serves over one of a shard multiple
    ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
    window = torch.zeros((2, 5), dtype=torch.long)
    pos = torch.tensor([3, 7], dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible by sp=3"):
        engine.model.verify_step(
            engine.serve_params, window,
            engine.base_model.init_cache(2, 128, torch.device("cpu")), pos,
            ctx)
    logits, _ = engine.model.verify_step(engine.serve_params, window, cache,
                                         pos, ctx)
    assert logits.shape[:2] == (2, 5)
    assert bool(torch.isfinite(logits).all())
    # the collective audit (ROADMAP item 19): sequence parallelism gathers
    # the decode partials and reduces nothing
    rep = engine.dry_run_report()
    assert rep["sp"] == 3 and rep["int8_all_reduces_ok"]
    assert rep["executables"]["decode"]["all_reduce_payloads"] == []
    assert set(rep["executables"]["decode"]["collective_by_kind"]) == \
        {"all-gather"}


def test_shard_counts_agree():
    """Two shards of 64 positions and three of 43 (the 128-rounded cache
    + 1) split the same float32 model's cache at other boundaries: the
    same greedy tokens, prefill logits to 1e-4."""
    cfg = torch_config("smollm-135m", smoke=True).replace(
        dtype=torch.float32)
    two, three = (ShardedEngine.from_checkpoint(cfg=cfg, sp=n, device="cpu")
                  for n in (2, 3))
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (2, 40),
                                                dtype=np.int32)
    a = two.generate_batch({"tokens": prompts}, gen=GEN)
    b = three.generate_batch({"tokens": prompts}, gen=GEN)
    np.testing.assert_array_equal(b.tokens.numpy(), a.tokens.numpy())
    np.testing.assert_allclose(b.prefill_logits.numpy(),
                               a.prefill_logits.numpy(), rtol=0, atol=1e-4)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
