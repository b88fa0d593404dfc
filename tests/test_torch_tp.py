"""Tensor-parallel serving of the port against the reference's
``ShardedEngine(tp=2, use_pallas=True)``.

The reference serves tp Megatron-style over a device mesh: the model at a
local config (heads, KV heads and d_ff over tp), weights sliced by role,
and each row-parallel layer's int32 accumulators summed through
``compressed_psum`` before one dequant.  The port serves the global model
on one device and sums its shards' int32 partials in the row-parallel
layers only (``core/api.py``).  The reference needs two JAX devices: ONE
subprocess builds it with ``XLA_FLAGS=--xla_force_host_platform_device_
count=2`` on the reference suite's head grid (smollm-135m ``SMOKE`` at 4
heads over 2 KV heads, ``tests/test_sharded.py``), in float32, with
thresholds calibrated on shared numpy batches, and writes what it served
to an ``.npz`` that a module fixture shares; the reduce and the role rules
are held in this process, the reduce per shard under
``jax.jit(jax.vmap(..., axis_name=))``.

Tolerances: integer tensors (the reduces' int32 sums, the int32 partials,
the slices) bit-identical; greedy tokens and every scheduler's completions
identical; teacher-forced logits within ``LOGIT_ATOL`` = 1e-4
(``test_torch_engine.py``'s float32 tolerance with shared thresholds;
measured 1.2e-7, largest |logit| 0.54); the float reduce bit-identical to
the reference's jitted form.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as JC
from repro.dist import sharding as JS
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as TA
from repro_torch.dist import collectives as TC
from repro_torch.dist import sharding as TS
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch.faults import FaultPlan, SimulatedCrash
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.scheduler import Request, SlotScheduler
from repro_torch.models import build_model
from repro_torch.shard import ShardedEngine
from test_torch_sharded import _flat, _unflat
from test_torch_sharded_modes import _qparams

S, GEN, TP = 16, 8, 2
GRID = dict(n_heads=4, n_kv_heads=2)
LOGIT_ATOL = 1e-4
SCHED = dict(max_slots=2, prompt_cap=S, gen_cap=GEN, prefill_chunk=8,
             block_steps=3)


def _requests(toks):
    """The reference suite's three ragged requests: prompts of 16, 11 and
    9 tokens, 8 generated each."""
    return [(r, toks[r % toks.shape[0], :n]) for r, n in
            enumerate([S, S - 5, 9])]


def _reference_main(out_path):
    """The subprocess: the reference's ShardedEngine(tp=2, use_pallas=True)
    on the grid in float32: its weights, serve params and thresholds, its
    greedy tokens and teacher-forced logits, the int32 sums its reduces
    return at the prefill and the first decode step, and the completions of
    its scheduler, a preempted run, the speculative strategy and a journal
    recovery; and the refusals' messages."""
    import functools

    from repro.configs import get_config
    from repro.launch import steps as JST
    from repro.launch.faults import FaultPlan as JFaultPlan
    from repro.launch.faults import SimulatedCrash as JCrash
    from repro.launch.scheduler import Request as JRequest
    from repro.launch.scheduler import SlotScheduler as JSlotScheduler
    from repro.models import build_model
    from repro.shard.engine import ShardedEngine as JShardedEngine

    assert jax.device_count() >= TP, jax.devices()
    sums, record = {}, {"on": False, "n": 0}
    plain_psum = JC.compressed_psum

    def keep(i, value, shard):
        sums.setdefault(i, {})[int(shard)] = np.asarray(value)

    def recording_psum(x, axis_name, *, mean=True):
        out = plain_psum(x, axis_name, mean=mean)
        if record["on"]:
            jax.debug.callback(functools.partial(keep, record["n"]), out,
                               jax.lax.axis_index(axis_name))
            record["n"] += 1
        return out

    JC.compressed_psum = recording_psum
    cfg = get_config("smollm-135m", smoke=True).replace(dtype=jnp.float32,
                                                         **GRID)
    rng = np.random.default_rng(31)
    calib = [rng.integers(0, cfg.vocab, (4, 32), dtype=np.int32)
             for _ in range(2)]
    prompts = rng.integers(0, cfg.vocab, (2, S), dtype=np.int32)
    sched_toks = rng.integers(0, cfg.vocab, (3, S), dtype=np.int32)
    eng = JShardedEngine.from_checkpoint(
        cfg=cfg, tp=TP, cache_layout="dense", use_pallas=True,
        calib_batches=[{"tokens": jnp.asarray(c)} for c in calib])
    out = dict(prompts=prompts, sched_toks=sched_toks)
    _flat("params:", build_model(cfg).init(jax.random.PRNGKey(0)), out)
    _flat("serve:", eng.serve_params, out)
    for path, entry in eng.qparams.items():
        _flat(f"qparams:{path}|", entry, out)
    toks = np.asarray(eng.generate_batch({"tokens": jnp.asarray(prompts)},
                                         GEN).tokens)
    out["tokens"] = toks
    prefill = jax.jit(JST.make_prefill_step(eng.model, cfg, eng.policy,
                                            "int8"))
    step = jax.jit(JST.make_serve_step(eng.model, cfg, eng.policy, "int8"))
    cache = eng.init_cache(2, eng._cache_len(S, GEN))
    record["on"] = True
    logits, cache = prefill(eng.serve_params, eng.qparams,
                            {"tokens": jnp.asarray(prompts)}, cache)
    forced = [np.asarray(logits[:, -1], np.float32)]
    _, logits, cache = step(eng.serve_params, eng.qparams,
                            jnp.asarray(toks[:, :1]), cache, jnp.int32(S))
    jax.block_until_ready(logits)
    jax.effects_barrier()
    record["on"] = False
    step = jax.jit(JST.make_serve_step(eng.model, cfg, eng.policy, "int8"))
    forced.append(np.asarray(logits[:, -1], np.float32))
    for i in range(1, GEN - 1):
        _, logits, cache = step(eng.serve_params, eng.qparams,
                                jnp.asarray(toks[:, i:i + 1]), cache,
                                jnp.int32(S + i))
        forced.append(np.asarray(logits[:, -1], np.float32))
    out["logits"] = np.stack(forced)
    for i, by_shard in sums.items():
        assert all(np.array_equal(v, by_shard[0])
                   for v in by_shard.values())
        out[f"sum:{i}"] = by_shard[0]

    def requests():
        return [JRequest(rid=r, tokens=t, max_gen=GEN)
                for r, t in _requests(sched_toks)]

    def keep_done(name, done):
        for c in done:
            out[f"{name}:{c.rid}"] = np.asarray(c.tokens, np.int64)
            out[f"{name}:status:{c.rid}"] = np.asarray(c.status)

    keep_done("sched", eng.generate(requests(), max_slots=2, block_steps=3))
    sched = eng.make_scheduler(max_slots=2, prompt_cap=S, gen_cap=GEN,
                               block_steps=3)
    for name, counts in (("exec", sched.executable_counts()),
                         ("calls", sched.call_counts())):
        out[f"{name}_names"] = np.asarray(sorted(counts))
        out[f"{name}_counts"] = np.asarray([counts[k] for k in sorted(counts)])

    def scheduler(**kw):
        return JSlotScheduler(eng.model, cfg, eng.policy, eng.serve_params,
                              eng.qparams, mode=eng.mode, **SCHED, **kw)

    keep_done("preempt", scheduler(
        fault_plan=JFaultPlan(preempt=((1, 0),))).run(requests()))
    keep_done("spec", scheduler(strategy="speculative",
                                spec_k=3).run(requests()))
    journal = os.path.join(os.path.dirname(out_path), "tp.jsonl")
    try:
        scheduler(journal=journal,
                  fault_plan=JFaultPlan(crash=(2,))).run(requests())
    except JCrash:
        keep_done("recovered", scheduler(journal=journal).recover())
    refusals = {"fp": dict(fp=True), "sp": dict(sp=2),
                "heads": dict(cfg=get_config("smollm-135m", smoke=True))}
    for name, kw in refusals.items():
        kw = dict(dict(cfg=cfg, tp=TP, smoke=True, cache_layout="dense",
                       use_pallas=True, calib_batches=[
                           {"tokens": jnp.asarray(calib[0])}]), **kw)
        try:
            JShardedEngine.from_checkpoint(**kw)
            out[f"refusal:{name}"] = np.asarray("served")
        except ValueError as err:
            out[f"refusal:{name}"] = np.asarray(str(err))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp") / "reference.npz"
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
        dtype=torch.float32, **GRID)


@pytest.fixture(scope="module")
def engine(reference):
    """The port's ShardedEngine(tp=2) on the CPU from the reference's
    weights and thresholds."""
    ref = reference
    return ShardedEngine.from_checkpoint(
        cfg=_cfg(), params=bridge.params_from_jax(_unflat(ref, "params:")),
        qparams=bridge.qparams_from_jax(_qparams(ref, "qparams:")),
        device="cpu", tp=TP, cache_layout="dense")


def _forced(engine, prompts, toks, sums=None):
    """Teacher-forced float32 logits (prefill, then GEN - 1 decode steps
    fed the reference's tokens); ``sums`` collects the int32 sums of the
    reduces of the prefill and the first decode step."""
    real = TC.compressed_psum

    def recording(x, *, mean=True):
        y = real(x, mean=mean)
        sums.append(y.clone())
        return y

    with torch.inference_mode():
        cache = engine.init_cache(2, engine._cache_len(S, GEN))
        ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
        out = []
        for i in range(GEN):
            TC.compressed_psum = recording if (sums is not None
                                               and i < 2) else real
            try:
                if i == 0:
                    logits, cache = engine.model.prefill(
                        engine.serve_params,
                        {"tokens": torch.from_numpy(prompts)}, cache, ctx)
                else:
                    logits, cache = engine.model.decode_step(
                        engine.serve_params, toks[:, i - 1:i], cache,
                        S + i - 1, ctx)
            finally:
                TC.compressed_psum = real
            out.append(logits[:, -1].float())
    return torch.stack(out).numpy()


def _by_rid(done):
    return {c.rid: (c.status, [int(t) for t in c.tokens]) for c in done}


def _want(ref, name):
    return {r: (str(ref[f"{name}:status:{r}"]), ref[f"{name}:{r}"].tolist())
            for r in range(3)}


def _port_requests(ref):
    return [Request(rid=r, tokens=t, max_gen=GEN)
            for r, t in _requests(ref["sched_toks"])]


# ---------------------------------------------------------------------------
# the reduce and the role rules, against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_compressed_psum_matches_the_reference(tp):
    """Both regimes, each shard's reference reduce under ``jax.jit(jax.
    vmap(..., axis_name=))`` against the port's over the stacked shards:
    the int32 sum exactly, the int8-compressed float mean and sum bit for
    bit (a NaN squashed to 0 first), a mean of integers refused with the
    reference's message; each reduce counts the int32 payload of the
    tp - 1 other shards."""
    rng = np.random.default_rng(tp)
    xi = rng.integers(-2**24, 2**24, (tp, 5, 7)).astype(np.int32)
    j = jax.jit(jax.vmap(lambda v: JC.compressed_psum(v, "m", mean=False),
                         axis_name="m"))(jnp.asarray(xi))
    ops.reset_launches()
    got = TC.compressed_psum(torch.from_numpy(xi), mean=False)
    assert got.dtype == torch.int32
    for i in range(tp):
        np.testing.assert_array_equal(got.numpy(), np.asarray(j[i]))
    assert ops.reduce_counts() == {"reduces": 1,
                                   "wire_bytes": (tp - 1) * 5 * 7 * 4}
    with pytest.raises(ValueError) as want:
        jax.vmap(lambda v: JC.compressed_psum(v, "m"), axis_name="m")(
            jnp.asarray(xi))
    with pytest.raises(ValueError) as err:
        TC.compressed_psum(torch.from_numpy(xi))
    assert str(err.value) == str(want.value)
    xf = (rng.standard_normal((tp, 6, 33)) * 3).astype(np.float32)
    xf[0, 1, 2] = np.nan
    for dtype in ("float32", "bfloat16"):
        for mean in (True, False):
            j = jax.jit(jax.vmap(
                lambda v: JC.compressed_psum(v, "m", mean=mean),
                axis_name="m"))(jnp.asarray(xf).astype(getattr(jnp, dtype)))
            got = TC.compressed_psum(
                torch.from_numpy(xf).to(getattr(torch, dtype)), mean=mean)
            for i in range(tp):
                np.testing.assert_array_equal(
                    got.float().numpy(), np.asarray(j[i], np.float32))


def _spec_axis(spec, ndim):
    """The (negative) axis a PartitionSpec splits, or None."""
    axes = [i for i, a in enumerate(tuple(spec)) if a is not None]
    return axes[0] - ndim if axes else None


def test_tp_slice_rules_match_the_references(reference):
    """Params (the reference engine's int8 serve tree), thresholds and the
    KV cache of every layout: each shard's slice is the leaf cut where the
    reference's ``tp_*_specs`` cut it; an indivisible width raises the
    reference's error, word for word."""
    serve = _unflat(reference, "serve:")
    specs = JS.tp_param_specs(jax.tree.map(jnp.asarray, serve), tp=TP)
    shards = TS.tp_param_slices(serve, tp=TP)
    flat_specs = {"/".join(map(str, JS._path_keys(p))): s for p, s in
                  jax.tree_util.tree_flatten_with_path(
                      specs, is_leaf=lambda s: isinstance(
                          s, jax.sharding.PartitionSpec))[0]}
    split = 0
    for keys, leaf in TA.flatten(serve).items():
        axis = _spec_axis(flat_specs["/".join(keys)], leaf.ndim)
        split += axis is not None
        for i in range(TP):
            want = leaf if axis is None else np.split(leaf, TP, axis)[i]
            got = shards[i]
            for k in keys:
                got = got[k]
            np.testing.assert_array_equal(got, want)
    # wq wk wv gate up (w_q, w_scale) and wo down (w_q) of both layers
    assert split == 2 * (5 * 2 + 2)
    qparams = _qparams(reference, "qparams:")
    qspecs = JS.tp_qparam_specs(jax.tree.map(jnp.asarray, qparams), tp=TP,
                                n_kv=GRID["n_kv_heads"])
    qshards = TS.tp_qparam_slices(qparams, tp=TP, n_kv=GRID["n_kv_heads"])
    for path, entry in qparams.items():
        for keys, leaf in TA.flatten(entry).items():
            spec = qspecs[path]
            for k in keys:
                spec = spec[k]
            axis = _spec_axis(spec, np.ndim(leaf))
            assert (axis is not None) == path.endswith("/kv")
            for i in range(TP):
                got = qshards[i][path]
                for k in keys:
                    got = got[k]
                want = leaf if axis is None else np.split(leaf, TP, axis)[i]
                np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError) as want:
        JS.tp_param_specs(jax.tree.map(jnp.asarray, serve), tp=3)
    with pytest.raises(ValueError) as got:
        TS.tp_param_slices(serve, tp=3)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("layout", ["dense", "ring", "paged"])
def test_tp_cache_slices_match_the_references(layout):
    """Every cache layout the reference's tp accepts: the k/v leaves and
    their scales cut on the KV-head axis where ``tp_cache_specs`` cuts
    them, block tables whole; a foreign cache whose KV heads do not divide
    raises the reference's error in the sharded model's entry points."""
    from repro.models import build_model as jbuild
    from repro.configs import get_config as jconfig

    jcfg = jconfig("smollm-135m", smoke=True).replace(**GRID, window=8)
    jcache = jbuild(jcfg).init_cache(2, 32, kv_int8=True, layout=layout,
                                     page_size=8)
    engine = ShardedEngine.from_checkpoint(
        cfg=_cfg().replace(window=8), device="cpu", tp=TP,
        cache_layout=layout, page_size=8)
    cache = engine.init_cache(2, 32)
    specs = JS.tp_cache_specs(jcache, tp=TP)
    shards = TS.tp_cache_slices(cache, tp=TP)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    seen = 0
    for path, spec in flat:
        keys = JS._path_keys(path)
        node = cache
        for k in keys[:-1]:
            node = node[k]
        leaf = getattr(node, keys[-1])
        axis = _spec_axis(spec, leaf.ndim)
        for i in range(TP):
            got = shards[i]
            for k in keys[:-1]:
                got = got[k]
            want = leaf if axis is None else torch.chunk(leaf, TP, axis)[i]
            assert torch.equal(getattr(got, keys[-1]), want)
        seen += axis is not None
    assert seen == 2 * 4   # k, v, k_scale, v_scale of both layers
    with pytest.raises(ValueError) as want:
        JS.tp_cache_specs(jcache, tp=3)
    with pytest.raises(ValueError) as got:
        TS.tp_cache_slices(cache, tp=3)
    assert str(got.value) == str(want.value)
    model = ShardedEngine(engine.base_model, engine.cfg, engine.policy,
                          engine.serve_params, engine.qparams, device="cpu",
                          tp=TP, cache_layout=layout, page_size=8).model
    foreign = build_model(engine.cfg.replace(n_kv_heads=1)).init_cache(
        2, 32, torch.device("cpu"), layout=layout, page_size=8)
    with pytest.raises(ValueError, match="KV-head axis 1 not divisible"):
        model.decode_step(engine.serve_params,
                          torch.zeros((2, 1), dtype=torch.long), foreign, 0)


@pytest.mark.parametrize("m,k,n,k0,k1", [(1, 64, 12, 0, 64),
                                         (4, 192, 36, 64, 128),
                                         (20, 96, 20, 48, 96),
                                         (128, 256, 8, 0, 0)])
def test_int32_partial_plain_version_is_numpys(m, k, n, k0, k1):
    """B3's int32-accumulator branch's plain version: the int32 sums of
    x_q[:, k0:k1] @ w_q[k0:k1], as numpy's int32 product; every shard's
    partial of a row split sums exactly to the full product."""
    rng = np.random.default_rng(m + k)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    tx, tw = torch.from_numpy(xq), torch.from_numpy(wq)
    got = ops.quant_matmul_acc(tx, tw, k0, k1)
    assert got.dtype == torch.int32
    want = xq[:, k0:k1].astype(np.int32) @ wq[k0:k1].astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.empty((m, n), dtype=torch.int32)
    assert ops.quant_matmul_acc(tx, tw, k0, k1, out=out) is out
    parts = [tref.quant_matmul_acc_ref(tx, tw, a, b)
             for a, b in TS.tp_row_slices("down", k, 4)]
    np.testing.assert_array_equal(sum(parts).numpy(),
                                  xq.astype(np.int32) @ wq.astype(np.int32))
    with pytest.raises(ValueError, match="contraction range"):
        ops.quant_matmul_acc(tx, tw, k0, k + 1)


# ---------------------------------------------------------------------------
# the engine against the reference ShardedEngine(tp=2)
# ---------------------------------------------------------------------------


def test_tokens_logits_and_int32_sums_match(engine, reference):
    """generate_batch's greedy tokens; the teacher-forced logits; every
    row-parallel reduce of the prefill and the first decode step (2 layers
    x wo and down each) returns the reference's int32 sums bit for bit;
    each sums 2 shards' partials, launched once per shard and layer."""
    ref = reference
    out = engine.generate_batch({"tokens": ref["prompts"]}, gen=GEN)
    np.testing.assert_array_equal(out.tokens.numpy(), ref["tokens"])
    sums = []
    ops.reset_launches()
    logits = _forced(engine, ref["prompts"],
                     torch.from_numpy(ref["tokens"]).long(), sums)
    np.testing.assert_allclose(logits, ref["logits"], rtol=0,
                               atol=LOGIT_ATOL)
    want = [ref[f"sum:{i}"] for i in range(len(sums))]
    assert len(sums) == 2 * 2 * engine.cfg.n_layers == len(
        [k for k in ref if k.startswith("sum:")])
    for got, w in zip(sums, want):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.reshape(w.shape).numpy(), w)
    assert ops.reduce_counts()["reduces"] == 2 * engine.cfg.n_layers * GEN


def test_scheduler_completions_and_programs_match(engine, reference):
    """Ragged admission through 2 slots (chunked prefill, slot decode
    blocks of 3): the reference's completions and call counts, and its
    programs, each built at most once and within 1 of the reference's
    ``executable_counts`` (whose ``insert`` splice the port runs eagerly,
    not as a program: it builds its jitted splice twice here)."""
    done = engine.generate(_port_requests(reference), max_slots=2,
                           block_steps=3)
    assert _by_rid(done) == _want(reference, "sched")
    sched = engine.make_scheduler(max_slots=2, prompt_cap=S, gen_cap=GEN,
                                  block_steps=3)
    ref = reference
    calls = dict(zip(ref["calls_names"].tolist(),
                     ref["calls_counts"].tolist()))
    assert sched.call_counts() == calls
    counts = sched.executable_counts()
    want = dict(zip(ref["exec_names"].tolist(), ref["exec_counts"].tolist()))
    assert set(counts) == set(want) - {"insert"}
    assert all(counts[k] <= 1 and abs(counts[k] - want[k]) <= 1
               for k in counts), (counts, want)


@pytest.mark.parametrize("case", ["preempt", "spec", "recovered"])
def test_scheduler_paths_match(engine, reference, case, tmp_path):
    """The reference suite's other paths under tp: a forced preemption
    re-admitted through the resume prefill; the speculative strategy
    (prompt lookup, spec_k 3); a crash at boundary 2 replayed from the
    journal on a fresh scheduler.  Each the reference's completions."""
    def scheduler(**kw):
        return SlotScheduler(engine.model, engine.cfg, engine.policy,
                             engine.serve_params, engine.qparams,
                             mode=engine.mode, device="cpu", **SCHED, **kw)

    reqs = _port_requests(reference)
    if case == "preempt":
        done = scheduler(fault_plan=FaultPlan(preempt=((1, 0),))).run(reqs)
    elif case == "spec":
        done = scheduler(strategy="speculative", spec_k=3).run(reqs)
    else:
        journal = str(tmp_path / "tp.jsonl")
        with pytest.raises(SimulatedCrash):
            scheduler(journal=journal,
                      fault_plan=FaultPlan(crash=(2,))).run(reqs)
        done = scheduler(journal=journal).recover()
    assert _by_rid(done) == _want(reference, case)


def test_state_dict_roundtrip_mid_generation(engine, reference):
    """Snapshot the cache after a tp prefill, rebuild it from its
    ``state_dict``, decode on both: the same logits bit for bit, and the
    reference's first decode logits."""
    from repro_torch.cache.base import QuantizedKV

    ref = reference
    with torch.inference_mode():
        cache = engine.init_cache(2, engine._cache_len(S, GEN))
        ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
        _, cache = engine.model.prefill(
            engine.serve_params, {"tokens": torch.from_numpy(ref["prompts"])},
            cache, ctx)
        restored = {name: {k: QuantizedKV.from_state_dict(c.state_dict())
                           for k, c in layer.items()}
                    for name, layer in cache.items()}
        tok = torch.from_numpy(ref["tokens"][:, :1]).long()
        want, _ = engine.model.decode_step(engine.serve_params, tok, cache, S,
                                           ctx)
        got, _ = engine.model.decode_step(engine.serve_params, tok, restored,
                                          S, ctx)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got[:, -1].float().numpy(), ref["logits"][1],
                               rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", ["fp", "sp", "heads"])
def test_refusals_are_the_references(reference, name):
    """fp mode (no integer accumulators), tp together with sp (one mesh
    axis), and smollm-135m's own 3 heads at tp = 2: the reference's
    ValueError, word for word, raised before any weight is built."""
    kw = {"fp": dict(fp=True), "sp": dict(sp=2),
          "heads": dict(cfg=torch_config("smollm-135m", smoke=True))}[name]
    kw = dict(dict(cfg=_cfg(), tp=TP, device="cpu", cache_layout="dense"),
              **kw)
    with pytest.raises(ValueError) as got:
        ShardedEngine.from_checkpoint(**kw)
    assert str(got.value) == str(reference[f"refusal:{name}"])


def test_bf16_tp_equals_the_unsharded_engine():
    """At bf16 (the configs' own dtype) the port's row epilogue rounds as
    its unsharded fused path does: tp=2 serves the unsharded engine's
    prefill logits and tokens bit for bit, in every cache layout.  The
    reference's bf16 tp parts from both: its XLA fusions keep some bf16
    roundings out (ROADMAP Queue C; measured at this grid: its first
    ``down`` reduce's int32 sums differ from the port's in 1433 of 1536
    entries, its first ``wo`` reduce's are equal)."""
    cfg = _cfg().replace(dtype=torch.bfloat16)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (3, S),
                                                dtype=np.int32)
    base = ShardedEngine.from_checkpoint(cfg=cfg, device="cpu",
                                         cache_layout="dense")
    want = base.generate_batch({"tokens": prompts}, gen=GEN)
    for layout in ("dense", "ring", "paged"):
        tp = ShardedEngine(base.base_model, cfg, base.policy,
                           base.serve_params, base.qparams, device="cpu",
                           tp=TP, cache_layout=layout)
        got = tp.generate_batch({"tokens": prompts}, gen=GEN)
        assert torch.equal(got.prefill_logits, want.prefill_logits)
        assert torch.equal(got.tokens, want.tokens)


def test_tp_engine_is_captured_and_counts_its_shards(engine):
    """tp reads nothing on the host: the engine captures its programs (on
    the CPU it runs them eagerly by route); its mesh is 2 shard slots on
    its device, and a mesh of fewer than one shard raises as the
    reference's does (IndexError)."""
    assert engine.eager_reason() is None
    assert engine.mesh.shape == {"model": TP} and engine.tp == TP
    assert engine.model.tp == TP and engine.model.sp == 1
    with pytest.raises(IndexError):
        make_serving_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="has size 3, expected 2"):
        ShardedEngine(engine.base_model, engine.cfg, engine.policy,
                      engine.serve_params, engine.qparams, device="cpu",
                      tp=TP, mesh=make_serving_mesh(3, device="cpu"))


if __name__ == "__main__":
    _reference_main(sys.argv[1])
