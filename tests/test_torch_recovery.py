"""The port's durability layer against the reference's: cache and
prefix-store snapshots, write-ahead journal recovery after a crash at any
block boundary, snapshot recovery, and journals that cross packages.

The reference is ``repro.launch.scheduler.SlotScheduler`` over a JAX
``Engine`` built with ``use_pallas=True`` (interpret mode), the port serving
the same weights with the reference's calibrated thresholds, bridged (as in
``tests/test_torch_scheduler.py``); float32 smoke config.  On the CPU the
port's plain kernel versions give the reference's bits, so recovered
completions must equal the uninterrupted run's, and the reference's,
exactly: no tolerance.  The cases follow ``tests/test_recovery.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JaxEngine
from repro.launch.faults import FaultPlan as JFaultPlan
from repro.launch.faults import SimulatedCrash as JSimulatedCrash
from repro.launch.scheduler import Request as JRequest
from repro.launch.scheduler import SlotScheduler as JSlotScheduler
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.cache import (DenseCache, PagedCache, PrefixEntry,
                               PrefixStore, layer_caches)
from repro_torch.cache.base import QuantizedKV
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config as torch_config
from repro_torch.launch.engine import Engine
from repro_torch.launch.faults import FaultPlan, SimulatedCrash
from repro_torch.launch.scheduler import Request, SlotScheduler

S, GEN, CHUNK, PAGE = 32, 6, 8, 8
BASE = dict(max_slots=2, prompt_cap=S, gen_cap=GEN + 2, prefill_chunk=CHUNK,
            block_steps=3)
SAMPLED = dict(temperature=0.8, top_p=0.9, seed=7)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_config("smollm-135m", smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config("smollm-135m", smoke=True).replace(
        dtype=torch.float32)
    rng = np.random.default_rng(31)
    calib = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (4, 32),
                                                 dtype=np.int32))}
             for _ in range(2)]
    ref = JaxEngine.from_checkpoint(cfg=jcfg, use_pallas=True,
                                    calib_batches=calib, prefill_chunk=CHUNK)
    params = bridge.params_from_jax(_np(jax_build(jcfg).init(
        jax.random.PRNGKey(0))))
    ours = Engine.from_checkpoint(
        cfg=tcfg, params=params, device="cpu", prefill_chunk=CHUNK,
        qparams=bridge.qparams_from_jax(_np(ref.qparams)))
    toks = rng.integers(0, jcfg.vocab, (2, S), dtype=np.int32)
    return dict(ref=ref, ours=ours, toks=toks)


def _ours(engines, **kw):
    e = engines["ours"]
    return SlotScheduler(e.model, e.cfg, e.policy, e.serve_params,
                         e.qparams, mode=e.mode, **{**BASE, **kw})


def _ref(engines, **kw):
    e = engines["ref"]
    if "fault_plan" in kw:
        kw["fault_plan"] = JFaultPlan(**vars(kw["fault_plan"]))
    return JSlotScheduler(e.model, e.cfg, e.policy, e.serve_params,
                          e.qparams, mode=e.mode, **{**BASE, **kw})


def _requests(toks, cls=Request, n=3):
    lens = [12, 20, 8, 16]
    return [cls(rid=r, tokens=toks[r % 2, :lens[r % 4]], max_gen=GEN)
            for r in range(n)]


def _by_rid(completions):
    return {c.rid: (tuple(int(t) for t in c.tokens), c.status,
                    c.finished_by) for c in completions}


@pytest.fixture(scope="module")
def clean(engines):
    """The uninterrupted runs, greedy and sampled: the port's equal the
    reference's."""
    out = {}
    for name, kw in (("greedy", {}), ("sampled", SAMPLED)):
        got = _by_rid(_ours(engines, **kw).run(_requests(engines["toks"])))
        want = _by_rid(_ref(engines, **kw).run(
            _requests(engines["toks"], JRequest)))
        assert got == want
        out[name] = got
    return out


# -- cache / prefix-store snapshots -------------------------------------------
def _filled(layout="dense", bits=8, quantized=True):
    g = torch.Generator().manual_seed(0)
    if layout == "dense":
        c = DenseCache.init(1, 16, 2, 4, bits=bits, quantized=quantized,
                            dtype=torch.bfloat16)
    else:
        c = PagedCache.init(2, 32, 2, 4, page_size=8, extra_pages=2,
                            bits=bits, quantized=quantized,
                            dtype=torch.bfloat16)
        c.table.copy_(torch.randperm(c.n_pages, generator=g)[
            :c.table.numel()].reshape(c.table.shape).to(torch.int32))
    if quantized:
        c.k.copy_(torch.randint(-127, 128, c.k.shape, generator=g))
        c.v.copy_(torch.randint(-127, 128, c.v.shape, generator=g))
        c.k_scale.copy_(torch.rand(c.k_scale.shape, generator=g))
    else:
        c.k.copy_(torch.randn(c.k.shape, generator=g))
        c.v.copy_(torch.randn(c.v.shape, generator=g))
    return c


def _same(a, b):
    names = type(a)._child_names()
    assert names == type(b)._child_names()
    for n in names:
        assert torch.equal(getattr(a, n), getattr(b, n)), n


class TestCacheStateDict:
    def test_dense_roundtrip_bit_exact(self):
        c = _filled()
        sd = c.state_dict()
        assert sd["layout"] == "dense"
        assert sd["static"] == {"_quantized": True, "bits": 8}
        assert sorted(sd["arrays"]) == ["k", "k_scale", "v", "v_scale"]
        c2 = QuantizedKV.from_state_dict(sd)
        assert type(c2) is DenseCache
        _same(c, c2)
        # the state dict holds copies, not the live tensors
        c.k.zero_()
        assert not torch.equal(sd["arrays"]["k"], c.k)

    def test_paged_roundtrip_keeps_statics(self):
        c = _filled("paged", bits=4)
        sd = c.state_dict()
        assert sd["static"] == {"_quantized": True, "page_size": 8,
                                "bits": 4}
        assert "table" in sd["arrays"]
        c2 = QuantizedKV.from_state_dict(sd)
        assert type(c2) is PagedCache
        assert (c2.page_size, c2.bits, c2.quantized) == (8, 4, True)
        _same(c, c2)

    def test_from_state_dict_validates(self):
        sd = _filled().state_dict()
        with pytest.raises(ValueError, match="unknown cache layout"):
            QuantizedKV.from_state_dict({**sd, "layout": "holographic"})
        broken = {**sd, "arrays": {k: v for k, v in sd["arrays"].items()
                                   if k != "k"}}
        with pytest.raises(ValueError, match="arrays"):
            QuantizedKV.from_state_dict(broken)
        with pytest.raises(ValueError, match="quantized"):
            QuantizedKV.from_state_dict(
                {**sd, "static": {"_quantized": False, "bits": 8}})
        # a snapshot from before int4 carries no bits: int8
        old = {**sd, "static": {"_quantized": True}}
        assert QuantizedKV.from_state_dict(old).bits == 8

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    @pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
    def test_roundtrip_through_checkpoint_manager(self, tmp_path, layout,
                                                  kind):
        """The npz trip boxes the scalars and the layout name; the restore
        unboxes them, bf16 tiles included, bit for bit."""
        c = _filled(layout, bits=4 if kind == "int4" else 8,
                    quantized=kind != "bf16")
        mgr = CheckpointManager(str(tmp_path), keep=2)
        mgr.save(1, {"c": c.state_dict()}, metadata={})
        tree, _ = mgr.restore_latest()
        c2 = QuantizedKV.from_state_dict(tree["c"])
        assert type(c2) is type(c) and c2.bits == c.bits
        assert c2.quantized == (kind != "bf16")
        _same(c, c2)

    def test_reference_state_dict_loads(self):
        """A reference cache's state dict (numpy arrays under the same
        layout, static and array names) restores into the port."""
        from repro.cache import DenseCache as JDenseCache

        c = JDenseCache.init(1, 16, 2, 4, quantized=True)
        rng = np.random.default_rng(0)
        kq = jnp.asarray(rng.integers(-127, 128, (1, 3, 2, 4)), jnp.int8)
        c = c.append(kq, kq, 0)
        sd = c.state_dict()
        ours = QuantizedKV.from_state_dict(sd)
        assert sorted(sd["arrays"]) == sorted(ours.state_dict()["arrays"])
        assert set(sd["static"]) == set(ours.state_dict()["static"])
        np.testing.assert_array_equal(ours.k.numpy(), np.asarray(c.k))

    def test_load_in_place_keeps_storage(self):
        """``load_state_dict_`` writes into the cache's own tensors (a
        captured program keeps reading them); a mismatch raises before
        anything is written."""
        src, dst = _filled("paged"), PagedCache.init(2, 32, 2, 4,
                                                     page_size=8,
                                                     extra_pages=2)
        ptrs = {n: getattr(dst, n).data_ptr() for n in dst._child_names()}
        assert dst.load_state_dict_(src.state_dict()) is dst
        _same(src, dst)
        assert {n: getattr(dst, n).data_ptr()
                for n in dst._child_names()} == ptrs
        wide = PagedCache.init(2, 48, 2, 4, page_size=8, extra_pages=2)
        before = dst.k.clone()
        with pytest.raises(ValueError, match="array 'k'"):
            dst.load_state_dict_(wide.state_dict())
        with pytest.raises(ValueError, match="static"):
            dst.load_state_dict_(PagedCache.init(
                2, 32, 2, 4, page_size=16).state_dict())
        with pytest.raises(ValueError, match="dense cache"):
            dst.load_state_dict_(_filled().state_dict())
        assert torch.equal(dst.k, before)

    def test_prefix_store_roundtrip(self, tmp_path):
        ps = PrefixStore(0, 4, 8)
        logits = torch.arange(7, dtype=torch.float32)[None, None]
        ps.register((1, 2, 3), PrefixEntry(pages=(0,), tail_page=1,
                                           length=10, logits=logits))
        ps.register((4, 5), PrefixEntry(pages=(), tail_page=2, length=2,
                                        logits=logits + 1))
        ps.lookup((1, 2, 3), slot=0)     # a hit, a live user, LRU order
        sd = ps.state_dict()
        mgr = CheckpointManager(str(tmp_path), keep=1)
        mgr.save(1, {"logits": {str(i): e.pop("logits")
                                for i, e in enumerate(sd["entries"])}},
                 metadata={"prefix": sd})
        tree, meta = mgr.restore_latest()
        psd = meta["prefix"]
        psd["entries"] = [{**e, "logits": tree["logits"][str(i)]}
                          for i, e in enumerate(psd["entries"])]
        ps2 = PrefixStore(0, 4, 8)
        ps2.load_state_dict(psd)
        assert ps2.stats() == ps.stats()
        assert list(ps2._entries) == list(ps._entries) == [(4, 5),
                                                           (1, 2, 3)]
        assert ps2._entries[(1, 2, 3)]["users"] == {0}
        e = ps2.lookup((1, 2, 3), slot=1)
        assert e is not None and e.length == 10
        assert torch.equal(e.logits, logits)
        with pytest.raises(ValueError, match="page_size"):
            PrefixStore(0, 4, 16).load_state_dict(psd)


# -- crash + journal-replay recovery -----------------------------------------
class TestJournalRecovery:
    @pytest.mark.parametrize("boundary", [1, 2, 3])
    def test_crash_any_boundary_recovers_bit_exact(self, engines, clean,
                                                   tmp_path, boundary):
        jp = str(tmp_path / "j.jsonl")
        crashed = _ours(engines, journal=jp,
                        fault_plan=FaultPlan(crash=(boundary,)))
        with pytest.raises(SimulatedCrash):
            crashed.run(_requests(engines["toks"]))
        fresh = _ours(engines, journal=jp)
        assert _by_rid(fresh.recover()) == clean["greedy"]
        h = fresh.health_stats()
        assert h["recoveries"] == 1
        # the in-flight requests rebuild through the one resume program
        assert fresh.executable_counts()["resume"] <= 1

    def test_repeated_crashes_chain(self, engines, clean, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        plan = FaultPlan(crash=(1, 2))
        with pytest.raises(SimulatedCrash):
            _ours(engines, journal=jp, fault_plan=plan).run(
                _requests(engines["toks"]))
        with pytest.raises(SimulatedCrash):
            _ours(engines, journal=jp, fault_plan=plan).recover()
        assert _by_rid(_ours(engines, journal=jp).recover()) == \
            clean["greedy"]

    def test_pre_crash_retirees_survive_with_health(self, engines,
                                                    tmp_path):
        t = engines["toks"]
        reqs = [Request(rid=0, tokens=t[0, :12], max_gen=1),
                Request(rid=1, tokens=t[1, :20], max_gen=GEN)]
        jp = str(tmp_path / "j.jsonl")
        with pytest.raises(SimulatedCrash):
            _ours(engines, journal=jp,
                  fault_plan=FaultPlan(crash=(1,))).run(reqs)
        s2 = _ours(engines, journal=jp)
        done = _by_rid(s2.recover())
        assert set(done) == {0, 1}
        assert done[0][2] == "budget" and len(done[0][0]) == 1
        h = s2.health_stats()
        assert h["ok"] == 2 and h["budget"] == 2
        assert h["replayed_tokens"] > 0
        assert s2.call_counts()["resume"] == 1

    def test_sampled_recovery_parity(self, engines, clean, tmp_path):
        """The carried per-request key rides the journal as two uint32
        words, so sampled streams continue across the crash."""
        jp = str(tmp_path / "j.jsonl")
        with pytest.raises(SimulatedCrash):
            _ours(engines, journal=jp, fault_plan=FaultPlan(crash=(2,)),
                  **SAMPLED).run(_requests(engines["toks"]))
        assert _by_rid(_ours(engines, journal=jp, **SAMPLED).recover()) \
            == clean["sampled"]

    def test_recover_requires_journal(self, engines):
        with pytest.raises(ValueError, match="needs a journal"):
            _ours(engines).recover()

    def test_knob_mismatch_rejected(self, engines, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        with pytest.raises(SimulatedCrash):
            _ours(engines, journal=jp, fault_plan=FaultPlan(crash=(1,))).run(
                _requests(engines["toks"]))
        with pytest.raises(ValueError, match="knobs do not match"):
            _ours(engines, journal=jp, block_steps=4).recover()

    def test_knobs_equal_the_reference(self, engines):
        for kw in ({}, SAMPLED, dict(cache_layout="paged", page_size=PAGE)):
            assert _ours(engines, **kw)._knobs() == _ref(engines,
                                                         **kw)._knobs()


@pytest.mark.parametrize("scheme", ["greedy", "sampled"])
@pytest.mark.parametrize("crasher", ["ours", "ref"])
def test_cross_engine_replay(engines, clean, tmp_path, crasher, scheme):
    """A journal written by one package's crashed run recovers in the other
    with the uninterrupted run's completions."""
    jp = str(tmp_path / "j.jsonl")
    kw = SAMPLED if scheme == "sampled" else {}
    if crasher == "ours":
        with pytest.raises(SimulatedCrash):
            _ours(engines, journal=jp, fault_plan=FaultPlan(crash=(2,)),
                  **kw).run(_requests(engines["toks"]))
        done = _ref(engines, journal=jp, **kw).recover()
    else:
        with pytest.raises(JSimulatedCrash):
            _ref(engines, journal=jp, fault_plan=FaultPlan(crash=(2,)),
                 **kw).run(_requests(engines["toks"], JRequest))
        done = _ours(engines, journal=jp, **kw).recover()
    assert _by_rid(done) == clean[scheme]


# -- snapshot recovery (save_state / load_state / resume_run) -----------------
class TestSnapshotRecovery:
    def test_snapshot_restore_bit_exact_in_place(self, engines, clean,
                                                 tmp_path):
        sd = str(tmp_path / "snaps")
        s1 = _ours(engines, snapshot_every=1, snapshot_dir=sd,
                   fault_plan=FaultPlan(crash=(2,)))
        with pytest.raises(SimulatedCrash):
            s1.run(_requests(engines["toks"]))
        s2 = _ours(engines, snapshot_dir=sd)
        s2._programs()
        bufs = [t for c in layer_caches(s2._cache)
                for t in (c.k, c.v, c.k_scale, c.v_scale)]
        bufs += [s2._keys, s2._hist]
        ptrs = [t.data_ptr() for t in bufs]
        assert s2.load_state() == 2
        assert [t.data_ptr() for t in layer_caches(s2._cache)
                for t in (t.k, t.v, t.k_scale, t.v_scale)] + [
            s2._keys.data_ptr(), s2._hist.data_ptr()] == ptrs
        for a, b in zip(layer_caches(s1._cache), layer_caches(s2._cache)):
            assert torch.equal(a.k, b.k) and torch.equal(a.k_scale,
                                                         b.k_scale)
        assert _by_rid(s2.resume_run()) == clean["greedy"]
        h = s2.health_stats()
        assert h["recoveries"] == 1 and h["replayed_tokens"] == 0
        assert s2.call_counts()["resume"] == 0

    def test_sampled_snapshot_restores_keys(self, engines, clean, tmp_path):
        sd = str(tmp_path / "snaps")
        with pytest.raises(SimulatedCrash):
            _ours(engines, snapshot_every=1, snapshot_dir=sd,
                  fault_plan=FaultPlan(crash=(1,)), **SAMPLED).run(
                _requests(engines["toks"]))
        s2 = _ours(engines, snapshot_dir=sd, **SAMPLED)
        s2.load_state()
        assert _by_rid(s2.resume_run()) == clean["sampled"]

    def test_paged_snapshot_preserves_prefix_store(self, engines, tmp_path):
        t = engines["toks"]
        reqs = [Request(rid=0, tokens=t[0, :16], max_gen=GEN),
                Request(rid=1, tokens=t[0, :16], max_gen=GEN),
                Request(rid=2, tokens=t[1, :8], max_gen=GEN)]
        kw = dict(cache_layout="paged", page_size=PAGE, prefix_pages=8)
        want = _by_rid(_ref(engines, **kw).run(
            [JRequest(rid=r.rid, tokens=r.tokens, max_gen=GEN)
             for r in reqs]))
        sd = str(tmp_path / "snaps")
        s1 = _ours(engines, snapshot_every=1, snapshot_dir=sd,
                   fault_plan=FaultPlan(crash=(1,)), **kw)
        with pytest.raises(SimulatedCrash):
            s1.run(reqs)
        before = s1.prefix_stats()
        s2 = _ours(engines, snapshot_dir=sd, **kw)
        s2.load_state()
        table = s2._cache["layer0"]["attn"].table
        assert torch.equal(table, s1._cache["layer0"]["attn"].table)
        assert _by_rid(s2.resume_run()) == want
        after = s2.prefix_stats()
        assert after["hits"] >= before["hits"]
        assert after["shared_tokens"] >= before["shared_tokens"] > 0

    def test_save_state_requires_dir(self, engines):
        sched = _ours(engines)
        with pytest.raises(ValueError, match="snapshot_dir"):
            sched.save_state()
        with pytest.raises(ValueError, match="snapshot_dir"):
            sched.load_state()

    def test_load_state_empty_dir_raises(self, engines, tmp_path):
        sched = _ours(engines, snapshot_dir=str(tmp_path / "none"))
        with pytest.raises(FileNotFoundError, match="no committed"):
            sched.load_state()

    def test_load_state_rejects_other_knobs(self, engines, tmp_path):
        sd = str(tmp_path / "snaps")
        s1 = _ours(engines, snapshot_dir=sd)
        s1.run(_requests(engines["toks"], n=1))
        s1.save_state()
        with pytest.raises(ValueError, match="knobs do not match"):
            _ours(engines, snapshot_dir=sd, gen_cap=200).load_state()


# -- health counter semantics -------------------------------------------------
def test_health_cumulative_across_runs_and_reset(engines):
    sched = _ours(engines)
    sched.run(_requests(engines["toks"], n=2))
    assert sched.health_stats()["ok"] == 2
    sched.run(_requests(engines["toks"], n=2))
    second = sched.health_stats()
    assert second["ok"] == 4
    second["ok"] = 99
    assert sched.health_stats()["ok"] == 4
    sched.reset_health()
    assert all(v == 0 for v in sched.health_stats().values())


# -- the Engine's durability entry points -------------------------------------
class TestEngineDurability:
    def _engine(self, engines, **kw):
        e = engines["ours"]
        return Engine(e.model, e.cfg, e.policy, e.serve_params, e.qparams,
                      device="cpu", prefill_chunk=CHUNK, **kw)

    def test_engine_threads_journal_and_recovers(self, engines, clean,
                                                 tmp_path):
        jp = str(tmp_path / "j.jsonl")
        sched_kw = dict(max_slots=2, prompt_cap=S, gen_cap=GEN + 2,
                        block_steps=3)
        e1 = self._engine(engines, journal=jp, fault_plan={"crash": [1]})
        with pytest.raises(SimulatedCrash):
            e1.generate(_requests(engines["toks"]), **sched_kw)
        e2 = self._engine(engines, journal=jp)
        assert _by_rid(e2.recover(**sched_kw)) == clean["greedy"]
        assert e2.health_report()["recoveries"] == 1

    def test_engine_snapshot_resume(self, engines, clean, tmp_path):
        sd = str(tmp_path / "snaps")
        sched_kw = dict(max_slots=2, prompt_cap=S, gen_cap=GEN + 2,
                        block_steps=3)
        e1 = self._engine(engines, snapshot_every=1, snapshot_dir=sd,
                          fault_plan=FaultPlan(crash=(2,)))
        with pytest.raises(SimulatedCrash):
            e1.generate(_requests(engines["toks"]), **sched_kw)
        assert e1.save_state().endswith("ckpt_0000000003")
        e2 = self._engine(engines, snapshot_dir=sd)
        assert _by_rid(e2.resume(**sched_kw)) == clean["greedy"]
        e3 = self._engine(engines, snapshot_dir=sd)
        assert e3.load_state(**sched_kw) == 2

    def test_engine_validates_snapshot_knobs(self):
        with pytest.raises(ValueError, match="snapshot_dir"):
            Engine.from_checkpoint(smoke=True, device="cpu",
                                   snapshot_every=3)
        with pytest.raises(ValueError, match="no scheduler"):
            Engine.from_checkpoint(smoke=True, device="cpu").save_state()


def test_sharded_engine_takes_the_knobs(engines, tmp_path):
    """``ShardedEngine`` inherits the Engine's resilience and durability
    knobs, as the reference's does: under sp=2 (its scheduler's programs
    run eagerly) a forced preemption re-admits through the ``resume``
    prefill and a journaled crash recovers, both to the clean run's
    tokens."""
    from repro_torch.shard import ShardedEngine

    e = engines["ours"]
    sched_kw = dict(max_slots=2, prompt_cap=S, gen_cap=GEN + 2,
                    block_steps=3)

    def sharded(**kw):
        return ShardedEngine(e.model, e.cfg, e.policy, e.serve_params,
                             e.qparams, device="cpu", sp=2,
                             prefill_chunk=CHUNK, **kw)

    reqs = _requests(engines["toks"])
    clean = _by_rid(sharded().generate(reqs, **sched_kw))
    pre = sharded(fault_plan={"preempt": [[1, 0]]})
    assert _by_rid(pre.generate(reqs, **sched_kw)) == clean
    assert pre.health_report()["readmits"] == 1
    assert pre._scheduler.executable_counts()["resume"] == 1
    jp = str(tmp_path / "j.jsonl")
    with pytest.raises(SimulatedCrash):
        sharded(journal=jp, fault_plan={"crash": [2]}).generate(reqs,
                                                                **sched_kw)
    assert _by_rid(sharded(journal=jp).recover(**sched_kw)) == clean
