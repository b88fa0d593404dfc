"""The port's resilience layer against the reference's, under the same
``FaultPlan``: per-request fault isolation, deadlines, priority preemption
with the ``resume`` prefill, the bounded queue, and sampled streams.

The reference is ``repro.launch.scheduler.SlotScheduler`` over a JAX
``Engine`` built with ``use_pallas=True`` (its kernels in interpret mode);
the port's scheduler serves the same weights with the reference's
calibrated thresholds, bridged (as in ``tests/test_torch_scheduler.py``).
Float32 smoke config.  Each case runs the same requests under the same plan
through both packages' schedulers and requires identical completions (rid,
tokens, finished_by, status) and identical ``health_stats()``: on the CPU
the port's plain kernel versions give the reference's bits, so no tolerance
is needed.  The cases follow ``tests/test_resilience.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JaxEngine
from repro.launch.faults import FaultPlan as JFaultPlan
from repro.launch.scheduler import Request as JRequest
from repro.launch.scheduler import SlotScheduler as JSlotScheduler
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs import get_config as torch_config
from repro_torch.launch.engine import Engine
from repro_torch.launch.faults import FaultPlan, InjectedFault
from repro_torch.launch.scheduler import Request, SlotScheduler

S, GEN, CHUNK, PAGE = 32, 6, 8, 8
BASE = dict(max_slots=2, prompt_cap=S, gen_cap=GEN + 2, prefill_chunk=CHUNK,
            block_steps=3)
LENGTHS = (9, 20, 3, 17, 24, 12, 30, 5)


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
    prompts = [rng.integers(0, jcfg.vocab, (n,), dtype=np.int32)
               for n in LENGTHS]
    return dict(ref=ref, ours=ours, prompts=prompts)


def _pair(engines, plan=None, **kw):
    """A reference and a port scheduler over the same weights, knobs and
    fault plan (``plan``: the FaultPlan fields)."""
    kw = {**BASE, **kw}
    ref, ours = engines["ref"], engines["ours"]
    r = JSlotScheduler(ref.model, ref.cfg, ref.policy, ref.serve_params,
                       ref.qparams, mode=ref.mode,
                       fault_plan=None if plan is None else JFaultPlan(**plan),
                       **kw)
    o = SlotScheduler(ours.model, ours.cfg, ours.policy, ours.serve_params,
                      ours.qparams, mode=ours.mode,
                      fault_plan=None if plan is None else FaultPlan(**plan),
                      **kw)
    return r, o


def _summary(done):
    return sorted((c.rid, [int(t) for t in c.tokens], c.finished_by,
                   c.status) for c in done)


def _both(engines, make, plan=None, **kw):
    """``make(cls)`` -> requests, served by both packages; asserts identical
    completions and health counters; returns (port completions by rid,
    port scheduler, reference scheduler)."""
    r, o = _pair(engines, plan, **kw)
    want = r.run(make(JRequest))
    got = o.run(make(Request))
    assert _summary(got) == _summary(want)
    assert o.health_stats() == r.health_stats()
    return {c.rid: c for c in got}, o, r


def _req(prompts, rid, n, cls, **kw):
    kw.setdefault("max_gen", GEN)
    return cls(rid=rid, tokens=prompts[n], **kw)


def chaos_requests(prompts):
    """The combined plan's queue: a forced preemption (rid 0), an injected
    reject (1), non-finite prefill (2) and decode (3) logits, an expiring
    deadline (4), a late high-priority arrival (5), arrivals that overflow
    ``queue_cap`` 3 (one, rid 9, is shed) and an empty prompt (8)."""
    def make(cls):
        R = lambda rid, n, **kw: _req(prompts, rid, n, cls, **kw)  # noqa
        return [R(0, 0, max_gen=12), R(1, 1), R(2, 2), R(3, 3, arrive_ms=5.0),
                R(4, 4, max_gen=30, deadline_ms=45.0, arrive_ms=5.0),
                R(5, 5, priority=5, arrive_ms=30.0), R(6, 6, arrive_ms=30.0),
                R(7, 7, arrive_ms=30.0), R(9, 1, arrive_ms=30.0),
                cls(rid=8, tokens=np.zeros(0, np.int32), max_gen=4,
                    arrive_ms=60.0)]
    return make


CHAOS_PLAN = dict(reject=(1,), nan_prefill=(2,), nan_decode=((3, 1),),
                  preempt=((2, 0),), ms_per_block=10.0)


class TestIsolation:
    def test_faults_stay_per_request(self, engines):
        p = engines["prompts"]

        def make(cls):
            return [_req(p, 10, 0, cls), _req(p, 11, 1, cls),
                    _req(p, 12, 3, cls), _req(p, 13, 4, cls)]

        done, sched, _ = _both(engines, make,
                               dict(reject=(10,), nan_prefill=(11,),
                                    nan_decode=((12, 1),)))
        assert done[10].status == "failed"
        assert "injected admission failure" in done[10].reason
        assert done[11].status == "failed"
        assert "non-finite prefill logits" in done[11].reason
        assert done[12].status == "failed" and len(done[12].tokens) == 2
        assert "non-finite logits during decode" in done[12].reason
        assert done[13].status == "ok" and len(done[13].tokens) == GEN

    def test_malformed_requests_rejected_not_raised(self, engines):
        p = engines["prompts"]

        def make(cls):
            return [cls(rid=0, tokens=np.zeros((0,), np.int32)),
                    cls(rid=1, tokens=np.zeros((S + 1,), np.int32)),
                    _req(p, 2, 0, cls, max_gen=0), _req(p, 3, 0, cls)]

        done, _, _ = _both(engines, make)
        assert [done[r].status for r in range(4)] == ["rejected"] * 3 + ["ok"]
        assert "exceeds prompt_cap" in done[1].reason

    def test_runtime_error_in_admission_escapes_run(self, engines):
        """A standing difference from the reference (ROADMAP Queue C): the
        port isolates only InjectedFault, FloatingPointError and ValueError
        at admission; any other exception, as a CUDA error would be,
        escapes ``run`` instead of retiring every later request as
        failed."""
        _, sched = _pair(engines)
        p = engines["prompts"]

        def broken():
            raise RuntimeError("CUDA error: an illegal memory access")

        sched._programs()
        sched._admission = broken
        with pytest.raises(RuntimeError, match="illegal memory access"):
            sched.run([_req(p, 0, 0, Request)])
        # the injected fault of the same admission is isolated
        ok = SlotScheduler(*_stack(engines), fault_plan=FaultPlan(reject=(0,)),
                           **BASE)
        (c,) = ok.run([_req(p, 0, 0, Request)])
        assert c.status == "failed" and InjectedFault.__name__ in c.reason


def _stack(engines):
    e = engines["ours"]
    return e.model, e.cfg, e.policy, e.serve_params, e.qparams


class TestChaosAcceptance:
    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_combined_fault_plan_one_run(self, engines, layout):
        """Every fault class in one run, with a bounded queue and the
        virtual clock; paged also exhausts the prefix pool.  Requests the
        plan does not touch, and the re-admitted victims, equal the clean
        run's tokens."""
        plan = dict(CHAOS_PLAN, exhaust_prefix=layout == "paged")
        make = chaos_requests(engines["prompts"])
        kw = dict(gen_cap=32, queue_cap=3, cache_layout=layout,
                  page_size=PAGE)
        done, sched, ref = _both(engines, make, plan, **kw)
        statuses = {c.status for c in done.values()}
        assert statuses == {"ok", "failed", "timeout", "shed", "rejected"}
        assert done[9].status == "shed" and done[4].status == "timeout"
        h = sched.health_stats()
        assert h["preemptions"] == h["readmits"] == 2
        # every prefill but the non-finite one would register its prompt
        assert h["prefix_exhausted"] == (6 if layout == "paged" else 0)
        assert sched.call_counts() == ref.call_counts()
        assert sched.executable_counts() == {"prefill": 1, "decode": 1,
                                             "resume": 1}
        # the same requests without the plan's faults and queue cap
        clean = SlotScheduler(*_stack(engines), **{
            **BASE, "gen_cap": 32, "cache_layout": layout,
            "page_size": PAGE})
        want = {c.rid: c.tokens for c in clean.run(
            [r for r in make(Request) if r.rid in (0, 5, 6, 7)])}
        for rid in (0, 5, 6, 7):        # 0 and 5's victim were parked
            assert done[rid].tokens == want[rid], rid

    def test_faulted_run_reuses_the_clean_programs(self, engines):
        """The plan is data: a clean run and a faulted run on one scheduler
        build each program once (the block's nan_step is its buffer)."""
        _, sched = _pair(engines, cache_layout="paged", page_size=PAGE)
        p = engines["prompts"]

        def make():
            return [_req(p, r, r, Request) for r in range(4)]

        clean = {c.rid: c.tokens for c in sched.run(make())}
        built = sched.executable_counts()
        nan_step = sched._nan_step
        sched._plan = FaultPlan(nan_decode=((1, 1),), preempt=((1, 0),),
                                exhaust_prefix=True)
        chaos = {c.rid: c for c in sched.run(make())}
        assert built == {"prefill": 1, "decode": 1, "resume": 0}
        assert sched.executable_counts() == {"prefill": 1, "decode": 1,
                                             "resume": 1}
        assert sched._nan_step is nan_step
        assert chaos[1].status == "failed"
        for rid in (0, 2, 3):
            assert chaos[rid].tokens == clean[rid], rid


class TestDeadlines:
    def test_resident_deadline_times_out_at_boundary(self, engines):
        p = engines["prompts"]
        done, sched, _ = _both(
            engines, lambda cls: [_req(p, 0, 0, cls, max_gen=30,
                                       deadline_ms=25.0)],
            dict(ms_per_block=10.0), gen_cap=40)
        assert done[0].status == "timeout"
        assert "while decoding" in done[0].reason
        assert len(done[0].tokens) == 1 + 3 * 3
        assert sched.health_stats()["deadline_misses"] == 1

    def test_queued_deadline_times_out_without_device_work(self, engines):
        p = engines["prompts"]
        done, _, _ = _both(
            engines, lambda cls: [_req(p, 0, 0, cls),
                                  _req(p, 1, 1, cls, deadline_ms=5.0)],
            dict(ms_per_block=10.0), max_slots=1)
        assert done[0].status == "ok"
        assert done[1].status == "timeout" and done[1].tokens == []
        assert "while queued" in done[1].reason


class TestPriorityPreemption:
    @pytest.mark.parametrize("layout", ["dense", "paged"])
    def test_high_priority_waiter_evicts_lowest_priority_slot(
            self, engines, layout):
        p = engines["prompts"]

        def make(cls):
            return [_req(p, 0, 0, cls, max_gen=12),
                    _req(p, 1, 1, cls, max_gen=12),
                    _req(p, 2, 4, cls, priority=5, arrive_ms=10.0)]

        done, sched, _ = _both(engines, make, dict(ms_per_block=10.0),
                               gen_cap=20, cache_layout=layout,
                               page_size=PAGE)
        assert all(c.status == "ok" for c in done.values())
        h = sched.health_stats()
        assert h["preemptions"] == 1 and h["readmits"] == 1
        assert sched.call_counts()["resume"] == 1
        alone = SlotScheduler(*_stack(engines), **{**BASE, "gen_cap": 20})
        (want,) = alone.run([_req(p, 0, 0, Request, max_gen=12)])
        assert done[0].tokens == want.tokens

    def test_equal_priorities_never_preempt(self, engines):
        p = engines["prompts"]
        done, sched, _ = _both(
            engines, lambda cls: [_req(p, r, r % 2, cls,
                                       arrive_ms=float(5 * r))
                                  for r in range(4)],
            dict(ms_per_block=10.0))
        assert all(c.status == "ok" for c in done.values())
        assert sched.health_stats()["preemptions"] == 0
        assert sched.call_counts()["resume"] == 0


class TestDegradation:
    def test_bounded_queue_sheds_under_overload(self, engines):
        p = engines["prompts"]
        done, sched, _ = _both(
            engines, lambda cls: [_req(p, r, r % 2, cls, max_gen=2)
                                  for r in range(3)],
            max_slots=1, queue_cap=1)
        assert done[0].status == "ok"
        assert done[1].status == "shed" and done[2].status == "shed"
        assert "queue_cap=1" in done[1].reason
        assert sched.health_stats()["shed"] == 2

    def test_block_policy_holds_arrivals_instead(self, engines):
        p = engines["prompts"]
        done, sched, _ = _both(
            engines, lambda cls: [_req(p, r, r % 2, cls, max_gen=2)
                                  for r in range(3)],
            max_slots=1, queue_cap=1, shed_policy="block")
        assert all(c.status == "ok" for c in done.values())
        assert sched.health_stats()["shed"] == 0

    def test_run_cut_retires_parked_as_preempted(self, engines):
        """A run cut by ``max_blocks`` retires the request parked for the
        priority arrival as 'preempted', with its tokens so far."""
        p = engines["prompts"]

        def make(cls):
            return [_req(p, 0, 0, cls, max_gen=12),
                    _req(p, 1, 1, cls, max_gen=12),
                    _req(p, 2, 4, cls, priority=5, arrive_ms=10.0)]

        r, o = _pair(engines, dict(ms_per_block=10.0), gen_cap=20)
        want = r.run(make(JRequest), max_blocks=2)
        got = o.run(make(Request), max_blocks=2)
        assert _summary(got) == _summary(want)
        by = {c.rid: c for c in got}
        assert by[0].status == "preempted" and len(by[0].tokens) == 4
        assert o.health_stats() == r.health_stats()

    @pytest.mark.parametrize("kw,match", [
        (dict(queue_cap=0), "queue_cap"),
        (dict(shed_policy="drop"), "shed_policy"),
        (dict(snapshot_every=2), "snapshot_dir"),
        (dict(snapshot_every=-1, snapshot_dir="x"), "snapshot_every"),
    ], ids=["queue_cap", "shed_policy", "snapshot_every_no_dir",
            "snapshot_every_negative"])
    def test_invalid_knobs_reject_at_construction(self, engines, kw, match):
        """The reference's errors, from the port's scheduler and Engine."""
        ref = engines["ref"]
        with pytest.raises(ValueError, match=match) as want:
            JSlotScheduler(ref.model, ref.cfg, ref.policy, ref.serve_params,
                           ref.qparams, **kw)
        with pytest.raises(ValueError, match=match) as got:
            SlotScheduler(*_stack(engines), **kw)
        assert str(got.value) == str(want.value)
        if "queue_cap" not in kw:
            e = engines["ours"]
            with pytest.raises(ValueError, match=match):
                Engine(e.model, e.cfg, e.policy, e.serve_params, e.qparams,
                       device="cpu", **kw)


class TestSamplingDeterminism:
    def test_same_seed_different_arrival_order_with_preemption(self,
                                                               engines):
        """Sampled streams depend on (seed, rid), not on arrival order or a
        preemption: both packages give the same streams, reversed or not,
        with request 1 force-preempted at block 1."""
        p = engines["prompts"]
        kw = dict(temperature=0.8, top_p=0.9, seed=7)

        def make(cls):
            return [_req(p, r, n, cls) for r, n in enumerate((6, 1, 0))]

        runs = []
        for order in (1, -1):
            done, sched, _ = _both(
                engines, lambda cls: make(cls)[::order],
                dict(preempt=((1, 1),)), **kw)
            assert sched.health_stats()["readmits"] == 1
            runs.append({r: c.tokens for r, c in done.items()})
        assert runs[0] == runs[1]
        assert len({tuple(t) for t in runs[0].values()}) > 1


    def test_parked_key_survives_the_slot_changing_hands(self, engines):
        """A sampled request preempted by a higher-priority arrival in the
        one slot parks its carried key; the arrival's key then takes the
        slot, and the victim resumes with its own key: the reference's
        streams."""
        p = engines["prompts"]

        def make(cls):
            return [_req(p, 0, 0, cls, max_gen=12),
                    _req(p, 1, 1, cls, priority=5, arrive_ms=10.0)]

        done, sched, _ = _both(engines, make, dict(ms_per_block=10.0),
                               max_slots=1, gen_cap=20, temperature=0.8,
                               top_p=0.9, seed=7)
        assert sched.health_stats()["readmits"] == 1
        assert all(c.status == "ok" for c in done.values())


class TestEngineReport:
    def test_engine_aggregates_outcomes_and_parses_plans(self, engines):
        e, p = engines["ours"], engines["prompts"]
        engine = Engine(e.model, e.cfg, e.policy, e.serve_params, e.qparams,
                        device="cpu", prefill_chunk=CHUNK,
                        fault_plan={"reject": [0]})
        assert engine.fault_plan == FaultPlan(reject=(0,))
        assert engine.health_report() == {}
        done = {c.rid: c for c in engine.generate(
            [_req(p, 0, 0, Request, max_gen=2),
             _req(p, 1, 1, Request, max_gen=2)],
            max_slots=2, prompt_cap=S, gen_cap=GEN, block_steps=3)}
        assert done[0].status == "failed" and done[1].status == "ok"
        h = engine.health_report()
        assert h["failed"] == 1 and h["ok"] == 1
        # the plan is part of the scheduler's key
        sched = engine._scheduler
        engine.fault_plan = FaultPlan()
        engine.make_scheduler(max_slots=2, prompt_cap=S, gen_cap=GEN,
                              block_steps=3)
        assert engine._scheduler is not sched
