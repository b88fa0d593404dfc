"""The port's analysis contracts (``repro_torch.analysis``) on the CPU: every
rule has a red case and the serving surface is clean, held against the
reference's ``repro.analysis`` where both packages can run the same case.

Mirrors ``tests/test_analysis.py``'s classes:

* the report schema, and each package's validator accepting the other's
  reports;
* dtype drift: each red and clean pair gives the same codes in both
  packages (the reference side ``jax.make_jaxpr`` + its
  ``check_dtype_drift``, the port side recorded torch ops + its own);
* the kernel contracts: red stubs of the C-interface, registry, packing,
  operand and plain-on-card rules, the real sources clean;
* the capture budgets, ``CaptureWatch``, the host-read guard, and the
  port's Program counts of one scheduler session against the reference's
  traced counts for the same requests;
* aliasing and the freeze contract;
* the sweep (``run_analysis``), the CLI, and the sharded dry run with its
  ``--mesh dryrun`` CLI.
"""
import json
import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import dtype_drift as JDD
from repro.analysis import report as JREP
from repro_torch.analysis import budgets as BU
from repro_torch.analysis import donation as DO
from repro_torch.analysis import dtype_drift as DD
from repro_torch.analysis import entrypoints as EP
from repro_torch.analysis import kernel_contracts as KC
from repro_torch.analysis.record import KernelCall, Operand, Recorder
from repro_torch.analysis.report import (Finding, make_report,
                                         validate_report, write_report)
from repro_torch.dist import collectives as C
from repro_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")


def codes(findings):
    return sorted(f.code for f in findings)


def recorded(fn):
    with Recorder() as rec:
        fn()
    return rec


# ---------------------------------------------------------------------------
# report schema
# ---------------------------------------------------------------------------

class TestReportSchema:
    def test_roundtrip(self, tmp_path):
        f = Finding(analyzer="budgets", code="budget.retrace", message="m")
        rep = make_report([f], entry_points=["scheduler"], backend="cpu")
        assert rep["tool"] == "repro_torch.analysis"
        assert validate_report(rep) == []
        out = tmp_path / "r.json"
        write_report(str(out), rep)
        assert validate_report(json.loads(out.read_text())) == []

    def test_counts_mismatch_rejected(self):
        rep = make_report([], tool="t")
        bad = dict(rep, counts={"error": 1, "warning": 0})
        assert any("tally" in e for e in validate_report(bad))

    def test_entry_point_count_mismatch_rejected(self):
        rep = make_report([], tool="t", entry_points=["a", "b"])
        bad = dict(rep, n_entry_points=3)
        assert any("n_entry_points" in e for e in validate_report(bad))

    def test_bad_severity_rejected(self):
        rep = json.loads(json.dumps(make_report(
            [Finding(analyzer="a", code="c", message="m")], tool="t")))
        rep["findings"][0]["severity"] = "fatal"
        assert any("severity" in e for e in validate_report(rep))

    def test_write_refuses_invalid(self, tmp_path):
        rep = make_report([], tool="t")
        rep["schema_version"] = 99
        with pytest.raises(ValueError, match="refusing"):
            write_report(str(tmp_path / "x.json"), rep)
        assert not (tmp_path / "x.json").exists()

    def test_each_package_validates_the_others_report(self):
        f = dict(analyzer="donation", code="freeze.log2_t-leaf",
                 message="m", entry_point="qparams", location="x.py:1")
        port = make_report([Finding(**f)], entry_points=["qparams"],
                           backend="cpu")
        ref = JREP.make_report([JREP.Finding(**f)], tool="repro.analysis",
                               entry_points=["qparams"], backend="cpu")
        assert JREP.validate_report(port) == []
        assert validate_report(ref) == []
        assert {k: v for k, v in port.items() if k != "tool"} == \
            {k: v for k, v in ref.items() if k != "tool"}


# ---------------------------------------------------------------------------
# dtype drift: the same codes in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rank_mesh(tmp_path_factory):
    """A one-rank gloo process group on the CPU: the port's group-form
    collectives (``dist/collectives.py``) run for real."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import RankMesh

    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    yield RankMesh(axis="model", n=1, rank=0, device=torch.device("cpu"),
                   backend="gloo")
    dist.destroy_process_group()


def _ref_promote_stub():
    # jnp converts the narrow operand first, so a mixed-dtype add exists only
    # in hand-lowered graphs: the reference's own test stubs the equation
    def var(dt, shape):
        return NS(aval=NS(dtype=np.dtype(dt), shape=shape))

    eqn = NS(primitive=NS(name="add"),
             invars=[var(jnp.bfloat16, (4,)), var("float32", (4,))],
             outvars=[var("float32", (4,))], params={}, source_info=None)
    return NS(eqns=[eqn])


def _jaxpr(fn, x, axis=False):
    kw = dict(axis_env=[("i", 2)]) if axis else {}
    return jax.make_jaxpr(fn, **kw)(x)


def _jax_compressed_psum_scalar():
    def compressed_psum(x):
        return jax.lax.pmax(jnp.max(jnp.abs(x)), "i")
    return _jaxpr(compressed_psum, jnp.ones((8,), jnp.float32), True)


def _jax_compressed_psum_tensor():
    def compressed_psum(x):
        return jax.lax.pmax(x, "i")
    return _jaxpr(compressed_psum, jnp.ones((8,), jnp.float32), True)


def _port_scalar_max(mesh):
    # the shared threshold of compressed_psum's group form: one float32
    # scalar max, then the int32 payload
    C.compressed_psum(torch.ones(8), group=mesh)


def _port_tensor_max(mesh):
    # the same scope with a tensor-sized float max: the one-scalar rule's
    # max_elems must not let it through
    def compressed_psum(x):
        return C.all_reduce(x, mesh, op=torch.distributed.ReduceOp.MAX)
    compressed_psum(torch.ones(8))


BF16, F32 = torch.bfloat16, torch.float32
DRIFT_CASES = {
    "bf16_plus_f32": (
        _ref_promote_stub,
        lambda m: torch.ones(4, dtype=BF16) + torch.ones(4, dtype=F32)),
    "explicit_convert": (
        lambda: jax.make_jaxpr(lambda a, b: a.astype(jnp.float32) + b)(
            jnp.ones((4,), jnp.bfloat16), jnp.ones((4,), jnp.float32)),
        lambda m: torch.ones(4, dtype=BF16).float() + torch.ones(4)),
    "raw_int8_cast": (
        lambda: _jaxpr(lambda x: x.astype(jnp.int8),
                       jnp.ones((4,), jnp.float32)),
        lambda m: torch.ones(4).to(torch.int8)),
    "quantizer_cast": (
        lambda: _jaxpr(lambda x: jnp.clip(jnp.round(x / 0.1), -127, 127)
                       .astype(jnp.int8), jnp.ones((4,), jnp.float32)),
        lambda m: torch.clamp(torch.round(torch.ones(4) / 0.1), -127,
                              127).to(torch.int8)),
    "float_collective": (
        lambda: _jaxpr(lambda x: jax.lax.psum(x, "i"),
                       jnp.ones((4,), jnp.float32), True),
        lambda m: C.all_reduce(torch.ones(4), m)),
    "int_collective": (
        lambda: _jaxpr(lambda x: jax.lax.psum(x, "i"),
                       jnp.ones((4,), jnp.int32), True),
        lambda m: C.all_reduce(torch.ones(4, dtype=torch.int32), m)),
    "scalar_max_allowed": (_jax_compressed_psum_scalar, _port_scalar_max),
    "max_elems_bound": (_jax_compressed_psum_tensor, _port_tensor_max),
}


@pytest.fixture
def jax_core_names(monkeypatch):
    """The reference's jaxpr walk (``repro/analysis/jaxprs.py``) names
    ``jax.core.ClosedJaxpr`` / ``Jaxpr`` / ``Var``, which this jax keeps
    under ``jax.extend.core`` only: put the names back for the test, so the
    reference's checker runs."""
    import jax.extend.core as jcore

    for name in ("ClosedJaxpr", "Jaxpr", "Var"):
        monkeypatch.setattr(jax.core, name, getattr(jcore, name),
                            raising=False)


class TestDtypeDrift:
    @pytest.mark.parametrize("case", list(DRIFT_CASES))
    def test_same_codes_as_the_reference(self, case, rank_mesh,
                                         jax_core_names):
        ref_fn, port_fn = DRIFT_CASES[case]
        want = codes(JDD.check_dtype_drift(ref_fn()))
        got = codes(DD.check_dtype_drift(recorded(lambda: port_fn(
            rank_mesh))))
        assert got == want
        assert got == ([] if case in ("explicit_convert", "quantizer_cast",
                                      "int_collective", "scalar_max_allowed")
                       else [{"bf16_plus_f32": "drift.promote",
                              "raw_int8_cast": "drift.raw-int-cast"}.get(
                                  case, "drift.collective")])

    def test_copy_into_int8_is_a_cast(self):
        rec = recorded(lambda: torch.zeros(4, dtype=torch.int8).copy_(
            torch.ones(4)))
        assert codes(DD.check_dtype_drift(rec)) == ["drift.raw-int-cast"]

    def test_one_process_merges_are_allowed_gathers(self):
        # sp_partial_combine's stand-in gather of float32 partials and
        # compressed_psum's stacked int32 sum: recorded, and allowed
        from repro_torch.shard.partial_softmax import sp_partial_combine

        m = [torch.zeros(2, 3, 1, 1)] * 2
        acc = [torch.zeros(2, 3, 1, 1, 8)] * 2
        rec = recorded(lambda: (sp_partial_combine(m, m, acc),
                                C.compressed_psum(torch.ones(
                                    3, 4, dtype=torch.int32), mean=False)))
        assert [(c.kind, c.dtype, c.numel, c.n) for c in rec.collectives] \
            == [("all_gather", torch.float32, 6 * 10, 2),
                ("all_reduce", torch.int32, 4, 3)]
        assert DD.check_dtype_drift(rec) == []
        assert codes(DD.check_dtype_drift(rec, allowlist=())) == \
            ["drift.collective"]

    def test_allow_rule_matching(self):
        rule = DD.AllowRule(code="drift.collective", primitive="all_reduce",
                            max_elems=1, note="n")
        rec = NS(primitive="all_reduce", names=())
        assert rule.matches("drift.collective", rec, 1)
        assert not rule.matches("drift.collective", rec, 2)
        assert not rule.matches("drift.promote", rec, 1)
        assert not rule.matches("drift.collective",
                                NS(primitive="all_gather", names=()), 1)

    def test_integer_all_reduce_rule(self):
        def coll(dtype, n):
            return NS(kind="all_reduce", dtype=dtype, numel=n)

        assert DD.check_integer_all_reduces(
            [coll(torch.int32, 64), coll(F32, 1)]) == (True, [])
        ok, bad = DD.check_integer_all_reduces([coll(F32, 1), coll(F32, 1)])
        assert not ok and len(bad) == 1
        assert not DD.check_integer_all_reduces([coll(BF16, 64)])[0]


# ---------------------------------------------------------------------------
# kernel contracts
# ---------------------------------------------------------------------------

def _operand(dtype, *shape, device="cpu"):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return Operand(dtype, tuple(shape), tuple(t.stride()), device, True)


def _decode_call(k_width=16, kv_bits=8, device="cpu", launched=False,
                 twin=False, cur_pos=torch.int32):
    q = _operand(F32, 2, 3, 4, 16, device=device)
    ops_ = dict(q=q, k=_operand(torch.int8, 2, 32, 3, k_width,
                                device=device),
                v=_operand(torch.int8, 2, 32, 3, k_width, device=device),
                k_scale=_operand(F32, 3, device=device),
                v_scale=_operand(F32, 3, device=device),
                cur_pos=_operand(cur_pos, 2, device=device))
    return KernelCall("decode_attention", launched, device, ops_,
                      dict(kv_bits=kv_bits, twin=twin), "stub.py:1", ())


def _copy_tree(tmp_path):
    kdir, cdir = tmp_path / "kernels", tmp_path / "csrc"
    shutil.copytree(os.path.join(PKG, "kernels"), kdir)
    shutil.copytree(os.path.join(PKG, "csrc"), cdir)
    return kdir, cdir


class TestKernelContracts:
    def test_real_sources_clean(self):
        assert KC.check_kernel_sources() == []
        symbols = {b[1] for b in KC.bindings(os.path.join(PKG, "kernels"))}
        assert symbols == set(KC.c_entries(os.path.join(PKG, "csrc")))
        assert len(symbols) == 6

    @pytest.mark.parametrize("edit", ["count", "kind"])
    def test_c_arity_red(self, tmp_path, edit):
        kdir, cdir = _copy_tree(tmp_path)
        src = (kdir / "quant_matmul.py").read_text()
        old = "[p, i, p, p, i, i, i, p]"
        new = "[p, i, p, p, i, i, p]" if edit == "count" else \
            "[p, i, p, p, p, i, i, p]"
        assert old in src
        (kdir / "quant_matmul.py").write_text(src.replace(old, new))
        found = KC.check_kernel_sources(str(kdir), str(cdir))
        assert codes(found) == ["kernel.c-arity"]
        assert "repro_quant_matmul_acc" in found[0].message

    def test_unregistered_module_red(self, tmp_path):
        kdir, cdir = _copy_tree(tmp_path)
        (cdir / "rogue.cu").write_text(
            'extern "C" int repro_rogue(const void* x, int n, '
            'float s, void* stream) { return 0; }\n')
        (kdir / "rogue.py").write_text(
            "import ctypes\n\n\ndef _fn():\n"
            "    from repro_torch.kernels import build\n\n"
            "    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float\n"
            "    return build.function('rogue', 'repro_rogue', "
            "[p, i, f, p])\n")
        assert codes(KC.check_kernel_sources(str(kdir), str(cdir))) == \
            ["kernel.module-registry"]

    def test_int4_packing(self):
        assert codes(KC.check_kernel_calls([_decode_call(12, 4)])) == \
            ["kernel.int4-packing"]
        assert codes(KC.check_kernel_calls([_decode_call(16, 4)])) == \
            ["kernel.int4-packing"]
        assert KC.check_kernel_calls([_decode_call(8, 4)]) == []
        assert KC.check_kernel_calls([_decode_call(16, 8)]) == []

    def test_plain_on_card_red(self):
        # a CUDA tensor's wrapper that ran its plain version: red outside
        # plain_versions(), the twin within it, a launch clean
        assert codes(KC.check_kernel_calls([_decode_call(
            device="cuda")])) == ["kernel.plain-on-card"]
        assert KC.check_kernel_calls([_decode_call(device="cuda",
                                                   twin=True)]) == []
        assert KC.check_kernel_calls([_decode_call(device="cuda",
                                                   launched=True)]) == []

    def test_operands_red(self):
        assert codes(KC.check_kernel_calls([_decode_call(
            cur_pos=torch.int64)])) == ["kernel.operands"]
        qmm = KernelCall("quant_matmul", False, "cpu", dict(
            x=_operand(BF16, 4, 64), w_q=_operand(torch.int8, 32, 16),
            w_scale=_operand(F32, 16), act_scale=_operand(F32)),
            dict(w_bits=8), "", ())
        assert codes(KC.check_kernel_calls([qmm])) == ["kernel.operands"]
        w4 = KernelCall("quant_matmul", False, "cpu", dict(qmm.operands),
                        dict(w_bits=4), "", ())
        assert KC.check_kernel_calls([w4]) == []
        strided = _decode_call()
        strided.operands["q"] = strided.operands["q"]._replace(
            contiguous=False)
        assert codes(KC.check_kernel_calls([strided])) == ["kernel.operands"]

    def test_recorded_calls_clean_and_counted(self):
        q = torch.randn(2, 3, 4, 16)
        k = torch.randint(-127, 128, (2, 32, 3, 16), dtype=torch.int8)
        s = torch.ones(3)
        rec = recorded(lambda: ops.decode_attention(q, k, k, s, s, 7))
        (kc,) = rec.kernels
        assert (kc.kernel, kc.launched, kc.device) == \
            ("decode_attention", False, "cpu")
        assert KC.check_kernel_calls(rec.kernels) == []
        want = {("decode_attention", "launches"): 1}
        assert KC.check_launch_counts(rec, want) == []
        assert codes(KC.check_launch_counts(
            rec, {("decode_attention", "launches"): 2})) == \
            ["kernel.launch-count"]


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------

class TestBudgets:
    def test_clean_counts(self):
        counts = {"prefill": 1, "decode": 1, "resume": 0}
        assert BU.check_executable_budgets(counts) == []
        assert BU.check_executable_budgets(counts,
                                           require_all_ran=True) == []

    def test_retrace_red(self):
        assert codes(BU.check_executable_budgets({"decode": 3})) == \
            ["budget.retrace"]
        # the eager pieces are declared: a Program for one is over budget
        assert codes(BU.check_executable_budgets({"insert": 1})) == \
            ["budget.retrace"]

    def test_undeclared_piece_red(self):
        assert codes(BU.check_executable_budgets(
            {"decode": 1, "newpiece": 1})) == ["budget.undeclared"]

    def test_never_ran_red(self):
        counts = {"prefill": 0}
        assert BU.check_executable_budgets(counts) == []
        assert codes(BU.check_executable_budgets(
            counts, require_all_ran=True)) == ["budget.never-traced"]

    def test_capture_watch_cold_then_warm(self):
        from repro_torch.launch.graphs import Program

        x = torch.arange(7.0)
        with BU.CaptureWatch() as cold:
            prog = Program(lambda: x * 2.0 + 1.0, "cpu")
            prog()
        assert cold.count == 1
        assert codes(cold.check(max_captures=0, what="cold")) == \
            ["budget.capture"]
        with BU.CaptureWatch() as warm:
            prog()
        assert warm.count == 0
        assert warm.check(max_captures=0, what="warm") == []

    def test_host_read_in_a_program_red(self):
        from repro_torch.launch.graphs import Program

        x = torch.arange(6.0)
        progs = {"reads": Program(lambda: x[: int(x.sum().item()) % 3],
                                  "cpu"),
                 "clean": Program(lambda: x * 2, "cpu")}
        found = BU.check_host_reads(progs, entry_point="t")
        assert codes(found) == ["capture.host-read"]
        assert "'reads'" in found[0].message

    def test_program_counts_match_the_reference(self):
        """One smoke session with ragged admissions and a preemption: the
        port's Program counts equal the reference's trace counts of the
        pieces both build (prefill, decode, resume)."""
        from repro.configs import get_config
        from repro.core import api as JA
        from repro.launch import steps as JST
        from repro.launch.faults import FaultPlan as JFaultPlan
        from repro.launch.scheduler import Request as JRequest
        from repro.launch.scheduler import SlotScheduler as JScheduler
        from repro.models import build_model
        from repro_torch.launch.engine import Engine
        from repro_torch.launch.scheduler import Request

        b, s, gen = EP.B, EP.S, EP.GEN
        cfg = get_config("smollm-135m", smoke=True)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(1).integers(0, cfg.vocab, (b, s))
        # use_pallas: the reference's kernel path rounds the cache to 128
        # positions, as the port always does (the widest resumable state)
        policy = JA.QuantPolicy(kv_int8=True, use_pallas=True)
        qp = JA.init_qparams(model, params, policy)
        qp = JST.make_calibrate_step(model, cfg, policy)(
            params, qp, {"tokens": jnp.asarray(toks, jnp.int32)})
        qp = JA.finalize_calibration(qp, policy)
        # rid 0 is preempted at block 1 and re-admitted through resume
        lens, gen = [s, s - 12, 9], gen + 2
        plan = dict(preempt=((1, 0),))
        ref = JScheduler(model, cfg, policy, params, qp, mode="none",
                         max_slots=2, prompt_cap=s, gen_cap=gen,
                         prefill_chunk=EP.CHUNK, block_steps=3,
                         fault_plan=JFaultPlan.parse(plan))
        list(ref.run([JRequest(rid=r, tokens=toks[r % b, :n], max_gen=gen)
                      for r, n in enumerate(lens)]))
        eng = Engine.from_checkpoint("smollm-135m", smoke=True,
                                     device="cpu", prefill_chunk=EP.CHUNK,
                                     fault_plan=plan)
        sched = eng.make_scheduler(max_slots=2, prompt_cap=s, gen_cap=gen,
                                   block_steps=3)
        list(sched.run([Request(rid=r, tokens=toks[r % b, :n], max_gen=gen)
                        for r, n in enumerate(lens)]))
        want = {k: ref.executable_counts()[k]
                for k in ("prefill", "decode", "resume")}
        assert sched.executable_counts() == want
        assert want == {"prefill": 1, "decode": 1, "resume": 1}
        assert sched.call_counts()["resume"] == ref.call_counts()["resume"] \
            == 1
        assert sched.check_budgets() == []
        assert set(sched.programs()) == {"prefill", "decode", "resume"}


# ---------------------------------------------------------------------------
# aliasing and the freeze contract
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    return EP.build_engine(device="cpu")


class TestDonationAndFreeze:
    def test_duplicate_storage_red(self):
        x = torch.arange(8.0)
        assert codes(DO.check_duplicate_donation(
            {"a": x, "b": x, "c": torch.arange(3.0)})) == \
            ["donate.duplicate-buffer"]
        # overlapping views of one storage, too
        assert codes(DO.check_duplicate_donation(
            {"a": x[:5], "b": x[4:]})) == ["donate.duplicate-buffer"]

    def test_distinct_storage_clean(self):
        x = torch.arange(8.0)
        assert DO.check_duplicate_donation({"a": x[:4], "b": x[4:],
                                            "c": torch.arange(4.0)}) == []

    def test_cache_layouts_clean(self, served):
        found = EP.cache_findings(served)
        assert found == []

    def test_trained_thresholds_red_frozen_clean(self, served):
        from repro_torch.core import api as A

        kv = {p: {kk: {"t_max": st["t_max"]} for kk, st in e.items()}
              for p, e in served.qparams.items() if A.is_kv_path(p)}
        trained = {**served.qparams, **{
            p: {kk: dict(st, log2_t=torch.log2(st["t_max"]))
                for kk, st in e.items()} for p, e in kv.items()}}
        assert codes(DO.check_frozen_qparams(trained)) == \
            ["freeze.log2_t-leaf", "freeze.trainable-mask"]
        assert DO.check_frozen_qparams(served.qparams) == []
        assert DO.check_frozen_qparams(A.freeze_thresholds(trained)) == []

    def test_fake_quant_call_red(self):
        x = torch.randn(8, 16)
        rec = recorded(lambda: ops.fake_quant(x, torch.tensor(2.0),
                                              torch.tensor(0.9)))
        found = DO.check_no_fake_quant(rec)
        assert codes(found) == ["freeze.fake-quant-call"]
        assert "B5 launched 0 time(s)" in found[0].message

    def test_fake_mode_forward_red(self):
        from repro_torch.core import api as A
        from repro_torch.launch.engine import Engine

        eng = Engine.from_checkpoint("smollm-135m", smoke=True, device="cpu",
                                     fp=True)
        toks = EP.prompts(eng)
        ctx = A.make_ctx("fake", eng.policy, eng.qparams)
        with torch.no_grad():
            rec = recorded(lambda: eng.model.hidden(
                eng.serve_params, {"tokens": toks}, ctx))
        found = DO.check_no_fake_quant(rec)
        assert found and set(codes(found)) == {"freeze.fake-quant-call"}

    def test_served_engine_has_none(self, served):
        eps = EP.build_entry_points(served, include=("prefill",
                                                     "decode_block"))
        for ep in eps:
            assert ep.record.kernels
            assert DO.check_no_fake_quant(ep.record) == []


# ---------------------------------------------------------------------------
# the sweep, Engine.analyze, the CLI
# ---------------------------------------------------------------------------

SURFACE = ["prefill", "chunked_prefill", "decode_loop", "decode_block",
           "resume", "speculative_verify"]


class TestSweep:
    def test_zero_findings_every_entry_point(self, tmp_path):
        found, names = EP.run_analysis(device="cpu")
        assert found == [], "\n".join(
            f"{f.entry_point}: {f.code}: {f.message}" for f in found)
        want = [f"{n}[{tag}]" for tag in EP.VARIANTS for n in SURFACE]
        want += [f"sharded_{n}[{tag}]" for tag, ns in EP.SHARDED.items()
                 for n in ns]
        want += ["served_qparams", "cache", "scheduler_session",
                 "sharded_scheduler_session"]
        assert names == want and len(names) == 27
        rep = make_report(found, entry_points=names, backend="cpu")
        assert validate_report(rep) == [] == JREP.validate_report(rep)

    def test_kernels_actually_on_the_surface(self, served):
        """The clean verdict is not vacuous: every entry point calls the
        kernel wrappers, as many times as its structure implies."""
        for ep in EP.build_entry_points(served):
            assert ep.expected and ep.record.kernels, ep.name
            assert KC.recorded_launches(ep.record) == ep.expected, ep.name

    def test_engine_analyze(self, served):
        assert served.analyze() == []

    def test_cli_exits_0(self, tmp_path):
        out = tmp_path / "r.json"
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
             "--no-scheduler", "--out", str(out)], env=env,
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout + res.stderr
        rep = json.loads(out.read_text())
        assert rep["n_entry_points"] == 25 and rep["backend"] == "cpu"
        assert JREP.validate_report(rep) == []

    def test_cli_needs_the_card_by_default(self, monkeypatch, tmp_path):
        from repro_torch.analysis.__main__ import main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--out", str(tmp_path / "r.json")])
        assert not (tmp_path / "r.json").exists()


def test_every_finding_code_is_documented():
    """The README's table of finding codes covers every code the analyzers
    define (the counterpart of the reference's ``scripts/check_docs.py``)."""
    defined = set()
    pattern = re.compile(r'(?:code=|_finding\(\s*)"([a-z]+\.[a-z0-9_-]+)"')
    adir = os.path.join(PKG, "analysis")
    for name in os.listdir(adir):
        if name.endswith(".py"):
            with open(os.path.join(adir, name)) as f:
                defined |= set(pattern.findall(f.read()))
    with open(os.path.join(ROOT, "README.md")) as f:
        table = {m for m in re.findall(r"^\| \w+ \| `([^`]+)` \|", f.read(),
                                       re.M)}
    assert len(defined) >= 17
    assert defined <= table, sorted(defined - table)


# ---------------------------------------------------------------------------
# the sharded dry run
# ---------------------------------------------------------------------------

REPORT_KEYS = {"collective_bytes", "collective_by_kind",
               "all_reduce_payloads", "int8_all_reduces_ok", "findings"}


def _bytes_moved():
    return ops.reduce_counts()["wire_bytes"] + ops.gather_counts()[
        "gather_bytes"]


@pytest.fixture(scope="module")
def tp2():
    return EP.build_sharded_engine(device="cpu", tp=2)


def _float_reduce(monkeypatch):
    """A red stub: the tensor-parallel reduce reports its payload as a
    float32 all-reduce (what an uncompressed float psum would move)."""
    real = C.compressed_psum

    def float_psum(x, *, mean=True, group=None):
        C.stand_in("all_reduce", torch.float32, x[0].numel(), x.shape[0])
        return real(x, mean=mean, group=group)

    monkeypatch.setattr(C, "compressed_psum", float_psum)


class TestDryRun:
    def test_tp_report(self, tp2):
        before = _bytes_moved()
        rep = tp2.dry_run_report()
        moved = _bytes_moved() - before
        assert set(rep) == {"tp", "sp", "executables", "int8_all_reduces_ok"}
        assert (rep["tp"], rep["sp"]) == (2, 1)
        assert rep["int8_all_reduces_ok"] is True
        total = 0
        for name in ("prefill", "decode"):
            ex = rep["executables"][name]
            assert set(ex) == REPORT_KEYS and ex["int8_all_reduces_ok"]
            layers = tp2.cfg.n_layers
            rows = EP.B * (EP.S if name == "prefill" else 1)
            assert ex["all_reduce_payloads"] == \
                [("int32", rows * tp2.cfg.d_model)] * (2 * layers)
            assert ex["collective_by_kind"] == {
                "all-reduce": ex["collective_bytes"]}
            total += ex["collective_bytes"]
        assert total == moved > 0

    def test_sp_report(self):
        sp2 = EP.build_sharded_engine(device="cpu", sp=2)
        before = _bytes_moved()
        rep = sp2.dry_run_report()
        moved = _bytes_moved() - before
        assert rep["int8_all_reduces_ok"] is True
        dec = rep["executables"]["decode"]
        assert dec["all_reduce_payloads"] == []
        assert set(dec["collective_by_kind"]) == {"all-gather"}
        assert rep["executables"]["prefill"]["collective_bytes"] == 0
        assert dec["collective_bytes"] == moved > 0

    def test_red_float_all_reduce(self, tp2, monkeypatch):
        _float_reduce(monkeypatch)
        rep = tp2.dry_run_report()
        assert rep["int8_all_reduces_ok"] is False
        assert rep["executables"]["decode"]["findings"]

    @pytest.mark.parametrize("red", [False, True], ids=["clean", "red"])
    def test_serve_mesh_dryrun(self, red, monkeypatch, capsys):
        from repro_torch.launch import serve

        if red:
            _float_reduce(monkeypatch)
        with pytest.raises(SystemExit) as exc:
            serve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                        "--tp", "2", "--mesh", "dryrun", "--requests", "2",
                        "--prompt-len", "16"])
        out = capsys.readouterr().out
        assert exc.value.code == (1 if red else 0)
        assert f"int8_all_reduces_ok={not red}" in out
