"""The port's fault plans and write-ahead journal (``launch/faults.py``,
``launch/journal.py``) against the reference's.

The reference's own cases (``tests/test_resilience.py::TestFaultPlan``,
``tests/test_recovery.py::TestFaultPlanCrash`` and ``TestJournal``) run
here against the port's copies; then the two packages are held against each
other: one spec parses to equal plans, a prompt hashes to the same digest,
and a journal written by either package replays in the other into the same
classification.  Pure host code: no model, no tolerance.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.launch import faults as JF
from repro.launch import journal as JJ
from repro.launch.scheduler import Completion as JCompletion
from repro.launch.scheduler import Request as JRequest
from repro_torch.launch import faults as TF
from repro_torch.launch import journal as TJ
from repro_torch.launch.faults import FaultPlan
from repro_torch.launch.journal import (JournalReplay, RequestJournal,
                                        completion_from_dict, prompt_hash,
                                        request_from_dict)
from repro_torch.launch.scheduler import Completion, Request

SPEC = {"reject": [5, 2], "nan_prefill": [7], "nan_decode": [[3, 1]],
        "preempt": [[1, 0], [2, 4]], "exhaust_prefix": True,
        "crash": [3, 1], "ms_per_block": 10.0}


# -- the reference's FaultPlan cases, on the port's copy ---------------------
class TestFaultPlan:
    def test_parse_forms_agree(self, tmp_path):
        want = FaultPlan(reject=(2,), nan_decode=((3, 1),),
                         preempt=((1, 0),), exhaust_prefix=True,
                         ms_per_block=10.0)
        spec = {"reject": [2], "nan_decode": [[3, 1]], "preempt": [[1, 0]],
                "exhaust_prefix": True, "ms_per_block": 10.0}
        assert FaultPlan.parse(spec) == want
        assert FaultPlan.parse(json.dumps(spec)) == want
        p = tmp_path / "plan.json"
        p.write_text(json.dumps(spec))
        assert FaultPlan.parse(str(p)) == want
        assert FaultPlan.parse({"nan_decode": {"3": 1}}).nan_decode \
            == ((3, 1),)
        assert FaultPlan.parse(want) is want

    def test_parse_rejects_unknown_keys(self):
        with pytest.raises(ValueError, match="unknown fault plan keys"):
            FaultPlan.parse({"nan_deocde": [[3, 1]]})
        with pytest.raises(ValueError, match="ms_per_block"):
            FaultPlan(ms_per_block=-1.0)
        with pytest.raises(ValueError, match="JSON object"):
            FaultPlan.parse("[1, 2]")

    def test_hashable_and_queries(self):
        plan = FaultPlan(reject=[5, 2], nan_decode=[(1, 4)],
                         preempt=[(2, 0), (2, 3)])
        assert {plan: 1}[FaultPlan(reject=(2, 5), nan_decode=((1, 4),),
                                   preempt=((2, 0), (2, 3)))] == 1
        assert plan.rejects(2) and not plan.rejects(3)
        assert plan.nan_decode_step(1) == 4
        assert plan.nan_decode_step(9) is None
        assert sorted(plan.preempts_at(2)) == [0, 3]
        assert plan.preempts_at(1) == ()
        assert not plan.empty and FaultPlan().empty
        assert "reject" in plan.describe()
        assert FaultPlan().describe() == "no faults"


class TestFaultPlanCrash:
    def test_crash_normalized_and_queried(self):
        plan = FaultPlan(crash=[3, 1])
        assert plan.crash == (1, 3)
        assert plan.crash_at(1) and plan.crash_at(3)
        assert not plan.crash_at(2)
        assert "crash at block [1, 3]" in plan.describe()

    def test_crash_boundaries_one_based(self):
        with pytest.raises(ValueError, match="1-based"):
            FaultPlan(crash=(0,))

    def test_crash_parses_from_json(self):
        assert FaultPlan.parse('{"crash": [2]}').crash == (2,)

    def test_duplicate_nan_decode_rid_rejected(self):
        with pytest.raises(ValueError, match="exactly one decode step"):
            FaultPlan(nan_decode=[(1, 3), (1, 5)])

    def test_duplicate_preempt_pair_rejected(self):
        with pytest.raises(ValueError, match="duplicate"):
            FaultPlan(preempt=[(2, 0), (2, 0)])


# -- the reference's journal cases, on the port's copy -----------------------
class TestJournal:
    def _req(self, rid, tokens=(5, 6, 7), **kw):
        return Request(rid=rid, tokens=np.asarray(tokens, np.int32), **kw)

    def test_roundtrip_and_classification(self, tmp_path):
        j = RequestJournal(str(tmp_path / "j.jsonl"))
        j.begin(1, {"max_slots": 2})
        j.enqueue(self._req(0))
        j.enqueue(self._req(1, tokens=(9, 9)))
        j.enqueue(self._req(2, arrive_ms=50.0))
        j.progress(0, [4, 2], np.asarray([1, 2], np.uint32), 3)
        j.retire(Completion(1, 2, [7], "eos"))
        j.block(2, 20.0)
        rp = j.replay()
        assert isinstance(rp, JournalReplay)
        assert rp.epoch == 1 and not rp.recovered
        assert rp.knobs == {"max_slots": 2}
        assert [d["rid"] for d in rp.done] == [1]
        assert [i["req"]["rid"] for i in rp.inflight] == [0]
        assert rp.inflight[0]["out"] == [4, 2]
        assert rp.inflight[0]["key"] == [1, 2]
        assert rp.inflight[0]["steps"] == 3
        assert [q["rid"] for q in rp.queued] == [2]
        assert rp.n_blocks == 2 and rp.vclock == 20.0
        r2 = request_from_dict(rp.queued[0])
        assert isinstance(r2, Request)
        assert r2.rid == 2 and r2.arrive_ms == 50.0
        c1 = completion_from_dict(rp.done[0])
        assert isinstance(c1, Completion)
        assert (c1.rid, c1.tokens, c1.finished_by) == (1, [7], "eos")

    def test_progress_is_absolute_newest_wins(self, tmp_path):
        j = RequestJournal(str(tmp_path / "j.jsonl"))
        j.begin(1, {})
        j.enqueue(self._req(0))
        j.progress(0, [4], [1, 1], 0)
        j.progress(0, [4, 8, 2], [3, 3], 6)
        rp = j.replay()
        assert rp.inflight[0]["out"] == [4, 8, 2]
        assert rp.inflight[0]["steps"] == 6

    def test_torn_trailing_line_dropped(self, tmp_path):
        p = tmp_path / "j.jsonl"
        j = RequestJournal(str(p))
        j.begin(1, {})
        j.enqueue(self._req(0))
        j.close()
        with open(p, "a") as f:
            f.write('{"t": "progress", "rid": 0, "ou')   # torn write
        rp = RequestJournal(str(p)).replay()
        assert [q["rid"] for q in rp.queued] == [0]
        assert rp.inflight == []

    def test_corrupt_middle_raises(self, tmp_path):
        p = tmp_path / "j.jsonl"
        j = RequestJournal(str(p))
        j.begin(1, {})
        j.enqueue(self._req(0))
        j.close()
        lines = p.read_text().splitlines()
        lines[0] = lines[0][:10]        # damage a NON-trailing record
        p.write_text("\n".join(lines) + "\n")
        with pytest.raises(ValueError, match="corrupt journal record"):
            RequestJournal(str(p)).replay()

    def test_prompt_hash_mismatch_raises(self, tmp_path):
        p = tmp_path / "j.jsonl"
        j = RequestJournal(str(p))
        j.begin(1, {})
        j.enqueue(self._req(0, tokens=(1, 2, 3)))
        j.close()
        p.write_text(p.read_text().replace("[1,2,3]", "[1,2,4]"))
        with pytest.raises(ValueError, match="prompt hash mismatch"):
            RequestJournal(str(p)).replay()

    def test_progress_without_enqueue_raises(self, tmp_path):
        j = RequestJournal(str(tmp_path / "j.jsonl"))
        j.begin(1, {})
        j.progress(7, [4], [1, 1], 0)
        with pytest.raises(ValueError, match="without an enqueue"):
            j.replay()

    def test_replay_reads_last_epoch_only(self, tmp_path):
        j = RequestJournal(str(tmp_path / "j.jsonl"))
        j.begin(1, {"a": 1})
        j.enqueue(self._req(0))
        j.retire(Completion(0, 3, [7], "eos"))
        j.begin(2, {"a": 2}, recovered=True)
        j.enqueue(self._req(5))
        rp = j.replay()
        assert rp.epoch == 2 and rp.recovered
        assert rp.knobs == {"a": 2}
        assert rp.done == [] and [q["rid"] for q in rp.queued] == [5]
        assert j.last_epoch() == 2

    def test_missing_or_empty_journal(self, tmp_path):
        j = RequestJournal(str(tmp_path / "nope.jsonl"))
        assert j.last_epoch() == 0
        with pytest.raises(FileNotFoundError):
            j.replay()
        (tmp_path / "empty.jsonl").write_text("")
        with pytest.raises(ValueError, match="no begin record"):
            RequestJournal(str(tmp_path / "empty.jsonl")).replay()

    def test_prompt_hash_deterministic(self):
        assert prompt_hash([1, 2, 3]) == prompt_hash(
            np.asarray([1, 2, 3], np.int32))
        assert prompt_hash([1, 2, 3]) != prompt_hash([1, 2])

    def test_torch_key_writes_uint32_words(self, tmp_path):
        """The port's carried keys are int64 tensors holding uint32 words:
        the journal writes the two words as they are."""
        import torch

        j = RequestJournal(str(tmp_path / "j.jsonl"))
        j.begin(1, {})
        j.enqueue(self._req(0))
        j.progress(0, [4], torch.tensor([0xFFFFFFFF, 7]), 1)
        assert j.replay().inflight[0]["key"] == [0xFFFFFFFF, 7]


# -- the two packages against each other -------------------------------------
def test_parse_gives_equal_fields_in_both_packages():
    ours, ref = TF.FaultPlan.parse(SPEC), JF.FaultPlan.parse(SPEC)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.describe() == ref.describe()
    for rid in range(8):
        assert ours.rejects(rid) == ref.rejects(rid)
        assert ours.nans_prefill(rid) == ref.nans_prefill(rid)
        assert ours.nan_decode_step(rid) == ref.nan_decode_step(rid)
    for block in range(5):
        assert ours.preempts_at(block) == ref.preempts_at(block)
        assert ours.crash_at(block) == ref.crash_at(block)


@pytest.mark.parametrize("tokens", [[1, 2, 3], list(range(300)), [0],
                                    [49151, 7, 0, 3]])
def test_prompt_hash_equal_in_both_packages(tokens):
    assert TJ.prompt_hash(tokens) == JJ.prompt_hash(tokens)
    assert TJ.prompt_hash(np.asarray(tokens, np.int32)) == JJ.prompt_hash(
        np.asarray(tokens, np.int32))


def _write(pkg, path):
    """One crashed run's journal, written by ``pkg`` ("ref" or "ours"): a
    retirement, an in-flight request at its second progress, a queued one,
    a recovered epoch after a first one."""
    J, R, C = ((JJ, JRequest, JCompletion) if pkg == "ref"
               else (TJ, Request, Completion))
    j = J.RequestJournal(str(path))
    j.begin(1, {"max_slots": 2, "mode": "int8", "top_p": 1.0})
    j.enqueue(R(rid=9, tokens=np.asarray([3, 3], np.int32)))
    j.begin(2, {"max_slots": 2, "mode": "int8", "top_p": 1.0},
            recovered=True)
    j.enqueue(R(rid=0, tokens=np.asarray([5, 6, 7], np.int32), max_gen=4,
                priority=2, deadline_ms=250.0))
    j.enqueue(R(rid=1, tokens=np.asarray([9, 9], np.int32)))
    j.enqueue(R(rid=2, tokens=np.asarray([1, 2], np.int32), arrive_ms=40.0))
    j.progress(0, [4], [11, 0xFFFFFFFF], 0)
    j.retire(C(1, 2, [7, 8], "budget"))
    j.progress(0, [4, 8, 2], [12, 0xFFFFFFF0], 6)
    j.block(2, 20.0)
    j.close()


@pytest.mark.parametrize("writer,reader", [("ref", "ours"), ("ours", "ref")])
def test_journal_replays_across_packages(tmp_path, writer, reader):
    """A journal written by one package replays in the other into the same
    ``JournalReplay``, and its dicts rebuild the reader's Request and
    Completion classes."""
    path = tmp_path / "j.jsonl"
    _write(writer, path)
    J = TJ if reader == "ours" else JJ
    got = J.RequestJournal(str(path)).replay()
    _write(reader, tmp_path / "own.jsonl")
    want = J.RequestJournal(str(tmp_path / "own.jsonl")).replay()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.epoch, got.recovered, got.n_blocks) == (2, True, 2)
    assert [i["req"]["rid"] for i in got.inflight] == [0]
    assert got.inflight[0]["key"] == [12, 0xFFFFFFF0]
    assert [d["rid"] for d in got.done] == [1]
    assert [d["rid"] for d in got.queued] == [2]
    req = J.request_from_dict(got.inflight[0]["req"])
    assert (req.priority, req.deadline_ms, list(req.tokens)) == (
        2, 250.0, [5, 6, 7])
    assert type(req).__module__ == ("repro_torch.launch.scheduler"
                                    if reader == "ours"
                                    else "repro.launch.scheduler")
    assert J.completion_from_dict(got.done[0]).tokens == [7, 8]
