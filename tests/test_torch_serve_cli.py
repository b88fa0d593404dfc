"""The port's serve CLI (``python -m repro_torch.launch.serve``) at
smollm-135m ``SMOKE`` on the CPU: its tokens are ``Engine``'s, a simulated
crash exits 3 and ``--restore journal --strict`` then exits 0 with the
uninterrupted run's tokens, and every flag of the reference's CLI is taken.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import repro_torch
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import pipeline as DP
from repro_torch.launch import serve
from repro_torch.launch.engine import Engine

SRC = os.path.dirname(os.path.dirname(repro_torch.__file__))
REF_SERVE = os.path.join(SRC, "repro", "launch", "serve.py")
BASE = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
        "--requests", "4", "--prompt-len", "16", "--gen", "5"]
SCHED = ["--max-slots", "2", "--block-steps", "2"]


def _engine(**kw):
    """The engine the CLI builds from BASE: calibrated on the pipeline's
    batches of --requests x --prompt-len (the Engine's default)."""
    return Engine.from_checkpoint("smollm-135m", smoke=True, device="cpu",
                                  calib_batch=4, calib_len=16, **kw)


def test_batch_tokens_equal_engine_generate_batch():
    got = serve.main(BASE)
    engine = _engine()
    spec = DP.spec_for(engine.cfg, ShapeSpec("cli", "train", 16, 4))
    toks = DP.make_batch(spec, 12345)["tokens"]
    want = engine.generate_batch({"tokens": toks}, 5).tokens.numpy()
    np.testing.assert_array_equal(got, want)


def test_scheduler_tokens_equal_engine_generate():
    got = serve.main(BASE + SCHED)
    engine = _engine()
    spec = DP.spec_for(engine.cfg, ShapeSpec("cli", "train", 16, 4))
    reqs = serve.ragged_requests(spec, 4, 16, 5)
    assert sorted(len(r.tokens) for r in reqs) == [8, 11, 14, 16]
    want = engine.generate(reqs, max_slots=2, prompt_cap=16, gen_cap=5,
                           block_steps=2)
    assert {c.rid: c.tokens for c in got} == {c.rid: c.tokens for c in want}
    assert all(c.status == "ok" for c in got)


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))


def test_crash_exits_3_then_journal_restore_exits_0(tmp_path):
    """The reference's durability pair: a journaled run killed by a
    simulated crash at block boundary 2 exits 3; the restarted process
    (``--restore journal --strict``) exits 0 and prints the tokens of the
    uninterrupted run."""
    journal = str(tmp_path / "requests.jsonl")
    # 8 tokens a request: two requests are still decoding at the crash
    run = BASE + SCHED + ["--gen", "8"]
    args = run + ["--journal", journal]
    crashed = _run(args + ["--fault-plan", '{"crash": [2]}'], tmp_path)
    assert crashed.returncode == 3, crashed.stdout + crashed.stderr
    assert "state is durable" in crashed.stdout
    restored = _run(args + ["--restore", "journal", "--strict"], tmp_path)
    assert restored.returncode == 0, restored.stdout + restored.stderr
    assert re.search(r"recovered via journal: recoveries=1 "
                     r"replayed_tokens=[1-9]", restored.stdout)
    clean = {c.rid: c.tokens for c in serve.main(run)}
    printed = re.findall(r"req(\d+): prompt_len=\d+ finished_by=\w+ -> "
                         r"\[([\d, ]*)\]", restored.stdout)
    assert len(printed) == 2
    for rid, toks in printed:
        assert [int(t) for t in toks.split(",")] == clean[int(rid)]


def test_strict_exits_1_on_a_failed_request():
    with pytest.raises(SystemExit) as e:
        serve.main(BASE + SCHED + ["--strict", "--fault-plan",
                                   '{"reject": [1]}'])
    assert e.value.code == 1


def test_every_reference_flag_is_taken_with_help():
    """The reference's flags (read from its source) all parse here, each
    with a help string; the port adds ``--device``."""
    with open(REF_SERVE) as f:
        ref_flags = set(re.findall(r'add_argument\("(--[\w-]+)"', f.read()))
    parser = serve.build_parser()
    port = {a.option_strings[0]: a for a in parser._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert ref_flags <= set(port), ref_flags - set(port)
    assert set(port) - ref_flags == {"--device"}
    assert all(a.help for a in port.values())
    assert "by device" in port["--pallas"].help


@pytest.mark.parametrize("extra,item", [(["--tp", "2", "--mesh", "dryrun",
                                          "--arch", "granite-8b"],
                                         "item 19"),
                                        (["--sp", "2", "--mesh", "dryrun"],
                                         "item 19")])
def test_unported_flags_raise_naming_their_item(extra, item, capsys):
    """``--mesh dryrun`` (ROADMAP item 19, ported) no longer raises: it
    prints the sharded engine's collective audit and exits 0 when every
    all-reduce carries integer bytes (granite-8b's SMOKE heads divide by
    tp = 2; smollm-135m's 3 do not)."""
    with pytest.raises(SystemExit) as exc:
        serve.main(BASE + extra)
    out = capsys.readouterr().out
    assert exc.value.code == 0
    assert "int8_all_reduces_ok=True" in out and item not in out


@pytest.mark.parametrize("extra", [["--no-kv-int8"],
                                   ["--strategy", "speculative"],
                                   ["--fp"]], ids=lambda v: " ".join(v))
def test_sp_takes_the_references_modes(extra, capsys):
    """``--sp 2`` serves through ``ShardedEngine(sp=2)`` every mode and
    strategy the reference's CLI takes with it: the float KV cache, whose
    tokens are the sharded engine's, and the speculative strategy, whose
    tokens are greedy's; ``--fp`` is refused with the reference's usage
    error (its parser exits 2)."""
    from repro_torch.shard import ShardedEngine

    argv = BASE + ["--sp", "2"] + extra
    if extra == ["--fp"]:
        with pytest.raises(SystemExit) as e:
            serve.main(argv)
        assert e.value.code == 2
        assert "--tp/--sp shard the int8 engine" in capsys.readouterr().err
        return
    got = serve.main(argv)
    assert "sharded serving: sp=2" in capsys.readouterr().out
    kw = {"--no-kv-int8": dict(kv_int8=False)}.get(extra[0], {})
    engine = ShardedEngine.from_checkpoint(
        "smollm-135m", smoke=True, device="cpu", sp=2, calib_batch=4,
        calib_len=16, **kw)
    spec = DP.spec_for(engine.cfg, ShapeSpec("cli", "train", 16, 4))
    toks = DP.make_batch(spec, 12345)["tokens"]
    want = engine.generate_batch({"tokens": toks}, 5).tokens.numpy()
    np.testing.assert_array_equal(got, want)


def test_pallas_is_accepted_and_ignored():
    np.testing.assert_array_equal(serve.main(BASE + ["--pallas"]),
                                  serve.main(BASE))
