"""The port stands alone: it imports neither JAX nor the reference package,
its entry points default to CUDA and raise without it, and the options it
does not port raise instead of being ignored (the options and request
fields that ROADMAP item 14 ported are taken and act)."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.launch import engine as E

SRC = os.path.dirname(os.path.dirname(repro_torch.__file__))


def test_no_module_imports_jax_or_repro():
    mods = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                        "repro_torch."))
    assert {"repro_torch.kernels.ops", "repro_torch.cache.paged",
            "repro_torch.launch.scheduler",
            "repro_torch.launch.strategies", "repro_torch.launch.prng",
            "repro_torch.kernels.decode_attention_partials",
            "repro_torch.shard", "repro_torch.shard.context",
            "repro_torch.shard.partial_softmax", "repro_torch.shard.model",
            "repro_torch.shard.engine", "repro_torch.checkpoint.manager",
            "repro_torch.data.pipeline", "repro_torch.launch.train",
            "repro_torch.kernels.fake_quant",
            "repro_torch.configs.shapes", "repro_torch.core.folding",
            "repro_torch.core.equalization", "repro_torch.bench",
            "repro_torch.bench.run", "repro_torch.bench.dws_model",
            "repro_torch.launch.serve", "repro_torch.examples",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.serve_int8",
            "repro_torch.examples.train_fat_qat",
            "repro_torch.analysis", "repro_torch.analysis.__main__",
            "repro_torch.analysis.report", "repro_torch.analysis.record",
            "repro_torch.analysis.dtype_drift",
            "repro_torch.analysis.budgets",
            "repro_torch.analysis.kernel_contracts",
            "repro_torch.analysis.donation",
            "repro_torch.analysis.entrypoints",
            "repro_torch.analysis.cost", "repro_torch.launch.specs",
            "repro_torch.launch.dryrun"} <= set(mods)
    assert len(mods) >= 69
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro',\n"
        "             'benchmarks') or m.startswith(('jax.', 'jaxlib',\n"
        "             'repro.', 'benchmarks.')))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.Engine.from_checkpoint("smollm-135m", smoke=True)
    engine = E.Engine.from_checkpoint("smollm-135m", smoke=True,
                                      device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.to(None)


@pytest.mark.parametrize("kw,item", [
    (dict(queue_cap=8), "item 14"),
    (dict(journal="requests.jsonl"), "item 14"),
    (dict(sp=2, kv_int8=False), "item 20"),
], ids=lambda v: str(v))
def test_unported_options_raise(kw, item, tmp_path):
    """Options of ROADMAP items that the port once refused are taken now.
    Item 14's: the engine hands the option to its scheduler, which acts on
    it (a cap of 8 sheds the 2 arrivals beyond it; the journal records the
    run).  Item 20's, a float KV cache under sequence parallelism: the
    sharded engine serves the requests through its scheduler over a float
    cache split into two shards."""
    from repro_torch.launch.scheduler import Request
    from repro_torch.shard import ShardedEngine

    if "journal" in kw:
        kw = dict(journal=str(tmp_path / kw["journal"]))
    cls = ShardedEngine if "sp" in kw else E.Engine
    engine = cls.from_checkpoint("smollm-135m", smoke=True, device="cpu",
                                 **kw)
    reqs = [Request(rid=r, tokens=np.full(4, r + 1, np.int32), max_gen=1)
            for r in range(10)]
    done = engine.generate(reqs, max_slots=1, block_steps=2)
    sched = engine._scheduler
    statuses = [c.status for c in done]
    if "queue_cap" in kw:
        assert sched.queue_cap == 8
        assert statuses.count("shed") == 2 and statuses.count("ok") == 8
        return
    assert statuses == ["ok"] * 10
    if "sp" in kw:
        cache = engine.init_cache(1, 64)["layer0"]["attn"]
        assert engine.sp == 2 and not cache.quantized
        assert item == "item 20"
        return
    replay = sched._journal.replay()
    assert replay.knobs == sched._knobs()
    assert sorted(d["rid"] for d in replay.done) == list(range(10))


@pytest.mark.parametrize("kw,strategy", [
    (dict(temperature=0.7), "SamplingStrategy"),
    (dict(top_p=0.9), "GreedyStrategy"),
    (dict(decode_strategy="speculative"), "SpeculativeStrategy"),
], ids=lambda v: str(v))
def test_sampling_and_speculative_options_build(kw, strategy):
    """The reference's decoding knobs (ROADMAP items 10 and 13) build an
    engine with the reference's strategy; ``top_p`` alone stays greedy."""
    engine = E.Engine.from_checkpoint("smollm-135m", smoke=True,
                                      device="cpu", **kw)
    assert type(engine._strategy).__name__ == strategy
    for name, value in kw.items():
        assert getattr(engine, name) == value


@pytest.mark.parametrize("kw", [dict(deadline_ms=50.0), dict(priority=1)],
                         ids=["deadline_ms", "priority"])
def test_unported_request_fields_raise(kw):
    """ROADMAP item 14 ported both fields: a request takes them and the
    scheduler acts on them on the virtual clock (10 ms a block).  A second
    request arriving at 10 ms behind an 8-token one in the one slot times
    out 50 ms after its arrival, or, at a higher priority, preempts it."""
    from repro_torch.launch.scheduler import Request

    engine = E.Engine.from_checkpoint("smollm-135m", smoke=True,
                                      device="cpu",
                                      fault_plan={"ms_per_block": 10.0})
    reqs = [Request(rid=0, tokens=np.ones(4, np.int32), max_gen=8),
            Request(rid=1, tokens=np.arange(1, 5, dtype=np.int32),
                    max_gen=8, arrive_ms=10.0, **kw)]
    assert all(getattr(reqs[1], k) == v for k, v in kw.items())
    done = {c.rid: c for c in engine.generate(reqs, max_slots=1,
                                              block_steps=2)}
    health = engine.health_report()
    if "priority" in kw:
        assert health["preemptions"] == health["readmits"] == 1
        assert [done[r].status for r in (0, 1)] == ["ok", "ok"]
        assert list(done) == [1, 0]
    else:
        assert done[1].status == "timeout" and done[0].status == "ok"
        assert health["deadline_misses"] == 1


def test_every_reference_arch_builds():
    """Every architecture of the reference package is ported: its config,
    full and smoke, field for field (the dtype's type aside), and its model
    at SMOKE with the reference's parameter tree, keys and shapes (the
    encoder-decoder an ``EncDecLM`` with a cross attention in every decoder
    layer, the VLM with its ``mm_proj``); an unknown arch raises."""
    import dataclasses

    import jax

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core import api as A
    from repro_torch.models import build_model
    from repro_torch.models.model import CausalLM, EncDecLM

    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for arch in JAX_ARCHS:
        for smoke in (False, True):
            want = dataclasses.asdict(jax_config(arch, smoke=smoke))
            got = dataclasses.asdict(get_config(arch, smoke=smoke))
            want.pop("dtype"), got.pop("dtype")
            assert got == want, arch
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        assert isinstance(model, EncDecLM if cfg.family == "encdec"
                          else CausalLM)
        want = A.flatten(jax.eval_shape(jax_build(jax_config(
            arch, smoke=True)).init, jax.random.PRNGKey(0)))
        got = A.flatten(model.init(torch.Generator().manual_seed(0)))
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}, arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-4")


def test_generate_validates_inputs():
    engine = E.Engine.from_checkpoint("smollm-135m", smoke=True,
                                      device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        engine.generate_one(np.zeros((2, 3), np.int32), gen=2)
    with pytest.raises(ValueError, match="gen"):
        engine.generate_batch({"tokens": np.zeros((1, 3), np.int32)}, gen=0)
