"""The port's single-dispatch serving programs (``launch/graphs.py``) on
the CPU.

On a CUDA device ``Engine.generate_batch`` captures its prefill and one
greedy decode step as CUDA graphs and the scheduler its admission prefill
and its decode block; on the CPU the same step functions run eagerly.
These tests hold, at the smoke size:

  (a) the programs' tokens and prefill logits against the eager
      ``generate_batch(loop=True)`` driver, bit for bit, in every serving
      mode (int8, int4 KV, the three bf16 modes), dense and paged, one-shot
      and chunked prefill: the captured step decodes through the per-slot
      branch (positions read on the device), the driver through the scalar
      branch (a host int);
  (b) that each captured step reads nothing back to the host and makes no
      tensor from host data (a dispatch mode that fails on
      ``_local_scalar_dense``, ``nonzero``, ``is_nonzero`` and
      ``lift_fresh``; the kernels' plain versions in ``kernels/ref.py`` are
      exempt, since on the card the kernels run there);
  (c) the launch accounting of a capture and its replays;
  (d) that the decode kernel's counter buffers are never freed once
      handed out;
  (e) that the cached rotary table and attention scale are today's bits;
  (f) that ``generate_batch(loop=True)`` (and the default) still equal the
      reference Engine with ``use_pallas=True`` on shared thresholds.

The card's half (the graphs themselves) is ``chip_smoke.py``'s
``[graphs]`` phase.
"""
import contextlib
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JaxEngine
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.analysis import HostReadGuard, guarded
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ops
from repro_torch.launch import graphs
from repro_torch.launch.engine import Engine
from repro_torch.launch.scheduler import Request
from repro_torch.models import attention as ATT
from repro_torch.models import layers as LAY
from repro_torch.shard import ShardedEngine

GEN = 6
PROMPT = 13                     # not a chunk multiple: the pad is masked
CHUNK, PAGE = 8, 8
MODES = {"int8": dict(),
         "int4": dict(kv_bits=4),
         "bf16_w_bf16_kv": dict(fp=True, kv_int8=False),
         "bf16_w_int8_kv": dict(fp=True),
         "int8_w_bf16_kv": dict(kv_int8=False)}
# (cache layout, prefill chunk): one-shot dense, chunked dense and paged
LAYOUTS = {"dense": ("dense", None), "dense-chunked": ("dense", CHUNK),
           "paged": ("paged", CHUNK)}


@pytest.fixture(scope="module")
def engines():
    """One smoke engine per serving mode (seeded random weights, its own
    calibration), on the CPU."""
    return {name: Engine.from_checkpoint("smollm-135m", smoke=True,
                                         device="cpu", **kw)
            for name, kw in MODES.items()}


def _twin(engine, layout, **strategy):
    cache_layout, chunk = LAYOUTS[layout]
    return Engine(engine.model, engine.cfg, engine.policy,
                  engine.serve_params, engine.qparams, device=engine.device,
                  mode=engine.mode, cache_layout=cache_layout,
                  page_size=PAGE, prefill_chunk=chunk, **strategy)


# the decoding strategies beside greedy (launch/strategies.py)
SCHEMES = {"sample": dict(temperature=0.7, top_p=0.9, seed=3),
           "speculative": dict(decode_strategy="speculative", spec_k=3)}


def _prompts(engine, b=2, s=PROMPT, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, engine.cfg.vocab, (b, s), dtype=np.int32)


# -- (a) the programs against the eager driver ---------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", list(MODES))
def test_programs_bit_identical_to_eager_loop(engines, mode, layout):
    eng = _twin(engines[mode], layout)
    prompts = _prompts(eng)
    want = eng.generate_batch({"tokens": prompts}, gen=GEN, loop=True)
    got = eng.generate_batch({"tokens": prompts}, gen=GEN)
    assert want.compile_s == 0.0 and got.compile_s == 0.0   # nothing captured
    assert got.tokens.dtype == want.tokens.dtype == torch.long
    assert torch.equal(got.prefill_logits, want.prefill_logits)
    assert torch.equal(got.tokens, want.tokens)
    # the same shape again reuses the programs and their static cache
    prog = eng._program
    again = eng.generate_batch({"tokens": _prompts(eng, seed=6)}, gen=GEN)
    assert eng._program is prog
    other = eng.generate_batch({"tokens": _prompts(eng, seed=6)}, gen=GEN,
                               loop=True)
    assert torch.equal(again.prefill_logits, other.prefill_logits)
    assert torch.equal(again.tokens, other.tokens)


def test_program_kept_per_shape(engines):
    eng = _twin(engines["int8"], "dense")
    eng.generate_batch({"tokens": _prompts(eng)}, gen=GEN)
    first = eng._program
    assert first.key == (2, PROMPT, eng._cache_len(PROMPT, GEN), ("greedy",))
    eng.generate_batch({"tokens": _prompts(eng, b=3)}, gen=GEN)
    assert eng._program is not first and eng._program.key[0] == 3


def test_sp_engine_serves_eagerly_by_its_branch(engines):
    """``sp`` > 1 names its ROADMAP entry and runs its programs uncaptured,
    the same tokens and logits as the eager per-token ``loop=True``."""
    base = engines["int8"]
    eng = ShardedEngine(base.model, base.cfg, base.policy, base.serve_params,
                        base.qparams, device="cpu", sp=2)
    assert "item 9d" in eng.eager_reason()
    prompts = _prompts(eng)
    got = eng.generate_batch({"tokens": prompts}, gen=GEN)
    want = eng.generate_batch({"tokens": prompts}, gen=GEN, loop=True)
    assert eng._program.prefill.graph is None
    assert eng._program.decode.graph is None
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.prefill_logits, want.prefill_logits)
    assert eng.make_scheduler(max_slots=2)._capture is False
    assert ShardedEngine(base.model, base.cfg, base.policy, base.serve_params,
                         base.qparams, device="cpu",
                         sp=1).eager_reason() is None


# -- (b) no host reads inside a step ---------------------------------------

# ``HostReadGuard`` fails on any op that reads a tensor back to the host or
# makes one from host data; ``guarded()`` runs a block under it with the
# plain kernel versions of ``kernels/ref.py`` exempt
# (``repro_torch.analysis.budgets``, where the analysis sweep runs it over
# every Program's step).


@pytest.mark.parametrize("bad", ["item", "bool", "nonzero", "mask",
                                 "mask_put", "masked_select", "tensor",
                                 "from_numpy"])
def test_guard_catches_host_reads(monkeypatch, bad):
    x = torch.arange(6.0)
    ops_ = {"item": lambda: x.sum().item(), "bool": lambda: bool(x[0] > 0),
            "nonzero": lambda: torch.nonzero(x), "mask": lambda: x[x > 2],
            "mask_put": lambda: x.clone().__setitem__(x > 2, 0.0),
            "masked_select": lambda: torch.masked_select(x, x > 2),
            "tensor": lambda: x + torch.tensor(1.0),
            "from_numpy": lambda: x + torch.from_numpy(np.ones(6,
                                                                np.float32))}
    with pytest.raises(AssertionError, match="inside a captured step"):
        with guarded() as guard:
            assert isinstance(guard, HostReadGuard)
            ops_[bad]()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", ["int8", "int4", "bf16_w_bf16_kv",
                                  "int8_w_bf16_kv"])
def test_batch_steps_read_nothing_back(engines, monkeypatch, mode, layout):
    """The prefill (one-shot or chunked) and the greedy decode step that
    ``generate_batch`` captures."""
    eng = _twin(engines[mode], layout)
    with torch.inference_mode():
        prog = eng._batch_program((2, PROMPT, eng._cache_len(PROMPT, GEN)))
        prog.tokens[:, :PROMPT].copy_(torch.from_numpy(_prompts(eng)))
        prog.prefill()                  # a warm-up, as before a capture
        prog.decode()
        with guarded():
            prog.prefill()
            prog.decode()
            prog.decode()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_strategy_steps_read_nothing_back(engines, monkeypatch, scheme,
                                          layout):
    """The sampled decode step (its key split on the device) and the
    speculative verify window (the drafts' gathers, the history and
    output scatters) that ``generate_batch`` captures, with the prefill
    that samples or seeds the history."""
    eng = _twin(engines["int8"], layout, **SCHEMES[scheme])
    with torch.inference_mode():
        prog = eng._batch_program((2, PROMPT, eng._cache_len(PROMPT, GEN + 3),
                                   eng._scheme(GEN)))
        prog.tokens[:, :PROMPT].copy_(torch.from_numpy(_prompts(eng)))
        prog.prefill()
        prog.decode()
        with guarded():
            prog.prefill()
            prog.decode()
            prog.decode()
    assert (prog.window is None) == (scheme == "sample")


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_strategy_programs_bit_identical_to_eager_steps(engines, scheme):
    """The programs against the same steps run eagerly: the ``loop=True``
    driver for sampling (the same key splits), and the windowed loop
    (``make_strategy_decode_loop``) after the same prefill for
    speculative decoding."""
    from repro_torch.launch import prng
    from repro_torch.launch import steps as ST
    from repro_torch.launch import strategies as SG

    eng = _twin(engines["int8"], "dense", **SCHEMES[scheme])
    prompts = _prompts(eng)
    got = eng.generate_batch({"tokens": prompts}, gen=GEN)
    if scheme == "sample":
        want = eng.generate_batch({"tokens": prompts}, gen=GEN, loop=True)
        assert torch.equal(got.prefill_logits, want.prefill_logits)
        assert torch.equal(got.tokens, want.tokens)
        return
    with torch.inference_mode():
        toks = torch.from_numpy(prompts).long()
        cache = eng.init_cache(2, eng._cache_len(PROMPT, GEN + 3))
        logits, cache = ST.make_prefill_step(eng.model, eng.policy)(
            eng.serve_params, eng.qparams, {"tokens": toks}, cache)
        tok0 = logits[:, -1].argmax(-1)
        hist = SG.seed_hist(torch.zeros((2, cache["layer0"]["attn"].capacity),
                                        dtype=torch.long), toks, tok0)
        out, _ = SG.make_strategy_decode_loop(
            eng.model, eng.policy, eng._strategy, n_steps=GEN)(
            eng.serve_params, eng.qparams, tok0, cache, PROMPT,
            prng.PRNGKey(3), hist)
    assert torch.equal(got.tokens, out)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["int8", "int4", "bf16_w_bf16_kv"])
def test_scheduler_steps_read_nothing_back(engines, monkeypatch, mode,
                                           layout):
    """The scheduler's admission prefill and decode block, with live and
    idle slots."""
    eng = _twin(engines[mode], layout if layout == "paged" else
                "dense-chunked")
    sched = eng.make_scheduler(max_slots=3, prompt_cap=16, gen_cap=8,
                               block_steps=3)
    with torch.inference_mode():
        sched._programs()
        sched._adm_toks[0, :PROMPT].copy_(
            torch.from_numpy(_prompts(eng, b=1)[0]))
        sched._adm_len.fill_(PROMPT)
        sched._tok.copy_(torch.tensor([3, 4, 5]))
        sched._pos.copy_(torch.tensor([PROMPT, 5, 0], dtype=torch.int32))
        sched._active.copy_(torch.tensor([True, True, False]))
        sched._admission()
        sched._block()
        with guarded():
            sched._admission()
            sched._block()


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_scheduler_strategy_block_reads_nothing_back(engines, monkeypatch,
                                                    scheme):
    """The scheduler's sampled block (per-slot keys on the device) and its
    speculative block (per-slot windows, the history buffer), with live
    and idle slots."""
    eng = _twin(engines["int8"], "paged", **SCHEMES[scheme])
    sched = eng.make_scheduler(max_slots=3, prompt_cap=16, gen_cap=8,
                               block_steps=3)
    with torch.inference_mode():
        sched._programs()
        sched._tok.copy_(torch.tensor([3, 4, 5]))
        sched._pos.copy_(torch.tensor([PROMPT, 5, 0], dtype=torch.int32))
        sched._active.copy_(torch.tensor([True, True, False]))
        sched._keys.copy_(torch.arange(6).reshape(3, 2))
        sched._hist.random_(0, eng.cfg.vocab)
        sched._block()
        keys = sched._keys.clone()
        with guarded():
            sched._block()
    # an idle slot keeps its key; a live one advances it when sampling
    assert torch.equal(sched._keys[2], keys[2])
    assert torch.equal(sched._keys[0], keys[0]) == (scheme != "sample")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_scheduler_faulted_block_and_resume_read_nothing_back(
        engines, monkeypatch, layout):
    """A fault plan's decode NaN is the block's ``nan_step`` buffer (data),
    and the re-admission prefill is a program at ``resume_cap``: neither
    reads back to the host.  The NaN freezes only its slot."""
    eng = _twin(engines["int8"], layout if layout == "paged" else
                "dense-chunked")
    sched = eng.make_scheduler(max_slots=3, prompt_cap=16, gen_cap=8,
                               block_steps=3)
    with torch.inference_mode():
        sched._programs()
        resume = sched._resume_program()
        sched._res_toks[0, :PROMPT + 2].copy_(torch.from_numpy(
            _prompts(eng, b=1, s=PROMPT + 2)[0]))
        sched._res_len.fill_(PROMPT + 2)
        sched._tok.copy_(torch.tensor([3, 4, 5]))
        sched._pos.copy_(torch.tensor([PROMPT, 5, 0], dtype=torch.int32))
        sched._active.copy_(torch.tensor([True, True, False]))
        sched._nan_step.copy_(torch.tensor([1, -1, 0], dtype=torch.int32))
        resume()
        with guarded():
            resume()
            toks, emitted, pos, active, bad = sched._block()
    assert sched._resume_program() is resume
    assert sched.executable_counts() == {"prefill": 1, "decode": 1,
                                         "resume": 1}
    assert bad.tolist() == [True, False, False]
    assert emitted[0].tolist() == [True, False, False]
    assert emitted[1].all() and not emitted[2].any()
    assert active.tolist() == [False, True, False]


# -- (c) launch accounting --------------------------------------------------

def test_launch_delta_arithmetic():
    from repro_torch.kernels import prefill_attention as _pa
    from repro_torch.kernels import quant_matmul as _qm

    saved = ops.launch_snapshot()
    try:
        ops.reset_launches()
        before = ops.launch_snapshot()
        assert set(before.values()) == {0}
        assert len(before) == len(ops.COUNTERS) == 19
        _qm.launches += 7
        _pa.launches += 2
        _pa.launches_paged += 2
        delta = ops.launch_delta(before, ops.launch_snapshot())
        assert delta == {("quant_matmul", "launches"): 7,
                         ("prefill_attention", "launches"): 2,
                         ("prefill_attention", "launches_paged"): 2}
        ops.add_launches(delta, -1)              # the capture launched none
        assert ops.launch_snapshot() == before
        for _ in range(3):                       # three replays
            ops.add_launches(delta)
        assert ops.launch_counts()["quant_matmul"] == 21
        assert ops.paged_launch_counts()["prefill_attention"] == 6
        assert ops.launch_counts()["decode_attention"] == 0
    finally:
        for (name, attr), n in saved.items():
            setattr(ops.COUNTED[name], attr, n)


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _fake_cuda(monkeypatch, fail_capture=False):
    """Let ``graphs.Program`` take its CUDA route on the CPU: streams,
    synchronize and the graph are stand-ins, so its accounting runs."""
    class Stream:
        def __init__(self, *a, **kw):
            pass

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def capture(graph, **kw):
        if fail_capture:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        yield

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_program_counts_warmup_and_replays(monkeypatch):
    from repro_torch.kernels import quant_matmul as _qm

    _fake_cuda(monkeypatch)
    saved = ops.launch_snapshot()
    calls = []

    def step():                     # a step whose wrappers launch 7 kernels
        calls.append(1)
        _qm.launches += 7
        return "out"

    try:
        ops.reset_launches()
        prog = graphs.Program(step, "cuda")
        # the warm-ups launched; the capture's 7 calls launched nothing
        assert graphs.WARMUP == 2
        assert len(calls) == 3 and _qm.launches == 14
        assert prog.launches == {("quant_matmul", "launches"): 7}
        assert [prog() for _ in range(3)] == ["out"] * 3
        assert len(calls) == 3 and prog.graph.replays == 3
        assert _qm.launches == 14 + 21
        eager = graphs.Program(step, "cuda", capture=False)
        assert eager.graph is None and eager() == "out" and len(calls) == 4
    finally:
        for (name, attr), n in saved.items():
            setattr(ops.COUNTED[name], attr, n)


def test_program_capture_failure_raises(monkeypatch):
    _fake_cuda(monkeypatch, fail_capture=True)
    calls = []
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.Program(lambda: calls.append(1), "cuda")
    assert len(calls) == graphs.WARMUP     # no eager step after the warm-up


def test_cpu_program_runs_eagerly():
    calls = []
    prog = graphs.Program(lambda: calls.append(1) or len(calls), "cpu")
    assert prog.graph is None and prog.capture_s == 0.0
    assert (prog(), prog()) == (1, 2)


# -- (d) the decode kernel's counter buffers --------------------------------

def test_counters_never_free_a_buffer(monkeypatch):
    monkeypatch.setattr(_da, "_COUNTERS", {})
    monkeypatch.setattr(_da, "_RETIRED", [])
    dev = torch.device("cpu")
    first = _da.counters(dev, 8)
    assert first.numel() == 1024 and not first.any()
    assert _da.counters(dev, 1024) is first
    alive = weakref.ref(first)
    ptr = first.data_ptr()
    del first
    bigger = _da.counters(dev, 4096)
    assert bigger.numel() == 4096 and _da.counters(dev, 100) is bigger
    # the replaced buffer is still allocated, at the same address
    assert alive() is not None and alive().data_ptr() == ptr
    assert [b.data_ptr() for b in _da._RETIRED] == [ptr]
    _da.counters(dev, 10_000)
    assert [b.numel() for b in _da._RETIRED] == [1024, 4096]


# -- (e) the rotary table and the attention scale ---------------------------

def _rotary_before(positions, head_dim, base):
    """``rotary_angles`` as it was: the table made on every call."""
    half = head_dim // 2
    freqs = 1.0 / (base ** (np.arange(0, half, dtype=np.float32) / half))
    freqs = torch.from_numpy(np.asarray(freqs, np.float32)).to(
        positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("head_dim", [8, 16, 64, 128])
@pytest.mark.parametrize("base", [10000.0, 500000.0])
def test_rotary_table_bits_unchanged(head_dim, base):
    pos = torch.arange(0, 700, 7)
    cos, sin = LAY.rotary_angles(pos, head_dim, base)
    want_cos, want_sin = _rotary_before(pos, head_dim, base)
    assert torch.equal(_bits(cos), _bits(want_cos))
    assert torch.equal(_bits(sin), _bits(want_sin))
    table = LAY.rotary_freqs(head_dim, base, pos.device)
    assert table is LAY.rotary_freqs(head_dim, base, pos.device)
    assert table.dtype == torch.float32 and not table.is_inference()


@pytest.mark.parametrize("d", [8, 16, 64, 96, 128])
def test_attention_scale_bits_unchanged(d):
    want = 1.0 / torch.sqrt(torch.tensor(float(d)))
    got = ATT.softmax_scale(d, torch.device("cpu"))
    assert got is ATT.softmax_scale(d, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(_bits(got.reshape(1)), _bits(want.reshape(1)))


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_rope_branches_rotate_by_the_same_bits(engines, b):
    """The scalar decode branch's (B, 1) host positions and the per-slot
    branch's device positions give the same rotated q and k."""
    attn = engines["int8"].model.stack.blocks[0].attn
    rng = np.random.default_rng(b)
    q = torch.from_numpy(rng.standard_normal(
        (b, 1, attn.n_kv, attn.groups, attn.head_dim), np.float32))
    k = torch.from_numpy(rng.standard_normal(
        (b, 1, attn.n_kv, attn.head_dim), np.float32))
    for p in (0, 13, 127, 639):
        q1, k1 = attn._rope(q, k, torch.full((b, 1), p))
        q2, k2 = attn._rope(q, k, torch.full((b,), p,
                                             dtype=torch.int32)[:, None])
        assert torch.equal(q1, q2) and torch.equal(k1, k2)


# -- (f) the eager driver and the default against the reference ------------

@pytest.fixture(scope="module")
def reference_pair():
    jcfg = jax_config("smollm-135m", smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config("smollm-135m", smoke=True).replace(
        dtype=torch.float32)
    rng = np.random.default_rng(11)
    calib = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (4, 32),
                                                 dtype=np.int32))}
             for _ in range(2)]
    ref_engine = JaxEngine.from_checkpoint(cfg=jcfg, use_pallas=True,
                                           cache_layout="dense",
                                           calib_batches=calib)
    params = jax.tree.map(np.asarray, jax_build(jcfg).init(
        jax.random.PRNGKey(0)))
    ours = Engine.from_checkpoint(
        cfg=tcfg, params=bridge.params_from_jax(params), device="cpu",
        qparams=bridge.qparams_from_jax(jax.tree.map(np.asarray,
                                                     ref_engine.qparams)))
    prompts = rng.integers(0, jcfg.vocab, (2, 16), dtype=np.int32)
    want = ref_engine.generate_batch({"tokens": jnp.asarray(prompts)},
                                     gen=GEN)
    return ours, prompts, np.asarray(want.tokens)


@pytest.mark.parametrize("loop", [True, False])
def test_generate_batch_matches_reference(reference_pair, loop):
    ours, prompts, ref_tokens = reference_pair
    got = ours.generate_batch({"tokens": prompts}, gen=GEN, loop=loop)
    np.testing.assert_array_equal(got.tokens.numpy(), ref_tokens)
    assert got.prefill_s > 0 and got.decode_s > 0 and got.compile_s == 0.0


def test_scheduler_programs_serve_requests(engines):
    """The scheduler through its programs: every request finishes by its
    budget, and a request served alone gives ``generate_batch``'s
    tokens."""
    eng = _twin(engines["int8"], "paged")
    rng = np.random.default_rng(9)
    reqs = [Request(rid=i, tokens=rng.integers(0, eng.cfg.vocab, n,
                                               dtype=np.int32), max_gen=GEN)
            for i, n in enumerate((5, 13, 9, 16))]
    done = eng.generate(reqs, max_slots=2, block_steps=3)
    assert sorted(c.rid for c in done) == [0, 1, 2, 3]
    assert all((c.status, c.finished_by, len(c.tokens)) == ("ok", "budget",
                                                            GEN)
               for c in done)
    sched = eng._scheduler
    assert sched.stage_seconds()["compile"] == 0.0
    assert sched._admission.graph is None and sched._block.graph is None
    alone = _twin(engines["int8"], "dense-chunked")
    for c in done:
        want = alone.generate_batch({"tokens": reqs[c.rid].tokens[None]},
                                    gen=GEN, loop=True).tokens[0].tolist()
        assert c.tokens == want, c.rid
