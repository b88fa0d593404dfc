"""Rank-per-shard serving: ``ShardedEngine`` on a rank mesh of gloo CPU
ranks (``dist.ranks.run_ranks``: one spawned process per shard) against
the one-process ``ShardedEngine`` of the same shards, which
``test_torch_tp.py`` and ``test_torch_sharded_modes.py`` hold against the
reference.

The grid is the reference suite's: smollm-135m ``SMOKE`` at 4 heads over 2
KV heads, float32, thresholds calibrated on seeded numpy batches.  The
calibrated engine is written once (``save_serving``) and every rank
restores its slice (``from_serving``).  Each of tp=2 and sp=2 spawns its
ranks once for the module, and every rank runs all of its cases; a
third spawn checks that a rank that raises fails the run, and a fourth
that ranks past their deadline are stopped.  Every
comparison is exact: tokens, prefill and teacher-forced logits, the int32
sums of the reduces, the sp ranks' cache rows after prefill and after
the last step, and the scheduler's completions; the ranks run one
intra-op thread each, and so does the one-process engine here.
"""
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import api as TA
from repro_torch.dist import collectives as TC
from repro_torch.dist.ranks import run_ranks
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch.scheduler import Request
from repro_torch.shard import ShardedEngine

S, GEN, N = 16, 8, 2
# the sp prompt straddles the ranks' boundary (cache 128 rows, 64 each),
# and so does its middle chunk of 24, [48, 72)
SP_PROMPT, SP_CHUNK = 72, 24
GRID = dict(n_heads=4, n_kv_heads=2)


def _cfg():
    return get_config("smollm-135m", smoke=True).replace(dtype=torch.float32,
                                                         **GRID)


def _requests(toks):
    """The reference suite's three ragged requests: prompts of 16, 11 and
    9 tokens, 8 generated each."""
    return [Request(rid=r, tokens=toks[r % toks.shape[0], :n], max_gen=GEN)
            for r, n in enumerate([S, S - 5, 9])]


def _by_rid(done):
    return {c.rid: (c.status, [int(t) for t in c.tokens]) for c in done}


def _forced(engine, prompts, toks, sums):
    """Teacher-forced logits (prefill, then GEN - 1 decode steps fed
    ``toks``); ``sums`` collects the int32 sums of the reduces of the
    prefill and the first decode step."""
    real = TC.compressed_psum

    def recording(x, *, mean=True, group=None):
        y = real(x, mean=mean, group=group)
        sums.append(y.clone())
        return y

    with torch.inference_mode():
        p = prompts.shape[1]
        cache = engine.init_cache(prompts.shape[0], engine._cache_len(p, GEN))
        ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
        out = []
        for i in range(GEN):
            TC.compressed_psum = recording if i < 2 else real
            try:
                if i == 0:
                    logits, cache = engine.model.prefill(
                        engine.serve_params,
                        {"tokens": torch.from_numpy(prompts)}, cache, ctx)
                else:
                    logits, cache = engine.model.decode_step(
                        engine.serve_params, toks[:, i - 1:i], cache,
                        p + i - 1, ctx)
            finally:
                TC.compressed_psum = real
            out.append(logits[:, -1].float())
    return torch.stack(out)


def _kv(cache, n_layers):
    return [(cache[f"layer{i}"]["attn"].k.clone(),
             cache[f"layer{i}"]["attn"].v.clone()) for i in range(n_layers)]


def _sp_trace(engine, prompts, toks, chunk):
    """The attention caches after the prefill (one-shot, or in chunks of
    ``chunk``) and after GEN - 1 decode steps fed ``toks``."""
    b, p = prompts.shape
    n_layers = engine.cfg.n_layers
    with torch.inference_mode():
        cache = engine.init_cache(b, engine._cache_len(p, GEN))
        prefill = ST.make_prefill_step(engine.model, engine.policy,
                                       prefill_chunk=chunk, mode="int8")
        args = (torch.full((b,), p, dtype=torch.int32),) if chunk else ()
        _, cache = prefill(engine.serve_params, engine.qparams,
                           {"tokens": torch.from_numpy(prompts)}, cache,
                           *args)
        after_prefill = _kv(cache, n_layers)
        ctx = TA.make_ctx("int8", engine.policy, engine.qparams)
        for i in range(GEN - 1):
            _, cache = engine.model.decode_step(
                engine.serve_params, toks[:, i:i + 1], cache, p + i, ctx)
    return after_prefill, _kv(cache, n_layers)


def _everyone(mine, mesh):
    """Every rank's ``mine``, in rank order (on every rank)."""
    out = [None] * mesh.n
    dist.all_gather_object(out, mine)
    return out


def _tp_rank(mesh, directory, cfg, prompts, sched_toks):
    eng = ShardedEngine.from_serving(directory, cfg, mesh=mesh, tp=mesh.n,
                                     cache_layout="dense")
    ops.reset_launches()
    res = eng.generate_batch({"tokens": prompts}, gen=GEN)
    counts = dict(acc=ops.acc_launch_counts()["quant_matmul"],
                  **ops.reduce_counts())
    sums = []
    forced = _forced(eng, prompts, res.tokens, sums)
    done = eng.generate(_requests(sched_toks), max_slots=2, block_steps=3)
    return _everyone(dict(tokens=res.tokens, prefill=res.prefill_logits,
                          forced=forced, sums=sums, counts=counts,
                          done=_by_rid(done), eager=eng.eager_reason()),
                     mesh)


def _sp_rank(mesh, directory, cfg, prompts, tokens):
    """``tokens``: the one-process engine's, by chunk, which the traces
    feed."""
    mine = {}
    for chunk in (None, SP_CHUNK):
        eng = ShardedEngine.from_serving(directory, cfg, mesh=mesh,
                                         sp=mesh.n, cache_layout="dense",
                                         prefill_chunk=chunk)
        res = eng.generate_batch({"tokens": prompts}, gen=GEN)
        mine[chunk] = dict(tokens=res.tokens, prefill=res.prefill_logits,
                           caches=_sp_trace(eng, prompts, tokens[chunk],
                                            chunk))
    return _everyone(mine, mesh)


def _raise_on_rank1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()
    return "unreachable"


def _sleep(mesh, seconds):
    time.sleep(seconds)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The one-process engines (tp=2, sp=2 one-shot and chunked) and what
    they served, the calibrated engine written for the ranks, and what
    the ranks served."""
    cfg = _cfg()
    rng = np.random.default_rng(31)
    calib = [{"tokens": rng.integers(0, cfg.vocab, (4, 32), dtype=np.int32)}
             for _ in range(2)]
    prompts = rng.integers(0, cfg.vocab, (2, S), dtype=np.int32)
    sched_toks = rng.integers(0, cfg.vocab, (3, S), dtype=np.int32)
    sp_prompts = rng.integers(0, cfg.vocab, (2, SP_PROMPT), dtype=np.int32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tp = ShardedEngine.from_checkpoint(cfg=cfg, device="cpu", tp=N,
                                           cache_layout="dense",
                                           calib_batches=calib)
        directory = str(tmp_path_factory.mktemp("serving"))
        tp.save_serving(directory)
        ops.reset_launches()
        res = tp.generate_batch({"tokens": prompts}, gen=GEN)
        counts = dict(acc=ops.acc_launch_counts()["quant_matmul"],
                      **ops.reduce_counts())
        sums = []
        one = dict(tokens=res.tokens, prefill=res.prefill_logits,
                   forced=_forced(tp, prompts, res.tokens, sums), sums=sums,
                   counts=counts, done=_by_rid(tp.generate(
                       _requests(sched_toks), max_slots=2, block_steps=3)))
        sp_one = {}
        for chunk in (None, SP_CHUNK):
            sp = ShardedEngine(tp.base_model, cfg, tp.policy,
                               tp.serve_params, tp.qparams, device="cpu",
                               sp=N, cache_layout="dense",
                               prefill_chunk=chunk)
            r = sp.generate_batch({"tokens": sp_prompts}, gen=GEN)
            sp_one[chunk] = dict(tokens=r.tokens, prefill=r.prefill_logits,
                                 caches=_sp_trace(sp, sp_prompts, r.tokens,
                                                  chunk))
    finally:
        torch.set_num_threads(threads)
    ranks = dict(
        tp=run_ranks(_tp_rank, N, backend="gloo", device="cpu", threads=1,
                     args=(directory, cfg, prompts, sched_toks)),
        sp=run_ranks(_sp_rank, N, backend="gloo", device="cpu", threads=1,
                     args=(directory, cfg, sp_prompts,
                           {c: v["tokens"] for c, v in sp_one.items()})))
    return dict(tp=one, sp=sp_one, ranks=ranks, cfg=cfg)


def test_tp_ranks_serve_the_one_process_bits(served):
    """tp=2 ranks: every rank's greedy tokens, prefill logits and
    teacher-forced logits bit-identical to one-process ShardedEngine(tp=2);
    served uncaptured, with its reason."""
    want = served["tp"]
    for rank, got in enumerate(served["ranks"]["tp"]):
        assert torch.equal(got["tokens"], want["tokens"]), rank
        assert torch.equal(got["prefill"], want["prefill"]), rank
        assert torch.equal(got["forced"], want["forced"]), rank
        assert "uncaptured" in got["eager"]


def test_tp_rank_reduce_sums_and_counts(served):
    """Each rank's int32 reduce sums (prefill and first decode step) equal
    the one-process stacked form's; each rank launches B3's accumulator
    branch once per row layer and call, half the one-process launches, and
    counts the same reduces and wire bytes."""
    want = served["tp"]
    n_row = 2 * served["cfg"].n_layers
    assert len(want["sums"]) == 2 * n_row
    for rank, got in enumerate(served["ranks"]["tp"]):
        assert len(got["sums"]) == len(want["sums"]), rank
        for a, b in zip(got["sums"], want["sums"]):
            assert a.dtype == torch.int32 and torch.equal(a, b), rank
        assert got["counts"]["acc"] * N == want["counts"]["acc"], rank
        assert got["counts"]["reduces"] == want["counts"]["reduces"]
        assert got["counts"]["wire_bytes"] == want["counts"]["wire_bytes"]


def test_tp_ranks_scheduler_completions(served):
    """One SlotScheduler run of three ragged requests through 2 slots on
    the tp=2 ranks: the one-process engine's completions."""
    for rank, got in enumerate(served["ranks"]["tp"]):
        assert got["done"] == served["tp"]["done"], rank


@pytest.mark.parametrize("chunk", [None, SP_CHUNK], ids=["oneshot",
                                                         "chunked"])
def test_sp_ranks_tokens_and_cache_rows(served, chunk):
    """sp=2 ranks, one-shot and chunked (the chunk [48, 72) straddles the
    ranks' boundary at 64): tokens and prefill logits equal to one-process
    ShardedEngine(sp=2), and each rank's cache, after the prefill and after
    the last decode step, bit-identical to its rows of the one-process
    cache."""
    want = served["sp"][chunk]
    for rank, got in enumerate(served["ranks"]["sp"]):
        got = got[chunk]
        assert torch.equal(got["tokens"], want["tokens"]), rank
        assert torch.equal(got["prefill"], want["prefill"]), rank
        for stage in range(2):
            for layer, ((k, v), (gk, gv)) in enumerate(zip(
                    got["caches"][stage], want["caches"][stage])):
                rows = slice(rank * k.shape[1], (rank + 1) * k.shape[1])
                assert k.shape[1] * N == gk.shape[1]
                assert torch.equal(k, gk[:, rows]), (rank, stage, layer)
                assert torch.equal(v, gv[:, rows]), (rank, stage, layer)
        # both ranks hold written rows
        assert got["caches"][0][0][0].abs().sum() > 0, rank


def test_a_rank_that_raises_fails_the_run():
    """Rank 1 raises while rank 0 waits in a collective: the run raises
    (whichever rank's error the join reports first: rank 1's own, or rank
    0's broken connection to it) and returns nothing."""
    with pytest.raises(Exception, match="terminated with the following "
                       "error"):
        run_ranks(_raise_on_rank1, N, backend="gloo", device="cpu",
                  threads=1)


def test_ranks_past_their_deadline_are_stopped():
    """Ranks that outlast ``timeout`` are terminated and the run raises
    TimeoutError, well before their own end."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still ran"):
        run_ranks(_sleep, N, backend="gloo", device="cpu", threads=1,
                  args=(120.0,), timeout=1.0)
    assert time.monotonic() - t0 < 60
