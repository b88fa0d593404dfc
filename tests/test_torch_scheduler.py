"""The port's continuous-batching scheduler against the reference's.

The reference is ``repro.launch.scheduler.SlotScheduler`` inside a JAX
``Engine`` built with ``use_pallas=True`` (its kernels in interpret mode,
the paged branches of both attention kernels on the decode and prefill
paths).  The port's engine serves the same weights with the reference's
calibrated thresholds, bridged, so its int8 weights and KV tiles are
bit-identical and the scheduler's completions (rid, tokens, finished_by,
status) must be identical, request for request.  Float32 throughout: the
comparison is of the scheduling and of the kernels' semantics, not of
bf16 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JaxEngine
from repro.launch.scheduler import Request as JRequest
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.cache import PagedCache, layer_caches
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import steps as TST
from repro_torch.launch.engine import Engine
from repro_torch.launch.scheduler import Request, SlotScheduler

PAGE, CHUNK, SLOTS, BLOCK = 8, 8, 2, 3
LENGTHS = (9, 20, 3, 17, 24)    # ragged prompts; 5 requests through 2 slots
GEN = 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def engines():
    """The reference Engine and the port's on the float32 smoke config, the
    port serving the reference's weights and calibrated thresholds."""
    jcfg = jax_config("smollm-135m", smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config("smollm-135m", smoke=True).replace(
        dtype=torch.float32)
    rng = np.random.default_rng(31)
    calib = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (4, 32),
                                                 dtype=np.int32))}
             for _ in range(2)]
    knobs = dict(cache_layout="paged", page_size=PAGE, prefill_chunk=CHUNK)
    ref = JaxEngine.from_checkpoint(cfg=jcfg, use_pallas=True,
                                    calib_batches=calib, **knobs)
    params = bridge.params_from_jax(_np(jax_build(jcfg).init(
        jax.random.PRNGKey(0))))
    ours = Engine.from_checkpoint(
        cfg=tcfg, params=params, device="cpu",
        qparams=bridge.qparams_from_jax(_np(ref.qparams)), **knobs)
    prompts = [rng.integers(0, jcfg.vocab, (n,), dtype=np.int32)
               for n in LENGTHS]
    return dict(ref=ref, ours=ours, prompts=prompts)


def _requests(prompts, cls, max_gen=GEN):
    return [cls(rid=i, tokens=p, max_gen=max_gen)
            for i, p in enumerate(prompts)]


def _summary(done):
    return sorted((c.rid, [int(t) for t in c.tokens], c.finished_by,
                   c.status) for c in done)


@pytest.fixture(scope="module")
def served(engines):
    """Both schedulers over the same ragged queue, paged and dense."""
    kw = dict(max_slots=SLOTS, block_steps=BLOCK)
    out = {"ref": engines["ref"].generate(
        _requests(engines["prompts"], JRequest), **kw)}
    for layout in ("paged", "dense"):
        eng = engines["ours"]
        if layout == "dense":
            eng = Engine(eng.model, eng.cfg, eng.policy, eng.serve_params,
                         eng.qparams, device="cpu", cache_layout="dense",
                         prefill_chunk=CHUNK)
        out[layout] = eng.generate(_requests(engines["prompts"], Request),
                                   **kw)
        out[f"{layout}_sched"] = eng._scheduler
    return out


def test_completions_identical_to_reference(served):
    want = _summary(served["ref"])
    assert len(want) == len(LENGTHS)
    assert all(len(t) == GEN and why == "budget" and st == "ok"
               for _, t, why, st in want)
    assert _summary(served["paged"]) == want


def test_dense_scheduler_matches_paged(served):
    assert _summary(served["dense"]) == _summary(served["paged"])


def test_scheduler_sizing_and_counts_match_reference(engines, served):
    ref = engines["ref"]._scheduler
    ours = served["paged_sched"]
    assert (ours.prompt_cap, ours.cache_len, ours.resume_cap) == (
        ref.prompt_cap, ref.cache_len, ref._resume_cap)
    assert isinstance(ours._cache["layer0"]["attn"], PagedCache)
    assert ours.call_counts() == ref.call_counts()
    assert ours.prefix_stats() == ref.prefix_stats()
    health = ours.health_stats()
    assert health["ok"] == health["budget"] == len(LENGTHS)


def test_prefix_sharing_one_prefill_and_private_tail(engines):
    """A repeated prompt whose last page is partial (27 = 3 pages of 8 and a
    tail of 3) admits once through prefill and once through the prefix
    store; the sharer's decode writes go to its private copy of the tail
    page, so both residents generate the tokens of a dense run, and the
    shared pages are never written."""
    eng = engines["ours"]
    prompt = np.random.default_rng(5).integers(0, 256, (27,), dtype=np.int32)
    reqs = [Request(rid=r, tokens=prompt, max_gen=GEN) for r in range(2)]
    sched = SlotScheduler(eng.model, eng.cfg, eng.policy, eng.serve_params,
                          eng.qparams, max_slots=SLOTS, prompt_cap=27,
                          gen_cap=GEN, prefill_chunk=CHUNK,
                          block_steps=BLOCK, cache_layout="paged",
                          page_size=PAGE)
    done = {c.rid: c for c in sched.run(reqs)}
    dense = SlotScheduler(eng.model, eng.cfg, eng.policy, eng.serve_params,
                          eng.qparams, max_slots=SLOTS, prompt_cap=27,
                          gen_cap=GEN, prefill_chunk=CHUNK,
                          block_steps=BLOCK)
    want = {c.rid: c for c in dense.run(reqs)}
    assert [done[r].tokens for r in (0, 1)] == [want[r].tokens
                                                for r in (0, 1)]
    assert done[0].tokens == done[1].tokens
    assert sched.call_counts()["prefill"] == 1
    stats = sched.prefix_stats()
    assert stats["hits"] == 1 and stats["shared_tokens"] == 27
    # the sharer's table row: three shared pages, then its own pages
    entry = next(iter(sched._prefix._entries.values()))["entry"]
    assert entry.tail_page is not None and len(entry.pages) == 3
    cache = sched._cache["layer0"]["attn"]
    row1 = cache.table[1].tolist()
    assert row1[:3] == list(entry.pages)
    assert row1[3:] == sched._private_rows[1][3:].tolist()
    # the shared tail snapshot holds the prompt's 3 tail tokens and none of
    # the decode writes after them; both residents wrote the same tokens
    # into their own copies of the tail page
    k_shared = cache.k[entry.tail_page]
    k_slot0 = cache.k[int(sched._private_rows[0][3])]
    k_slot1 = cache.k[int(sched._private_rows[1][3])]
    assert torch.equal(k_shared[:3], k_slot0[:3])
    assert not torch.equal(k_shared[3:], k_slot0[3:])
    assert torch.equal(k_slot1, k_slot0)


def test_prefix_store_hits_across_runs(engines):
    """The scheduler (and its prefix store) persists across generate calls:
    the same prompt served again is all hits."""
    eng = engines["ours"]
    prompt = engines["prompts"][1]
    first = eng.generate([Request(rid=0, tokens=prompt, max_gen=GEN)],
                         max_slots=SLOTS, block_steps=BLOCK)
    sched = eng._scheduler
    before = sched.call_counts()["prefill"]
    again = eng.generate([Request(rid=r, tokens=prompt, max_gen=GEN)
                          for r in (1, 2)], max_slots=SLOTS,
                         block_steps=BLOCK)
    assert eng._scheduler is sched
    assert sched.call_counts()["prefill"] == before
    assert all(c.tokens == first[0].tokens for c in again)


@pytest.fixture(scope="module")
def slot_loop(engines):
    """Two slots admitted at different lengths, ready for one decode block:
    (engine, cache, tok0, pos0) on a dense 2-slot cache."""
    eng = engines["ours"]
    prompts = engines["prompts"][:2]
    with torch.inference_mode():
        cache = eng.init_cache(2, 128, layout="dense")
        toks = torch.zeros((2, 24), dtype=torch.long)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = torch.from_numpy(p)
        lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
        logits, cache = TST.make_prefill_step(
            eng.model, eng.policy, prefill_chunk=CHUNK)(
            eng.serve_params, eng.qparams, {"tokens": toks}, cache, lengths)
    return eng, cache, logits[:, -1].argmax(-1), lengths


def _copy(cache):
    return {k: {"attn": dataclasses.replace(
        v["attn"], k=v["attn"].k.clone(), v=v["attn"].v.clone())}
        for k, v in cache.items()}


def test_eos_mid_block_freezes_one_slot(slot_loop):
    eng, cache, tok0, pos0 = slot_loop
    n = 6
    active = torch.ones(2, dtype=torch.bool)
    with torch.inference_mode():
        free = TST.make_slot_decode_loop(eng.model, eng.policy, n_steps=n)(
            eng.serve_params, eng.qparams, tok0, _copy(cache), pos0, active)
        toks = free[0]
        # slot 0's third token is the EOS; slot 1 must never emit it
        eos = int(toks[0, 2])
        assert eos not in toks[1].tolist() and eos not in toks[0, :2].tolist()
        got = TST.make_slot_decode_loop(eng.model, eng.policy, n_steps=n,
                                        eos_id=eos)(
            eng.serve_params, eng.qparams, tok0, _copy(cache), pos0, active)
    g_toks, g_emit, _, g_pos, g_active, _ = got
    assert g_emit[0].tolist() == [True] * 3 + [False] * (n - 3)
    assert g_toks[0, :3].tolist() == toks[0, :3].tolist()
    assert g_emit[1].all() and torch.equal(g_toks[1], toks[1])
    assert g_active.tolist() == [False, True]
    assert g_pos.tolist() == [int(pos0[0]) + 3, int(pos0[1]) + n]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_all_inactive_block_leaves_cache_unchanged(slot_loop, layout):
    eng, dense, tok0, pos0 = slot_loop
    with torch.inference_mode():
        cache = eng.init_cache(2, 128, layout=layout, page_size=PAGE)
        for big, small in zip(layer_caches(cache), layer_caches(dense)):
            if layout == "dense":
                big.k.copy_(small.k)
                big.v.copy_(small.v)
            else:
                big.k.copy_(small.k.reshape(big.k.shape))
                big.v.copy_(small.v.reshape(big.v.shape))
            big.k_scale, big.v_scale = small.k_scale, small.v_scale
        before = [(c.k.clone(), c.v.clone()) for c in layer_caches(cache)]
        toks, emitted, cache, pos, active, _ = TST.make_slot_decode_loop(
            eng.model, eng.policy, n_steps=3)(
            eng.serve_params, eng.qparams, tok0, cache, pos0,
            torch.zeros(2, dtype=torch.bool))
    assert not emitted.any() and not active.any()
    assert torch.equal(pos, pos0)
    for (k, v), c in zip(before, layer_caches(cache)):
        assert torch.equal(k, c.k) and torch.equal(v, c.v)


def test_requests_validated_and_unported_knobs_raise(engines):
    eng = engines["ours"]
    done = eng.generate([Request(rid=0, tokens=np.zeros(0, np.int32)),
                         Request(rid=1, tokens=np.ones(4, np.int32),
                                 max_gen=0),
                         Request(rid=2, tokens=np.ones(4, np.int32),
                                 max_gen=2)],
                        max_slots=SLOTS, prompt_cap=8, block_steps=BLOCK)
    by = {c.rid: c for c in done}
    assert by[0].status == by[1].status == "rejected"
    assert by[2].status == "ok" and len(by[2].tokens) == 2
    # the bounded queue (ROADMAP item 14) is ported: a cap of 1 sheds the
    # arrivals beyond it, and a cap below 1 raises as in the reference
    sched = SlotScheduler(eng.model, eng.cfg, eng.policy, eng.serve_params,
                          eng.qparams, queue_cap=1, max_slots=1,
                          prompt_cap=8, prefill_chunk=CHUNK,
                          block_steps=BLOCK)
    shed = {c.rid: c.status for c in sched.run(
        [Request(rid=r, tokens=np.ones(4, np.int32), max_gen=2)
         for r in range(3)])}
    assert shed == {0: "ok", 1: "shed", 2: "shed"}
    with pytest.raises(ValueError, match="queue_cap must be >= 1"):
        SlotScheduler(eng.model, eng.cfg, eng.policy, eng.serve_params,
                      eng.qparams, queue_cap=0)
    # speculative decoding is ported; its knobs are validated as in the
    # reference
    with pytest.raises(ValueError, match="draft_k must be >= 1"):
        SlotScheduler(eng.model, eng.cfg, eng.policy, eng.serve_params,
                      eng.qparams, strategy="speculative", spec_k=0)
    with pytest.raises(ValueError, match="dense or paged"):
        SlotScheduler(eng.model, eng.cfg, eng.policy, eng.serve_params,
                      eng.qparams, cache_layout="ragged")
