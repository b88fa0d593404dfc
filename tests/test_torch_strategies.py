"""The port's decoding strategies (``launch/strategies.py``): sampled and
speculative decoding against the reference on the CPU, with the same
weights (``bridge.params_from_jax``) and thresholds.  The reference runs
with ``use_pallas=True`` (its kernels in interpret mode), as the other
parity tests do.

  * Sampling: ``sample_tokens``, the Engine and the scheduler give the
    reference's tokens.  Tie rule (the only allowed difference): where the
    two picks differ, the port's own perturbed scores (logits / T, top-p
    filtered, plus the Gumbel noise) put them within ``TIE`` of each
    other (the Gumbel noise's ``log`` may round an ulp away from XLA's,
    and the reference's compiled loop divides by T as a multiply by 1/T),
    or one of them has exclusive probability mass within ``BOUNDARY`` of
    top_p (the two packages' float32 cumsums run in other orders).  After
    a row's first difference its streams diverge, so the rest of that row
    is not compared.  Scheduler streams also must not depend on arrival
    order, exactly.
  * Speculative decoding: engine and scheduler tokens equal the port's
    greedy tokens and the reference's ``SpeculativeStrategy`` tokens
    exactly; the strategy's loop on the reference's cyclic stub (full
    acceptance, EOS inside a window, the capacity guard) gives the
    reference's tokens, emissions, positions and history.
  * ``verify_step``: at s = 1 bit-equal to ``decode_step`` at vector
    positions; at the verify window's shapes its logits against the
    reference's (B2's plain version against the Pallas prefill kernel)
    within ``VERIFY_ATOL``, and its cache writes bit for bit.
  * Cache writes: multi-token ``append_slots`` (the dense window's start
    clamp, the paged window across a page boundary and past the capacity,
    masked rows) and ``PagedCache.rollback(private_row=)`` bit-equal to
    the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import DenseCache as JDense
from repro.cache import PagedCache as JPaged
from repro.cache import paged as jpaged
from repro.configs import get_config as jax_config
from repro.core import api as JA
from repro.launch import strategies as JSG
from repro.launch.engine import Engine as JaxEngine
from repro.launch.scheduler import Request as JRequest
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.cache import DenseCache, PagedCache, layer_caches
from repro_torch.cache import paged as tpaged
from repro_torch.configs import get_config as torch_config
from repro_torch.core import api as A
from repro_torch.launch import prng
from repro_torch.launch import steps as ST
from repro_torch.launch import strategies as SG
from repro_torch.launch.engine import Engine
from repro_torch.launch.scheduler import Request

GEN, S = 8, 16
T, TOP_P, SEED = 0.7, 0.9, 3
TIE = 1e-5          # perturbed scores this close may order either way
BOUNDARY = 1e-5     # exclusive mass this close to top_p may fall either side
VERIFY_ATOL = 1e-4  # float32 logits, B2's plain version vs Pallas interpret


# -- the engines -------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The reference Engine (``use_pallas=True``, float32 smoke config,
    sampling knobs) and the port's Engine on its weights and thresholds."""
    jcfg = jax_config("smollm-135m", smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config("smollm-135m", smoke=True).replace(
        dtype=torch.float32)
    rng = np.random.default_rng(11)
    calib = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (4, 32),
                                                 dtype=np.int32))}
             for _ in range(2)]
    ref = JaxEngine.from_checkpoint(cfg=jcfg, use_pallas=True,
                                    cache_layout="dense", calib_batches=calib,
                                    temperature=T, top_p=TOP_P, seed=SEED)
    params = jax.tree.map(np.asarray, jax_build(jcfg).init(
        jax.random.PRNGKey(0)))
    ours = Engine.from_checkpoint(
        cfg=tcfg, params=bridge.params_from_jax(params), device="cpu",
        qparams=bridge.qparams_from_jax(jax.tree.map(np.asarray,
                                                     ref.qparams)),
        temperature=T, top_p=TOP_P, seed=SEED)
    prompts = rng.integers(0, jcfg.vocab, (2, S), dtype=np.int32)
    return ref, ours, prompts


def _twin(engine, **kw):
    base = dict(device=engine.device, mode=engine.mode)
    return Engine(engine.model, engine.cfg, engine.policy,
                  engine.serve_params, engine.qparams, **{**base, **kw})


def _jtwin(engine, **kw):
    return JaxEngine(engine.model, engine.cfg, engine.policy,
                     engine.serve_params, engine.qparams, mode=engine.mode,
                     **kw)


# -- the tie rule -------------------------------------------------------------

def _near_tie(logits, noise, a, b):
    """Whether picks ``a`` and ``b`` of one row are a near-tie of the port's
    perturbed scores (see the module docstring)."""
    lg = logits.astype(np.float32) / np.float32(T)
    order = np.argsort(-lg, kind="stable")
    e = np.exp(lg[order].astype(np.float64) - lg[order[0]])
    p = e / e.sum()
    cum = np.empty_like(p)
    cum[order] = np.cumsum(p) - p
    thresh = lg[order][cum[order] < TOP_P].min()
    score = np.where(lg >= thresh, lg, -np.inf) + noise
    return (abs(score[a] - score[b]) <= TIE
            or min(abs(cum[a] - TOP_P), abs(cum[b] - TOP_P)) <= BOUNDARY)


def _check_rows(got, want, logits, noise):
    """``got`` == ``want`` row by row, or the first difference of a row is
    a near-tie (the row is not compared after it); ``logits``/``noise``
    give each step's (row-indexable) values, teacher-forced on ``want``."""
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size:
            i = diff[0]
            assert _near_tie(logits(r, i), noise(r, i), got[r, i],
                             want[r, i]), (r, i, got[r], want[r])


def _forced_logits(engine, prompt, toks):
    """The port's float32 logits (B, n, V) for prompt (B, S) then ``toks``
    (B, n) fed back, eager: step i's row is what picked ``toks[:, i]``."""
    with torch.inference_mode():
        ctx = A.make_ctx(engine.mode, engine.policy, engine.qparams)
        b, s = prompt.shape
        cache = engine.init_cache(b, engine._cache_len(s, toks.shape[1]))
        logits, cache = engine.model.prefill(
            engine.serve_params, {"tokens": torch.as_tensor(prompt)}, cache,
            ctx)
        out = [logits[:, -1].float()]
        for i in range(toks.shape[1] - 1):
            logits, cache = engine.model.decode_step(
                engine.serve_params, torch.as_tensor(toks[:, i:i + 1]),
                cache, s + i, ctx)
            out.append(logits[:, -1].float())
    return torch.stack(out, dim=1).numpy()


def _engine_noise(b, v, n):
    """The single-stream schedule's noise: one split of PRNGKey(seed) a
    token, the second half sampling over (B, V)."""
    key, out = prng.PRNGKey(SEED), []
    for _ in range(n):
        ks = prng.split(key)
        key = ks[0]
        out.append(prng.gumbel(ks[1], (b, v)).numpy())
    return np.stack(out, axis=1)


def _request_noise(rid, v, n):
    """A scheduler request's noise: fold_in(PRNGKey(seed), rid) split into
    the first token's key and the carried key, which splits once a step
    (its first half sampling over (V,))."""
    ks = prng.split(prng.fold_in(prng.PRNGKey(SEED), rid))
    out, carry = [prng.gumbel(ks[0], (1, v))[0].numpy()], ks[1]
    for _ in range(n - 1):
        ks = prng.split(carry)
        out.append(prng.gumbel(ks[0], (v,)).numpy())
        carry = ks[1]
    return np.stack(out)


# -- sampling ----------------------------------------------------------------

@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
@pytest.mark.parametrize("per_row", [False, True])
def test_sample_tokens_match_reference(top_p, per_row):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((6, 512)) * 4).astype(np.float32)
    if per_row:
        keys = jax.random.split(jax.random.PRNGKey(1), 6)
        want = jax.vmap(lambda l, k: JSG.sample_tokens(
            l[None], k, temperature=T, top_p=top_p)[0])(
            jnp.asarray(logits), keys)
        key = torch.from_numpy(np.asarray(keys).astype(np.int64))
        noise = prng.gumbel(key, (512,)).numpy()
    else:
        jkey = jax.random.PRNGKey(1)
        want = JSG.sample_tokens(jnp.asarray(logits), jkey, temperature=T,
                                 top_p=top_p)
        key = torch.from_numpy(np.asarray(jkey).astype(np.int64))
        noise = prng.gumbel(key, (6, 512)).numpy()
    got = SG.sample_tokens(torch.from_numpy(logits), key, temperature=T,
                           top_p=top_p).numpy()
    want = np.asarray(want)
    if top_p == TOP_P:
        _check_rows(got[:, None], want[:, None],
                    lambda r, i: logits[r], lambda r, i: noise[r])
    else:
        assert np.array_equal(got, want)
    # temperature 0 is argmax
    assert np.array_equal(SG.sample_tokens(torch.from_numpy(logits), key,
                                           temperature=0.0).numpy(),
                          logits.argmax(-1))


@pytest.mark.parametrize("loop", [False, True])
def test_engine_sampling_matches_reference(pair, loop):
    ref, ours, prompts = pair
    want = np.asarray(ref.generate_batch({"tokens": jnp.asarray(prompts)},
                                         gen=GEN, loop=loop).tokens)
    got = ours.generate_batch({"tokens": prompts}, gen=GEN, loop=loop)
    got = got.tokens.numpy()
    if not np.array_equal(got, want):
        lg = _forced_logits(ours, prompts, want)
        noise = _engine_noise(*lg.shape[::2], GEN)
        _check_rows(got, want, lambda r, i: lg[r, i],
                    lambda r, i: noise[r, i])
    # the programs and the eager driver draw the same keys: bit for bit
    other = ours.generate_batch({"tokens": prompts}, gen=GEN, loop=not loop)
    assert np.array_equal(other.tokens.numpy(), got)
    # another seed, other tokens
    again = _twin(ours, temperature=T, top_p=TOP_P, seed=SEED + 1)
    assert not np.array_equal(
        again.generate_batch({"tokens": prompts}, gen=GEN).tokens.numpy(),
        got)


def _requests(vocab, rng):
    return [(i, rng.integers(0, vocab, n, dtype=np.int32))
            for i, n in enumerate((5, 13, 9, 16, 11))]


def test_scheduler_sampling_matches_reference_in_any_order(pair):
    ref, ours, _ = pair
    reqs = _requests(ours.cfg.vocab, np.random.default_rng(12))
    want = {c.rid: c.tokens for c in ref.generate(
        [JRequest(rid=i, tokens=t, max_gen=GEN) for i, t in reqs],
        max_slots=2, block_steps=3)}
    runs = []
    for order, slots in ((reqs, 2), (reqs[::-1], 3)):
        runs.append({c.rid: c.tokens for c in ours.generate(
            [Request(rid=i, tokens=t, max_gen=GEN) for i, t in order],
            max_slots=slots, block_steps=3)})
    assert runs[0] == runs[1]
    for i, prompt in reqs:
        got, exp = np.asarray(runs[0][i]), np.asarray(want[i])
        if not np.array_equal(got, exp):
            lg = _forced_logits(ours, prompt[None], exp[None])[0]
            noise = _request_noise(i, lg.shape[-1], GEN)
            _check_rows(got[None], exp[None], lambda r, j: lg[j],
                        lambda r, j: noise[j])


# -- speculative decoding ----------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_speculative_matches_greedy_and_reference(pair, layout):
    ref, ours, prompts = pair
    kw = dict(cache_layout=layout, page_size=8,
              prefill_chunk=8 if layout == "paged" else None)
    spec = _twin(ours, decode_strategy="speculative", spec_k=3, **kw)
    greedy = _twin(ours, **kw)
    ref_spec = _jtwin(ref, decode_strategy="speculative", spec_k=3, **kw)
    # a repetitive prompt: prompt lookup finds matches, windows accept
    rep = np.tile(prompts[:, :4], 4)
    for p in (prompts, rep):
        got = spec.generate_batch({"tokens": p}, gen=GEN).tokens.numpy()
        assert np.array_equal(
            got, greedy.generate_batch({"tokens": p}, gen=GEN).tokens.numpy())
        assert np.array_equal(got, np.asarray(ref_spec.generate_batch(
            {"tokens": jnp.asarray(p)}, gen=GEN).tokens))
    with pytest.raises(ValueError, match="no speculative variant"):
        spec.generate_batch({"tokens": prompts}, gen=GEN, loop=True)
    assert spec._cache_len(S, GEN + 3) >= S + GEN + 3


def test_scheduler_speculative_matches_greedy_and_reference(pair):
    ref, ours, _ = pair
    rng = np.random.default_rng(13)
    reqs = _requests(ours.cfg.vocab, rng)
    reqs.append((5, np.tile(reqs[1][1][:3], 5)))     # lookup hits
    kw = dict(cache_layout="paged", page_size=8, prefill_chunk=8)
    spec = _twin(ours, decode_strategy="speculative", spec_k=3, **kw)
    greedy = _twin(ours, **kw)
    ref_spec = _jtwin(ref, decode_strategy="speculative", spec_k=3, **kw)

    def run(eng, req_cls):
        return {c.rid: list(c.tokens) for c in eng.generate(
            [req_cls(rid=i, tokens=t, max_gen=GEN) for i, t in reqs],
            max_slots=2, block_steps=3)}

    got = run(spec, Request)
    assert got == run(greedy, Request)
    assert got == run(ref_spec, JRequest)
    stats = spec._scheduler.spec_stats()
    assert stats["verify_windows"] > 0 and stats["draft_k"] == 3
    assert stats == ref_spec._scheduler.spec_stats()
    assert greedy._scheduler.spec_stats() == {}


class _CyclicStub:
    """The reference suite's stub (tests/test_strategies.py): logits are a
    one-hot of (token + 1) % cycle, so greedy text is periodic and prompt
    lookup drafts are accepted once the cycle repeats."""

    def __init__(self, vocab, cycle, xp):
        self.vocab, self.cycle, self.xp = vocab, cycle, xp

    def _logits(self, tokens):
        nxt = (tokens + 1) % self.cycle
        if self.xp is jnp:
            return jax.nn.one_hot(nxt, self.vocab) * 10.0
        return torch.nn.functional.one_hot(nxt, self.vocab).float() * 10.0

    def decode_step(self, params, tokens, cache, cur_pos, ctx=None, *,
                    slot_mask=None):
        return self._logits(tokens), cache

    verify_step = decode_step


@dataclasses.dataclass
class _StubCache:
    capacity: int

    def rollback(self, pos, private_row=None):
        return self


def _stub_loops(n_steps, k, eos_id, cache_len):
    """The reference's and the port's slot loop on the cyclic stub, from
    the same history (the periodic text, the pending token at position
    10)."""
    cfg = jax_config("smollm-135m", smoke=True)
    hist = np.tile((np.arange(cache_len) + 1) % 8, (2, 1)).astype(np.int32)
    hist[:, 11:] = 0
    pos0, tok0 = np.array([10, 10], np.int32), np.array([3, 3], np.int32)
    jmodel = _CyclicStub(16, 8, jnp)
    jstrat = JSG.SpeculativeStrategy(jmodel, cfg, JA.QuantPolicy(),
                                     mode="none", draft_k=k, ngram=2)
    want = JSG.make_strategy_slot_loop(
        jmodel, cfg, JA.QuantPolicy(), jstrat, mode="none", n_steps=n_steps,
        eos_id=eos_id)(None, {}, jnp.asarray(tok0),
                       {"attn": {"k": jnp.zeros((2, cache_len, 1, 1))}},
                       jnp.asarray(pos0), jnp.ones((2,), bool), None,
                       jnp.asarray(hist))
    tmodel = _CyclicStub(16, 8, torch)
    tstrat = SG.SpeculativeStrategy(tmodel, A.QuantPolicy(), mode="none",
                                    draft_k=k, ngram=2)
    got = SG.make_strategy_slot_loop(
        tmodel, A.QuantPolicy(), tstrat, n_steps=n_steps, eos_id=eos_id)(
        None, {}, torch.from_numpy(tok0).long(),
        {"layer0": {"attn": _StubCache(cache_len)}}, torch.from_numpy(pos0),
        torch.ones(2, dtype=torch.bool), None,
        torch.from_numpy(hist).long())
    for i in (0, 1, 3, 4, 6, 7):     # toks, emitted, pos, active, hist, bad
        assert np.array_equal(got[i].numpy(), np.asarray(want[i])), i
    return got


def test_speculative_full_acceptance_windows():
    toks, emitted, _, pos, active, _, hist, _ = _stub_loops(2, 4, -1, 64)
    want = [(4 + i) % 8 for i in range(10)]
    assert emitted.all() and toks[0].tolist() == want
    assert pos.tolist() == [20, 20] and hist[0, 11:21].tolist() == want


def test_speculative_eos_mid_window_holds_the_eos():
    toks, emitted, _, pos, active, _, _, _ = _stub_loops(2, 4, 6, 64)
    assert toks[0, :3].tolist() == [4, 5, 6]
    assert emitted[0].tolist() == [True] * 3 + [False] * 7
    assert not active[0] and int(pos[0]) == 13
    # the frozen slot's held token is its EOS: the second window repeats it
    assert toks[0, 5:].tolist() == [6] * 5


def test_speculative_capacity_guard_before_a_partial_window():
    _, emitted, _, pos, active, _, _, _ = _stub_loops(2, 4, -1, 17)
    assert emitted[0].tolist() == [True] * 5 + [False] * 5
    assert int(pos[0]) == 15 and not active[0]


def test_speculative_strategy_knobs_and_errors(pair):
    _, ours, _ = pair
    m, pol = ours.model, ours.policy
    with pytest.raises(ValueError, match="draft_k"):
        SG.make_strategy("speculative", m, pol, spec_k=0)
    with pytest.raises(ValueError, match="ngram"):
        SG.make_strategy("speculative", m, pol, spec_ngram=0)
    with pytest.raises(ValueError, match="temperature must be 0"):
        SG.make_strategy("speculative", m, pol, temperature=0.5)
    with pytest.raises(ValueError, match="ignores temperature"):
        SG.make_strategy("greedy", m, pol, temperature=0.5)
    with pytest.raises(ValueError, match="unknown decode strategy"):
        SG.make_strategy("beam", m, pol)
    assert SG.make_strategy("speculative", m, pol, spec_k=3).emit_width == 4
    assert isinstance(SG.make_strategy(None, m, pol, temperature=0.1),
                      SG.SamplingStrategy)


# -- the verify step ---------------------------------------------------------

def _prefilled(engine, prompts, cache_len, **layout):
    with torch.inference_mode():
        cache = engine.init_cache(prompts.shape[0], cache_len, **layout)
        ctx = A.make_ctx(engine.mode, engine.policy, engine.qparams)
        logits, cache = engine.model.prefill(
            engine.serve_params, {"tokens": torch.as_tensor(prompts)}, cache,
            ctx)
    return cache, ctx, logits[:, -1].argmax(-1)


def _clone(cache):
    return {k: {"attn": dataclasses.replace(
        v["attn"], k=v["attn"].k.clone(), v=v["attn"].v.clone(),
        **({"table": v["attn"].table.clone()}
           if v["attn"].layout == "paged" else {}))}
        for k, v in cache.items()}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_verify_s1_is_decode_bit_for_bit(pair, kv):
    """A one-token window IS per-slot decode: the same rotary, append and
    mask; over a float cache the same contractions (both plain), over a
    quantized one B2's and B1's plain versions.  Logits and caches equal
    bit for bit, an inactive slot included."""
    _, ours, prompts = pair
    eng = _twin(ours) if kv == "int8" else Engine.from_checkpoint(
        "smollm-135m", smoke=True, device="cpu", fp=True, kv_int8=False)
    cache, ctx, tok0 = _prefilled(eng, prompts, S + GEN)
    pos = torch.full((2,), S, dtype=torch.int32)
    mask = torch.tensor([True, False])
    with torch.inference_mode():
        c_d, c_v = _clone(cache), _clone(cache)
        lg_d, c_d = eng.model.decode_step(eng.serve_params, tok0[:, None],
                                          c_d, pos, ctx, slot_mask=mask)
        lg_v, c_v = eng.model.verify_step(eng.serve_params, tok0[:, None],
                                          c_v, pos, ctx, slot_mask=mask)
    assert torch.equal(lg_d, lg_v)
    for a, b in zip(layer_caches(c_d), layer_caches(c_v)):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("bits", [8, 4])
def test_verify_window_matches_reference(pair, bits, layout):
    """A 4-token window at per-slot positions (one row crossing a page
    boundary, one inactive): the port's logits (B2's plain version) against
    the reference's fused verify (the Pallas prefill kernel's per-row
    q_start, interpret mode); the cache writes bit for bit."""
    ref, ours, _ = pair
    # the same weights and thresholds, the KV cache at ``bits``
    jpol = dataclasses.replace(ref.policy, kv_bits=bits)
    teng = Engine(ours.model, ours.cfg,
                  dataclasses.replace(ours.policy, kv_bits=bits),
                  ours.serve_params, ours.qparams, device="cpu")
    rng = np.random.default_rng(bits)
    b, cap = 3, 64
    prompt = rng.integers(0, ours.cfg.vocab, (b, 12), dtype=np.int32)
    window = rng.integers(0, ours.cfg.vocab, (b, 4), dtype=np.int32)
    pos = np.array([12, 6, 9], np.int32)      # row 1 crosses a page of 8
    mask = np.array([True, True, False])
    lay = dict(layout=layout, page_size=8) if layout == "paged" else {}
    cache, ctx, _ = _prefilled(teng, prompt, cap, **lay)
    with torch.inference_mode():
        lg, cache = teng.model.verify_step(
            teng.serve_params, torch.from_numpy(window).long(), cache,
            torch.from_numpy(pos), ctx, slot_mask=torch.from_numpy(mask))
    jcache = ref.model.init_cache(b, cap, ref.cfg.dtype, kv_int8=True,
                                  kv_bits=bits, layout=layout, page_size=8)
    jctx = JSG._serve_ctx("int8", jpol, ref.qparams)
    _, jcache = ref.model.prefill(ref.serve_params,
                                  {"tokens": jnp.asarray(prompt)}, jcache,
                                  jctx)
    jlg, jcache = ref.model.verify_step(
        ref.serve_params, jnp.asarray(window), jcache, jnp.asarray(pos),
        jctx, slot_mask=jnp.asarray(mask))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                               atol=VERIFY_ATOL)
    for i, c in enumerate(layer_caches(cache)):
        jc = jcache[f"layer{i}"]["attn"]
        assert np.array_equal(c.k.numpy(), np.asarray(jc.k))
        assert np.array_equal(c.v.numpy(), np.asarray(jc.v))


# -- multi-token cache writes and the paged rewind ---------------------------

def _tiles(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_multi_token_append_slots_match_reference(layout):
    rng = np.random.default_rng(3)
    b, cap, kvh, d, s = 4, 32, 2, 8, 3
    if layout == "dense":
        jc = JDense.init(b, cap, kvh, d, dtype=jnp.int8, quantized=True)
        tc = DenseCache.init(b, cap, kvh, d)
    else:
        jc = JPaged.init(b, cap, kvh, d, quantized=True, page_size=8)
        tc = PagedCache.init(b, cap, kvh, d, page_size=8)
        table = rng.permutation(b * 4).reshape(b, 4).astype(np.int32)
        for r in range(b):
            jc = jpaged.set_table_row(jc, r, table[r])
            tpaged.set_table_row(tc, r, table[r])
    jc = dataclasses.replace(jc, k=jnp.asarray(_tiles(rng, jc.k.shape)),
                             v=jnp.asarray(_tiles(rng, jc.v.shape)))
    tc.k.copy_(_t(jc.k))
    tc.v.copy_(_t(jc.v))
    # in range; across a page boundary; at the end (dense: clamped to
    # cap - s; paged: the positions past it clamp to the last slot); masked
    for starts, active in (([0, 6, 14, 29], [True, True, True, True]),
                           ([7, 30, 31, 3], [True, True, False, False]),
                           ([5, 9, 12, 40], [False, True, True, False])):
        k, v = _tiles(rng, (b, s, kvh, d)), _tiles(rng, (b, s, kvh, d))
        st, act = np.asarray(starts, np.int32), np.asarray(active)
        if layout == "paged" and act[st + s > cap].any():
            continue        # an active window past a paged cache: no caller
        jc = jc.append_slots(jnp.asarray(k), jnp.asarray(v), jnp.asarray(st),
                             active=jnp.asarray(act))
        tc.append_slots(_t(k), _t(v), _t(st), active=_t(act))
        assert np.array_equal(tc.k.numpy(), np.asarray(jc.k))
        assert np.array_equal(tc.v.numpy(), np.asarray(jc.v))


@pytest.mark.parametrize("pos", [2, 8, 13])
def test_paged_rollback_private_row_matches_reference(pos):
    """Slot 0's blocks 0 and 1 point at shared pages; a rewind to ``pos``
    (inside block 0, at its end, inside block 1) copies the boundary page
    into the slot's private page and re-points the rewound blocks; the
    shared pages stay as they were."""
    rng = np.random.default_rng(pos)
    ps, nb = 8, 4
    jc = JPaged.init(2, nb * ps, 1, 8, quantized=True, page_size=ps,
                     extra_pages=3)
    jc = dataclasses.replace(jc, k=jnp.asarray(_tiles(rng, jc.k.shape)),
                             v=jnp.asarray(_tiles(rng, jc.v.shape)))
    tc = PagedCache.init(2, nb * ps, 1, 8, page_size=ps, extra_pages=3)
    tc.k.copy_(_t(jc.k))
    tc.v.copy_(_t(jc.v))
    private = np.arange(2 * nb, dtype=np.int32).reshape(2, nb)
    row = private[0].copy()
    row[:2] = [2 * nb, 2 * nb + 1]
    jc = jpaged.set_table_row(jc, 0, row)
    tpaged.set_table_row(tc, 0, row)
    shared = tc.k[2 * nb:].clone()
    at = np.array([pos, 5], np.int32)
    jc = jc.rollback(jnp.asarray(at), private_row=jnp.asarray(private))
    assert tc.rollback(_t(at), private_row=_t(private)) is tc
    for a, b in ((tc.k, jc.k), (tc.v, jc.v), (tc.table, jc.table)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert torch.equal(tc.k[2 * nb:], shared)


# -- the steps module's wrappers ---------------------------------------------

def test_sampled_slot_loop_keys_advance_only_on_active_slots(pair):
    _, ours, prompts = pair
    cache, _, tok0 = _prefilled(ours, prompts, S + GEN)
    keys = prng.split(prng.PRNGKey(SEED), 2)
    loop = ST.make_slot_decode_loop(ours.model, ours.policy, n_steps=3,
                                    temperature=T, top_p=TOP_P)
    with torch.inference_mode():
        toks, emitted, _, pos, active, key = loop(
            ours.serve_params, ours.qparams, tok0, cache,
            torch.full((2,), S, dtype=torch.int32),
            torch.tensor([True, False]), keys)
    carry = keys[0]
    for _ in range(3):
        carry = prng.split(carry)[1]
    assert torch.equal(key[0], carry) and torch.equal(key[1], keys[1])
    assert emitted[0].all() and not emitted[1].any()
    assert pos.tolist() == [S + 3, S]
