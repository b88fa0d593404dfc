"""The sliding-window ring cache and the layout rules around it, against the
reference: ``repro_torch.cache.RingCache`` slot for slot against
``repro.cache.RingCache`` (one-shot writes shorter than, equal to and
longer than the window, single-token writes that wrap, ``abs_positions``,
int8 and packed int4 tiles, ``state_dict`` in both directions),
``make_cache``'s choice of layout, the constraints that raise with the
reference's messages, and the slot scheduler over the new configs: the
same completions as the reference's for granite-8b, and the reference's
refusal of gemma3-12b's windows.  Every comparison here is of integers or
of layouts: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import RingCache as JRing
from repro.cache import make_cache as jax_make_cache
from repro.configs import get_config as jax_config
from repro.launch.engine import Engine as JaxEngine
from repro.launch.scheduler import Request as JRequest
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.cache import LAYOUTS, RingCache, make_cache
from repro_torch.cache.base import QuantizedKV
from repro_torch.configs import get_config as torch_config
from repro_torch.launch.engine import Engine
from repro_torch.launch.scheduler import Request, SlotScheduler

W, B, KV, D = 8, 2, 2, 16


def _tiles(rng, s, bits):
    """(B, s, KV, D) int8 tiles, or (B, s, KV, D/2) bytes of packed int4
    nibbles (any byte value)."""
    width = D if bits == 8 else D // 2
    return rng.integers(-128, 128, (B, s, KV, width), dtype=np.int8)


def _pair(bits):
    return (RingCache.init(B, W, KV, D, bits=bits),
            JRing.init(B, W, KV, D, dtype=jnp.bfloat16, quantized=True,
                       bits=bits))


def _same(ours, ref):
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(ours, key).numpy(),
                                      np.asarray(getattr(ref, key)),
                                      err_msg=key)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("s", [5, W, 13, 3 * W + 3])
def test_one_shot_write_then_wrapping_tokens(s, bits):
    """A prompt of s tokens (shorter than, equal to, longer than the window,
    and longer than two windows), then 2 window's worth of single tokens
    that wrap around the ring: every slot equals the reference's after
    every write."""
    rng = np.random.default_rng(s + bits)
    ours, ref = _pair(bits)
    k, v = _tiles(rng, s, bits), _tiles(rng, s, bits)
    ours = ours.append(torch.from_numpy(k), torch.from_numpy(v), 0)
    ref = ref.append(jnp.asarray(k), jnp.asarray(v), 0)
    _same(ours, ref)
    for p in range(s, s + 2 * W):
        k, v = _tiles(rng, 1, bits), _tiles(rng, 1, bits)
        ours = ours.append(torch.from_numpy(k), torch.from_numpy(v), p)
        ref = ref.append(jnp.asarray(k), jnp.asarray(v), p)
        _same(ours, ref)
        np.testing.assert_array_equal(ours.abs_positions(p).numpy(),
                                      np.asarray(ref.abs_positions(p)))


def test_device_position_writes_the_int_positions_slots():
    """The captured decode step writes at a (B,) device position: the same
    slots as the int position, and the same ``abs_positions`` rows."""
    rng = np.random.default_rng(7)
    a, _ = _pair(8)
    b, _ = _pair(8)
    for p in range(0, 3 * W):
        k, v = _tiles(rng, 1, 8), _tiles(rng, 1, 8)
        a.append(torch.from_numpy(k), torch.from_numpy(v), p)
        b.append(torch.from_numpy(k), torch.from_numpy(v),
                 torch.full((B,), p, dtype=torch.int32))
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
        pos = b.abs_positions(torch.full((B,), p, dtype=torch.int32))
        assert pos.shape == (B, W)
        assert torch.equal(pos, a.abs_positions(p).expand(B, W))


@pytest.mark.parametrize("bits", [8, 4])
def test_state_dict_round_trips_across_packages(bits):
    """The port's ``state_dict`` rebuilds the reference's ring, and the
    reference's the port's, under the layout name "ring"; in place too."""
    rng = np.random.default_rng(bits)
    ours, ref = _pair(bits)
    k, v = _tiles(rng, 11, bits), _tiles(rng, 11, bits)
    scale = rng.random(KV).astype(np.float32) + 0.1
    ours = ours.with_scales(torch.from_numpy(scale),
                            torch.from_numpy(scale * 2))
    ours.append(torch.from_numpy(k), torch.from_numpy(v), 0)
    sd = ours.state_dict()
    assert sd["layout"] == "ring" and sd["static"]["bits"] == bits
    back = JRing.from_state_dict({**sd, "arrays": {
        n: a.numpy() for n, a in sd["arrays"].items()}})
    assert isinstance(back, JRing)
    _same(ours, back)
    again = QuantizedKV.from_state_dict(back.state_dict())
    assert isinstance(again, RingCache) and again.window == W
    _same(again, back)
    fresh = RingCache.init(B, W, KV, D, bits=bits)
    storage = fresh.k.data_ptr()
    fresh.load_state_dict_(back.state_dict())
    assert fresh.k.data_ptr() == storage
    _same(fresh, back)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("window,max_len", [(None, 64), (16, 64), (16, 16),
                                            (64, 16)])
def test_make_cache_picks_the_references_layout(layout, window, max_len):
    """A windowed layer shorter than the cache gets a ring of its window in
    the "ring" and "paged" layouts (never in "dense"), as in the
    reference."""
    ours = make_cache(B, max_len, KV, D, layout=layout, window=window,
                      page_size=8)
    ref = jax_make_cache(B, max_len, KV, D, dtype=jnp.bfloat16,
                         quantized=True, layout=layout, window=window,
                         page_size=8)
    assert ours.layout == type(ref).layout
    assert ours.capacity == ref.capacity


def test_ring_writes_and_reads_raise_as_the_references():
    ring = RingCache.init(B, W, KV, D)
    t = torch.zeros((B, 2, KV, D), dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="absolute slots"):
        ring.append_slots(t, t, torch.zeros(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="one-shot prompt write"):
        ring.append(t, t, 3)


@pytest.fixture(scope="module")
def gemma3():
    return Engine.from_checkpoint("gemma3-12b", smoke=True, device="cpu",
                                  prefill_chunk=8)


def test_windowed_paths_raise_with_the_references_messages(gemma3):
    """Chunked prefill into a ring, per-slot decode over a ring and a verify
    window over a ring raise, as the reference's do; speculative decoding
    serves the ring default through dense caches (the reference's fallback)
    and gives greedy's tokens."""
    prompts = np.random.default_rng(2).integers(0, 256, (2, 24),
                                                dtype=np.int32)
    # chunks within the window reach the layer, which raises; a longer
    # prompt meets the step's check of the first layer's capacity first
    # (the reference's order too)
    with pytest.raises(ValueError, match="chunked prefill needs absolute"):
        gemma3.generate_batch({"tokens": prompts[:, :8]}, gen=3)
    with pytest.raises(ValueError, match="exceeds the cache length 16"):
        gemma3.generate_batch({"tokens": prompts}, gen=3)
    eng = Engine(gemma3.model, gemma3.cfg, gemma3.policy,
                 gemma3.serve_params, gemma3.qparams, device="cpu")
    assert eng.cache_layout == "ring"
    from repro_torch.core import api as TA

    ctx = TA.make_ctx("int8", eng.policy, eng.qparams)
    with torch.inference_mode():
        cache = eng.init_cache(2, 64)
        _, cache = eng.model.prefill(
            eng.serve_params, {"tokens": torch.from_numpy(prompts)}, cache,
            ctx)
        tok = torch.zeros((2, 1), dtype=torch.long)
        with pytest.raises(ValueError, match="per-slot decode"):
            eng.model.decode_step(eng.serve_params, tok, cache,
                                  torch.full((2,), 24, dtype=torch.int32),
                                  ctx, slot_mask=torch.ones(2, dtype=bool))
        with pytest.raises(ValueError, match="speculative verify needs"):
            eng.model.verify_step(eng.serve_params, tok.expand(2, 3), cache,
                                  torch.full((2,), 24, dtype=torch.int32),
                                  ctx)
    greedy = eng.generate_batch({"tokens": prompts}, gen=6)
    spec = Engine(eng.model, eng.cfg, eng.policy, eng.serve_params,
                  eng.qparams, device="cpu", decode_strategy="speculative",
                  spec_k=3).generate_batch({"tokens": prompts}, gen=6)
    assert torch.equal(spec.tokens, greedy.tokens)


def test_scheduler_refuses_windows_as_the_reference(gemma3):
    """The reference's slot scheduler refuses a stack with sliding-window
    layers (its rings drop absolute slots); so does the port's, with the
    same message, in every layout."""
    jcfg = jax_config("gemma3-12b", smoke=True)
    ref = JaxEngine.from_checkpoint(cfg=jcfg)
    reqs = [JRequest(rid=0, tokens=np.ones(4, np.int32), max_gen=2)]
    with pytest.raises(ValueError) as want:
        ref.generate(reqs, max_slots=1)
    for layout in ("ring", "dense", "paged"):
        with pytest.raises(ValueError) as got:
            SlotScheduler(gemma3.model, gemma3.cfg, gemma3.policy,
                          gemma3.serve_params, gemma3.qparams,
                          cache_layout=layout)
        assert str(got.value) == str(want.value)


def test_scheduler_matches_reference_on_granite():
    """granite-8b (no windows): the ring default serves as dense in both
    schedulers, and 4 ragged requests through 2 slots complete identically
    (float32, the reference's thresholds bridged)."""
    jcfg = jax_config("granite-8b", smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config("granite-8b", smoke=True).replace(dtype=torch.float32)
    rng = np.random.default_rng(9)
    calib = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (4, 32),
                                                 dtype=np.int32))}
             for _ in range(2)]
    ref = JaxEngine.from_checkpoint(cfg=jcfg, use_pallas=True,
                                    calib_batches=calib, prefill_chunk=8)
    params = bridge.params_from_jax(jax.tree.map(
        np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0))))
    ours = Engine.from_checkpoint(
        cfg=tcfg, params=params, device="cpu", prefill_chunk=8,
        qparams=bridge.qparams_from_jax(jax.tree.map(np.asarray,
                                                     ref.qparams)))
    prompts = [rng.integers(0, jcfg.vocab, (n,), dtype=np.int32)
               for n in (9, 20, 3, 14)]

    def summary(done):
        return sorted((c.rid, [int(t) for t in c.tokens], c.finished_by,
                       c.status) for c in done)

    kw = dict(max_slots=2, block_steps=3)
    want = summary(ref.generate([JRequest(rid=i, tokens=p, max_gen=5)
                                 for i, p in enumerate(prompts)], **kw))
    got = summary(ours.generate([Request(rid=i, tokens=p, max_gen=5)
                                 for i, p in enumerate(prompts)], **kw))
    assert got == want
    assert all(st == "ok" and len(t) == 5 for _, t, _, st in got)
    assert ours._scheduler.cache_layout == "dense"
