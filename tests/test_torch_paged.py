"""The port's paged KV cache, prefix store, paged attention and chunked
prefill against the reference.

  * Cache operations (``PagedCache`` writes and reads, the scheduler's
    page ops, ``DenseCache.append_slots``) move integer tiles only: they
    must be bit-identical to the reference's, at int8 and int4, through a
    shuffled block table.
  * ``PrefixStore`` is host bookkeeping: the same scripted run gives the
    same returns and counters.
  * The paged plain versions of the two attention kernels against the
    Pallas kernels (``decode_attention_tiles``, ``prefill_attention_tiles``)
    in interpret mode, with a permuted table that maps one page into two
    rows: float32 sums in another order, so to 1e-5 x (1 + max |out|).
  * End to end, a paged cache is storage indirection only: dense and paged
    logits and tokens are bit-identical in the port, one-shot and chunked;
    the chunked engine's tokens equal the reference's (``use_pallas=True``)
    with the reference's thresholds bridged.
  * The CUDA kernels' paged variants (marked ``cuda``) against the plain
    version, and bit for bit against the dense kernel on the gathered
    copy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import DenseCache as JDense
from repro.cache import PagedCache as JPaged
from repro.cache import paged as jpaged
from repro.configs import get_config as jax_config
from repro.kernels import decode_attention as jda
from repro.kernels import prefill_attention as jpa
from repro.launch.engine import Engine as JaxEngine
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.bridge import to_tensor
from repro_torch.cache import (LAYOUTS, DenseCache, KernelView, PagedCache,
                               make_cache)
from repro_torch.cache import paged as tpaged
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops
from repro_torch.kernels import prefill_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.launch.engine import Engine

B, KV, D, PS, CAP, EXTRA = 3, 2, 16, 8, 40, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _caches(bits, seed):
    """The reference's and the port's paged caches with the same shuffled
    table (every slot's pages permuted through the pool)."""
    jc = JPaged.init(B, CAP, KV, D, quantized=True, page_size=PS,
                     extra_pages=EXTRA, bits=bits)
    tc = PagedCache.init(B, CAP, KV, D, page_size=PS, extra_pages=EXTRA,
                         bits=bits)
    nb = tc.n_blocks
    perm = np.random.default_rng(seed).permutation(B * nb + EXTRA)
    table = perm[:B * nb].reshape(B, nb).astype(np.int32)
    for b in range(B):
        jc = jpaged.set_table_row(jc, b, table[b])
        tpaged.set_table_row(tc, b, table[b])
    return jc, tc


def _tiles(rng, shape, bits):
    """Random storage bytes: int8 values, or packed int4 nibble pairs."""
    dp = shape[-1] // 2 if bits == 4 else shape[-1]
    return rng.integers(-128, 128, shape[:-1] + (dp,), dtype=np.int8)


def _same(jc, tc):
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.table.numpy(), np.asarray(jc.table))


@pytest.mark.parametrize("bits", [8, 4])
def test_paged_writes_and_reads_bit_identical(bits):
    rng = np.random.default_rng(bits)
    jc, tc = _caches(bits, seed=1)
    assert (tc.capacity, tc.n_blocks, tc.n_pages) == (
        jc.capacity, jc.n_blocks, jc.n_pages)
    # a run of 13 positions from 5 spans three pages of every row
    k, v = _tiles(rng, (B, 13, KV, D), bits), _tiles(rng, (B, 13, KV, D),
                                                     bits)
    jc = jc.append(jnp.asarray(k), jnp.asarray(v), 5)
    tc.append(to_tensor(k), to_tensor(v), 5)
    _same(jc, tc)
    # per-slot writes: ragged positions, the middle row inactive
    starts = np.array([18, 7, 39], np.int32)
    active = np.array([True, False, True])
    k, v = _tiles(rng, (B, 1, KV, D), bits), _tiles(rng, (B, 1, KV, D), bits)
    jc = jc.append_slots(jnp.asarray(k), jnp.asarray(v), jnp.asarray(starts),
                         active=jnp.asarray(active))
    tc.append_slots(to_tensor(k), to_tensor(v), to_tensor(starts),
                    active=to_tensor(active))
    _same(jc, tc)
    for limit in (None, 21, CAP):
        for want, got in zip(jc.dense_view(limit), tc.dense_view(limit)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jv, tv = jc.kernel_view(21), tc.kernel_view(21)
    np.testing.assert_array_equal(tv.block_table.numpy(),
                                  np.asarray(jv.block_table))
    assert (tv.page_size, tv.bits) == (jv.tile, jv.bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_scheduler_page_ops_bit_identical(bits):
    rng = np.random.default_rng(10 + bits)
    jc, tc = _caches(bits, seed=2)
    nb = tc.n_blocks
    slot = _tiles(rng, (1, CAP, KV, D), bits)
    scale = rng.random(KV).astype(np.float32)
    jslot = JDense(jnp.asarray(slot), jnp.asarray(slot), jnp.asarray(scale),
                   jnp.asarray(scale), _quantized=True, bits=bits)
    tslot = DenseCache(to_tensor(slot), to_tensor(slot), to_tensor(scale),
                       to_tensor(scale), bits=bits)
    row = np.arange(nb, 2 * nb, dtype=np.int32)[::-1].copy()
    jc = jpaged.splice_dense_into_pages(jc, jslot, jnp.asarray(row))
    tpaged.splice_dense_into_pages(tc, tslot, row)
    _same(jc, tc)
    np.testing.assert_array_equal(tc.k_scale.numpy(), np.asarray(jc.k_scale))
    jc = jpaged.set_table_row(jc, 2, jnp.asarray(row))
    tpaged.set_table_row(tc, 2, row)
    src, dst = [row[0], row[1]], [B * nb, B * nb + 1]
    jc = jpaged.copy_pages(jc, jnp.asarray(src), jnp.asarray(dst))
    tpaged.copy_pages(tc, src, dst)
    _same(jc, tc)
    for want, got in zip(jc.dense_view(), tc.dense_view()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [8, 4])
def test_dense_append_slots_bit_identical(bits):
    rng = np.random.default_rng(20 + bits)
    base = _tiles(rng, (B, CAP, KV, D), bits)
    ones = np.ones(KV, np.float32)
    jc = JDense(jnp.asarray(base), jnp.asarray(base), jnp.asarray(ones),
                jnp.asarray(ones), _quantized=True, bits=bits)
    tc = DenseCache(to_tensor(base), to_tensor(base), to_tensor(ones),
                    to_tensor(ones), bits=bits)
    for starts, active in (([3, 0, 39], [True, True, True]),
                           ([11, 50, 2], [False, True, False]),
                           ([5, 6, 7], [False, False, False])):
        k, v = (_tiles(rng, (B, 1, KV, D), bits) for _ in range(2))
        st = np.asarray(starts, np.int32)
        act = np.asarray(active)
        jc = jc.append_slots(jnp.asarray(k), jnp.asarray(v), jnp.asarray(st),
                             active=jnp.asarray(act))
        tc.append_slots(to_tensor(k), to_tensor(v), to_tensor(st),
                        active=to_tensor(act))
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    assert not np.array_equal(tc.k.numpy(), base)


def test_make_cache_layouts_and_rollback():
    assert LAYOUTS == ("dense", "ring", "paged")
    assert isinstance(make_cache(2, 16, KV, D, layout="ring"), DenseCache)
    paged = make_cache(2, 20, KV, D, layout="paged", page_size=8,
                       extra_pages=3, bits=4)
    assert isinstance(paged, PagedCache)
    assert (paged.capacity, paged.n_pages, paged.k.shape[-1]) == (24, 9, 8)
    assert paged.rollback(torch.zeros(2)) is paged
    # with the identity table as the private rows: a self-copy, in place
    before = (paged.k.clone(), paged.table.clone())
    assert paged.rollback(torch.tensor([3, 9]),
                          private_row=paged.table.clone()) is paged
    assert torch.equal(paged.k, before[0])
    assert torch.equal(paged.table, before[1])
    # a windowed layer shorter than the cache gets its ring (item 9, done)
    ring = make_cache(2, 16, KV, D, layout="ring", window=4)
    assert (ring.layout, ring.capacity) == ("ring", 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        make_cache(2, 16, KV, D, layout="paged", page_size=12)
    with pytest.raises(ValueError, match="unknown cache layout"):
        make_cache(2, 16, KV, D, layout="sparse")
    with pytest.raises(ValueError, match="overruns"):
        paged.append(torch.zeros((2, 5, KV, D // 2), dtype=torch.int8),
                     torch.zeros((2, 5, KV, D // 2), dtype=torch.int8), 20)


def test_prefix_store_scripted_run_matches_reference():
    """Registration, hits, refcount pins, LRU eviction of an entry and its
    tail page, and exhaustion, step by step on both stores."""
    stores = [jpaged.PrefixStore(10, 5, 8), tpaged.PrefixStore(10, 5, 8)]
    entries = [jpaged.PrefixEntry, tpaged.PrefixEntry]
    logits = np.zeros((1, 1, 4), np.float32)

    def both(op, *args):
        outs = []
        for store, entry in zip(stores, entries):
            if op == "register":
                key, n = args
                alloc = store.reserve(key, n)
                if alloc is not None:
                    store.register(key, entry(alloc[0], alloc[1], n, logits))
                out = alloc
            elif op == "lookup":
                e = store.lookup(*args)
                out = None if e is None else (e.pages, e.tail_page, e.length)
            else:
                out = getattr(store, op)(*args)
            outs.append((out, store.stats()))
        assert outs[0] == outs[1], (op, args, outs)

    script = [("register", ("a",), 12), ("register", ("b",), 16),
              ("lookup", ("a",), 0), ("lookup", ("c",), 1),
              ("register", ("c",), 8), ("register", ("a",), 12),
              ("release", 0), ("register", ("d",), 20),
              ("lookup", ("a",), 2), ("lookup", ("d",), 3),
              ("register", ("e",), 0), ("register", ("f",), 40),
              ("release", 3), ("register", ("g",), 9)]
    for op, *args in script:
        both(op, *args)
    assert stores[1].stats()["evictions"] >= 2
    assert stores[1].stats()["exhausted"] >= 1


# ---------------------------------------------------------------------------
# the paged attentions: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _attn_inputs(b, sq, nb, ps, kvh, g, d, bits, seed):
    """q, K/V pools with a permuted table whose rows 0 and 1 share their
    first page, and per-head scales."""
    rng = np.random.default_rng(seed)
    lv = 127 if bits == 8 else 7
    pages = b * nb + 2
    vals = [rng.integers(-lv, lv + 1, (pages, ps, kvh, d), dtype=np.int8)
            for _ in range(2)]
    if bits == 4:
        from repro.core.packing import pack_int4
        vals = [np.asarray(pack_int4(jnp.asarray(x), axis=-1)) for x in vals]
    table = rng.permutation(pages)[:b * nb].reshape(b, nb).astype(np.int32)
    table[1, 0] = table[0, 0]
    q = rng.normal(size=(b, sq, kvh, g, d)).astype(np.float32)
    ks = (rng.random(kvh) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random(kvh) * 0.05 + 0.01).astype(np.float32)
    return q, vals[0], vals[1], table, ks, vs


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (1 + np.abs(want).max()))


@pytest.mark.parametrize("bits", [8, 4])
def test_paged_decode_plain_matches_pallas(bits):
    q, kp, vp, table, ks, vs = _attn_inputs(4, 1, 5, 8, 2, 3, 16, bits, 40)
    q = q[:, 0]
    cur = np.array([0, 17, 40, 9], np.int32)
    view = KernelView(to_tensor(kp), to_tensor(vp), to_tensor(table), 8, bits)
    got = ops.decode_attention_view(to_tensor(q), view, to_tensor(ks),
                                    to_tensor(vs), to_tensor(cur)).numpy()
    want = np.asarray(jda.decode_attention_tiles(
        *(jnp.asarray(a) for a in (q, kp, vp, table, ks, vs, cur)),
        interpret=True, kv_bits=bits))
    _close(got, want)
    np.testing.assert_array_equal(got[0], 0.0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_prefill_plain_matches_pallas(bits, window):
    q, kp, vp, table, ks, vs = _attn_inputs(3, 8, 4, 8, 2, 3, 16, bits, 41)
    q_start = np.array([0, 8, 19], np.int32)
    kv_len = np.array([8, 16, 27], np.int32)
    view = KernelView(to_tensor(kp), to_tensor(vp), to_tensor(table), 8, bits)
    got = ops.prefill_attention_view(
        to_tensor(q), view, to_tensor(ks), to_tensor(vs), to_tensor(q_start),
        to_tensor(kv_len), causal=True, window=window).numpy()
    want = np.asarray(jpa.prefill_attention_tiles(
        *(jnp.asarray(a) for a in (q, kp, vp, table, ks, vs, q_start,
                                   kv_len)),
        causal=True, window=window, interpret=True, kv_bits=bits))
    _close(got, want)


def test_paged_entry_points_validate_the_table():
    q, kp, vp, table, ks, vs = (to_tensor(a) for a in _attn_inputs(
        2, 1, 3, 8, 2, 3, 16, 8, 42))
    for bad in (table.long(), table[:, None], table[:1]):
        with pytest.raises(ValueError, match="block table"):
            ops.decode_attention_view(q[:, 0], KernelView(kp, vp, bad, 8),
                                      ks, vs, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.launch(q[:, 0].contiguous(), kp, vp, ks, vs,
                   torch.full((2,), 4, dtype=torch.int32), table=table)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpa.launch(q, kp, vp, ks, vs, torch.zeros(2, dtype=torch.int32),
                   torch.full((2,), 8, dtype=torch.int32), table=table)


# ---------------------------------------------------------------------------
# end to end: dense == paged, chunked prefill against the reference
# ---------------------------------------------------------------------------

GEN = 6


@pytest.fixture(scope="module")
def engines():
    """The reference Engine (Pallas interpret, paged, chunked prefill) and
    the port's, float32 smoke config, the port serving the reference's
    weights and thresholds."""
    jcfg = jax_config("smollm-135m", smoke=True).replace(dtype=jnp.float32)
    tcfg = torch_config("smollm-135m", smoke=True).replace(
        dtype=torch.float32)
    rng = np.random.default_rng(51)
    calib = [{"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (4, 32),
                                                 dtype=np.int32))}
             for _ in range(2)]
    ref = JaxEngine.from_checkpoint(cfg=jcfg, use_pallas=True,
                                    calib_batches=calib,
                                    cache_layout="paged", page_size=8,
                                    prefill_chunk=8)
    params = bridge.params_from_jax(_np(jax_build(jcfg).init(
        jax.random.PRNGKey(0))))
    qparams = bridge.qparams_from_jax(_np(ref.qparams))
    ours = {(layout, chunk): Engine.from_checkpoint(
        cfg=tcfg, params=params, qparams=qparams, device="cpu",
        cache_layout=layout, page_size=8, prefill_chunk=chunk)
        for layout in ("dense", "paged") for chunk in (None, 8)}
    prompts = rng.integers(0, jcfg.vocab, (2, 20), dtype=np.int32)
    return dict(ref=ref, ours=ours, prompts=prompts)


@pytest.mark.parametrize("chunk", [None, 8], ids=["one_shot", "chunked"])
def test_dense_and_paged_bit_identical(engines, chunk):
    out = {layout: engines["ours"][layout, chunk].generate_batch(
        {"tokens": engines["prompts"]}, gen=GEN) for layout in
        ("dense", "paged")}
    assert torch.equal(out["dense"].prefill_logits,
                       out["paged"].prefill_logits)
    assert torch.equal(out["dense"].tokens, out["paged"].tokens)


def test_chunked_paged_tokens_match_reference(engines):
    prompts = engines["prompts"]
    want = engines["ref"].generate_batch({"tokens": jnp.asarray(prompts)},
                                         gen=GEN)
    got = engines["ours"]["paged", 8].generate_batch({"tokens": prompts},
                                                     gen=GEN)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    # chunked and one-shot prefill give the same first token
    one = engines["ours"]["dense", None].generate_batch(
        {"tokens": prompts}, gen=1)
    np.testing.assert_array_equal(one.tokens.numpy(),
                                  got.tokens[:, :1].numpy())


def test_chunked_prefill_rejects_a_prompt_longer_than_the_cache(engines):
    from repro_torch.launch import steps as TST

    eng = engines["ours"]["paged", 8]
    step = TST.make_prefill_step(eng.model, eng.policy, prefill_chunk=8)
    toks, lengths = TST.pad_for_chunked_prefill(
        torch.zeros((1, 30), dtype=torch.long), 8)
    assert toks.shape == (1, 32) and lengths.tolist() == [30]
    with torch.inference_mode(), pytest.raises(ValueError, match="exceeds"):
        step(eng.serve_params, eng.qparams, {"tokens": toks},
             eng.init_cache(1, 24), lengths)
    with pytest.raises(ValueError, match="multiple of prefill_chunk"):
        step(eng.serve_params, eng.qparams, {"tokens": toks[:, :30]},
             eng.init_cache(1, 64), lengths)


# ---------------------------------------------------------------------------
# on the card: paged kernels against the plain version and the dense kernel
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_paged_kernels_match_plain_and_dense(cuda_device, bits):
    dev = cuda_device
    q, kp, vp, table, ks, vs = (to_tensor(a).to(dev) for a in _attn_inputs(
        3, 70, 5, 16, 3, 3, 64, bits, 43))
    kd, vd = tref.gather_pages(kp, table), tref.gather_pages(vp, table)
    qs = torch.tensor([0, 5, 10], dtype=torch.int32, device=dev)
    kl = torch.tensor([70, 75, 80], dtype=torch.int32, device=dev)
    got = tpa.launch(q, kp, vp, ks, vs, qs, kl, kv_bits=bits, table=table)
    want = tref.prefill_attention_ref(q, kd, vd, ks, vs, qs, kl, kv_bits=bits)
    _close(got.cpu().numpy(), want.cpu().numpy(), tol=1e-4)
    assert torch.equal(got, tpa.launch(q, kd, vd, ks, vs, qs, kl,
                                       kv_bits=bits))
    qd = q[:, 0].contiguous()
    pos = torch.tensor([0, 33, 80], dtype=torch.int32, device=dev)
    got = tda.launch(qd, kp, vp, ks, vs, pos, kv_bits=bits, table=table)
    want = tref.decode_attention_ref(qd, kd, vd, ks, vs, pos, kv_bits=bits)
    _close(got.cpu().numpy(), want.cpu().numpy(), tol=1e-4)
    assert torch.equal(got, tda.launch(qd, kd, vd, ks, vs, pos, kv_bits=bits))
