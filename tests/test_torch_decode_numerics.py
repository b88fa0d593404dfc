"""The order of sums of the decode attention kernel (B1, and its partials
epilogue B4, ``csrc/decode_attention.cuh``), emulated on the CPU.

The kernel cuts the sequence axis into chunks of ``SPLIT`` positions, one
block each, fixed by position alone.  In a chunk each warp takes PPW
positions and keeps its own max, probabilities (base 2: the scores carry
log2 e) and sums; the warps' states are rescaled to the chunk's max and
added in warp order.  The chunks' states are then merged in chunk order,
weighted by 2^(m_c - M).  These tests repeat that walk in float32 torch
and hold it against the float32 plain version ``ref.decode_attention_ref``
and against the reference's Pallas kernel ``decode_attention_int8`` in
interpret mode, within the tolerance ``chip_smoke.py`` holds the kernel
to on the card: 1e-4 x (1 + max |out|).  The walk depends on the
positions only, so the same rows in caches of different capacity give
the same bits, and one shard of partials over the whole cache,
normalized, is the normalized walk.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.kernels import decode_attention as jda
from repro_torch.core.packing import unpack_int4
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import SPLIT

KV, G, D = 3, 3, 64      # smollm-135m's attention
CAP, LONG = 640, 1024    # the serving cache, and a longer one
PPW = 8                  # positions per warp: SPLIT / (256 threads / 32)
TOL = 1e-4               # chip_smoke.ATTN_TOL
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
CUR_POS = (0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 528, CAP)


def emulate(q, k, v, k_scale, v_scale, cur_pos, kv_bits, partials=False):
    """The kernel's walk in float32: (B, KV, G, D) normalized, or the
    partials epilogue's (acc * v_scale, m, l)."""
    b, kvh, g, d = q.shape
    if kv_bits == 4:
        k = unpack_int4(k, axis=-1, size=d)
        v = unpack_int4(v, axis=-1, size=d)
    kf, vf = k.float(), v.float()
    cq = k_scale * torch.tensor(1.0 / np.sqrt(np.float32(d)),
                                dtype=torch.float32) * LOG2E
    qf = q.float() * cq.reshape(1, -1, 1, 1)
    n_live = torch.clamp((cur_pos + SPLIT - 1) // SPLIT, min=1)
    states = []
    for c in range(int(n_live.max())):
        c0 = c * SPLIT
        kt, vt = kf[:, c0:c0 + SPLIT], vf[:, c0:c0 + SPLIT]
        n = kt.shape[1]
        s2 = torch.einsum("bkgd,bskd->bkgs", qf, kt)
        valid = (c0 + torch.arange(n))[None, :] < cur_pos[:, None]
        valid = valid[:, None, None, :]
        s2 = torch.where(valid, s2, ref.NEG_INF)
        nw = -(-n // PPW)
        pad = nw * PPW - n
        s2w = torch.nn.functional.pad(s2, (0, pad), value=ref.NEG_INF)
        s2w = s2w.reshape(b, kvh, g, nw, PPW)
        vw = torch.nn.functional.pad(vt, (0, 0, 0, 0, 0, pad))
        vw = vw.reshape(b, nw, PPW, kvh, d)
        validw = torch.nn.functional.pad(valid, (0, pad)).reshape(
            b, 1, 1, nw, PPW)
        mw = s2w.amax(-1)
        p = torch.where(validw, torch.exp2(s2w - mw[..., None]), 0.0)
        lw = p.sum(-1)
        accw = torch.einsum("bkgws,bwskd->bkgwd", p, vw)
        m = mw.amax(-1)
        e = torch.exp2(mw - m[..., None])
        states.append(((accw * e[..., None]).sum(-2), m, (lw * e).sum(-1)))
    live = [(c < n_live).reshape(-1, 1, 1) for c in range(len(states))]
    mx = torch.full_like(states[0][1], ref.NEG_INF)
    for (_, m, _), ok in zip(states, live):
        mx = torch.where(ok, torch.maximum(mx, m), mx)
    acc = torch.zeros_like(states[0][0])
    l_sum = torch.zeros_like(states[0][2])
    for (a, m, l), ok in zip(states, live):
        e = torch.where(ok, torch.exp2(m - mx), 0.0)
        acc = acc + a * e[..., None]
        l_sum = l_sum + l * e
    acc = acc * v_scale.reshape(1, -1, 1, 1)
    if partials:
        return acc, torch.where(mx <= ref.NEG_INF, ref.NEG_INF, mx * LN2), l_sum
    return acc / torch.clamp_min(l_sum, 1e-30)[..., None]


@functools.lru_cache(maxsize=None)
def _inputs(kv_bits, cap=CAP, seed=18):
    """One request per case of CUR_POS, at chip_smoke.py's scale ranges;
    the cache of ``cap`` positions holds the first CAP of the LONG rows."""
    rng = np.random.default_rng(seed)
    lv = 127 if kv_bits == 8 else 7
    b = len(CUR_POS)
    q = rng.normal(size=(b, KV, G, D)).astype(np.float32)
    k, v = (rng.integers(-lv, lv + 1, (b, LONG, KV, D), dtype=np.int8)
            for _ in range(2))
    k, v = k[:, :cap], v[:, :cap]
    ks, vs = ((rng.random(KV) * 0.05 + 0.01).astype(np.float32)
              for _ in range(2))
    if kv_bits == 4:
        k = np.array(jpack.pack_int4(jnp.asarray(k)))
        v = np.array(jpack.pack_int4(jnp.asarray(v)))
    pos = np.asarray(CUR_POS, np.int32)
    return q, np.ascontiguousarray(k), np.ascontiguousarray(v), ks, vs, pos


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@functools.lru_cache(maxsize=None)
def _emulated(kv_bits, cap=CAP):
    q, k, v, ks, vs, pos = _torch(_inputs(kv_bits, cap))
    return emulate(q, k, v, ks, vs, pos, kv_bits)


@functools.lru_cache(maxsize=None)
def _pallas(kv_bits):
    q, k, v, ks, vs, pos = _inputs(kv_bits)
    return np.asarray(jda.decode_attention_int8(
        *[jnp.asarray(a) for a in (q, k, v, ks, vs)], jnp.asarray(pos),
        interpret=True, kv_bits=kv_bits))


def _close(got, want):
    err = float(np.abs(got - want).max())
    assert err <= TOL * (1 + float(np.abs(want).max())), err


CASES = [pytest.param(bits, i, id=f"int{bits}-cur{c}")
         for bits in (8, 4) for i, c in enumerate(CUR_POS)]


@pytest.mark.parametrize("kv_bits,row", CASES)
def test_emulation_matches_plain_version(kv_bits, row):
    q, k, v, ks, vs, pos = _torch(_inputs(kv_bits))
    want = ref.decode_attention_ref(q, k, v, ks, vs, pos, kv_bits)
    _close(_emulated(kv_bits)[row].numpy(), want[row].numpy())


@pytest.mark.parametrize("kv_bits,row", CASES)
def test_emulation_matches_pallas_interpret(kv_bits, row):
    _close(_emulated(kv_bits)[row].numpy(), _pallas(kv_bits)[row])


@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_bit_identical_across_capacities(kv_bits):
    """Chunks are fixed by position: the rows of a 640-position cache in a
    1024-position one give the same bits."""
    assert torch.equal(_emulated(kv_bits), _emulated(kv_bits, LONG))


@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_one_shard_of_partials_normalizes_to_the_kernel(kv_bits):
    """B4 over the whole cache, normalized as the sequence-parallel merge
    does with one shard, is B1's output bit for bit; a row that sees no
    key is the merge's identity (0, -1e30, 0)."""
    q, k, v, ks, vs, pos = _torch(_inputs(kv_bits))
    acc, m, l = emulate(q, k, v, ks, vs, pos, kv_bits, partials=True)
    assert torch.equal(acc / torch.clamp_min(l, 1e-30)[..., None],
                       _emulated(kv_bits))
    empty = pos == 0
    assert torch.equal(acc[empty], torch.zeros_like(acc[empty]))
    assert torch.equal(l[empty], torch.zeros_like(l[empty]))
    assert bool((m[empty] == ref.NEG_INF).all())
    want = ref.decode_attention_partials_ref(q, k, v, ks, vs, pos, kv_bits)
    live = ~empty
    for got, w in ((acc, want[0]), (m, want[1]), (l, want[2])):
        _close(got[live].numpy(), w[live].numpy())


@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_ragged_batch_with_an_empty_row(kv_bits):
    """The whole ragged batch at once against the plain version; the row
    with cur_pos 0 is exact zeros."""
    q, k, v, ks, vs, pos = _torch(_inputs(kv_bits))
    got = _emulated(kv_bits)
    _close(got.numpy(),
           ref.decode_attention_ref(q, k, v, ks, vs, pos, kv_bits).numpy())
    assert torch.equal(got[0], torch.zeros_like(got[0]))

