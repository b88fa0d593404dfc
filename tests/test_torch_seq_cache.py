"""The sequence-parallel ranks' owner writes and gathers
(``repro_torch.shard.seq_cache``) and the group form of
``compressed_psum`` against the reference's (``repro.shard.seq_cache``,
``repro.dist.collectives``).

The reference runs under ``jax.jit(jax.vmap(..., axis_name=))``, where its
``axis_index``, ``all_gather`` and ``psum`` run over the mapped shards on
one CPU device.  The port's writes run in this process, one call per
rank of a ``RankMesh`` (a write needs only the rank's index); its gather
runs here with the collective standing in as every rank's tiles in rank
order, and the group reduce on two spawned gloo CPU ranks
(``dist.ranks.run_ranks``).  Every comparison is bit for bit: int8 (and
packed int4) tiles, dequantized views, int32 sums and the float reduce.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.cache.base import DenseCache as JDenseCache
from repro.dist import collectives as JC
from repro.shard import seq_cache as JSC
from repro_torch.cache import DenseCache
from repro_torch.dist import collectives as TC
from repro_torch.dist.ranks import run_ranks
from repro_torch.launch.mesh import RankMesh
from repro_torch.shard import seq_cache as TSC

SP, B, S_LOCAL, KV, D = 2, 3, 8, 2, 8


def _mesh(rank):
    return RankMesh(axis="sp", n=SP, rank=rank, device=torch.device("cpu"),
                    backend="gloo")


def _tiles(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int8)


def _scales(rng):
    return rng.uniform(0.01, 0.1, (KV,)).astype(np.float32)


def _port_caches(k, v, ks, vs, bits=8):
    """The ranks' caches (their rows of the (SP, B, S_LOCAL, KV, D') tiles)
    as the port's ``RankRows``."""
    return [TSC.rank_rows(DenseCache(
        torch.from_numpy(k[r].copy()), torch.from_numpy(v[r].copy()),
        torch.from_numpy(ks), torch.from_numpy(vs), bits=bits), SP)
        for r in range(SP)]


def _ref(fn, k, v, ks, vs, *args, bits=8):
    """``fn(cache, *args)`` per shard of the reference under vmap, the
    shards' (k, v) stacked."""
    def one(kk, vv, *a):
        c = JDenseCache(kk, vv, jnp.asarray(ks), jnp.asarray(vs),
                        _quantized=True, bits=bits)
        out = fn(c, *a)
        return out.k, out.v

    rk, rv = jax.jit(jax.vmap(one, in_axes=(0, 0) + (None,) * len(args),
                              axis_name="sp"))(k, v, *args)
    return np.asarray(rk), np.asarray(rv)


@pytest.mark.parametrize("start,s", [(5, 6), (0, 8), (8, 3), (13, 3)],
                         ids=["straddles", "rank0", "rank1", "rank1-end"])
def test_owner_append_matches_reference(start, s):
    """A chunk of ``s`` rows at global ``start``: each rank writes exactly
    its rows, a chunk straddling the boundary (5..11 over 8) its part on
    each side."""
    rng = np.random.default_rng(start * 10 + s)
    k, v = _tiles(rng, (SP, B, S_LOCAL, KV, D)), _tiles(rng, (SP, B, S_LOCAL,
                                                             KV, D))
    kq, vq = _tiles(rng, (B, s, KV, D)), _tiles(rng, (B, s, KV, D))
    ks, vs = _scales(rng), _scales(rng)
    wk, wv = _ref(lambda c, a, b, st: JSC.owner_append(c, a, b, st, "sp"),
                  k, v, ks, vs, kq, vq, jnp.int32(start))
    for r, c in enumerate(_port_caches(k, v, ks, vs)):
        out = TSC.owner_append(c, torch.from_numpy(kq), torch.from_numpy(vq),
                               start, _mesh(r))
        np.testing.assert_array_equal(out.k.numpy(), wk[r], err_msg=str(r))
        np.testing.assert_array_equal(out.v.numpy(), wv[r], err_msg=str(r))
    assert (wk != k).any()


@pytest.mark.parametrize("s", [1, 3], ids=["decode", "verify"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "inactive"])
def test_owner_append_slots_matches_reference(s, masked):
    """Per-slot writes at positions 3, 7 and 12 (a window from 7 straddles
    the boundary), with the second slot inactive in the masked case: it
    writes nothing on either rank."""
    rng = np.random.default_rng(s + 7 * masked)
    k, v = _tiles(rng, (SP, B, S_LOCAL, KV, D)), _tiles(rng, (SP, B, S_LOCAL,
                                                             KV, D))
    kq, vq = _tiles(rng, (B, s, KV, D)), _tiles(rng, (B, s, KV, D))
    ks, vs = _scales(rng), _scales(rng)
    pos = np.array([3, 7, 12], np.int32)
    active = np.array([True, not masked, True])
    wk, wv = _ref(lambda c, a, b, p, act: JSC.owner_append_slots(
        c, a, b, p, "sp", active=act), k, v, ks, vs, kq, vq, pos, active)
    for r, c in enumerate(_port_caches(k, v, ks, vs)):
        out = TSC.owner_append_slots(
            c, torch.from_numpy(kq), torch.from_numpy(vq),
            torch.from_numpy(pos), _mesh(r),
            active=torch.from_numpy(active))
        np.testing.assert_array_equal(out.k.numpy(), wk[r], err_msg=str(r))
        np.testing.assert_array_equal(out.v.numpy(), wv[r], err_msg=str(r))
    if masked:
        # the inactive slot's rows are untouched on every rank
        np.testing.assert_array_equal(wk[:, 1], k[:, 1])


@pytest.mark.parametrize("bits,limit", [(8, None), (8, 11), (4, None)],
                         ids=["int8", "int8-limit", "int4"])
def test_gathered_dense_matches_reference(monkeypatch, bits, limit):
    """The gathered, dequantized global view: every rank's tiles in rank
    order (the collective stands in here as the ranks' tiles), cut after
    the gather, dequantized with the replicated scales."""
    rng = np.random.default_rng(bits + (limit or 0))
    d = D if bits == 8 else D // 2
    k, v = _tiles(rng, (SP, B, S_LOCAL, KV, d)), _tiles(rng, (SP, B, S_LOCAL,
                                                             KV, d))
    ks, vs = _scales(rng), _scales(rng)

    def one(kk, vv):
        c = JDenseCache(kk, vv, jnp.asarray(ks), jnp.asarray(vs),
                        _quantized=True, bits=bits)
        return JSC.gathered_dense(c, "sp", limit)

    wk, wv = (np.asarray(a) for a in jax.jit(jax.vmap(
        one, axis_name="sp"))(k, v))
    caches = _port_caches(k, v, ks, vs, bits=bits)

    def gather(x, mesh):
        name = "k" if any(x is c.k for c in caches) else "v"
        return [getattr(c, name) for c in caches]

    monkeypatch.setattr(TSC, "all_gather", gather)
    for r, c in enumerate(caches):
        gk, gv = TSC.gathered_dense(c, _mesh(r), limit)
        np.testing.assert_array_equal(gk.numpy(), wk[r], err_msg=str(r))
        np.testing.assert_array_equal(gv.numpy(), wv[r], err_msg=str(r))
    assert wk.shape[2] == (limit or SP * S_LOCAL)


def test_rank_rows_capacity_is_the_global_length():
    """A rank's cache holds S / sp rows; its logical capacity, which the
    steps size their windows by, is S; the scale updates keep both."""
    c = TSC.rank_rows({"attn": DenseCache.init(B, S_LOCAL, KV, D)}, SP)
    c = c["attn"].with_scales(torch.ones(KV), torch.ones(KV))
    assert (type(c), c.rows, c.capacity) == (TSC.RankRows, S_LOCAL,
                                             SP * S_LOCAL)
    assert dataclasses.replace(c).n_ranks == SP


def _psum_rank(mesh, payloads):
    """Every rank's group reduces of its payloads, gathered in rank
    order."""
    mine = {name: TC.compressed_psum(torch.from_numpy(x[mesh.rank]),
                                     mean=mean, group=mesh)
            for name, (x, mean) in payloads.items()}
    out = [None] * mesh.n
    dist.all_gather_object(out, mine)
    return out


def test_group_compressed_psum_matches_reference():
    """The group form on two gloo ranks against the reference's
    ``compressed_psum`` under vmap: the int32 sum exact (every rank the
    same), the float reduce's mean and sum (a shared max-abs threshold,
    an int8 payload) bit for bit; an integer mean raises."""
    rng = np.random.default_rng(3)
    payloads = {
        "int32": (rng.integers(-2 ** 20, 2 ** 20, (SP, 5, 7),
                               dtype=np.int32), False),
        "mean": (rng.normal(size=(SP, 5, 7)).astype(np.float32), True),
        "sum": ((rng.normal(size=(SP, 5, 7)) * 3).astype(np.float32), False),
    }
    got = run_ranks(_psum_rank, SP, backend="gloo", device="cpu", threads=1,
                    args=(payloads,))
    for name, (x, mean) in payloads.items():
        want = np.asarray(jax.jit(jax.vmap(
            lambda a, m=mean: JC.compressed_psum(a, "sp", mean=m),
            axis_name="sp"))(jnp.asarray(x)))
        for r in range(SP):
            assert got[r][name].dtype == torch.from_numpy(x).dtype
            np.testing.assert_array_equal(got[r][name].numpy(), want[r],
                                          err_msg=f"{name} rank {r}")
    with pytest.raises(ValueError, match="truncate"):
        TC.compressed_psum(torch.zeros(3, dtype=torch.int32), mean=True,
                           group=_mesh(0))
