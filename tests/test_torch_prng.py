"""``repro_torch.launch.prng`` against ``jax.random`` (threefry2x32 with
``jax_threefry_partitionable``, the reference's default) on the CPU.

Keys, ``split``, ``fold_in``, ``bits`` and ``uniform`` are held bit for
bit, at (V,), (B, V) and (B, 1, V) shapes and for a batch of keys (the
reference's ``jax.vmap`` over per-slot keys); ``gumbel`` goes through
``log``, which may round differently from XLA's: within 1e-6 absolute
(one ulp of its values, measured 4.8e-7 at most); ``categorical``
picks the reference's index except where the two top perturbed scores
lie within ``TIE`` of each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.launch import prng

SHAPES = [(7,), (256,), (3, 5), (4, 256), (2, 1, 9), (49152,)]
# gumbel: -log(-log(u)) with the uniform bit-exact; each log may round to
# the other neighbour of XLA's
GUMBEL_ATOL = 1e-6
# categorical: two perturbed scores closer than this may order either way
TIE = 1e-5


def _np(key):
    return np.asarray(key).astype(np.int64)


def _t(key):
    return torch.from_numpy(_np(key))


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**31 - 1, -1, -7])
def test_prng_key_words(seed):
    assert np.array_equal(prng.PRNGKey(seed).numpy(),
                          _np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 8])
@pytest.mark.parametrize("seed", [0, 3])
def test_split_bits(seed, num):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(prng.split(_t(key), num).numpy(),
                          _np(jax.random.split(key, num)))


def test_split_chain_and_vmapped_split():
    """The engines' schedules: ``key, sub = split(key)`` repeated, and each
    slot splitting its own key (``jax.vmap(jax.random.split)``)."""
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for _ in range(6):
        jk, _ = jax.random.split(jk)
        tk = prng.split(tk)[0]
        assert np.array_equal(tk.numpy(), _np(jk))
    keys = jax.random.split(jax.random.PRNGKey(5), 8)
    assert np.array_equal(prng.split(_t(keys)).numpy(),
                          _np(jax.vmap(jax.random.split)(keys)))


@pytest.mark.parametrize("data", [0, 1, 7, 1000, 2**31 - 1, 2**32 - 1])
def test_fold_in_bits(data):
    key = jax.random.PRNGKey(3)
    assert np.array_equal(prng.fold_in(_t(key), data).numpy(),
                          _np(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_bits(shape):
    key = jax.random.PRNGKey(3)
    assert np.array_equal(prng.bits(_t(key), shape).numpy(),
                          _np(jax.random.bits(key, shape)))
    tiny = np.finfo(np.float32).tiny
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.0, 3.0)):
        want = np.asarray(jax.random.uniform(key, shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(_t(key), shape, lo, hi).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_a_row_of_a_batch_draw_is_not_a_row_draw():
    """Counters run over the whole draw's flat index: row b of a (B, V)
    draw hashes b * V + v, so it differs from a (V,) draw."""
    key = prng.PRNGKey(3)
    batch, row = prng.bits(key, (2, 64)), prng.bits(key, (64,))
    assert torch.equal(batch[0], row) and not torch.equal(batch[1], row)
    assert np.array_equal(batch[1].numpy(), _np(jax.random.bits(
        jax.random.PRNGKey(3), (128,)))[64:])


def test_bits_per_key_batch_match_vmap():
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    want = jax.vmap(lambda k: jax.random.bits(k, (1, 33)))(keys)
    assert np.array_equal(prng.bits(_t(keys), (33,)).numpy(),
                          _np(want)[:, 0])
    assert np.array_equal(prng.bits(_t(keys), (1, 33)).numpy(), _np(want))


@pytest.mark.parametrize("shape", [(256,), (4, 256), (49152,)], ids=str)
def test_gumbel_within_an_ulp(shape):
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.gumbel(key, shape))
    got = prng.gumbel(_t(key), shape).numpy()
    assert np.abs(got - want).max() <= GUMBEL_ATOL


@pytest.mark.parametrize("per_row", [False, True])
def test_categorical_picks_the_references_index(per_row):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((8, 256)) * 3).astype(np.float32)
    if per_row:
        keys = jax.random.split(jax.random.PRNGKey(2), 8)
        want = jax.vmap(lambda l, k: jax.random.categorical(
            k, l[None], axis=-1)[0])(jnp.asarray(logits), keys)
        key = _t(keys)
        noise = prng.gumbel(key, (256,))
    else:
        jkey = jax.random.PRNGKey(2)
        want = jax.random.categorical(jkey, jnp.asarray(logits), axis=-1)
        key = _t(jkey)
        noise = prng.gumbel(key, (8, 256))
    got = prng.categorical(key, torch.from_numpy(logits)).numpy()
    want = np.asarray(want)
    scores = noise.numpy() + logits
    for r in np.nonzero(got != want)[0]:
        assert scores[r, got[r]] - scores[r, want[r]] <= TIE, r
    assert got.dtype == np.int64


@pytest.mark.parametrize("key_dims", [1, 2])
def test_functions_keep_the_keys_device_and_shape(key_dims):
    key = prng.PRNGKey(1) if key_dims == 1 else prng.split(prng.PRNGKey(1),
                                                           3)
    lead = () if key_dims == 1 else (3,)
    assert prng.split(key).shape == lead + (2, 2)
    assert prng.bits(key, (4, 5)).shape == lead + (4, 5)
    assert prng.uniform(key, (6,)).dtype == torch.float32
    assert key.dtype == torch.int64 and int(key.max()) <= prng.MASK
