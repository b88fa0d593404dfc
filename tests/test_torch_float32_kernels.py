"""The float32 branches of the port's kernels against the reference's.

B3's float32 output (the reference's ``quant_matmul(..., out_dtype=
jnp.float32)``, what a float32 config's expert products return) and B2
over a float32 K/V stream with unit scales (the reference's
``prefill_attention_tiles`` over a float32 cache).  On the CPU each entry
point runs its plain version; the reference runs its Pallas kernel in
interpret mode, as its own tests run it.  Inputs are made with numpy from
a seed and handed to both.

Tolerances: B3 is integer arithmetic and one float32 multiply in both
packages, so bit for bit.  B2 sums float32 products in another order than
the reference: 1e-5 x (1 + max |out|), the tolerance of
``test_torch_bf16.py`` for B2 against the reference.

Tests marked ``cuda`` hold the CUDA kernels' float32 branches against the
plain versions on the card and skip where there is none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_int4 as jax_pack_int4
from repro.kernels import prefill_attention as jpa
from repro.kernels import quant_matmul as jqm
from repro_torch.bridge import to_tensor
from repro_torch.cache import KernelView
from repro_torch.core import api as TA
from repro_torch.kernels import ops
from repro_torch.kernels import prefill_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref

ATTN_TOL = 1e-5


def _qm_inputs(m, k, n, w_bits, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
    lv = 127 if w_bits == 8 else 7
    w = rng.integers(-lv, lv + 1, (k, n), dtype=np.int8)
    w_q = np.asarray(jax_pack_int4(jnp.asarray(w), axis=0)) if w_bits == 4 \
        else w
    w_scale = (rng.random(n) * 1e-2).astype(np.float32)
    act_scale = np.float32(127.0 / (np.abs(x).max() * 0.7))
    return x, w_q, w_scale, act_scale


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(1, 64, 32), (5, 128, 64), (40, 256, 128)])
def test_quant_matmul_float32_output_bit_exact_vs_pallas(m, k, n, w_bits):
    """``ops.quant_matmul(..., out_dtype=torch.float32)`` against the
    reference kernel's ``out_dtype=jnp.float32`` in interpret mode: the
    same float32 bits (no bf16 rounding on either side), ragged M."""
    x, w_q, w_scale, act_scale = _qm_inputs(m, k, n, w_bits, seed=m + k)
    want = np.asarray(jqm.quant_matmul(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale),
        jnp.asarray(act_scale), out_dtype=jnp.float32, interpret=True,
        w_bits=w_bits))
    got = ops.quant_matmul(to_tensor(x), to_tensor(w_q), to_tensor(w_scale),
                           to_tensor(np.asarray(act_scale)), w_bits=w_bits,
                           out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # into a float32 slice, as an expert writes its rows of the layer output
    out = torch.zeros((2, m, n))
    ops.quant_matmul(to_tensor(x), to_tensor(w_q), to_tensor(w_scale),
                     to_tensor(np.asarray(act_scale)), w_bits=w_bits,
                     out=out[1])
    np.testing.assert_array_equal(out[1].numpy(), want)


def _f32_kv(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATTN_TOL * (1 + np.abs(want).max()))


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_prefill_attention_float32_kv_matches_reference(q_dtype):
    """``ops.prefill_attention`` over a float32 K/V stream with unit scales
    against the reference's dense entry (``prefill_attention_tiles``
    through the identity table, interpret mode); ragged q_start and kv_len,
    one request with kv_len 0 (exact zeros)."""
    rng = np.random.default_rng(71)
    b, sq, sk, kvh, g, d = 3, 12, 30, 2, 3, 16
    q = _f32_kv(rng, (b, sq, kvh, g, d)).astype(getattr(jnp, q_dtype))
    k, v = _f32_kv(rng, (b, sk, kvh, d)), _f32_kv(rng, (b, sk, kvh, d))
    ones = np.ones(kvh, np.float32)
    q_start = np.array([0, 9, 18], np.int32)
    kv_len = np.array([12, 21, 0], np.int32)
    got = ops.prefill_attention(
        *(to_tensor(a) for a in (q, k, v, ones, ones, q_start, kv_len)),
        causal=True).numpy()
    want = np.asarray(jpa.prefill_attention_int8(
        *(jnp.asarray(a) for a in (q, k, v, ones, ones, q_start, kv_len)),
        causal=True, interpret=True))
    _close(got, want)
    np.testing.assert_array_equal(got[2], 0.0)


def test_paged_prefill_attention_float32_kv_matches_reference():
    """``ops.prefill_attention_view`` over a float32 page pool read through
    a permuted table that maps one page into two rows (a chunk at a
    position past the first page), against the reference's
    ``prefill_attention_tiles`` in interpret mode."""
    rng = np.random.default_rng(72)
    b, sq, ps, nb, kvh, g, d = 3, 8, 8, 4, 2, 3, 16
    q = _f32_kv(rng, (b, sq, kvh, g, d))
    kp = _f32_kv(rng, (b * nb + 2, ps, kvh, d))
    vp = _f32_kv(rng, (b * nb + 2, ps, kvh, d))
    table = rng.permutation(b * nb + 2)[:b * nb].reshape(b, nb).astype(
        np.int32)
    table[1, 0] = table[0, 0]
    ones = np.ones(kvh, np.float32)
    q_start = np.array([0, 8, 19], np.int32)
    kv_len = np.array([8, 16, 27], np.int32)
    view = KernelView(to_tensor(kp), to_tensor(vp), to_tensor(table), ps)
    got = ops.prefill_attention_view(
        to_tensor(q), view, to_tensor(ones), to_tensor(ones),
        to_tensor(q_start), to_tensor(kv_len), causal=True).numpy()
    want = np.asarray(jpa.prefill_attention_tiles(
        *(jnp.asarray(a) for a in (q, kp, vp, table, ones, ones, q_start,
                                   kv_len)), causal=True, interpret=True))
    _close(got, want)


def test_meta_route_returns_the_asked_types():
    """The dry run's meta route: B3 returns the asked output type (float32
    or the default bf16), also into an ``out`` of either type; B2 over a
    float32 stream returns float32, as its plain version."""
    x = torch.empty((5, 64), device="meta")
    w = torch.empty((64, 32), dtype=torch.int8, device="meta")
    s = torch.empty((32,), device="meta")
    a = torch.empty((), device="meta")
    assert ops.quant_matmul(x, w, s, a).dtype == torch.bfloat16
    y = ops.quant_matmul(x, w, s, a, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and y.shape == (5, 32)
    out = torch.empty((5, 32), device="meta")
    assert ops.quant_matmul(x, w, s, a, out=out).dtype == torch.float32
    q = torch.empty((2, 4, 2, 3, 16), device="meta")
    kv = torch.empty((2, 8, 2, 16), device="meta")
    one = torch.empty((2,), device="meta")
    o = ops.prefill_attention(q, kv, kv, one, one, 0, 8)
    assert o.dtype == torch.float32 and o.shape == q.shape


def test_out_dtype_validation():
    """B3 takes a bfloat16 or float32 output and an ``out`` of the asked
    type; B2 keeps refusing mixed K/V types."""
    x, w = torch.zeros((3, 16)), torch.zeros((16, 8), dtype=torch.int8)
    one = torch.ones(())
    with pytest.raises(TypeError, match="out_dtype"):
        ops.quant_matmul(x, w, torch.ones(8), one, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="out must be"):
        ops.quant_matmul(x, w, torch.ones(8), one, out_dtype=torch.float32,
                         out=torch.zeros((3, 8), dtype=torch.bfloat16))
    q = torch.zeros((1, 2, 1, 1, 8))
    with pytest.raises(TypeError, match="one dtype"):
        ops.prefill_attention(q, torch.zeros((1, 2, 1, 8)),
                              torch.zeros((1, 2, 1, 8), dtype=torch.bfloat16),
                              torch.ones(1), torch.ones(1), 0, 2)


def test_dense_dequant_scale_is_the_references_division():
    """The Dense layers' combined dequant scale ``w_scale / s_x`` is the
    reference's own: ``repro.core.api._int8_matmul`` (its XLA path, jitted)
    on x = T_adj / levels over int8 weights of ones quantizes x to 1, so
    its float32 output is its compiled scale exactly; the port's
    ``_dequant_scale`` of its own ``s_x`` equals it bit for bit over 4096
    channels, where ``(w_scale * T) * (1 / levels)`` differs in the last
    bit."""
    from repro.core import api as JA
    from repro.core import quant as JQ
    from repro_torch.core import quant as TQ

    rng = np.random.default_rng(5)
    n = 4096
    w_scale = (rng.random(n) * 1e-3).astype(np.float32)
    t = np.float32(3.6599)
    x = np.full((1, 1), t / np.float32(127), np.float32)

    @jax.jit
    def reference(x, w_scale, t):
        return JA._int8_matmul(x, jnp.ones((1, n), jnp.int8), w_scale,
                               {"t_max": t, "alpha": jnp.float32(1.0)},
                               JQ.QuantSpec())

    want = np.asarray(reference(jnp.asarray(x), jnp.asarray(w_scale),
                                jnp.asarray(t)))[0]
    assert want.dtype == np.float32
    _, s_x = TA._act_scale({"t_max": torch.tensor(t),
                            "alpha": torch.tensor(1.0)}, TQ.QuantSpec(),
                           torch.from_numpy(w_scale))
    got = TA._dequant_scale(torch.from_numpy(w_scale), s_x).numpy()
    np.testing.assert_array_equal(got, want)
    other = (w_scale * t) * np.float32(1 / 127)
    assert (other != want).any()


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels' float32 branches run on "
                    "the card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("m", [1, 4, 8, 32, 128, 512, 2048])
def test_cuda_quant_matmul_float32_output_bit_exact(cuda_device, m, w_bits):
    """B3's float32 epilogue (tensor-core and cluster decode kernels)
    against the plain version, bit for bit, at a granite-moe expert
    width."""
    x, w_q, w_scale, act = (to_tensor(a).to(cuda_device) for a in
                            _qm_inputs(m, 1536, 512, w_bits, seed=m))
    before = tqm.launches_f32
    got = ops.quant_matmul(x, w_q, w_scale, act.reshape(()), w_bits=w_bits,
                           out_dtype=torch.float32)
    want = tref.quant_matmul_ref(x, w_q, w_scale, act.reshape(()), w_bits,
                                 out_dtype=torch.float32)
    assert tqm.launches_f32 == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cuda_prefill_attention_float32_kv(cuda_device, paged):
    """B2's float32 K/V branch (3xTF32) against the plain version at
    smollm-135m's heads, dense and through a block table; it counts as a
    float32 launch."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(3)
    b, sq, kvh, g, d, ps = 2, 96, 3, 3, 64, 16
    q = torch.randn((b, sq, kvh, g, d), generator=gen, device=dev)
    kv = [torch.randn((b, sq, kvh, d), generator=gen, device=dev)
          for _ in range(2)]
    one = torch.ones((kvh,), device=dev)
    qs = torch.zeros((b,), dtype=torch.int32, device=dev)
    kl = torch.full((b,), sq, dtype=torch.int32, device=dev)
    table = None
    if paged:
        table = torch.randperm(b * sq // ps, generator=gen, device=dev).to(
            torch.int32).reshape(b, sq // ps)
        kv = [t.reshape(b * sq // ps, ps, kvh, d)[table.reshape(-1).argsort()]
              for t in kv]
    before = tpa.launches_f32
    got = tpa.launch(q, *kv, one, one, qs, kl, table=table)
    want = (tref.prefill_attention_paged_ref(q, *kv, table, one, one, qs, kl)
            if paged else tref.prefill_attention_ref(q, *kv, one, one, qs, kl))
    assert tpa.launches_f32 == before + 1
    tol = ATTN_TOL * (1 + want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
