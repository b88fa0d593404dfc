"""The port's kernel entry points against the reference's kernels.

On the CPU each entry point runs its plain PyTorch version; these tests
hold it against the JAX oracle (``repro.kernels.ref``) and against the
Pallas kernel run in interpret mode, on the same numpy inputs.  Tests
marked ``cuda`` hold the hand-written CUDA kernel against the plain
version and skip where no CUDA device is present.

Tolerances: quant_matmul is integer arithmetic plus one float32 multiply
and one bf16 rounding, identical in both packages, so it must be
bit-exact.  The attentions sum float32 products in another order than
XLA (and fold the scales differently from the jnp oracle), so they agree
to atol 1e-5 on outputs of magnitude ~1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_int4
from repro.kernels import decode_attention as jda
from repro.kernels import prefill_attention as jpa
from repro.kernels import quant_matmul as jqm
from repro.kernels import ref as jref
from repro_torch.bridge import to_tensor
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops
from repro_torch.kernels import prefill_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref

ATOL = 1e-5


def _qm_inputs(m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    w_q = rng.integers(-127, 128, (k, n), dtype=np.int8)
    w_scale = (rng.random(n) * 1e-2).astype(np.float32)
    act_scale = np.float32(127.0 / (np.abs(x.astype(np.float32)).max() * 0.7))
    return x, w_q, w_scale, act_scale


def _ours_qm(x, w_q, w_scale, act_scale):
    out = ops.quant_matmul(to_tensor(x), to_tensor(w_q), to_tensor(w_scale),
                           to_tensor(np.asarray(act_scale)))
    return out.view(torch.uint16).numpy()


def _bits(jax_bf16):
    return np.asarray(jax_bf16).view(np.uint16)


@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("k,n", [(64, 32), (576, 192), (1536, 576), (40, 24)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quant_matmul_bit_exact_vs_jax_oracle(m, k, n, dtype):
    """Ragged M, K and N included (the port masks edges)."""
    x, w_q, w_scale, act_scale = _qm_inputs(m, k, n, dtype, seed=m + k + n)
    want = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w_q),
                                 jnp.asarray(w_scale), jnp.asarray(act_scale))
    np.testing.assert_array_equal(_ours_qm(x, w_q, w_scale, act_scale),
                                  _bits(want))


@pytest.mark.parametrize("m", [1, 5, 64])
def test_quant_matmul_bit_exact_vs_pallas_interpret(m):
    """Where K and N tile the TPU kernel's blocks, against the Pallas
    kernel itself."""
    x, w_q, w_scale, act_scale = _qm_inputs(m, 64, 32, "bf16", seed=m)
    want = jqm.quant_matmul(jnp.asarray(x), jnp.asarray(w_q),
                            jnp.asarray(w_scale), jnp.asarray(act_scale),
                            interpret=True)
    np.testing.assert_array_equal(_ours_qm(x, w_q, w_scale, act_scale),
                                  _bits(want))


def test_quant_matmul_smollm_widths_where_the_tpu_kernel_asserts():
    """The TPU kernel asserts that K and N tile by (512, 256); smollm-135m's
    K=576 does not.  The port takes these widths."""
    x, w_q, w_scale, act_scale = _qm_inputs(8, 576, 576, "bf16", seed=3)
    with pytest.raises(AssertionError, match="not tiled"):
        jqm.quant_matmul(jnp.asarray(x), jnp.asarray(w_q),
                         jnp.asarray(w_scale), jnp.asarray(act_scale),
                         interpret=True)
    want = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w_q),
                                 jnp.asarray(w_scale), jnp.asarray(act_scale))
    np.testing.assert_array_equal(_ours_qm(x, w_q, w_scale, act_scale),
                                  _bits(want))


def _w4_inputs(m, k, n, dtype, seed):
    """test_int4.py's int4-weight case: weights in [-7, 7], packed along
    K."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    w_raw = rng.integers(-7, 8, size=(k, n), dtype=np.int8)
    w_q = np.asarray(pack_int4(jnp.asarray(w_raw), axis=0))
    w_scale = (np.abs(rng.normal(size=(n,))) * 0.01 + 0.005).astype(
        np.float32)
    return x, w_raw, w_q, w_scale, np.float32(127.0 / 3.0)


@pytest.mark.parametrize("m", [1, 16, 40])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quant_matmul_int4_weights_bit_exact_vs_pallas_interpret(m, dtype):
    """``w_bits=4`` at test_int4.py's tiling (K=64, N=16, blocks 16 x 16 x
    32) against the Pallas kernel, and against the int8 branch on the
    unpacked weights."""
    x, w_raw, w_q, w_scale, act_scale = _w4_inputs(m, 64, 16, dtype, seed=m)
    want = jqm.quant_matmul(jnp.asarray(x), jnp.asarray(w_q),
                            jnp.asarray(w_scale), jnp.asarray(act_scale),
                            w_bits=4, block_m=16, block_n=16, block_k=32,
                            interpret=True)
    got = ops.quant_matmul(to_tensor(x), to_tensor(w_q), to_tensor(w_scale),
                           to_tensor(np.asarray(act_scale)), w_bits=4)
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  _bits(want))
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  _ours_qm(x, w_raw, w_scale, act_scale))


def _attn_inputs(b, sq, sk, kvh, g, d, seed, decode=False):
    rng = np.random.default_rng(seed)
    qshape = (b, kvh, g, d) if decode else (b, sq, kvh, g, d)
    q = rng.normal(size=qshape).astype(np.float32)
    k = rng.integers(-127, 128, (b, sk, kvh, d), dtype=np.int8)
    v = rng.integers(-127, 128, (b, sk, kvh, d), dtype=np.int8)
    ks = (rng.random(kvh) * 0.02 + 0.005).astype(np.float32)
    vs = (rng.random(kvh) * 0.02 + 0.005).astype(np.float32)
    return q, k, v, ks, vs


@pytest.mark.parametrize("cur_pos", [
    17, np.array([32, 9, 1], np.int32), np.array([0, 20, 5], np.int32)],
    ids=["scalar", "vector", "with_zero"])
def test_decode_attention_vs_jax(cur_pos):
    q, k, v, ks, vs = _attn_inputs(3, 1, 32, 2, 3, 16, seed=4, decode=True)
    args = [jnp.asarray(a) for a in (q, k, v, ks, vs)]
    pos_j = jnp.asarray(cur_pos, jnp.int32)
    pos_t = (cur_pos if isinstance(cur_pos, int)
             else torch.from_numpy(np.asarray(cur_pos)))
    got = ops.decode_attention(*[to_tensor(a) for a in (q, k, v, ks, vs)],
                               pos_t).numpy()
    oracle = np.asarray(jref.decode_attention_ref(*args, pos_j))
    pallas = np.asarray(jda.decode_attention_int8(*args, pos_j,
                                                  interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    if not isinstance(cur_pos, int):
        np.testing.assert_array_equal(got[np.asarray(cur_pos) == 0], 0.0)


@pytest.mark.parametrize("q_start,kv_len,window", [
    (0, [24, 24], None),
    (5, [20, 11], None),
    (8, [24, 3], 6),
], ids=["full", "q_start_kv_len", "window"])
def test_prefill_attention_vs_jax(q_start, kv_len, window):
    b, sq, sk = 2, 13, 24
    q, k, v, ks, vs = _attn_inputs(b, sq, sk, 2, 3, 16, seed=5)
    args = [jnp.asarray(a) for a in (q, k, v, ks, vs)]
    qs_j, kl_j = jnp.int32(q_start), jnp.asarray(kv_len, jnp.int32)
    got = ops.prefill_attention(
        *[to_tensor(a) for a in (q, k, v, ks, vs)], q_start,
        torch.tensor(kv_len, dtype=torch.int32), causal=True,
        window=window).numpy()
    oracle = np.asarray(jref.prefill_attention_ref(
        *args, qs_j, kl_j, causal=True, window=window))
    pallas = np.asarray(jpa.prefill_attention_int8(
        *args, qs_j, kl_j, causal=True, window=window, interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


def test_prefill_attention_per_request_q_start_vs_pallas():
    """A (B,) q_start vector, as the per-slot verify pass uses it."""
    q, k, v, ks, vs = _attn_inputs(2, 5, 24, 2, 3, 16, seed=6)
    qs, kl = np.array([3, 17], np.int32), np.array([8, 22], np.int32)
    got = ops.prefill_attention(*[to_tensor(a) for a in (q, k, v, ks, vs)],
                                torch.from_numpy(qs), torch.from_numpy(kl),
                                causal=True).numpy()
    pallas = np.asarray(jpa.prefill_attention_int8(
        *[jnp.asarray(a) for a in (q, k, v, ks, vs)], jnp.asarray(qs),
        jnp.asarray(kl), causal=True, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


def test_entry_points_validate_inputs():
    q, k, v, ks, vs = [to_tensor(a) for a in
                       _attn_inputs(2, 4, 8, 2, 3, 16, seed=7)]
    with pytest.raises(TypeError, match="int8"):
        ops.prefill_attention(q, k.float(), v, ks, vs, 0, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.prefill_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                              v[..., :12].contiguous(), ks, vs, 0, 8)
    with pytest.raises(ValueError, match="packed"):
        # kv_bits=4 takes D/2 packed bytes a row, not int8-wide tiles
        ops.prefill_attention(q, k, v, ks, vs, 0, 8, kv_bits=4)
    x = torch.zeros((3, 16))
    w = torch.zeros((16, 8), dtype=torch.int8)
    one = torch.ones(())
    with pytest.raises(ValueError, match="w_scale"):
        ops.quant_matmul(x, w, torch.ones(4), one)
    with pytest.raises(ValueError, match="packed"):
        # w_bits=4 takes (K/2, N) packed bytes, not an int8-wide matrix
        ops.quant_matmul(x, w, torch.ones(8), one, w_bits=4)
    with pytest.raises(ValueError, match="odd"):
        ops.quant_matmul(torch.zeros((3, 15)), w[:7], torch.ones(8), one,
                         w_bits=4)


@pytest.mark.parametrize("launch", [
    lambda: tqm.launch(torch.zeros((2, 8)), torch.zeros((8, 8), dtype=torch.int8),
                       torch.ones(8), torch.ones(())),
    lambda: tda.launch(torch.zeros((1, 1, 1, 8)),
                       torch.zeros((1, 4, 1, 8), dtype=torch.int8),
                       torch.zeros((1, 4, 1, 8), dtype=torch.int8),
                       torch.ones(1), torch.ones(1),
                       torch.ones(1, dtype=torch.int32)),
    lambda: tpa.launch(torch.zeros((1, 2, 1, 1, 8)),
                       torch.zeros((1, 2, 1, 8), dtype=torch.int8),
                       torch.zeros((1, 2, 1, 8), dtype=torch.int8),
                       torch.ones(1), torch.ones(1),
                       torch.zeros(1, dtype=torch.int32),
                       torch.full((1,), 2, dtype=torch.int32)),
], ids=["quant_matmul", "decode_attention", "prefill_attention"])
def test_cuda_launch_refuses_cpu_tensors(launch):
    """The kernel wrappers never fall back to the plain version."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# the decode kernel's rows (M <= 8: each of its four row bounds), the
# tensor-core kernel's small, admission and prefill rows at smollm-135m's
# K x N, and ragged K and N
CUDA_QMM_SHAPES = [(m, 576, 192) for m in (1, 3, 4, 8, 9, 17, 128, 2048)] + [
    (37, 100, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", CUDA_QMM_SHAPES)
def test_cuda_quant_matmul_bit_exact(cuda_device, m, k, n):
    x, w_q, w_scale, act_scale = [
        to_tensor(np.asarray(a)).to(cuda_device)
        for a in _qm_inputs(m, k, n, "bf16", seed=m)]
    np.testing.assert_array_equal(
        tqm.launch(x, w_q, w_scale, act_scale).cpu().view(torch.uint16),
        tref.quant_matmul_ref(x, w_q, w_scale, act_scale).cpu().view(
            torch.uint16))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", CUDA_QMM_SHAPES)
def test_cuda_quant_matmul_int4_weights_bit_exact(cuda_device, m, k, n):
    x, _, w_q, w_scale, act_scale = [
        to_tensor(np.asarray(a)).to(cuda_device)
        for a in _w4_inputs(m, k, n, "bf16", seed=m)]
    np.testing.assert_array_equal(
        tqm.launch(x, w_q, w_scale, act_scale, 4).cpu().view(torch.uint16),
        tref.quant_matmul_ref(x, w_q, w_scale, act_scale, 4).cpu().view(
            torch.uint16))


@pytest.mark.cuda
def test_cuda_attention_kernels_match_plain(cuda_device):
    dev = cuda_device
    q, k, v, ks, vs = [to_tensor(a).to(dev) for a in
                       _attn_inputs(2, 70, 100, 3, 3, 64, seed=8)]
    qs = torch.tensor([0, 30], dtype=torch.int32, device=dev)
    kl = torch.tensor([70, 100], dtype=torch.int32, device=dev)
    np.testing.assert_allclose(
        tpa.launch(q, k, v, ks, vs, qs, kl).cpu(),
        tref.prefill_attention_ref(q, k, v, ks, vs, qs, kl).cpu(),
        rtol=0, atol=1e-4)
    qd = q[:, 0].contiguous()
    pos = torch.tensor([0, 77], dtype=torch.int32, device=dev)
    np.testing.assert_allclose(
        tda.launch(qd, k, v, ks, vs, pos).cpu(),
        tref.decode_attention_ref(qd, k, v, ks, vs, pos).cpu(),
        rtol=0, atol=1e-4)


def _prefill_case(dev, b, sq, sk, g, d, q_dtype, bits, seed):
    """Seeded prefill inputs on ``dev``: q in ``q_dtype``, int8 or packed
    int4 K/V with chip_smoke.py's scale ranges, or (``bits`` 16) bf16 K/V
    with unit scales (a float cache)."""
    from repro_torch.core.packing import pack_int4 as tpack

    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, sq, 3, g, d)).astype(np.float32))
    if bits == 16:
        k, v = (torch.from_numpy(rng.normal(size=(b, sk, 3, d)).astype(
            np.float32)).to(torch.bfloat16) for _ in range(2))
        ks = vs = torch.ones(3)
        return [t.to(dev) for t in (q.to(q_dtype), k, v, ks, vs)]
    lv = 127 if bits == 8 else 7
    k, v = (torch.from_numpy(rng.integers(-lv, lv + 1, (b, sk, 3, d),
                                          dtype=np.int8)) for _ in range(2))
    if bits == 4:
        k, v = tpack(k), tpack(v)
    ks, vs = (torch.from_numpy((rng.random(3) * 0.05 + 0.01).astype(
        np.float32)) for _ in range(2))
    return [t.to(dev) for t in (q.to(q_dtype), k, v, ks, vs)]


def _kv_bits(bits):
    """The wrapper's kv_bits for a case's ``bits`` (a bf16 stream is 8)."""
    return 8 if bits == 16 else bits


# (q dtype, D, G, Sq, Sk, q_start, kv_len, window, K/V bits; 16: bf16 K/V):
# the edge cases of the tensor-core prefill kernel, a small grid of
# chip_smoke.py's
@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,d,g,sq,sk,q_start,kv_len,window,bits", [
    (torch.float32, 64, 3, 70, 100, [0, 30], [70, 100], None, 8),
    (torch.bfloat16, 8, 3, 33, 50, [0, 17], [50, 0], None, 4),
    (torch.float32, 40, 1, 65, 65, [0, 0], [65, 1], 20, 8),
    (torch.bfloat16, 128, 64, 5, 40, [35, 0], [40, 5], None, 4),
    (torch.bfloat16, 24, 1, 100, 100, [0, 0], [100, 37], 9, 8),
    (torch.bfloat16, 64, 3, 70, 100, [0, 30], [70, 100], None, 16),
    (torch.float32, 8, 3, 33, 50, [0, 17], [50, 0], None, 16),
    (torch.bfloat16, 72, 1, 65, 65, [0, 0], [65, 1], 20, 16),
    (torch.float32, 128, 64, 5, 40, [35, 0], [40, 5], None, 16),
], ids=["f32-d64", "d8-kvlen0-int4", "d40-g1-window", "d128-g64-int4",
        "d24-window", "bf16kv-d64", "bf16kv-d8-kvlen0-f32",
        "bf16kv-d72-g1-window", "bf16kv-d128-g64-f32"])
def test_cuda_prefill_attention_edge_cases(cuda_device, q_dtype, d, g, sq, sk,
                                           q_start, kv_len, window, bits):
    """Within chip_smoke.py's ATTN_TOL, 1e-4 x (1 + max |out|); a request
    with kv_len 0 is exact zeros."""
    dev = cuda_device
    q, k, v, ks, vs = _prefill_case(dev, 2, sq, sk, g, d, q_dtype, bits, 9)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    got = tpa.launch(q, k, v, ks, vs, qs, kl, window=window,
                     kv_bits=_kv_bits(bits)).cpu()
    want = tref.prefill_attention_ref(q, k, v, ks, vs, qs, kl, window=window,
                                      kv_bits=_kv_bits(bits)).cpu()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * (1 + want.abs().max().item()))
    empty = torch.tensor(kv_len) == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4, 16])
def test_cuda_prefill_paged_bit_identical_d128(cuda_device, bits):
    """A paged pool read through a permuted table gives the dense kernel's
    bits on the gathered copy, at the kernel's widest D."""
    dev = cuda_device
    page, nb = 16, 6
    q, k, v, ks, vs = _prefill_case(dev, 2, 40, nb * page, 3, 128,
                                    torch.bfloat16, bits, 10)
    k_pool = k.reshape((2 * nb, page) + tuple(k.shape[2:]))
    v_pool = v.reshape((2 * nb, page) + tuple(v.shape[2:]))
    table = torch.from_numpy(np.random.default_rng(11).permutation(
        2 * nb)[:2 * nb].reshape(2, nb).astype(np.int32)).to(dev)
    qs = torch.tensor([56, 0], dtype=torch.int32, device=dev)
    kl = torch.tensor([96, 40], dtype=torch.int32, device=dev)
    got = tpa.launch(q, k_pool, v_pool, ks, vs, qs, kl,
                     kv_bits=_kv_bits(bits), table=table)
    dense = tpa.launch(q, tref.gather_pages(k_pool, table).contiguous(),
                       tref.gather_pages(v_pool, table).contiguous(), ks, vs,
                       qs, kl, kv_bits=_kv_bits(bits))
    assert torch.equal(got, dense)


@pytest.mark.cuda
def test_cuda_prefill_bf16_kv_counts_and_float32_kv_raises(cuda_device):
    """A bf16 K/V launch counts as one, a float32 K/V launch (a float32
    cache, B2's float32 branch) as one of its own; float32 K/V past D 128
    has no kernel branch (the wide library, ROADMAP Queue B) and raises,
    with no fallback to the plain version."""
    dev = cuda_device
    q, k, v, ks, vs = _prefill_case(dev, 2, 40, 40, 3, 64, torch.bfloat16,
                                    16, 12)
    qs = torch.zeros(2, dtype=torch.int32, device=dev)
    kl = torch.full((2,), 40, dtype=torch.int32, device=dev)
    before = tpa.launches_bf16
    tpa.launch(q, k, v, ks, vs, qs, kl)
    assert tpa.launches_bf16 == before + 1
    before = tpa.launches_f32
    tpa.launch(q, k.float(), v.float(), ks, vs, qs, kl)
    assert tpa.launches_f32 == before + 1
    q, k, v, ks, vs = _prefill_case(dev, 2, 40, 40, 3, 160, torch.bfloat16,
                                    16, 12)
    with pytest.raises(TypeError, match="float32 K/V"):
        tpa.launch(q, k.float(), v.float(), ks, vs, qs, kl)
