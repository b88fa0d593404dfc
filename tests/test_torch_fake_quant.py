"""The port's fused fake-quant (B5, ``ops.fake_quant``) against the
reference's ``repro.kernels.ops.fake_quant``.

On the CPU the port's forward is its plain version
(``ref.fake_quant_ref``); the reference's runs the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it.  Both compute in
float32 with true divisions and round half to even, so the outputs must
be bit-identical, bf16 included.  The STE backward is the reference's
``_fq_bwd``: dx is a masked copy of the incoming gradient (bit-identical),
dalpha a float32 sum over the rows, which the two packages take in another
order (rtol 1e-6), and the cotangent of t_max is zero.  Tests marked
``cuda`` hold the CUDA kernel against the plain version bit for bit and
skip where no CUDA device is present.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fake_quant as jfq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.bridge import to_tensor
from repro_torch.kernels import fake_quant as tfq
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

DALPHA_RTOL = 1e-6


def _inputs(m, n, dtype, seed, scalar_t=False):
    """x with a block of exact .5 ties of x * s, alphas below, inside and
    above [0.5, 1]."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, n)) * 2).astype(np.float32)
    t = (np.abs(rng.normal(size=(n,))) + 0.5).astype(np.float32)
    a = rng.uniform(0.3, 1.2, size=(n,)).astype(np.float32)
    a[:4] = [0.5, 1.0, 0.25, 1.5]          # the band's ends, and outside
    # columns 4..7: t_adj = 63.5 so s = 2 exactly, and x * s = k + 0.5
    t[4:8], a[4:8] = 63.5, 1.0
    # (|k| < 64 keeps (k + 0.5) / 2 exact in bfloat16 too)
    x[:, 4:8] = (rng.integers(-64, 64, size=(m, 4)) + 0.5) / 2.0
    if scalar_t:
        t = np.float32(63.5)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return x, np.asarray(t), a


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _ours(x, t, a):
    out = ops.fake_quant(to_tensor(x), to_tensor(t), to_tensor(a))
    if out.dtype == torch.bfloat16:
        return out.view(torch.uint16).numpy()
    return out.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scalar_t", [False, True], ids=["per_channel",
                                                         "scalar_t"])
def test_forward_bit_identical_to_pallas_interpret(dtype, scalar_t):
    """512 x 256, the benchmark's shape: ties, the alpha band's ends and
    alphas outside it, per-channel and scalar t_max."""
    x, t, a = _inputs(512, 256, dtype, seed=1, scalar_t=scalar_t)
    want = jops.fake_quant(jnp.asarray(x), jnp.asarray(t), jnp.asarray(a))
    np.testing.assert_array_equal(_ours(x, t, a), _bits(want))
    # the ties really are ties: x * s lands on k + 0.5
    s = 127.0 / 63.5
    assert np.all(np.abs(np.asarray(x[:, 4:8], np.float32) * s % 1) == 0.5)


def test_forward_scalar_alpha_bit_identical():
    """One alpha (and one t_max) for every column, broadcast as the TPU
    kernel does."""
    x, _, _ = _inputs(64, 128, "f32", seed=2)
    t, a = np.float32(3.0), np.float32(0.8)
    want = jops.fake_quant(jnp.asarray(x), jnp.asarray(t), jnp.asarray(a))
    np.testing.assert_array_equal(_ours(x, t, a), _bits(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ste_gradients_match_jax_grad(dtype):
    x, t, a = _inputs(512, 256, dtype, seed=3)
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def f_jax(x, t, a):
        return jnp.sum(jops.fake_quant(x, t, a).astype(jnp.float32) * w)

    gx, gt, ga = jax.grad(f_jax, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(a))
    xt, tt, at = (to_tensor(v).requires_grad_(True) for v in (x, t, a))
    y = ops.fake_quant(xt, tt, at)
    torch.sum(y.float() * torch.from_numpy(w)).backward()
    np.testing.assert_array_equal(_bits(xt.grad.view(
        torch.uint16 if dtype == "bf16" else torch.int32).numpy()),
        _bits(gx))
    assert not tt.grad.any() and not np.asarray(gt).any()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga),
                               rtol=DALPHA_RTOL, atol=0)
    # outside the band (a[2] = 0.25, a[3] = 1.5) alpha takes no gradient;
    # at its ends (0.5, 1.0) it does
    assert at.grad[2] == 0 and at.grad[3] == 0
    assert at.grad[0] != 0 and at.grad[1] != 0


def test_scalar_alpha_gradient_is_the_per_channel_sum():
    """One alpha for every column: the reference's backward returns a
    per-column dalpha for it and ``jax.grad`` raises on the shape; the
    port sums it, the gradient of the shared alpha."""
    x, t, _ = _inputs(512, 256, "f32", seed=6)
    a = np.float32(0.8)
    with pytest.raises(ValueError, match="shapes do not match"):
        jax.grad(lambda a: jnp.sum(jops.fake_quant(
            jnp.asarray(x), jnp.asarray(t), a)))(jnp.asarray(a))
    per_column = jax.grad(lambda a: jnp.sum(jops.fake_quant(
        jnp.asarray(x), jnp.asarray(t), a)))(jnp.full((256,), a))
    at = torch.tensor(a, requires_grad=True)
    ops.fake_quant(to_tensor(x), to_tensor(t), at).sum().backward()
    assert at.grad.shape == ()
    np.testing.assert_allclose(float(at.grad),
                               float(np.sum(np.asarray(per_column))),
                               rtol=DALPHA_RTOL)


def test_ragged_shape_where_the_tpu_kernel_asserts():
    """The TPU kernel asserts that M and N tile by 512; the port masks the
    ragged edge and gives the reference function's bits."""
    x, t, a = _inputs(1000, 1000, "bf16", seed=5)
    with pytest.raises(AssertionError):
        jfq.fake_quant_fwd(jnp.asarray(x), jnp.asarray(t), jnp.asarray(a),
                           interpret=True)
    want = jref.fake_quant_ref(jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(a))
    np.testing.assert_array_equal(_ours(x, t, a), _bits(want))


def test_entry_point_validates_inputs():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="one value or"):
        ops.fake_quant(x, torch.ones(4), torch.ones(8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fake_quant(x.half(), torch.ones(8), torch.ones(8))
    with pytest.raises(ValueError, match=r"\(M, N\)"):
        ops.fake_quant(torch.zeros(8), torch.ones(8), torch.ones(8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfq.launch(x, torch.ones(8), torch.ones(8))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(1024, 576), (1000, 1000)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_fake_quant_bit_exact(cuda_device, m, n, dtype):
    x, t, a = (to_tensor(v).to(cuda_device)
               for v in _inputs(m, n, dtype, seed=m + n))
    got = tfq.launch(x, t, a)
    want = tref.fake_quant_ref(x, t, a)
    assert torch.equal(got.cpu(), want.cpu())
