"""Mamba2 (state-space duality) block: the chunked SSD scan of prefill and
training, and the O(1)-state recurrent decode; counterpart of
``repro/models/ssm.py``.

Within a chunk the SSD output is an attention-like quadratic form under a
decay mask; across chunks a (B, H, N, P) state is carried by a linear
scan.  ``ssd_chunked`` also returns that scan's final carry, the decode
state after the whole sequence, so a prefill computes its projections
and its state once (the reference folds the state again with a
sequential scan of ``ssd_decode_step``; for a zero initial state the
carry is the same sum in another order, ROADMAP Queue C).

The six projections are quantizable ``Dense`` layers (z / x / B / C / dt
and out); ``a_log``, ``d_skip``, ``dt_bias``, ``conv_w`` and ``conv_b``
are float32 leaves that no mode quantizes.  Every path into the SSD
recursion crosses a nonlinearity (silu on the conv stream and the z gate,
softplus on dt), so the block declares no equalization pairs.

The elementwise forms are the reference's compiled ones (its optimized
CPU HLO): silu as ``x * (1 / (1 + exp(-x)))``, each op rounded in the
tensor's dtype; softplus as ``jax.nn.softplus`` evaluates it; the
convolutions' products contracted into fused multiply-adds in the orders
XLA's CPU backend gives them; the gate product ``y * silu(z)`` left in
float32 for the norm (XLA drops its bf16 rounding inside the fusion).
The float32 einsums must not run in TF32 on the card.
"""
from __future__ import annotations

import torch

from repro_torch.cache.ssm import SSMState
from repro_torch.models.layers import RMSNorm, check_no_tf32, silu_xla
from repro_torch.models.module import Dense, Module


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)), NaN passed through (``F.softplus`` switches to x past
    a threshold of 20 and rounds otherwise)."""
    y = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, y)


def _fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add: in float64, where
    the float32 product is exact, then back to float32."""
    return (a.double() * b.double() + c.double()).float()


def causal_conv1d(x, w, b=None):
    """Depthwise causal conv. x: (B, L, C); w: (K, C).  The reference's
    sum of K shifted products, as its CPU backend contracts it: the second
    product rounded, the first fused onto it, then each later one fused
    onto the sum; the bias added last."""
    k, length = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    taps = [xp[:, i:i + length] for i in range(k)]
    y = taps[0] * w[0]
    if k > 1:
        y = _fma(taps[0], w[0], taps[1] * w[1])
        for i in range(2, k):
            y = _fma(taps[i], w[i], y)
    if b is not None:
        y = y + b
    return y


def conv1d_decode(conv_state, x_t, w, b=None):
    """conv_state: (B, K-1, C) previous inputs; x_t: (B, 1, C).  Returns
    (the shifted window (B, K-1, C), y (B, 1, C)).  The reference's dot
    over the window, as its CPU backend sums it for three or more rows:
    the first product rounded, each later one fused on in order (one and
    two rows sum otherwise, ROADMAP Queue C)."""
    window = torch.cat([conv_state, x_t], dim=1)        # (B, K, C)
    y = window[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        y = _fma(window[:, i], w[i], y)
    y = y[:, None, :]
    if b is not None:
        y = y + b
    return window[:, 1:, :], y


def ssd_chunked(x, dt, a_log, b, c, *, chunk: int = 128):
    """Chunked SSD scan.

    x:  (B, L, H, P) inputs per head
    dt: (B, L, H)    post-softplus timesteps
    a_log: (H,)      A = -exp(a_log)
    b:  (B, L, G, N) input projections (G groups broadcast over heads)
    c:  (B, L, G, N) output projections
    Returns (y (B, L, H, P) in x's dtype, the final state (B, H, N, P)
    float32: the carry after the last chunk, from a zero state).  A
    ragged L pads with dt = 0, which makes the padded steps exact no-ops
    of the recursion."""
    bsz, l0, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hpg = h // g
    chunk = min(chunk, l0)
    length = -(-l0 // chunk) * chunk
    if length != l0:
        pad = length - l0
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    nc = length // chunk

    a = -torch.exp(a_log.float())
    dta = dt.float() * a                                  # (B, L, H)
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    dac = dta.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, g, n).float()
    cc = c.reshape(bsz, nc, chunk, g, n).float()

    cum = torch.cumsum(dac, dim=2)                        # (B, nc, Q, H)
    total = cum[:, :, -1, :]                              # (B, nc, H)

    # intra-chunk: decay[i, j] = exp(cum_i - cum_j) for i >= j, the exponent
    # clamped to 0 at masked entries BEFORE exp (exp overflows there, and
    # inf * 0 in the backward poisons every gradient upstream)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, diff, 0.0)) * causal
    scores = torch.einsum("bzign,bzjgn->bzijg", cc, bc)   # (B,nc,Q,Q,G)
    scores = scores.repeat_interleave(hpg, dim=-1)        # (B,nc,Q,Q,H)
    m = scores * decay * dtc[:, :, None, :, :]            # weight by dt_j
    y_intra = torch.einsum("bzijh,bzjhp->bzihp", m, xc)

    # chunk-local states: sum_j exp(total - cum_j) dt_j B_j (x) x_j
    rdecay = torch.exp(total[:, :, None, :] - cum)        # (B,nc,Q,H)
    bh = bc.repeat_interleave(hpg, dim=3)                 # (B,nc,Q,H,N)
    s_local = torch.einsum("bzqhn,bzqhp->bzhnp",
                           bh * (rdecay * dtc)[..., None], xc)

    # inter-chunk linear scan, emitting the state entering each chunk
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
    s_in = []
    for z in range(nc):
        s_in.append(state)
        state = (torch.exp(total[:, z])[:, :, None, None] * state
                 + s_local[:, z])
    s_in = torch.stack(s_in, dim=1)                       # (B,nc,H,N,P)

    ch = cc.repeat_interleave(hpg, dim=3)                 # (B,nc,Q,H,N)
    y_inter = torch.einsum("bzqhn,bzhnp->bzqhp",
                           ch * torch.exp(cum)[..., None], s_in)
    y = (y_intra + y_inter).reshape(bsz, length, h, p)
    return y[:, :l0].to(x.dtype), state


def ssd_decode_step(state, x_t, dt_t, a_log, b_t, c_t):
    """One recurrent step.

    state: (B, H, N, P); x_t: (B, H, P); dt_t: (B, H); b_t / c_t: (B, G,
    N) broadcast over heads.  Returns (new_state, y_t (B, H, P))."""
    hpg = x_t.shape[1] // b_t.shape[1]
    a = -torch.exp(a_log.float())
    da = torch.exp(dt_t.float() * a)                      # (B, H)
    bh = b_t.float().repeat_interleave(hpg, dim=1)        # (B, H, N)
    ch = c_t.float().repeat_interleave(hpg, dim=1)
    outer = bh[..., :, None] * x_t.float()[..., None, :]  # (B, H, N, P)
    new_state = da[:, :, None, None] * state + dt_t[:, :, None, None] * outer
    y = torch.einsum("bhn,bhnp->bhp", ch, new_state)
    return new_state, y.to(x_t.dtype)


class Mamba2Block(Module):
    def __init__(self, d_model: int, *, path: str, d_state: int = 128,
                 n_heads: int | None = None, head_dim: int = 64,
                 expand: int = 2, n_groups: int = 1, conv_width: int = 4,
                 chunk: int = 128, dtype=torch.bfloat16):
        self.d_model = d_model
        self.d_inner = expand * d_model
        self.head_dim = head_dim
        self.n_heads = n_heads or self.d_inner // head_dim
        assert self.n_heads * head_dim == self.d_inner
        self.d_state = d_state
        self.n_groups = n_groups
        self.conv_width = conv_width
        self.chunk = chunk
        self.path = path
        self.dtype = dtype
        gn = n_groups * d_state
        self.z_proj = Dense(d_model, self.d_inner, path=f"{path}/z_proj",
                            dtype=dtype)
        self.x_proj = Dense(d_model, self.d_inner, path=f"{path}/x_proj",
                            dtype=dtype)
        self.b_proj = Dense(d_model, gn, path=f"{path}/b_proj", dtype=dtype)
        self.c_proj = Dense(d_model, gn, path=f"{path}/c_proj", dtype=dtype)
        self.dt_proj = Dense(d_model, self.n_heads, path=f"{path}/dt_proj",
                             dtype=dtype)
        self.out_proj = Dense(self.d_inner, d_model, path=f"{path}/out_proj",
                              dtype=dtype, logical_axes=("heads", "embed"))
        self.norm = RMSNorm(self.d_inner, path=f"{path}/norm", dtype=dtype)

    @property
    def conv_channels(self) -> int:
        """The conv stream's width: x, B and C side by side."""
        return self.d_inner + 2 * self.n_groups * self.d_state

    def init(self, gen):
        dev, h = gen.device, self.n_heads
        return {
            "z_proj": self.z_proj.init(gen),
            "x_proj": self.x_proj.init(gen),
            "b_proj": self.b_proj.init(gen),
            "c_proj": self.c_proj.init(gen),
            "dt_proj": self.dt_proj.init(gen),
            "out_proj": self.out_proj.init(gen),
            "norm": self.norm.init(gen),
            "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
            "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
            "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
            "conv_w": torch.randn((self.conv_width, self.conv_channels),
                                  generator=gen, dtype=torch.float32,
                                  device=dev) * 0.1,
            "conv_b": torch.zeros((self.conv_channels,), dtype=torch.float32,
                                  device=dev),
        }

    def _project(self, params, u, ctx):
        """The five input projections: (z, x, B, C, dt) in u's dtype."""
        return tuple(proj(params[name], u, ctx) for name, proj in (
            ("z_proj", self.z_proj), ("x_proj", self.x_proj),
            ("b_proj", self.b_proj), ("c_proj", self.c_proj),
            ("dt_proj", self.dt_proj)))

    def _split(self, xbc):
        """The conved stream (..., C) -> x (..., H, P), B and C (..., G,
        N)."""
        di, gn = self.d_inner, self.n_groups * self.d_state
        lead = xbc.shape[:-1]
        return (xbc[..., :di].reshape(*lead, self.n_heads, self.head_dim),
                xbc[..., di:di + gn].reshape(*lead, self.n_groups,
                                             self.d_state),
                xbc[..., di + gn:].reshape(*lead, self.n_groups,
                                           self.d_state))

    def _gated_out(self, params, y, z, dtype, ctx):
        """out_proj(norm(y * silu(z))): y (..., d_inner) float32 rounds to
        the activation dtype, the product stays float32 into the norm,
        whose output rounds back."""
        p = y.to(dtype).float() * silu_xla(z).float()
        return self.out_proj(params["out_proj"],
                             self.norm(params["norm"], p).to(dtype), ctx)

    def _forward(self, params, u, ctx):
        """The chunked path: (y (B, L, d_model), the five projections'
        conv input (B, L, C) float32, the final SSD state)."""
        check_no_tf32(u, f"{self.path}: the SSD's float32 products")
        bsz, length, _ = u.shape
        z, xi, bi, ci, dt = self._project(params, u, ctx)
        xbc_raw = torch.cat([xi.float(), bi.float(), ci.float()], dim=-1)
        xbc = silu_xla(causal_conv1d(xbc_raw, params["conv_w"],
                                     params["conv_b"]))
        x_h, b_h, c_h = self._split(xbc)
        dt_s = softplus(dt.float() + params["dt_bias"])
        y, state = ssd_chunked(x_h, dt_s, params["a_log"], b_h, c_h,
                               chunk=self.chunk)
        y = y + params["d_skip"][None, None, :, None] * x_h
        y = y.reshape(bsz, length, self.d_inner)
        return self._gated_out(params, y, z, u.dtype, ctx), xbc_raw, state

    def __call__(self, params, u, ctx=None):
        """u: (B, L, d_model) -> (B, L, d_model); the training and
        calibration path."""
        return self._forward(params, u, ctx)[0]

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, device=None) -> SSMState:
        return SSMState.init(batch, self.n_heads, self.d_state,
                             self.head_dim, self.conv_width,
                             self.conv_channels, device=device)

    def prefill(self, params, u, state: SSMState, ctx=None):
        """The prompt's output, and its decode state written over
        ``state`` in place (a replayed prefill starts from zero whatever
        the buffers hold): the SSD carry, and the last K - 1 raw rows of
        the conv stream.  A prompt shorter than K - 1 rows raises."""
        if u.shape[1] < self.conv_width - 1:
            raise ValueError(
                f"{self.path}: a prompt of {u.shape[1]} tokens is shorter "
                f"than the conv window's {self.conv_width - 1} rows of "
                "decode state (the reference's decode fails on it)")
        y, xbc_raw, ssm = self._forward(params, u, ctx)
        state.write_(ssm, xbc_raw[:, -(self.conv_width - 1):])
        return y, state

    def decode(self, params, u, state: SSMState, ctx=None):
        """u: (B, 1, d_model) -> (y, state), the state advanced in place.
        O(1) in the sequence length."""
        check_no_tf32(u, f"{self.path}: the SSD's float32 products")
        bsz = u.shape[0]
        z, xi, bi, ci, dt = self._project(params, u, ctx)
        xbc = torch.cat([xi.float(), bi.float(), ci.float()], dim=-1)
        window, xbc = conv1d_decode(state.conv, xbc, params["conv_w"],
                                    params["conv_b"])
        x_t, b_t, c_t = self._split(silu_xla(xbc)[:, 0])
        dt_t = softplus(dt[:, 0].float() + params["dt_bias"])
        ssm, y_t = ssd_decode_step(state.ssm, x_t, dt_t, params["a_log"],
                                   b_t, c_t)
        state.write_(ssm, window)
        y_t = y_t + params["d_skip"][None, :, None] * x_t
        y = self._gated_out(params, y_t.reshape(bsz, 1, self.d_inner), z,
                            u.dtype, ctx)
        return y, state

    def equalization_pairs(self):
        """None: every producer -> consumer pair crosses a nonlinearity or
        the SSD recursion (the paper's §3.3 restriction)."""
        return []
