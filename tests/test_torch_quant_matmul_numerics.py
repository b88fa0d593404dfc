"""The operand assembly of the tensor-core quant_matmul kernel (B3,
``csrc/quant_matmul.cu``), emulated on the CPU.

The kernel runs ``mma.sync.m16n8k32`` with s8 operands and s32 sums.  These
tests repeat, in numpy, what each lane of it does:

- the quantize: the float32 product x * s, a clamp to +-127, + 1.5 * 2^23,
  the low byte (``quantize_bits``), packed four at a time with
  ``__byte_perm`` (``pack4``);
- the x tile: rows of ``LDA`` bytes, read by ``ldmatrix.x4`` (b16) with the
  kernel's lane addresses; the weight tile: 16-byte chunks XOR-swizzled
  (``wchunk``), read as 32-bit words and transposed 4x4 with the kernel's
  ``__byte_perm`` selectors; int4 bytes unpacked as 16 x each nibble;
- the A, B and C fragment ownership of m16n8k32 as the PTX ISA gives it;
- the column map (n8 tile u holds the warp's columns 4g + u) and its
  inverse in the epilogue, the shift back by 4 at int4, float(acc) *
  w_scale and one bf16 rounding; rows and columns past M and N masked.

The emulation must give ``ref.quant_matmul_ref``'s bits: at smollm-135m's
widths, at small and ragged M, N and K, both weight widths, float32 and
bf16 x, on .5 ties of x * act_scale, past the clip, and where |acc| >
2^24.  Where the TPU kernel's tiling allows, it must also give the Pallas
kernel's bits in interpret mode.  The fragment loads must be free of bank
conflicts.

The decode kernel (M <= 8, K and N multiples of 4) is emulated the same
way: the cluster's K slices and each block's column tile, each thread's
16-byte (or 4-byte) pieces of weights and x, the quantize into packed
words, the 4x4 ``__byte_perm`` transpose, int4 as 16 x each nibble and the
shift back by 4, the sums over a block's threads (shuffles within a warp,
then shared memory across warps), each column's block sum sent to the
inbox of the cluster block that stores it, and that block's epilogue (its
columns, masked past M and N).  Every
weight byte must be read by exactly one thread of one block, and every
output stored exactly once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_int4 as jpack_int4
from repro.core.packing import unpack_int4 as junpack_int4
from repro.kernels import quant_matmul as jqm
from repro_torch.kernels import ref

BK, LDA = 64, 80          # k a step; bytes a row of the x tile
SMS = 132                 # H100 SXM streaming multiprocessors
# (BM, BN, MT): the kernel's tiles, largest first; warps of 16*MT x 32
TILES = ((64, 128, 4), (32, 128, 2), (32, 64, 1))
NARROW = (32, 64, 1)
MAGIC = np.float32(12582912.0)    # 1.5 * 2^23
SMOLLM = ((576, 576), (576, 192), (576, 1536), (1536, 576))


def byte_perm(x, y, sel):
    """CUDA ``__byte_perm(x, y, sel)``: byte i of the result is byte
    (sel >> 4i) & 7 of the eight bytes y:x (x holds bytes 0-3)."""
    v = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(v.shape, np.uint64)
    for i in range(4):
        s = (sel >> (4 * i)) & 0xF
        assert s < 8, "the kernel's selectors never set the sign bit"
        out |= ((v >> np.uint64(8 * s)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def quantize_bits(x, s):
    f = np.minimum(np.maximum(np.float32(x) * np.float32(s), np.float32(-127)),
                   np.float32(127))
    return (f + MAGIC).view(np.uint32)


def pack4(a, b, c, d):
    return byte_perm(byte_perm(a, b, 0x0040), byte_perm(c, d, 0x0040), 0x5410)


def transpose4x4(w):
    """The kernel's 4x4 byte transpose: c[j] byte i = byte j of w[i]."""
    lo01 = byte_perm(w[0], w[1], 0x5140)
    hi01 = byte_perm(w[0], w[1], 0x7362)
    lo23 = byte_perm(w[2], w[3], 0x5140)
    hi23 = byte_perm(w[2], w[3], 0x7362)
    return [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]


def wchunk(r, c, bn, rg):
    """Byte offset of 16-byte chunk c of weight tile row r."""
    return ((r * (bn // 16) + c) ^ (((r // rg) & 3) << 1)) << 4


def bytes_of(words):
    """(..., ) uint32 -> (..., 4) int8, little-endian."""
    return np.ascontiguousarray(words, np.uint32).view(np.int8).reshape(
        *np.shape(words), 4)


def words_at(flat, off):
    """32-bit words of ``flat`` (blocks, bytes) int8 at byte offsets
    ``off`` (any shape): (blocks, *off.shape) uint32."""
    b = flat[:, off[..., None] + np.arange(4)].view(np.uint8).astype(np.uint32)
    return (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24)


LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3
# PTX m16n8k32 .s8 fragments: A register q byte b of lane L holds A[row, col]
A_ROW = (G[:, None, None] + 8 * (np.arange(4)[None, :, None] & 1)
         + 0 * np.arange(4)[None, None, :])
A_COL = (16 * (np.arange(4)[None, :, None] >> 1) + 4 * T[:, None, None]
         + np.arange(4)[None, None, :])
# B register h byte j of lane L holds B[k, n]; C register e holds D[row, col]
B_K = 16 * np.arange(2)[None, :, None] + 4 * T[:, None, None] + np.arange(4)
B_N = np.broadcast_to(G[:, None, None], B_K.shape)
C_ROW = G[:, None] + 8 * (np.arange(4)[None, :] >> 1)
C_COL = 2 * T[:, None] + (np.arange(4)[None, :] & 1)


# the decode kernel: threads a block, bytes of its slab, k quads a stage,
# blocks a cluster (``DEC_*`` in the source)
DEC_NT, DEC_BUF, DEC_SQ, DEC_CMAX = 256, 32768, 128, 4


def decode_split(k, n, sms=SMS):
    """(BN, C) of the decode kernel (``launch_decode`` in the source): the
    largest power-of-two cluster <= 4 with 64 k or more a block, and the
    widest column tile that still gives half the SMs a block."""
    c = 1
    while c < DEC_CMAX and 2 * c * 64 <= k:
        c *= 2
    bn = 128
    while bn > 32 and -(-n // bn) * c < sms // 2:
        bn //= 2
    return bn, c


def dispatch(m, k, n, x_dtype, aligned=True):
    """The kernel's choice (``dispatch`` in the source): ("decode", BN, C)
    where the decode kernel takes the call, else the tensor-core kernel's
    (tile, VEC)."""
    if m <= 8 and n % 4 == 0 and k % 4 == 0 and k > 0:
        return ("decode", *decode_split(k, n))
    e = 16 // np.dtype(x_dtype).itemsize if x_dtype != "bf16" else 8
    if not aligned or k % e or n % 16:
        return NARROW, False
    blocks = [-(-m // bm) * -(-n // bn) for bm, bn, _ in TILES]
    if blocks[0] >= 2 * SMS:
        return TILES[0], True
    return (TILES[1] if 2 * blocks[1] >= SMS else TILES[2]), True


def emulate(x, w_q, w_scale, act_scale, w_bits, tile):
    """The kernel's output bits, (M, N) uint16, lane by lane.  x: (M, K)
    float32 (holding bf16 values for a bf16 x); w_q: (K, N) int8 or (K/2,
    N) packed int4."""
    bm_, bn_, mt_ = tile
    m, k = x.shape
    kw, n = w_q.shape
    kr, rg = BK * w_bits // 8, 4 * w_bits // 8
    wm_n, wn_n = bm_ // (16 * mt_), bn_ // 32
    nk = -(-k // BK)
    nbm, nbn = -(-m // bm_), -(-n // bn_)
    mp, np_ = nbm * bm_, nbn * bn_

    # quantized x: zeros past M and K, packed four at a time
    xz = np.zeros((mp, nk * BK), np.float32)
    xz[:m, :k] = x
    q = quantize_bits(xz, act_scale).reshape(mp, -1, 4)
    xq = bytes_of(pack4(q[..., 0], q[..., 1], q[..., 2], q[..., 3])).reshape(
        mp, nk * BK)
    wz = np.zeros((nk * kr, np_), np.int8)
    wz[:kw, :n] = w_q

    # the kernel's lane addresses into its shared tiles
    wm, mt = np.arange(wm_n), np.arange(mt_)
    a_row_addr = ((wm[:, None, None] * 16 * mt_ + mt[None, :, None] * 16
                   + (LANE & 7) + (LANE & 8)) * LDA + (LANE >> 4) * 16)
    col = np.arange(wn_n)[:, None] * 32 + 4 * G          # (wn, lane)
    boff = [wchunk(rg * T + i, col >> 4, bn_, rg) + (col & 15)
            for i in range(rg)]
    r_c, c_c = np.meshgrid(np.arange(kr), np.arange(bn_ // 16), indexing="ij")
    dst = wchunk(r_c, c_c, bn_, rg)
    assert sorted(dst.ravel()) == list(range(0, kr * bn_, 16)), "a bijection"

    acc = np.zeros((mp, np_), np.int64)     # C fragments, fragment columns
    for step in range(nk):
        xs = np.full((nbm, bm_, LDA), 0x55, np.int8)     # padding: never read
        xs[:, :, :BK] = xq[:, step * BK:(step + 1) * BK].reshape(nbm, bm_, BK)
        xs = xs.reshape(nbm, bm_ * LDA)
        tile_w = wz[step * kr:(step + 1) * kr].reshape(kr, nbn, bn_ // 16, 16)
        ws = np.full((nbn, kr * bn_), 0x55, np.int8)
        ws[:, dst[..., None] + np.arange(16)] = tile_w.transpose(1, 0, 2, 3)
        for kk in range(BK // 32):
            # A: ldmatrix.x4, lane 8q + i gives row i of matrix q; lane L gets
            # bytes 4 (L % 4) .. of row L / 4 of each matrix
            addr = a_row_addr + kk * 32                  # (wm, mt, lane)
            src = addr[..., (8 * np.arange(4))[None, :] + G[:, None]]
            src = src + 4 * T[:, None]                   # (wm, mt, L, q)
            regs = xs[:, src[..., None] + np.arange(4)]  # bm, wm, mt, L, q, b
            a_full = np.zeros((nbm, wm_n, mt_, 16, 32), np.float64)
            a_full[:, :, :, A_ROW, A_COL] = regs
            a_full = a_full.reshape(mp, 32)
            # B: 32-bit words of the swizzled tile, transposed 4x4
            b_full = np.zeros((32, nbn, wn_n, 4, 8), np.float64)
            for h in range(2):
                half = (2 * kk + h) * 16 * rg // 4 * bn_
                wds = []
                for i in range(rg):
                    p = words_at(ws, boff[i] + half)
                    wds += ([p] if w_bits == 8 else
                            [(p << 4) & 0xF0F0F0F0, p & 0xF0F0F0F0])
                for u, word in enumerate(transpose4x4(wds)):
                    vals = bytes_of(word)                # (bn, wn, lane, j)
                    b_full[B_K[:, h, :], :, :, u, B_N[:, h, :]] = \
                        vals.transpose(2, 3, 0, 1)
            # D = A @ B per tile; exact in float64
            acc += (a_full @ b_full.reshape(32, np_)).astype(np.int64)

    acc32 = acc.astype(np.uint32).view(np.int32)         # the int32 wrap
    out = np.zeros((m, n), np.uint16)
    sc = np.zeros(np_, np.float32)
    sc[:n] = w_scale
    # epilogue: lane (g, t) of warp (wm, wn), m16 tile mt, rows g and g + 8
    for hr in range(2):
        rows = (np.arange(nbm)[:, None, None, None] * bm_
                + wm[None, :, None, None] * 16 * mt_
                + mt[None, None, :, None] * 16 + G + 8 * hr)
        for j in range(8):
            ncol = (np.arange(nbn)[:, None, None] * bn_
                    + np.arange(wn_n)[None, :, None] * 32 + 8 * T)
            fcol = ncol - 8 * T + (j & 3) * 8 + 2 * T + (j >> 2)
            r = rows.reshape(-1, 1)
            c_act, c_frag = ncol.reshape(1, -1) + j, fcol.reshape(1, -1)
            v = acc32[r, c_frag]
            if w_bits == 4:
                v = v >> 4
            f = v.astype(np.float32) * sc[c_act]
            bits = torch.from_numpy(f).to(torch.bfloat16).view(
                torch.uint16).numpy()
            ok = (r < m) & (c_act < n)
            out[np.broadcast_to(r, ok.shape)[ok],
                np.broadcast_to(c_act, ok.shape)[ok]] = bits[ok]
    return out


def bf16_bits(f):
    """float32 -> bf16 bits, rounded to nearest even (torch's conversion)."""
    return torch.from_numpy(np.ascontiguousarray(f, np.float32)).to(
        torch.bfloat16).view(torch.uint16).numpy()


def quantize_pieces(xp, s, x_dtype):
    """``quantize_chunk``: 16-byte pieces of x (P, E) (bf16 values held as
    float32) -> their quantized bytes (P, E), through the kernel's words."""
    if x_dtype == "bf16":   # word i holds elements 2i (low half), 2i + 1
        h = (xp.view(np.uint32) >> 16).reshape(-1, 4, 2)
        u = h[..., 0] | (h[..., 1] << 16)
        lo = quantize_bits((u << 16).view(np.float32), s)
        hi = quantize_bits((u & 0xFFFF0000).view(np.float32), s)
        q = np.stack([lo, hi], -1).reshape(-1, 8)
        words = [pack4(*q[:, 4 * h_:4 * h_ + 4].T) for h_ in range(2)]
    else:
        q = quantize_bits(xp, s)
        words = [pack4(*q.T)]
    return bytes_of(np.stack(words, -1)).reshape(len(xp), -1)


def emulate_decode(x, w_q, w_scale, act_scale, w_bits, x_dtype, split=None,
                   aligned=True, trace=None):
    """The decode kernel's output bits, (M, N) uint16, thread by thread.
    ``aligned=False``: pointers not on 16 bytes (4-byte weight words,
    element-wise x).  ``trace`` (a dict) receives ``reads``: (K rows of
    w_q, N) count of compute-step reads of each weight byte, and
    ``stores``: (M, N) count of stores of each output."""
    m, k = x.shape
    kw, n = w_q.shape
    mr = next(r for r in (1, 2, 4, 8) if m <= r)
    bn, cl = split or decode_split(k, n)
    lg = bn.bit_length() - 1
    e = 8 if x_dtype == "bf16" else 4
    rq, p, cqn = w_bits // 2, bn + 16, bn // 4
    nks = DEC_NT // cqn
    kc = -(-(-(-k // cl)) // 8) * 8
    sq = min(DEC_SQ, DEC_BUF // (rq * p)) & ~1
    wvec = aligned and n % 16 == 0
    xvec = aligned and k % e == 0
    wflat = np.ascontiguousarray(w_q).reshape(-1)
    reads = np.zeros((kw, n), int)
    stores = np.zeros((m, n), int)
    out = np.zeros((m, n), np.uint16)
    for t in range(-(-n // bn)):
        n0 = t * bn
        own = bn // cl
        # each block's inbox [rank][m][own]; -2**40: never written
        inbox = np.full((cl, cl * mr * own), -2**40, np.int64)
        for r in range(cl):
            k0 = r * kc
            nq = min(k - k0, kc) // 4
            assert nq >= 1, "a block without k never opens its inbox"
            acc = np.zeros((DEC_NT, mr, 4), np.int64)
            for q0 in range(0, nq, sq):
                qn, kb = min(sq, nq - q0), k0 + 4 * q0
                rn, rb = qn * rq, kb * w_bits // 8
                # the weight slab: pieces of `width` bytes, zeros past N;
                # origin: the w_q row and column of each byte (-1: a zero
                # fill, -2: never written)
                buf = np.full(DEC_BUF, 0x55, np.int8)
                org_r = np.full(DEC_BUF, -2)
                org_c = np.full(DEC_BUF, -2)
                width = 16 if wvec else 4
                i = np.arange(rn * (bn // width))
                rr = i >> (lg - (4 if wvec else 2))
                cc = width * (i & (bn // width - 1))
                ok = n0 + cc < n
                for b in range(width):
                    src = np.where(ok, (rb + rr) * n + n0 + cc + b, 0)
                    buf[rr * p + cc + b] = np.where(ok, wflat[src], 0)
                    org_r[rr * p + cc + b] = np.where(ok, rb + rr, -1)
                    org_c[rr * p + cc + b] = np.where(ok, n0 + cc + b, -1)
                # the stage's x, quantized; rows past M zeros
                kn = 4 * qn
                xq = np.full((mr, 4 * DEC_SQ), 0x55, np.int8)
                if xvec:    # warp w: row w, lane l: pieces l, l + 32, ...
                    ppr = kn // e
                    xp = 4 * DEC_SQ // e // 32
                    wid, lane, j = np.meshgrid(np.arange(8), np.arange(32),
                                               np.arange(xp), indexing="ij")
                    p_ = (lane + 32 * j).ravel()
                    wid = wid.ravel()
                    load = (wid < m) & (p_ < ppr)
                    rows = np.zeros((len(p_), e), np.float32)
                    cols = kb + e * p_[load, None] + np.arange(e)
                    rows[load] = x[wid[load, None], cols]
                    qb = quantize_pieces(rows, act_scale, x_dtype)
                    st_ = (wid < mr) & (p_ < ppr)
                    xq[wid[st_, None], e * p_[st_, None] + np.arange(e)] = \
                        qb[st_]
                else:
                    for mm in range(mr):
                        xq[mm, :kn] = (bytes_of(quantize_bits(
                            x[mm, kb:kb + kn], act_scale))[:, 0]
                            if mm < m else 0)
                # thread (cq, ks) takes quads q = ks (mod NKS): pairs (q, cq)
                q, cq = np.meshgrid(np.arange(qn), np.arange(cqn),
                                    indexing="ij")
                tid = (q % nks) * cqn + cq
                base = q * rq * p + 4 * cq
                flat = buf[None]
                if w_bits == 8:
                    offs = [base + i_ * p for i_ in range(4)]
                    rows4 = [words_at(flat, o)[0] for o in offs]
                else:
                    offs = [base, base + p]
                    p0, p1 = (words_at(flat, o)[0] for o in offs)
                    rows4 = [(p0 << 4) & 0xF0F0F0F0, p0 & 0xF0F0F0F0,
                             (p1 << 4) & 0xF0F0F0F0, p1 & 0xF0F0F0F0]
                for o in offs:
                    at = o[..., None] + np.arange(4)
                    assert (org_r[at] != -2).all(), "read of an unwritten byte"
                    hit = org_r[at] >= 0
                    np.add.at(reads, (org_r[at][hit], org_c[at][hit]), 1)
                c = transpose4x4(rows4)     # c[j]: the four k of column j
                a = words_at(xq.reshape(1, -1), (np.arange(mr)[:, None]
                                                 * 4 * DEC_SQ + 4 * q[:, 0]))
                a = bytes_of(a[0]).astype(np.int64)        # (MR, qn, 4)
                for j in range(4):
                    cb = bytes_of(c[j]).astype(np.int64)   # (qn, CQ, 4)
                    dot = np.einsum("mqb,qcb->qcm", a, cb)
                    np.add.at(acc[:, :, j], tid.ravel(),
                              dot.reshape(-1, mr))
            # the block's sums: lanes of a warp that share columns meet by
            # shuffles (xor CQ, 2 CQ, ... < 32), then lanes < CQ of each warp
            # write red[warp][m][BN]; thread (m, cq) adds the warps' sums and
            # sends them to block 4cq / own's inbox
            tid = np.arange(DEC_NT)
            o = cqn
            while o < 32:
                acc = acc + acc[tid ^ o]
                o <<= 1
            red = np.full((DEC_NT // 32, mr, bn), -2**40, np.int64)
            wr = tid[(tid & 31) < cqn]
            for j in range(4):
                red[wr >> 5, :, 4 * (wr & (cqn - 1)) + j] = acc[wr, :, j]
            assert (red != -2**40).all(), "a sum never written"
            i = np.arange(mr * cqn)
            mm, cc = i >> (lg - 2), 4 * (i & (cqn - 1))
            dst = cc // own
            at = ((r * mr + mm) * own + cc - dst * own)[:, None] + np.arange(4)
            assert len(set(zip(dst, at[:, 0]))) == len(i)
            assert (inbox[dst[:, None], at] == -2**40).all()
            inbox[dst[:, None], at] = red.sum(0)[mm[:, None],
                                                 cc[:, None] + np.arange(4)]
        # block r stores columns r*own ..: four a thread, its C inbox entries
        for r in range(cl):
            c0 = r * own
            sc = np.array([w_scale[n0 + c0 + i] if n0 + c0 + i < n else 0
                           for i in range(own)], np.float32)
            i = np.arange(mr * own // 4)
            mm, j = i // (own // 4), 4 * (i % (own // 4))
            live = (mm < m) & (n0 + c0 + j < n)
            mm, j = mm[live], j[live]
            got = np.stack([inbox[r, ((b * mr + mm) * own + j)[:, None]
                                  + np.arange(4)] for b in range(cl)])
            assert (got != -2**40).all(), "an inbox entry never written"
            tot = got.sum(0).astype(np.uint32).view(np.int32)
            if w_bits == 4:
                tot = tot >> 4
            f = tot.astype(np.float32) * sc[j[:, None] + np.arange(4)]
            cols = n0 + c0 + j[:, None] + np.arange(4)
            out[mm[:, None], cols] = bf16_bits(f)
            np.add.at(stores, (np.broadcast_to(mm[:, None], cols.shape),
                               cols), 1)
    if trace is not None:
        trace.update(reads=reads, stores=stores)
    return out


def plain_bits(x, w_q, w_scale, act_scale, w_bits, x_dtype):
    xt = torch.from_numpy(x)
    if x_dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    got = ref.quant_matmul_ref(xt, torch.from_numpy(w_q),
                               torch.from_numpy(w_scale),
                               torch.tensor(act_scale), w_bits)
    return got.view(torch.uint16).numpy()


def inputs(m, k, n, w_bits, x_dtype, seed, ties=False):
    """x with values past the clip and, with ``ties``, many products
    x * act_scale on exact .5 ties (act_scale = 4: x = (i + .5) / 4)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
    if ties:
        act = np.float32(4.0)
        x = ((rng.integers(-300, 300, (m, k)) + 0.5) / 4).astype(np.float32)
    else:
        act = np.float32(127.0 / (np.abs(x).max() * 0.6))
    if x_dtype == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    hi = 8 if w_bits == 4 else 128
    w = rng.integers(-hi, hi, (k, n), dtype=np.int8)
    if w_bits == 4:
        w = np.array(jpack_int4(jnp.asarray(w), axis=0))
    w_scale = (rng.random(n) * 1e-2 + 1e-3).astype(np.float32)
    return x, w, w_scale, act


def check(m, k, n, w_bits, x_dtype, seed=0, tile=None, **kw):
    x, w, ws, act = inputs(m, k, n, w_bits, x_dtype, seed, **kw)
    tile = tile or dispatch(m, k, n, x_dtype)[0]
    np.testing.assert_array_equal(emulate(x, w, ws, act, w_bits, tile),
                                  plain_bits(x, w, ws, act, w_bits, x_dtype))


def check_decode(m, k, n, w_bits, x_dtype, seed=0, ties=False, **kw):
    x, w, ws, act = inputs(m, k, n, w_bits, x_dtype, seed, ties=ties)
    np.testing.assert_array_equal(
        emulate_decode(x, w, ws, act, w_bits, x_dtype, **kw),
        plain_bits(x, w, ws, act, w_bits, x_dtype))


def test_byte_perm_selects_bytes_of_y_x():
    x, y = np.uint32(0x33221100), np.uint32(0x77665544)
    assert byte_perm(x, y, 0x3210) == 0x33221100
    assert byte_perm(x, y, 0x7654) == 0x77665544
    assert byte_perm(x, y, 0x5140) == 0x55114400
    assert byte_perm(x, y, 0x0040) == 0x00004400


def test_transpose4x4_and_pack4():
    rng = np.random.default_rng(0)
    w = [np.uint32(v) for v in rng.integers(0, 2**32, 4, dtype=np.uint64)]
    c = transpose4x4(w)
    for i in range(4):
        for j in range(4):
            assert int(c[j]) >> 8 * i & 0xFF == int(w[i]) >> 8 * j & 0xFF
    q = quantize_bits(np.array([1.0, -2.0, 127.0, -127.0], np.float32),
                      np.float32(1))
    assert bytes_of(pack4(*q)).tolist() == [1, -2, 127, -127]


def test_quantize_bits_is_rint_then_clip():
    """Half to even on exact ties, the clip, the extremes (F2I saturates,
    the clamp gives the same +-127)."""
    s = np.float32(1.0)
    ties = np.arange(-140, 140, dtype=np.float32) + np.float32(0.5)
    rng = np.random.default_rng(1)
    big = rng.normal(size=4096).astype(np.float32) * 200
    vals = np.concatenate([ties, big,
                           np.array([0.0, -0.0, 0.49999997, -0.49999997, 1e30,
                                     -1e30, np.inf, -np.inf], np.float32)])
    got = bytes_of(quantize_bits(vals, s))[..., 0]
    want = np.clip(np.rint(vals.astype(np.float64)), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(got, want)


def test_int4_unpack_is_16x_each_nibble():
    p = np.arange(256, dtype=np.uint32)
    p = p | (p << 8) | (p << 16) | (p << 24)
    lo = bytes_of((p << 4) & 0xF0F0F0F0)[:, 0].astype(int)
    hi = bytes_of(p & 0xF0F0F0F0)[:, 0].astype(int)
    b = np.arange(256)
    np.testing.assert_array_equal(lo, 16 * (((b & 15) ^ 8) - 8))
    np.testing.assert_array_equal(hi, 16 * (((b >> 4) ^ 8) - 8))


def test_fragment_ownership_covers_each_element_once():
    a = np.zeros((16, 32), int)
    np.add.at(a, (A_ROW, A_COL), 1)
    b = np.zeros((32, 8), int)
    np.add.at(b, (B_K, B_N), 1)
    c = np.zeros((16, 8), int)
    np.add.at(c, (C_ROW, C_COL), 1)
    assert (a == 1).all() and (b == 1).all() and (c == 1).all()


def test_column_map_and_its_inverse():
    """Tile u column g is the warp's column 4g + u; a lane's value j of row
    g is fragment column 2t + j // 4 of tile j % 4, and is column 8t + j."""
    seen = np.zeros(32, int)
    for t in range(4):
        for j in range(8):
            u, fc = j % 4, 2 * t + j // 4
            assert 4 * fc + u == 8 * t + j
            seen[8 * t + j] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("bn", [64, 128])
def test_fragment_loads_are_free_of_bank_conflicts(w_bits, bn):
    """Every 32-bit B fragment load of a warp hits 32 banks; each 8-lane
    phase of ldmatrix and of the cp.async stores hits distinct 16-byte bank
    groups."""
    kr, rg = BK * w_bits // 8, 4 * w_bits // 8
    for wn in range(bn // 32):
        col = wn * 32 + 4 * G
        for kk in range(BK // 32):
            for h in range(2):
                rows = ([kk * 32 + h * 16 + 4 * T + i for i in range(4)]
                        if w_bits == 8 else
                        [kk * 16 + h * 8 + 2 * T + i for i in range(2)])
                for r in rows:
                    banks = (wchunk(r, col >> 4, bn, rg) + (col & 15)) // 4 % 32
                    assert len(set(banks)) == 32
    c = np.arange(kr * bn // 16)
    dst = wchunk(c // (bn // 16), c % (bn // 16), bn, rg)
    for ph in range(0, len(c), 8):
        assert len(set(dst[ph:ph + 8] // 16 % 8)) == 8
    for q in range(4):
        addr = (np.arange(8) + 8 * (q & 1)) * LDA + 16 * (q >> 1)
        assert len(set(addr // 16 % 8)) == 8


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("bn", [64, 128])
def test_hoisted_b_offsets_equal_the_swizzle(w_bits, bn):
    """The kernel computes a lane's B word offsets once: row RG*t + i of
    each 16-k half sits at boff[i] plus the half's rows times BN."""
    kr, rg = BK * w_bits // 8, 4 * w_bits // 8
    for wn in range(bn // 32):
        col = wn * 32 + 4 * G
        for half in range(kr // (4 * rg)):
            for i in range(rg):
                r = half * 4 * rg + rg * T + i
                direct = wchunk(r, col >> 4, bn, rg) + (col & 15)
                hoisted = (wchunk(rg * T + i, col >> 4, bn, rg) + (col & 15)
                           + half * 16 * rg // 4 * bn)
                np.testing.assert_array_equal(direct, hoisted)


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("tile", TILES)
def test_staging_offsets_computed_once(tile, w_bits):
    """A thread's weight pieces j of a step sit at its first piece's
    swizzled offset plus j * WRS rows (WRS threads to a column of pieces):
    the swizzle does not change over WRS rows."""
    bm, bn, mt = tile
    nt = 32 * (bm // (16 * mt)) * (bn // 32)
    kr, rg = BK * w_bits // 8, 4 * w_bits // 8
    wrs = nt // (bn // 16)
    assert kr % wrs == 0 and wrs % (4 * rg) == 0
    tid = np.arange(nt)
    r0, c = tid // (bn // 16), tid % (bn // 16)
    seen = []
    for j in range(kr // wrs):
        off = wchunk(r0 + j * wrs, c, bn, rg)
        np.testing.assert_array_equal(off, wchunk(r0, c, bn, rg) + j * wrs * bn)
        seen += list(off)
    assert sorted(seen) == list(range(0, kr * bn, 16))


def test_dispatch_picks_the_tiles_measured_fastest():
    """smollm-135m's calls: 64 x 128 where that still gives two blocks an
    SM, 32 x 128 while it gives half a block an SM, else 32 x 64."""
    want = {(2048, 1536): TILES[0], (2048, 576): TILES[1],
            (2048, 192): TILES[1], (512, 1536): TILES[1],
            (512, 576): TILES[1], (512, 192): TILES[2],
            (128, 1536): TILES[2], (128, 192): TILES[2]}
    for (m, n), tile in want.items():
        assert dispatch(m, 576, n, "bf16") == (tile, True), (m, n)
    assert dispatch(8, 576, 192, "bf16") == ("decode", 32, 4)
    assert dispatch(8, 576, 194, "bf16") == (NARROW, False)
    assert dispatch(4, 0, 192, "bf16") == (TILES[-1], True)
    assert dispatch(9, 576, 200, "bf16") == (NARROW, False)
    assert dispatch(37, 100, 32, "float32") == (TILES[-1], True)
    assert dispatch(37, 100, 32, "bf16") == (NARROW, False)


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("k,n", SMOLLM)
def test_smollm_widths_bit_exact(k, n, w_bits):
    check(160, k, n, w_bits, "bf16", seed=k + n)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("w_bits", [8, 4])
def test_every_tile_bit_exact(tile, w_bits):
    check(200, 576, 192, w_bits, "bf16", seed=7, tile=tile)


def test_prefill_rows_at_the_dispatched_tile():
    check(2048, 576, 192, 8, "bf16", seed=11)


@pytest.mark.parametrize("x_dtype", ["float32", "bf16"])
@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("m", [9, 15, 16, 17, 37, 129])
def test_small_and_ragged_rows(m, w_bits, x_dtype):
    check(m, 576, 192, w_bits, x_dtype, seed=m, ties=m % 2 == 1)


@pytest.mark.parametrize("x_dtype", ["float32", "bf16"])
@pytest.mark.parametrize("w_bits,k,n", [(8, 576, 200), (4, 576, 200),
                                        (8, 100, 36), (4, 100, 36),
                                        (8, 33, 17), (4, 34, 17)])
def test_ragged_k_and_n(w_bits, k, n, x_dtype):
    check(37, k, n, w_bits, x_dtype, seed=k * n, ties=True)


@pytest.mark.parametrize("w_bits", [8, 4])
def test_acc_past_2_24_rounds_like_the_plain_version(w_bits):
    """All +-127 activations and extreme weights at K = 1536: |acc| up to
    127 * 127 * 1536 > 2^24, where int -> float rounds to nearest even."""
    m, k, n = 32, 1536, 64
    rng = np.random.default_rng(5)
    x = np.where(rng.random((m, k)) < 0.9, 300.0, -300.0).astype(np.float32)
    hi = 7 if w_bits == 4 else 127
    w = np.where(rng.random((k, n)) < 0.95, hi, -hi).astype(np.int8)
    if w_bits == 4:
        w = np.array(jpack_int4(jnp.asarray(w), axis=0))
    ws = (rng.random(n) + 0.5).astype(np.float32)
    act = np.float32(1.0)
    got = emulate(x, w, ws, act, w_bits, dispatch(m, k, n, "float32")[0])
    np.testing.assert_array_equal(got, plain_bits(x, w, ws, act, w_bits,
                                                  "float32"))


@pytest.mark.parametrize("w_bits,blocks", [(8, {}),
                                           (4, dict(block_m=16, block_n=16,
                                                    block_k=32))])
def test_pallas_interpret_where_its_tiling_allows(w_bits, blocks):
    x, w, ws, act = inputs(40, 64, 32 if w_bits == 8 else 16, w_bits, "bf16",
                           seed=3, ties=True)
    want = jqm.quant_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                            jnp.asarray(ws), jnp.asarray(act),
                            w_bits=w_bits, interpret=True, **blocks)
    got = emulate(x, w, ws, act, w_bits, dispatch(40, 64, w.shape[1],
                                                  "bf16")[0])
    np.testing.assert_array_equal(got, np.asarray(want).view(np.uint16))


# (K, N) of chip_smoke.py's QMM_DECODE_EDGES: smollm-135m's widths, K and N
# that end a cluster slice, a column tile or a 16-byte piece early
DECODE_EDGE_KN = ((576, 192), (1536, 576), (576, 1536), (100, 36), (4, 4),
                  (8, 1540))


def test_decode_split_for_smollm_widths():
    """24-96 blocks a call: N = 1536 in tiles of 64, 576 and 192 of 32,
    each tile's K split across a cluster of 4."""
    want = {(576, 576): (32, 4), (576, 192): (32, 4), (576, 1536): (64, 4),
            (1536, 576): (32, 4)}
    for (k, n), split in want.items():
        assert decode_split(k, n) == split, (k, n)
        for m in (1, 4, 8):
            assert dispatch(m, k, n, "bf16") == ("decode", *split)
    blocks = {kn: -(-kn[1] // bn) * c for kn, (bn, c) in want.items()}
    assert sorted(blocks.values()) == [24, 72, 72, 96]
    assert decode_split(100, 36) == (32, 1) and decode_split(4, 4) == (32, 1)
    assert decode_split(256, 4096) == (128, 4)
    assert decode_split(200, 4096) == (64, 2)


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("k,n", SMOLLM)
@pytest.mark.parametrize("m", range(1, 9))
def test_decode_smollm_widths_bit_exact(m, k, n, w_bits):
    check_decode(m, k, n, w_bits, "bf16", seed=m * 7 + k + n)


@pytest.mark.parametrize("x_dtype", ["float32", "bf16"])
@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("k,n", DECODE_EDGE_KN)
def test_decode_edges_bit_exact(k, n, w_bits, x_dtype):
    """QMM_DECODE_EDGES' rows on .5 ties of x * act_scale and past the
    clip."""
    for m in (1, 2, 3, 5, 7, 8):
        check_decode(m, k, n, w_bits, x_dtype, seed=k + n + m, ties=True)


@pytest.mark.parametrize("w_bits", [8, 4])
def test_decode_acc_past_2_24(w_bits):
    """All +-127 activations and extreme weights at K = 1536."""
    m, k, n = 8, 1536, 576
    rng = np.random.default_rng(6)
    x = np.where(rng.random((m, k)) < 0.9, 300.0, -300.0).astype(np.float32)
    hi = 7 if w_bits == 4 else 127
    w = np.where(rng.random((k, n)) < 0.95, hi, -hi).astype(np.int8)
    if w_bits == 4:
        w = np.array(jpack_int4(jnp.asarray(w), axis=0))
    ws = (rng.random(n) + 0.5).astype(np.float32)
    act = np.float32(1.0)
    got = emulate_decode(x, w, ws, act, w_bits, "float32")
    np.testing.assert_array_equal(got, plain_bits(x, w, ws, act, w_bits,
                                                  "float32"))
    w8 = w if w_bits == 8 else np.array(junpack_int4(jnp.asarray(w), axis=0))
    acc = np.clip(np.rint(x), -127, 127).astype(np.int64) @ w8.astype(
        np.int64) * (16 if w_bits == 4 else 1)
    assert np.abs(acc).max() > 2**24     # the kernel's int32 sums


@pytest.mark.parametrize("x_dtype", ["float32", "bf16"])
@pytest.mark.parametrize("w_bits", [8, 4])
def test_decode_unaligned_pointers_take_words(w_bits, x_dtype):
    """Pointers off 16 bytes: 4-byte weight words and element-wise x."""
    check_decode(5, 576, 192, w_bits, x_dtype, seed=21, ties=True,
                 aligned=False)


@pytest.mark.parametrize("w_bits", [8, 4])
def test_decode_slices_longer_than_a_stage(w_bits):
    """K = 8192 in a cluster of 4: 512 quads a block, two or more stages
    of its slab."""
    bn, c = decode_split(8192, 128)
    kc = 8192 // c
    sq = min(DEC_SQ, DEC_BUF // (w_bits // 2 * (bn + 16))) & ~1
    assert kc // 4 > sq
    check_decode(3, 8192, 128, w_bits, "bf16", seed=4)


@pytest.mark.parametrize("w_bits,k,n", [(8, 576, 192), (4, 576, 1536),
                                        (8, 1536, 576), (4, 100, 36),
                                        (8, 4, 4), (4, 8, 1540)])
def test_decode_reads_each_weight_once_and_stores_each_output_once(
        w_bits, k, n):
    """Every weight byte (k, n) is read by exactly one thread of exactly one
    block; every output (m < M, n < N) is stored once, nothing else."""
    x, w, ws, act = inputs(5, k, n, w_bits, "bf16", seed=2)
    trace = {}
    emulate_decode(x, w, ws, act, w_bits, "bf16", trace=trace)
    assert (trace["reads"] == 1).all()
    assert (trace["stores"] == 1).all()


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("w_bits,blocks", [(8, {}),
                                           (4, dict(block_m=16, block_n=16,
                                                    block_k=32))])
def test_decode_pallas_interpret_where_its_tiling_allows(m, w_bits, blocks):
    x, w, ws, act = inputs(m, 64, 32 if w_bits == 8 else 16, w_bits, "bf16",
                           seed=3, ties=True)
    want = jqm.quant_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                            jnp.asarray(ws), jnp.asarray(act),
                            w_bits=w_bits, interpret=True, **blocks)
    got = emulate_decode(x, w, ws, act, w_bits, "bf16")
    np.testing.assert_array_equal(got, np.asarray(want).view(np.uint16))
