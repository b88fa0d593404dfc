// Fused int8 serving matmul for Hopper (sm_90a): FAT int8 mode, paper §2 / eq. 20.
//
//   y[m, n] = O( float( sum_k int8(clip(rint(x[m, k] * act_scale), ±127)) * w_q[k, n] )
//                * w_scale[n] )
//
// O, the output type, is bf16 or float32 (the TPU kernel's out_dtype): float32 stores
// the product float(acc) * w_scale[n] as it is, with no bf16 rounding.
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py::quant_matmul (body
// `_kernel`, both w_bits branches); unlike it, this kernel masks ragged M, N and K.
//
// What bounds it on an H100: at prefill (M = 2048) one smollm-135m layer's seven
// calls do 14.5 G int8 operations and must move 45 MB (bf16 x 20.4, bf16 out 21.2,
// weights 3.5): 7.3 us at 1,979 TOP/s, 13.5 us at 3.35 TB/s; 322 operations a byte
// against the card's ridge of 591, so bytes, near the ridge.  Decode: the weights.
//
// Prefill runs on the int8 tensor cores: mma.sync.m16n8k32 s8, int32 sums (wrapping
// like dp4a's; exact for K < 2^31 / 127^2).  Not wgmma: with 8-bit operands wgmma
// takes A and B K-major from shared memory (only 16-bit types may be transposed),
// while B3's weights are (K, N), N contiguous, the layout the decode kernel and the
// parity tests read; ldmatrix .trans moves 16-bit elements, not bytes.
//  - Tiles: BM x BN a block of 4 warps, each 16*MT rows x 32 columns (no two warps
//    build the same B fragments): 64 x 128 where that still gives two blocks an SM,
//    else 32 x 128 or 32 x 64, as measured fastest.  K goes in steps of 64.
//  - x: 16-byte pieces loaded one step ahead into registers, quantized into an int8
//    [row][k] tile (rows of 80 bytes: ldmatrix reads A without bank conflicts).  The
//    quantize is clip(rint(x * s)) bit for bit without F2I (a quarter of the float
//    rate): the float32 product, a clamp to ±127 (it commutes with rounding to an
//    integer), + 1.5 * 2^23, which rounds half to even, and the low byte.  A NaN
//    product gives ±127 (the plain version's row is NaN).
//  - Weights: cp.async of 16-byte chunks, four stages; chunk c of tile row r sits at
//    (r * BN/16 + c) ^ 2 * ((r / RG) & 3) (RG rows hold 4 k), so the fragment loads
//    are free of bank conflicts and a lane's offsets depend on its t alone.
//  - B fragments: lane (group g, thread t) loads rows 4t .. 4t+3 of each 16-k half
//    at columns 4g .. 4g+3 of its warp's 32 and transposes the 4x4 bytes with
//    __byte_perm: word j holds the four k of column 4g + j.  Column map: word j is
//    column g of n8 tile j, so tile j holds the warp's columns 4g' + j, and a lane's
//    C fragments of the four tiles are its columns 8t .. 8t+7 of rows g and g + 8:
//    one 16-byte store each.
//  - int4 weights (w_bits = 4): (K/2, N) bytes, K rows 2r and 2r + 1 in the low and
//    high nibble of row r (core/packing.py::unpack_int4(axis=0)), copied as they are.
//    p & 0xF0 and (p << 4) & 0xF0 are 16 x the nibbles, exact as int8; the sums are
//    16 x the int8 branch's (exact for K < 2^31 / (16 * 127 * 8)), shifted back by 4.
//  - Epilogue: float(acc) * w_scale[n] (one __fmul_rn), rounded once to bf16 (16 bytes
//    a row group), or stored as float32 (32 bytes), as the plain version.
//  - Edges: rows past M and k past K quantize zeros, weights past K or N are zero-
//    filled, rows and columns past M and N are not stored.  K, N or pointers that do
//    not allow 16-byte pieces take the NARROW variant (element-wise staging).
//  - Measured (chip_smoke.py): 0.073 ms a layer at M = 2048, 5x its bound.  Each
//    step's x loads, quantize and barrier-joined phases hold it, not the bytes.
//
// Decode (M <= 8, N and K multiples of 4) takes a second kernel.  What bounds it:
// the weight bytes, 3.5 MB a smollm-135m layer (1.06 us at 3.35 TB/s; 0.1-0.9 MB a
// call), with 4-16 integer operations a byte, far below the ridge.  In practice a
// call's fixed chain (launch, one memory round trip, the reduction) holds it, so
// the design puts every byte of a call in flight at once and keeps the chain short:
//  - Split K across a thread block cluster: C blocks (a power of two <= 4, 64 k or
//    more each) share a column tile of BN = 128, 64 or 32 columns (the widest that
//    still gives half the SMs a block); block r of the cluster owns k r*kc ..
//    r*kc+kc-1 (kc a multiple of 8).  smollm-135m's calls run 24-96 blocks.
//  - A block first loads its K slice of x (warp m row m, 16 bytes a lane, into
//    registers), then issues all its weight bytes: cp.async of 16-byte pieces
//    (4-byte words where N or the pointer do not allow them) into a slab of rows of
//    BN + 16 bytes, at most 32 KB a stage (longer slices run stage after stage);
//    int4 weights are copied packed.  Then x is quantized as above.
//  - Thread (cq, ks) of 256 takes columns 4cq .. 4cq+3 of the block's k quads ks,
//    ks + 256/(BN/4), ...: four rows of four weight bytes are transposed (the same
//    __byte_perm 4x4) into dp4a operands; int4 enters as 16 x each nibble and the
//    sum is shifted back by 4 at the end.
//  - The int32 sums are exact in any order (wrapping; no overflow below the limits
//    above).  The lanes of a warp that share columns meet by shuffles (at most two
//    rounds), the 8 warps in shared memory; then each column's block sum goes to
//    the cluster block that stores the column (block r: columns r*BN/C ..
//    (r+1)*BN/C - 1) by st.async into its inbox, counted by the inbox's mbarrier.
//    A cluster barrier, arrived when the first loads are out and waited on before
//    the first st.async, makes sure every inbox barrier is set up.  The owner adds
//    its C entries and stores float(acc) * w_scale[n], one bf16 rounding, four
//    columns (8 bytes) a thread, or the float32 products (16 bytes).  No global
//    scratch, no counter.
//  - Edges: weights past K or N are zero-filled, x rows past M quantize zeros, rows
//    and columns past M and N are not stored.
//
// The int32-accumulator branch (x of type int8_t, entry repro_quant_matmul_acc):
//
//   acc[m, n] = sum_{k0 <= k < k1} x_q[m, k] * w_q[k, n]      (int32, wrapping)
//
// x_q is already quantized (int8, rows of ldx bytes) and w_q's rows k0 .. k1 - 1 are
// read in place: one tensor-parallel shard's partial product of a row-parallel
// layer, whose shards' partials the caller sums exactly (the reference's
// src/repro/core/api.py::_int8_matmul with reduce_axis, which takes an XLA
// dot_general with int32 output there and no Pallas kernel).  The same two kernels
// under the same tiling, with no quantize (the bytes are staged as they are, 16 x
// per 16-byte piece) and no scale: the epilogue stores the int32 sums (8 columns,
// 32 bytes, a lane of the tensor-core kernel; 4 columns, 16 bytes, a thread of the
// decode kernel).  Bound: the weight bytes at decode, as above, and int8 operations
// at prefill; each partial reads a 1 / tp slice of the weights.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// low byte = int8(clip(rint(x * s), +-127)), for any product that is not NaN
// (see the note)
__device__ __forceinline__ uint32_t quantize_bits(float x, float s) {
  const float f = fminf(fmaxf(__fmul_rn(x, s), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(f, 12582912.0f));
}

// the low bytes of four quantize_bits words, in order, as one word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// 16 bytes of x (8 bf16 or 4 float) -> 8 or 4 quantized bytes
template <typename T>
__device__ __forceinline__ uint2 quantize_chunk(uint4 v, float s) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  uint32_t q[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[2 * i] = quantize_bits(__uint_as_float(sizeof(T) == 4 ? u[i] : u[i] << 16), s);
    q[2 * i + 1] = quantize_bits(__uint_as_float(u[i] & 0xffff0000u), s);
  }
  if (sizeof(T) == 4) return make_uint2(pack4(q[0], q[2], q[4], q[6]), 0u);
  return make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
}

// bf16(a) in the low half, bf16(b) in the high half, each rounded once
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16;
}

// c[j] byte i = byte j of w[i]: four rows of four bytes, transposed
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&c)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

// d += a @ b: m16n8k32, s8 operands, s32 sums (wrapping, no .satfinite)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// 16 bytes global -> shared; n == 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
// the address of p in the shared memory of cluster block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(rank));
  return a;
}
// an mbarrier of one arrival, that arrival made and `bytes` expected; its
// initialization made visible to the cluster's async stores
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar, int bytes) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(b), "r"(bytes) : "memory");
}
// 16 bytes into another cluster block's shared memory, counted by its mbarrier
__device__ __forceinline__ void st_async_v4(uint32_t addr, int4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], "
               "{%1, %2, %3, %4}, [%5];\n"
               ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}
// until the mbarrier's first phase has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(b) : "memory");
}
// 4 bytes global -> shared; n == 0 zero-fills without reading
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int BK = 64;        // k a step
constexpr int LDA = BK + 16;  // bytes a row of the quantized x tile
constexpr int STAGES = 4;     // weight tiles in flight (a power of two)

// byte offset of 16-byte chunk c of row r of a weight tile (see the note)
template <int BN, int RG>
__device__ __forceinline__ int wchunk(int r, int c) {
  return ((r * (BN / 16) + c) ^ (((r / RG) & 3) << 1)) << 4;
}

template <int BM, int BN, int MT>
__host__ __device__ constexpr int threads() {
  return 32 * (BM / (16 * MT)) * (BN / 32);
}

// BM x BN output tile, warps of 16*MT rows x 32 columns; VEC: 16-byte staging
// (x loaded one step ahead into registers, weights by cp.async), else
// element-wise.  x rows are ldx elements apart; O the output type (bf16 or
// float).  T = int8_t: the int32-accumulator branch (x already quantized,
// int32 out, O = int, no scale)
template <typename T, typename O, int WB, int BM, int BN, int MT, bool VEC>
__global__ void __launch_bounds__(threads<BM, BN, MT>(), 2)
quant_matmul_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ w_scale,
                        const float* __restrict__ act_scale,
                        void* __restrict__ out, int M, int K, int N, int ldx) {
  constexpr bool ACC = std::is_same<T, int8_t>::value;
  constexpr int WN = BN / 32;
  constexpr int NT = threads<BM, BN, MT>();
  constexpr int KR = BK * WB / 8;    // weight tile rows a step (packed at WB == 4)
  constexpr int RG = 4 * WB / 8;     // weight tile rows that hold 4 k
  constexpr int E = 16 / sizeof(T);  // x elements in 16 bytes
  // a thread's 16-byte pieces of a step: x rows xr0 + j * XRS at k xk, and
  // weight rows wr0 + j * WRS at column wc * 16
  constexpr int XRS = NT / (BK / E), WRS = NT / (BN / 16);
  constexpr int XL = BM / XRS, WL = KR / WRS;
  static_assert(XL * XRS == BM && WL * WRS == KR && WRS % (4 * RG) == 0, "tile split");
  __shared__ __align__(16) int8_t xs[2 * BM * LDA];      // [2][BM][LDA] quantized x
  __shared__ __align__(16) int8_t ws[STAGES * KR * BN];  // [STAGES][KR][BN] swizzled

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (tid >> 5) / WN, wn = (tid >> 5) % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KW = K * WB / 8;
  const int nk = (K + BK - 1) / BK;
  float s = 0.0f;
  if constexpr (!ACC) s = *act_scale;
  // this lane's A rows, and its B words: rows RG*t + i at columns col .. col+3
  // of each 16-k half; the swizzle of those rows depends on t alone, so row
  // RG*t + i + 16*(RG/4)*q sits at boff[i] + 16*(RG/4)*q*BN
  const int arow = (wm * 16 * MT + (lane & 7) + (lane & 8)) * LDA + (lane >> 4) * 16;
  const int col = wn * 32 + 4 * g;
  int boff[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) boff[i] = wchunk<BN, RG>(RG * t + i, col >> 4) + (col & 15);

  // staging addresses, computed once: the pieces of step `step` lie
  // step * BK elements (x) and step * KR rows (weights) further on
  const int xr0 = tid / (BK / E), xk = (tid % (BK / E)) * E;
  const int wr0 = tid / (BN / 16), wc = tid % (BN / 16);
  const T* xp = x + (size_t)min(m0 + xr0, M - 1) * ldx + xk;
  const size_t xjs = (size_t)XRS * ldx;
  const int8_t* wp = w + (size_t)wr0 * N + n0 + wc * 16;
  const size_t wjs = (size_t)WRS * N, wss = (size_t)KR * N;
  const bool wcol = n0 + wc * 16 < N;
  const int wso = wchunk<BN, RG>(wr0, wc);
  unsigned xrows = 0;  // bit j: x row xr0 + j * XRS lies inside M
#pragma unroll
  for (int j = 0; j < XL; ++j) xrows |= (m0 + xr0 + j * XRS < M ? 1u : 0u) << j;

  uint4 xr[XL];
  auto load_x = [&](int step) {
    const bool kin = step * BK + xk < K;
#pragma unroll
    for (int j = 0; j < XL; ++j)
      xr[j] = kin && (xrows >> j & 1)
                  ? *reinterpret_cast<const uint4*>(xp + j * xjs + step * BK)
                  : make_uint4(0, 0, 0, 0);
  };
  auto store_x = [&](int8_t* xt) {
#pragma unroll
    for (int j = 0; j < XL; ++j) {
      int8_t* d = xt + (xr0 + j * XRS) * LDA + xk;
      if constexpr (ACC) {
        *reinterpret_cast<uint4*>(d) = xr[j];
      } else {
        const uint2 q = quantize_chunk<T>(xr[j], s);
        if constexpr (E == 8)
          *reinterpret_cast<uint2*>(d) = q;
        else
          *reinterpret_cast<uint32_t*>(d) = q.x;
      }
    }
  };
  auto load_w = [&](int step) {
    int8_t* wt = ws + (step & (STAGES - 1)) * KR * BN + wso;
    const int8_t* src = wp + step * wss;
#pragma unroll
    for (int j = 0; j < WL; ++j) {
      const bool ok = wcol && step * KR + wr0 + j * WRS < KW;
      cp_async16(wt + j * WRS * BN, ok ? src + j * wjs : w, ok ? 16 : 0);
    }
  };
  auto stage_narrow = [&](int step, int8_t* xt, int8_t* wt) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK, gm = m0 + r, gk = step * BK + c;
      int8_t v = 0;
      if (gm < M && gk < K) {
        if constexpr (ACC)
          v = x[(size_t)gm * ldx + gk];
        else
          v = static_cast<int8_t>(quantize_bits(to_f32(x[(size_t)gm * ldx + gk]), s));
      }
      xt[r * LDA + c] = v;
    }
    for (int i = tid; i < KR * BN; i += NT) {
      const int r = i / BN, c = i % BN, kr = step * KR + r, gn = n0 + c;
      wt[wchunk<BN, RG>(r, c >> 4) + (c & 15)] =
          kr < KW && gn < N ? w[(size_t)kr * N + gn] : static_cast<int8_t>(0);
    }
  };

  int acc[MT][4][4];  // [m16 tile][n8 tile][C fragment]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][u][i] = 0;

  if constexpr (VEC) {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) load_w(st);
      cp_async_commit();
    }
    load_x(0);
  }
  for (int step = 0; step < nk; ++step) {
    int8_t* xt = xs + (step & 1) * BM * LDA;
    int8_t* wt = ws + (step & (STAGES - 1)) * KR * BN;
    if constexpr (VEC) {
      store_x(xt);
      if (step + 1 < nk) load_x(step + 1);
      cp_async_wait<STAGES - 2>();
    } else {
      stage_narrow(step, xt, wt);
    }
    __syncthreads();
    if constexpr (VEC) {
      if (step + STAGES - 1 < nk) load_w(step + STAGES - 1);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], xt + arow + mt * 16 * LDA + kk * 32);
      uint32_t b[2][4];  // [k half][n8 tile]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int8_t* wh = wt + (2 * kk + h) * 16 * RG / 4 * BN;
        uint32_t rows[4];
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          const uint32_t p = *reinterpret_cast<const uint32_t*>(wh + boff[i]);
          if constexpr (WB == 8) {
            rows[i] = p;
          } else {  // packed rows 2t, 2t + 1: k 4t .. 4t + 3, each as 16 x its value
            rows[2 * i] = (p << 4) & 0xF0F0F0F0u;
            rows[2 * i + 1] = p & 0xF0F0F0F0u;
          }
        }
        transpose4x4(rows, b[h]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_s8(acc[mt][u], a[mt], b[0][u], b[1][u]);
    }
  }

  // lane's columns ncol .. ncol + 7: value j is n8 tile j % 4, fragment column
  // 2t + j / 4
  const int ncol = n0 + wn * 32 + 8 * t;
  if constexpr (ACC) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + wm * 16 * MT + mt * 16 + g + 8 * hr;
        if (row >= M) continue;
        __align__(16) int v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = acc[mt][j & 3][2 * hr + (j >> 2)];
        int* o = static_cast<int*>(out) + (size_t)row * N + ncol;
        if constexpr (VEC) {
          if (ncol < N) {
            reinterpret_cast<int4*>(o)[0] = reinterpret_cast<const int4*>(v)[0];
            reinterpret_cast<int4*>(o)[1] = reinterpret_cast<const int4*>(v)[1];
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (ncol + j < N) o[j] = v[j];
        }
      }
    return;
  }
  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sc[j] = ncol + j < N ? w_scale[ncol + j] : 0.0f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * 16 * MT + mt * 16 + g + 8 * hr;
      if (row >= M) continue;
      __align__(16) float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int a = acc[mt][j & 3][2 * hr + (j >> 2)];
        if (WB == 4) a >>= 4;
        f[j] = __fmul_rn(static_cast<float>(a), sc[j]);
      }
      O* o = static_cast<O*>(out) + (size_t)row * N + ncol;
      if constexpr (std::is_same<O, float>::value) {
        if constexpr (VEC) {
          if (ncol < N) {
            reinterpret_cast<float4*>(o)[0] = reinterpret_cast<const float4*>(f)[0];
            reinterpret_cast<float4*>(o)[1] = reinterpret_cast<const float4*>(f)[1];
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (ncol + j < N) o[j] = f[j];
        }
      } else if constexpr (std::is_same<O, __nv_bfloat16>::value) {
        __align__(16) __nv_bfloat162 v[4];
#pragma unroll
        for (int j = 0; j < 8; j += 2) v[j / 2] = __floats2bfloat162_rn(f[j], f[j + 1]);
        if constexpr (VEC) {
          if (ncol < N) *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (ncol + j < N) o[j] = j & 1 ? v[j / 2].y : v[j / 2].x;
        }
      }
    }
}

constexpr int DEC_NT = 256;       // threads a decode block
constexpr int DEC_BUF = 32768;    // bytes: a stage's weight slab, then the int32 sums
constexpr int DEC_SQ = 128;       // k quads a stage, at most
constexpr int DEC_CMAX = 4;       // blocks a cluster, at most (8 is portable)

// M <= MR rows; K % 4 == 0, N % 4 == 0.  Block (column tile t, cluster rank r)
// owns columns t*BN .. t*BN+BN-1 (BN = 1 << bn_log2) and k slice r*kc ..
// r*kc+kc-1 (kc % 8 == 0, % 16 == 0 for int8 x), staged in stages of up to
// DEC_SQ k quads; the cluster's C blocks share the tile (see the note).  x rows
// are ldx elements apart; O the output type (bf16 or float); T = int8_t: the
// int32-accumulator branch (O = int).
template <typename T, typename O, int WB, int MR>
__global__ void __launch_bounds__(DEC_NT, 1)
quant_matmul_decode_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ w_scale,
                           const float* __restrict__ act_scale,
                           void* __restrict__ out, int M, int K, int N,
                           int bn_log2, int kc, int ldx) {
  constexpr bool ACC = std::is_same<T, int8_t>::value;
  constexpr int E = 16 / sizeof(T);  // x elements in 16 bytes
  constexpr int RQ = WB / 2;         // weight rows a k quad (packed at WB == 4)
  // weight slab [rows][P], then the sums [warp][MR][BN]
  __shared__ __align__(16) int8_t buf[DEC_BUF];
  __shared__ __align__(16) int8_t xq[MR][4 * DEC_SQ];  // quantized x of a stage
  __shared__ __align__(16) int inbox[MR * 128];  // [rank][m][BN / C]: sums sent here
  __shared__ __align__(8) uint64_t inbar;         // counts the inbox's bytes
  __shared__ float sc[128];                       // w_scale of the stored columns
  static_assert(DEC_NT / 32 * MR * 128 * 4 <= DEC_BUF, "sums fit the slab");
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int C = cl.num_blocks(), rank = cl.block_rank(), own_log2 = bn_log2 + 1 - __ffs(C);
  const int BN = 1 << bn_log2, P = BN + 16, CQ = BN / 4, NKS = DEC_NT / CQ;
  const int tid = threadIdx.x, cq = tid & (CQ - 1), ks = tid >> (bn_log2 - 2);
  const int wid = tid >> 5, lane = tid & 31;
  const int n0 = (blockIdx.x >> (bn_log2 - own_log2)) << bn_log2, own = 1 << own_log2;
  const int c0 = rank * own;
  const int k0 = rank * kc, nq = min(K - k0, kc) / 4;  // >= 1: C leaves 64 k a block
  // stages of an even number of quads (a multiple of 4 for int8 x: 16-byte pieces)
  const int sq = min(DEC_SQ, DEC_BUF / (RQ * P)) & (ACC ? ~3 : ~1);
  float s = 0.0f, scv = 0.0f;
  if constexpr (!ACC) {
    s = *act_scale;
    // w_scale of the stored columns (own <= DEC_NT), into shared memory later
    scv = tid < own && n0 + c0 + tid < N ? w_scale[n0 + c0 + tid] : 0.0f;
  }
  const bool wvec = ((reinterpret_cast<uintptr_t>(w) | static_cast<unsigned>(N)) & 15) == 0;
  const bool xvec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && K % E == 0 && ldx % E == 0;

  int acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;
  for (int q0 = 0; q0 < nq; q0 += sq) {
    const int qn = min(sq, nq - q0), kb = k0 + 4 * q0;
    const int rn = qn * RQ, rb = kb * WB / 8;  // weight rows of the stage
    const int kn = 4 * qn, ppr = xvec ? kn / E : 0;   // k, and 16-byte x pieces a row
    if (q0 > 0) __syncthreads();  // the last stage's slab is read
    // x first (the longer chain): warp m loads row m (zeros past M), 16 bytes a
    // lane; then every weight byte of the stage, zeros past N
    constexpr int XP = 4 * DEC_SQ / E / 32;  // x pieces a lane, at most
    uint4 xr[XP];
#pragma unroll
    for (int j = 0; j < XP; ++j)
      xr[j] = wid < M && lane + 32 * j < ppr
                  ? *reinterpret_cast<const uint4*>(x + (size_t)wid * ldx + kb + E * (lane + 32 * j))
                  : make_uint4(0, 0, 0, 0);
    if (wvec) {
      for (int i = tid; i < rn * CQ / 4; i += DEC_NT) {
        const int r = i >> (bn_log2 - 4), c = 16 * (i & (CQ / 4 - 1));
        const bool ok = n0 + c < N;
        cp_async16(buf + r * P + c, ok ? w + (size_t)(rb + r) * N + n0 + c : w, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < rn * CQ; i += DEC_NT) {
        const int r = i >> (bn_log2 - 2), c = 4 * (i & (CQ - 1));
        const bool ok = n0 + c < N;
        cp_async4(buf + r * P + c, ok ? w + (size_t)(rb + r) * N + n0 + c : w, ok ? 4 : 0);
      }
    }
    cp_async_commit();
    if (q0 == 0) {  // the inbox's barrier, counted before any block may send; set
                    // up once the first loads are out (its fence takes a while)
      if (tid == DEC_NT - 1) mbar_init_expect(&inbar, MR * BN * 4);
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    }
    if (xvec) {
#pragma unroll
      for (int j = 0; j < XP; ++j) {
        const int k = E * (lane + 32 * j);
        if (wid >= MR || k >= kn) continue;
        if constexpr (ACC) {
          *reinterpret_cast<uint4*>(&xq[wid][k]) = xr[j];
        } else {
          const uint2 q = quantize_chunk<T>(xr[j], s);
          if constexpr (E == 8)
            *reinterpret_cast<uint2*>(&xq[wid][k]) = q;
          else
            *reinterpret_cast<uint32_t*>(&xq[wid][k]) = q.x;
        }
      }
    } else {
      for (int i = tid; i < MR * kn; i += DEC_NT) {
        const int m = i / kn, k = i % kn;
        int8_t v = 0;
        if (m < M) {
          if constexpr (ACC)
            v = x[(size_t)m * ldx + kb + k];
          else
            v = static_cast<int8_t>(quantize_bits(to_f32(x[(size_t)m * ldx + kb + k]), s));
        }
        xq[m][k] = v;
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // thread (cq, ks): columns 4cq .. 4cq+3 of quads ks, ks + NKS, ...
    for (int q = ks; q < qn; q += NKS) {
      const int8_t* wq = buf + q * RQ * P + 4 * cq;
      uint32_t rows[4];
      if constexpr (WB == 8) {
#pragma unroll
        for (int i = 0; i < 4; ++i) rows[i] = *reinterpret_cast<const uint32_t*>(wq + i * P);
      } else {  // packed rows 2q, 2q + 1: k 4q .. 4q + 3, each as 16 x its value
        const uint32_t p0 = *reinterpret_cast<const uint32_t*>(wq);
        const uint32_t p1 = *reinterpret_cast<const uint32_t*>(wq + P);
        rows[0] = (p0 << 4) & 0xF0F0F0F0u, rows[1] = p0 & 0xF0F0F0F0u;
        rows[2] = (p1 << 4) & 0xF0F0F0F0u, rows[3] = p1 & 0xF0F0F0F0u;
      }
      uint32_t c[4];  // c[j]: the four k of column 4cq + j
      transpose4x4(rows, c);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int a = *reinterpret_cast<const int*>(&xq[m][4 * q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(a, static_cast<int>(c[j]), acc[m][j]);
      }
    }
  }

  // the block's sums: the 32 / CQ lanes of a warp that share columns meet by
  // shuffles, the warps in shared memory, red[warp][m][BN]
  for (int o = CQ; o < 32; o <<= 1)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], o);
  int* red = reinterpret_cast<int*>(buf);
  if (tid < own) sc[tid] = scv;
  __syncthreads();  // the slab is read
  if ((tid & 31) < CQ)
#pragma unroll
    for (int m = 0; m < MR; ++m)
      *reinterpret_cast<int4*>(red + ((tid >> 5) * MR + m) * BN + 4 * cq) =
          make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every inbox is ready
  // thread (m, cq) adds the warps' sums of its four columns and sends them to
  // inbox [rank][m][own] of block 4cq / own, counted by its barrier
  for (int i = tid; i < MR * CQ; i += DEC_NT) {
    const int4* d = reinterpret_cast<const int4*>(red) + i;
    int4 t = d[0];
#pragma unroll
    for (int j = 1; j < DEC_NT / 32; ++j) {
      const int4 v = d[j * MR * CQ];
      t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
    }
    const int m = i >> (bn_log2 - 2), c = 4 * (i & (CQ - 1)), dst = c >> own_log2;
    st_async_v4(cluster_addr(inbox + (rank * MR + m) * own + c - dst * own, dst), t,
                cluster_addr(&inbar, dst));
  }
  mbar_wait(&inbar);  // every block's sums of this block's columns are in
  // block r stores columns c0 .. c0 + own - 1, four a thread
  for (int i = tid; i < MR * own / 4; i += DEC_NT) {
    const int m = i >> (own_log2 - 2), j = 4 * (i & (own / 4 - 1)), n = n0 + c0 + j;
    if (m >= M || n >= N) continue;
    int4 t = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int b = 0; b < DEC_CMAX; ++b)
      if (b < C) {
        const int4 v = *reinterpret_cast<const int4*>(inbox + (b * MR + m) * own + j);
        t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
      }
    if (WB == 4) t.x >>= 4, t.y >>= 4, t.z >>= 4, t.w >>= 4;
    if constexpr (ACC) {
      *reinterpret_cast<int4*>(static_cast<int*>(out) + (size_t)m * N + n) = t;
      continue;
    }
    const float* f = sc + j;
    const float4 y = make_float4(__fmul_rn(static_cast<float>(t.x), f[0]),
                                 __fmul_rn(static_cast<float>(t.y), f[1]),
                                 __fmul_rn(static_cast<float>(t.z), f[2]),
                                 __fmul_rn(static_cast<float>(t.w), f[3]));
    if constexpr (std::is_same<O, float>::value)
      *reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)m * N + n) = y;
    else if constexpr (std::is_same<O, __nv_bfloat16>::value)
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + (size_t)m * N + n) =
          make_uint2(bf16_pair(y.x, y.y), bf16_pair(y.z, y.w));
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// blocks a cluster: the largest power of two <= DEC_CMAX that leaves every block
// 64 k or more (so every block has k quads)
int decode_cluster(int K) {
  int c = 1;
  while (c < DEC_CMAX && 2 * c * 64 <= K) c *= 2;
  return c;
}

template <typename T, typename O, int WB, int MR>
cudaError_t launch_decode(const void* x, const void* w, const void* w_scale,
                          const void* act_scale, void* out, int M, int K, int N, int ldx,
                          cudaStream_t stream) {
  // the widest column tile (128, 64, 32) that still gives half the SMs a block
  const int C = decode_cluster(K);
  int bn_log2 = 7;
  while (bn_log2 > 5 && ((N + (1 << bn_log2) - 1) >> bn_log2) * C < sm_count() / 2) --bn_log2;
  const int tiles = (N + (1 << bn_log2) - 1) >> bn_log2;
  constexpr int KA = sizeof(T) == 1 ? 16 : 8;  // k a block: whole 16-byte x pieces
  const int kc = ((K + C - 1) / C + KA - 1) / KA * KA;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C);
  cfg.blockDim = dim3(DEC_NT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, quant_matmul_decode_kernel<T, O, WB, MR>,
                            static_cast<const T*>(x), static_cast<const int8_t*>(w),
                            static_cast<const float*>(w_scale),
                            static_cast<const float*>(act_scale), out, M, K, N, bn_log2,
                            kc, ldx);
}

template <typename T, typename O, int WB, int BM, int BN, int MT, bool VEC>
void launch(const void* x, const void* w, const void* w_scale, const void* act_scale,
            void* out, int M, int K, int N, int ldx, cudaStream_t stream) {
  constexpr int nt = threads<BM, BN, MT>();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_mma_kernel<T, O, WB, BM, BN, MT, VEC><<<grid, nt, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(act_scale), out, M, K,
      N, ldx);
}

// x rows ldx elements apart (ldx == K but for a shard's K slice of int8 x); O the
// output type
template <typename T, typename O, int WB>
cudaError_t dispatch(const void* x, const void* w, const void* w_scale,
                     const void* act_scale, void* out, int M, int K, int N, int ldx,
                     cudaStream_t stream) {
  // (K = 0: the other kernel's zeros; the decode kernel stores 4 columns at once)
  if (M <= 8 && N % 4 == 0 && K % 4 == 0 && K > 0 &&
      reinterpret_cast<uintptr_t>(out) % (4 * sizeof(O)) == 0) {
    if (M <= 1)
      return launch_decode<T, O, WB, 1>(x, w, w_scale, act_scale, out, M, K, N, ldx, stream);
    if (M <= 2)
      return launch_decode<T, O, WB, 2>(x, w, w_scale, act_scale, out, M, K, N, ldx, stream);
    if (M <= 4)
      return launch_decode<T, O, WB, 4>(x, w, w_scale, act_scale, out, M, K, N, ldx, stream);
    return launch_decode<T, O, WB, 8>(x, w, w_scale, act_scale, out, M, K, N, ldx, stream);
  }
  const uintptr_t al = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                       reinterpret_cast<uintptr_t>(out);
  // warps span the block's rows (no two warps build the same B fragments); the
  // widest tile that still fills the card, else the one with the shortest chain
  const auto blocks = [&](int bm, int bn) { return ((M + bm - 1) / bm) * ((N + bn - 1) / bn); };
  if (al % 16 || K % (16 / sizeof(T)) || ldx % (16 / sizeof(T)) || N % 16)
    launch<T, O, WB, 32, 64, 1, false>(x, w, w_scale, act_scale, out, M, K, N, ldx, stream);
  else if (blocks(64, 128) >= 2 * sm_count())
    launch<T, O, WB, 64, 128, 4, true>(x, w, w_scale, act_scale, out, M, K, N, ldx, stream);
  else if (2 * blocks(32, 128) >= sm_count())
    launch<T, O, WB, 32, 128, 2, true>(x, w, w_scale, act_scale, out, M, K, N, ldx, stream);
  else
    launch<T, O, WB, 32, 64, 1, true>(x, w, w_scale, act_scale, out, M, K, N, ldx, stream);
  return cudaSuccess;
}

}  // namespace

template <typename O>
cudaError_t dispatch_x(const void* x, int x_bf16, const void* w, int w_bits,
                       const void* w_scale, const void* act_scale, void* out, int M, int K,
                       int N, cudaStream_t st) {
  if (x_bf16 && w_bits == 4)
    return dispatch<__nv_bfloat16, O, 4>(x, w, w_scale, act_scale, out, M, K, N, K, st);
  if (x_bf16)
    return dispatch<__nv_bfloat16, O, 8>(x, w, w_scale, act_scale, out, M, K, N, K, st);
  if (w_bits == 4) return dispatch<float, O, 4>(x, w, w_scale, act_scale, out, M, K, N, K, st);
  return dispatch<float, O, 8>(x, w, w_scale, act_scale, out, M, K, N, K, st);
}

// x: (M, K) float32 (x_bf16 == 0) or bfloat16 (x_bf16 == 1), row-major;
// w: (K, N) int8 row-major (w_bits == 8) or (K/2, N) packed int4 (w_bits ==
// 4, K even); w_scale: (N,) f32; act_scale: one f32 on the device; out:
// (M, N) bf16 (out_f32 == 0) or float32 (out_f32 == 1).  Launches on `stream`;
// returns the decode launch's own error (a refused cluster launch) or else
// cudaGetLastError().
extern "C" int repro_quant_matmul(const void* x, int x_bf16, const void* w,
                                  int w_bits, const void* w_scale,
                                  const void* act_scale, void* out, int out_f32,
                                  int M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;  // nothing to write (an empty grid is an error)
  const cudaError_t err =
      out_f32 ? dispatch_x<float>(x, x_bf16, w, w_bits, w_scale, act_scale, out, M, K, N, st)
              : dispatch_x<__nv_bfloat16>(x, x_bf16, w, w_bits, w_scale, act_scale, out, M,
                                          K, N, st);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The int32-accumulator branch: x: (M, K) int8 already quantized, row i at x + i *
// ldx (a shard's K slice of a wider row: the caller passes x + k0); w: (K, N) int8
// row-major (the caller passes w_q + k0 * N); out: (M, N) int32, the sums alone.
// Launches on `stream`; returns as repro_quant_matmul.
extern "C" int repro_quant_matmul_acc(const void* x, int ldx, const void* w, void* out,
                                      int M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  const cudaError_t err =
      dispatch<int8_t, int, 8>(x, w, nullptr, nullptr, out, M, K, N, ldx, st);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
