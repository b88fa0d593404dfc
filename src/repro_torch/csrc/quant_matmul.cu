// Fused int8 serving matmul for Hopper (sm_90a): FAT int8 mode, paper §2 / eq. 20.
//
//   y[m, n] = bf16( float( sum_k int8(clip(rint(x[m, k] * act_scale), ±127)) * w_q[k, n] )
//                   * w_scale[n] )
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
//  - Epilogue: float(acc) * w_scale[n], rounded once to bf16, as the plain version.
//  - Edges: rows past M and k past K quantize zeros, weights past K or N are zero-
//    filled, rows and columns past M and N are not stored.  K, N or pointers that do
//    not allow 16-byte pieces take the NARROW variant (element-wise staging).
//  - Measured (chip_smoke.py): 0.073 ms a layer at M = 2048, 5x its bound.  Each
//    step's x loads, quantize and barrier-joined phases hold it, not the bytes.
//
// Decode (M <= 8, N and K multiples of 4) takes a second kernel: a warp owns four
// output columns and its 32 lanes split K, so every lane issues its weight loads
// back to back; four rows of four int8 weights are transposed in registers
// (__byte_perm) into dp4a operands, and the partial int32 sums meet in a warp
// shuffle, which is exact in any order.  int4 weights: two packed words unpack into
// the four int8 words of four K rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t quantize(float x, float s) {
  int q = __float2int_rn(x * s);
  q = max(-127, min(127, q));
  return static_cast<int8_t>(q);
}

// low byte = quantize(x, s), for any product that is not NaN (see the note)
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

// byte j of the result = the sign-extended low (HI == false) or high nibble
// of byte j of p
template <bool HI>
__device__ __forceinline__ uint32_t nibbles(uint32_t p) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = static_cast<int8_t>(p >> (8 * j));
    const int v = HI ? (b >> 4) : (((b & 15) ^ 8) - 8);
    r |= static_cast<uint32_t>(v & 0xff) << (8 * j);
  }
  return r;
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
// element-wise
template <typename T, int WB, int BM, int BN, int MT, bool VEC>
__global__ void __launch_bounds__(threads<BM, BN, MT>(), 2)
quant_matmul_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ w_scale,
                        const float* __restrict__ act_scale,
                        __nv_bfloat16* __restrict__ out, int M, int K, int N) {
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
  const float s = *act_scale;
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
  const T* xp = x + (size_t)min(m0 + xr0, M - 1) * K + xk;
  const size_t xjs = (size_t)XRS * K;
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
      const uint2 q = quantize_chunk<T>(xr[j], s);
      int8_t* d = xt + (xr0 + j * XRS) * LDA + xk;
      if constexpr (E == 8)
        *reinterpret_cast<uint2*>(d) = q;
      else
        *reinterpret_cast<uint32_t*>(d) = q.x;
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
      xt[r * LDA + c] = gm < M && gk < K
                            ? static_cast<int8_t>(quantize_bits(
                                  to_f32(x[(size_t)gm * K + gk]), s))
                            : static_cast<int8_t>(0);
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
  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sc[j] = ncol + j < N ? w_scale[ncol + j] : 0.0f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * 16 * MT + mt * 16 + g + 8 * hr;
      if (row >= M) continue;
      __align__(16) __nv_bfloat162 v[4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        int a0 = acc[mt][j & 3][2 * hr + (j >> 2)];
        int a1 = acc[mt][(j + 1) & 3][2 * hr + (j >> 2)];
        if (WB == 4) a0 >>= 4, a1 >>= 4;
        v[j / 2] = __floats2bfloat162_rn(__fmul_rn(static_cast<float>(a0), sc[j]),
                                         __fmul_rn(static_cast<float>(a1), sc[j + 1]));
      }
      __nv_bfloat16* o = out + (size_t)row * N + ncol;
      if constexpr (VEC) {
        if (ncol < N) *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (ncol + j < N) o[j] = j & 1 ? v[j / 2].y : v[j / 2].x;
      }
    }
}

constexpr int DEC_WARPS = 8;  // column quads per block: 32 columns

// M <= MR rows; N % 4 == 0 and K % 4 == 0 (4-byte weight loads).
template <typename T, int WB, int MR>
__global__ void __launch_bounds__(DEC_WARPS * 32)
quant_matmul_decode_kernel(const T* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ w_scale,
                           const float* __restrict__ act_scale,
                           __nv_bfloat16* __restrict__ out, int M, int K,
                           int N) {
  extern __shared__ __align__(16) int8_t xq[];  // [MR][K] quantized rows
  const int lane = threadIdx.x % 32;
  const int n = (blockIdx.x * DEC_WARPS + threadIdx.x / 32) * 4;
  const float s = *act_scale;
  for (int i = threadIdx.x; i < MR * K; i += DEC_WARPS * 32) {
    const int m = i / K;
    xq[i] = m < M ? quantize(to_f32(x[i]), s) : static_cast<int8_t>(0);
  }
  __syncthreads();

  int acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;
  if (n < N) {  // warp-uniform
#pragma unroll 4
    for (int k = lane * 4; k < K; k += 128) {
      // w0..w3: the int8 weights (k + i, n .. n + 3), i = 0..3
      uint32_t w0, w1, w2, w3;
      if (WB == 8) {
        const int8_t* wp = w + (size_t)k * N + n;
        w0 = *reinterpret_cast<const uint32_t*>(wp);
        w1 = *reinterpret_cast<const uint32_t*>(wp + N);
        w2 = *reinterpret_cast<const uint32_t*>(wp + 2 * (size_t)N);
        w3 = *reinterpret_cast<const uint32_t*>(wp + 3 * (size_t)N);
      } else {  // packed byte rows k/2 and k/2 + 1 hold K rows k .. k + 3
        const int8_t* wp = w + (size_t)(k >> 1) * N + n;
        const uint32_t p0 = *reinterpret_cast<const uint32_t*>(wp);
        const uint32_t p1 = *reinterpret_cast<const uint32_t*>(wp + N);
        w0 = nibbles<false>(p0);
        w1 = nibbles<true>(p0);
        w2 = nibbles<false>(p1);
        w3 = nibbles<true>(p1);
      }
      // byte j of c[j'] = weight (k + j, n + j'): four k of one column
      const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
      const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
      const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
      const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
      const int c[4] = {static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
                        static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
                        static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
                        static_cast<int>(__byte_perm(hi01, hi23, 0x7632))};
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int a = *reinterpret_cast<const int*>(&xq[m * K + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(a, c[j], acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], o);
  if (lane == 0 && n < N) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m >= M) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(size_t)m * N + n + j] = __float2bfloat16_rn(
            static_cast<float>(acc[m][j]) * w_scale[n + j]);
    }
  }
}

template <typename T, int WB, int MR>
void launch_decode(const void* x, const void* w, const void* w_scale,
                   const void* act_scale, void* out, int M, int K, int N,
                   cudaStream_t stream) {
  const size_t smem = (size_t)MR * K;
  auto kern = quant_matmul_decode_kernel<T, WB, MR>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const int cols = DEC_WARPS * 4;
  kern<<<(N + cols - 1) / cols, DEC_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(act_scale),
      static_cast<__nv_bfloat16*>(out), M, K, N);
}

template <typename T, int WB, int BM, int BN, int MT, bool VEC>
void launch(const void* x, const void* w, const void* w_scale, const void* act_scale,
            void* out, int M, int K, int N, cudaStream_t stream) {
  constexpr int nt = threads<BM, BN, MT>();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_mma_kernel<T, WB, BM, BN, MT, VEC><<<grid, nt, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(act_scale),
      static_cast<__nv_bfloat16*>(out), M, K, N);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <typename T, int WB>
void dispatch(const void* x, const void* w, const void* w_scale,
              const void* act_scale, void* out, int M, int K, int N,
              cudaStream_t stream) {
  const bool words = N % 4 == 0 && K % 4 == 0;
  if (M <= 1 && words)
    return launch_decode<T, WB, 1>(x, w, w_scale, act_scale, out, M, K, N, stream);
  if (M <= 2 && words)
    return launch_decode<T, WB, 2>(x, w, w_scale, act_scale, out, M, K, N, stream);
  if (M <= 4 && words)
    return launch_decode<T, WB, 4>(x, w, w_scale, act_scale, out, M, K, N, stream);
  if (M <= 8 && words)
    return launch_decode<T, WB, 8>(x, w, w_scale, act_scale, out, M, K, N, stream);
  const uintptr_t al = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                       reinterpret_cast<uintptr_t>(out);
  if (al % 16 || K % (16 / sizeof(T)) || N % 16)
    return launch<T, WB, 32, 64, 1, false>(x, w, w_scale, act_scale, out, M, K, N, stream);
  // warps span the block's rows (no two warps build the same B fragments); the
  // widest tile that still fills the card, else the one with the shortest chain
  const auto blocks = [&](int bm, int bn) { return ((M + bm - 1) / bm) * ((N + bn - 1) / bn); };
  if (blocks(64, 128) >= 2 * sm_count())
    launch<T, WB, 64, 128, 4, true>(x, w, w_scale, act_scale, out, M, K, N, stream);
  else if (2 * blocks(32, 128) >= sm_count())
    launch<T, WB, 32, 128, 2, true>(x, w, w_scale, act_scale, out, M, K, N, stream);
  else
    launch<T, WB, 32, 64, 1, true>(x, w, w_scale, act_scale, out, M, K, N, stream);
}

}  // namespace

// x: (M, K) float32 (x_bf16 == 0) or bfloat16 (x_bf16 == 1), row-major;
// w: (K, N) int8 row-major (w_bits == 8) or (K/2, N) packed int4 (w_bits ==
// 4, K even); w_scale: (N,) f32; act_scale: one f32 on the device; out:
// (M, N) bf16.  Launches on `stream`; returns cudaGetLastError().
extern "C" int repro_quant_matmul(const void* x, int x_bf16, const void* w,
                                  int w_bits, const void* w_scale,
                                  const void* act_scale, void* out, int M,
                                  int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;  // nothing to write (an empty grid is an error)
  if (x_bf16 && w_bits == 4)
    dispatch<__nv_bfloat16, 4>(x, w, w_scale, act_scale, out, M, K, N, st);
  else if (x_bf16)
    dispatch<__nv_bfloat16, 8>(x, w, w_scale, act_scale, out, M, K, N, st);
  else if (w_bits == 4)
    dispatch<float, 4>(x, w, w_scale, act_scale, out, M, K, N, st);
  else
    dispatch<float, 8>(x, w, w_scale, act_scale, out, M, K, N, st);
  return static_cast<int>(cudaGetLastError());
}
