// Fused int8 serving matmul for Hopper (sm_90a): FAT int8 mode, paper §2 / eq. 20.
//
//   y[m, n] = bf16( float( sum_k int8(clip(rint(x[m, k] * act_scale), ±127)) * w_q[k, n] )
//                   * w_scale[n] )
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py::quant_matmul
// (Pallas body `_kernel`).  Unlike the TPU kernel, which asserts that K and N
// tile by its MXU blocks (and so cannot run smollm-135m's K=576, N=192), this
// kernel masks ragged M, N and K edges.
//
// What bounds it on an H100: at decode (M = batch, a handful of rows) the
// int8 weight stream -- K*N bytes per call -- so the kernel is bytes-bound;
// at prefill (M = 2048) the int8 multiply-adds.  Design, right and simple
// first: a block owns a BM x BN output tile and walks K in BK steps through
// shared memory.  The activation quantize is fused into the load (multiply by
// act_scale, __float2int_rn = round half to even like jnp.round, clamp), so
// the int8 activations never touch device memory.  The weight tile is stored
// transposed in shared memory, so four consecutive k of one column form one
// 32-bit word, and each thread accumulates a TM x TN micro-tile exactly in
// int32 with __dp4a.  The epilogue applies the per-channel dequant and rounds
// to bf16 once.
//
// Decode (M <= 8) takes a second kernel: the tiled one walks K in dependent
// load/sync/compute steps and is latency-bound there.  In the decode kernel
// a warp owns four output columns and its 32 lanes split K, so every lane
// issues its weight loads back to back; four rows of four int8 weights are
// transposed in registers (__byte_perm) into dp4a operands, and the partial
// int32 sums meet in a warp shuffle, which is exact in any order.  Shapes
// with N or K not a multiple of 4, or 8 < M <= 16, use the tiled kernel with
// a narrow tile.  Tensor-core MMA (wgmma s8) and TMA are later work.
//
// int4 weights (w_bits = 4, the TPU kernel's `w_bits == 4` branch) arrive
// packed along K as (K/2, N) bytes: byte row r holds K rows 2r (low nibble)
// and 2r + 1 (high nibble), each sign-extended from 4 bits
// (core/packing.py::unpack_int4(axis=0)).  The weight width is a template
// argument of both kernels: the tiled kernel unpacks each nibble as it
// stages the transposed weight tile, the decode kernel unpacks two packed
// words into the four int8 words of four K rows.  From there the dp4a
// operands, and so the int32 sums, are the int8 branch's on the unpacked
// weights; activations stay int8.  Half the weight bytes cross memory.
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

// weight (k, n) of a (K, N) int8 (WB == 8) or (K/2, N) packed int4 matrix
template <int WB>
__device__ __forceinline__ int8_t weight(const int8_t* __restrict__ w, int k,
                                         int n, int N) {
  if (WB == 8) return w[(size_t)k * N + n];
  const int b = w[(size_t)(k >> 1) * N + n];  // sign-extended byte
  return static_cast<int8_t>((k & 1) ? (b >> 4) : (((b & 15) ^ 8) - 8));
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

template <typename T, int WB, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ w_scale,
                    const float* __restrict__ act_scale,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int LDS = BK + 4;  // bytes per shared row: 4-byte aligned, skewed banks
  __shared__ __align__(16) int8_t xs[BM * LDS];  // [row][k]
  __shared__ __align__(16) int8_t ws[BN * LDS];  // [col][k] (transposed)

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float s = *act_scale;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r * LDS + c] = (gm < M && gk < K)
                            ? quantize(to_f32(x[(size_t)gm * K + gk]), s)
                            : static_cast<int8_t>(0);
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, c = i % BN;
      const int gk = k0 + kk, gn = n0 + c;
      ws[c * LDS + kk] = (gk < K && gn < N) ? weight<WB>(w, gk, gn, N)
                                            : static_cast<int8_t>(0);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BK / 4; ++kw) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const int*>(&xs[(ty * TM + i) * LDS + kw * 4]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const int*>(&ws[(tx * TN + j) * LDS + kw * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N)
        out[(size_t)gm * N + gn] =
            __float2bfloat16_rn(static_cast<float>(acc[i][j]) * w_scale[gn]);
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

template <typename T, int WB, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const void* w, const void* w_scale,
            const void* act_scale, void* out, int M, int K, int N,
            cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_kernel<T, WB, BM, BN, BK, TM, TN><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(act_scale),
      static_cast<__nv_bfloat16*>(out), M, K, N);
}

template <typename T, int WB>
void dispatch(const void* x, const void* w, const void* w_scale,
              const void* act_scale, void* out, int M, int K, int N,
              cudaStream_t stream) {
  const bool words = N % 4 == 0 && K % 4 == 0;
  if (M <= 1 && words)
    launch_decode<T, WB, 1>(x, w, w_scale, act_scale, out, M, K, N, stream);
  else if (M <= 2 && words)
    launch_decode<T, WB, 2>(x, w, w_scale, act_scale, out, M, K, N, stream);
  else if (M <= 4 && words)
    launch_decode<T, WB, 4>(x, w, w_scale, act_scale, out, M, K, N, stream);
  else if (M <= 8 && words)
    launch_decode<T, WB, 8>(x, w, w_scale, act_scale, out, M, K, N, stream);
  else if (M <= 16)  // narrow tiles: more blocks on the weight stream
    launch<T, WB, 16, 32, 64, 2, 2>(x, w, w_scale, act_scale, out, M, K, N, stream);
  else
    launch<T, WB, 64, 64, 32, 4, 4>(x, w, w_scale, act_scale, out, M, K, N, stream);
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
