// Fused per-channel fake-quantize for Hopper (sm_90a): the QAT student's
// elementwise quantize-dequantize (paper §3.1.3).
//
//   t_adj[n] = max(clip(alpha[n], alpha_min, alpha_max) * t_max[n], 1e-8)
//   s[n]     = levels / t_adj[n]
//   y[m, n]  = T( clip(rint(float(x[m, n]) * s[n]), qmin, qmax) / s[n] )
//
// Replaces the TPU kernel src/repro/kernels/fake_quant.py::fake_quant_fwd
// (Pallas body `_kernel`) in the reference's order of operations: float32
// throughout, round half to even (rintf, like jnp.round), a true division by
// s (never a multiply by 1/s), and one round-to-nearest-even cast to x's
// type.  The build keeps -use_fast_math off, so both divisions are IEEE.
// NaN propagates through the clips, as it does through jnp.clip.  The TPU
// kernel asserts that M and N tile by its 512 x 512 blocks; this kernel
// masks ragged edges.
//
// What bounds it on an H100: the bytes.  Each element is read once and
// written once (2 * M * N * sizeof(T)); the arithmetic is a handful of
// float32 operations an element.  Design, simple first: a thread owns one
// column n, computes s[n] once, and walks ROWS rows of it; the 128 threads
// of a block cover 128 neighbouring columns, so every row access of a warp
// is one coalesced segment.  t_max and alpha are a scalar (stride 0) or
// one value a column (stride 1), as the reference broadcasts them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // columns a block
constexpr int ROWS = 8;       // rows a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// jnp.clip(v, lo, hi) == minimum(maximum(v, lo), hi), NaN passing through
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fake_quant_kernel(const T* __restrict__ x, const float* __restrict__ t_max,
                  int t_stride, const float* __restrict__ alpha, int a_stride,
                  T* __restrict__ out, int M, int N, float levels, float qmin,
                  float qmax, float alpha_min, float alpha_max) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const float a = clip(alpha[n * a_stride], alpha_min, alpha_max);
  const float p = a * t_max[n * t_stride];
  const float t_adj = p < 1e-8f ? 1e-8f : p;  // jnp.maximum(p, 1e-8)
  const float s = levels / t_adj;
  const int m1 = min(M, (int)(blockIdx.y + 1) * ROWS);
  for (int m = blockIdx.y * ROWS; m < m1; ++m) {
    const size_t i = (size_t)m * N + n;
    const float q = clip(rintf(to_f32(x[i]) * s), qmin, qmax);
    out[i] = from_f32<T>(q / s);
  }
}

template <typename T>
void launch(const void* x, const float* t_max, int t_stride,
            const float* alpha, int a_stride, void* out, int M, int N,
            float levels, float qmin, float qmax, float alpha_min,
            float alpha_max, cudaStream_t stream) {
  const dim3 grid((N + THREADS - 1) / THREADS, (M + ROWS - 1) / ROWS);
  fake_quant_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), t_max, t_stride, alpha, a_stride,
      static_cast<T*>(out), M, N, levels, qmin, qmax, alpha_min, alpha_max);
}

}  // namespace

// x, out: (M, N) row-major, float32 (x_bf16 == 0) or bfloat16 (x_bf16 ==
// 1); t_max, alpha: float32 on the device, one value (stride 0) or N
// (stride 1).  Launches on `stream`; returns cudaGetLastError().
extern "C" int repro_fake_quant(const void* x, int x_bf16, const void* t_max,
                                int t_stride, const void* alpha, int a_stride,
                                void* out, int M, int N, float levels,
                                float qmin, float qmax, float alpha_min,
                                float alpha_max, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(t_max);
  const float* a = static_cast<const float*>(alpha);
  if (x_bf16)
    launch<__nv_bfloat16>(x, t, t_stride, a, a_stride, out, M, N, levels,
                          qmin, qmax, alpha_min, alpha_max, st);
  else
    launch<float>(x, t, t_stride, a, a_stride, out, M, N, levels, qmin, qmax,
                  alpha_min, alpha_max, st);
  return static_cast<int>(cudaGetLastError());
}
