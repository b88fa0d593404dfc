// One-token flash-decode attention over the quantized KV cache, for Hopper (sm_90a):
// the kernel body shared by decode_attention.cu (normalized output, PARTIALS
// false) and decode_attention_partials.cu (raw flash state, PARTIALS true).
// Each entry file instantiates one epilogue, so the two build in parallel.
//
//   out[b, h, g] = v_scale[h] * softmax_{p < cur_pos[b]}((q[b, h, g] * k_scale[h] / sqrt(D))
//                  . K[b, p, h]) @ V[b, :, h] ,   zeros when cur_pos[b] == 0
//
// or, with the partials epilogue (PARTIALS), the raw flash state of
// the same walk for a cross-shard merge: acc = v_scale[h] * sum_p e^(s_p - m) V_p
// (unnormalized), m = max_p s_p and l = sum_p e^(s_p - m), where s_p is the
// scaled score above; a row with nothing visible writes (0, -1e30, 0), the
// merge's identity.  acc / max(l, 1e-30) is then the normalized output bit for
// bit: the same operations in the same order.
//
// K/V hold int8 values (bits == 8) or int4 values packed two per byte along D
// (bits == 4: element 2i in the low nibble of byte i, D/2 bytes a row).  They
// are a dense (B, S, KV, D) stream (table == nullptr), or a paged pool (pages,
// P, KV, D) with a (B, NB) block table: position t of request b is pool row
// table[b * NB + t / P] * P + t % P.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py::decode_attention_tiles
// (bodies `_kernel` + `_flash_step`, both kv_bits branches; its dense entry
// decode_attention_int8 is the null table here, the paged layout's call the
// real table) and ::decode_attention_partials_tiles (body `_partials_kernel`,
// the PARTIALS epilogue; its dense entry decode_attention_partials reads one
// shard's slice of the sequence axis in place, through the row pitch).
//
// What bounds it on an H100: the quantized K/V stream, 2 * cur_pos * D * bits / 8
// bytes per (request, KV head) and step -- decode attention does ~2 flops per
// byte, far below the card's ridge, so it is bytes-bound.  Design: one block
// per (request, KV head).  The G query heads that share a KV head (GQA) share
// every K/V tile: a tile of TS positions is staged once in shared memory in its
// storage form (int8, or packed int4 at half the bytes; the dequant scales fold
// into q and into the epilogue, so the dequantize costs nothing per element and
// an int4 scale T/7 folds exactly as T/127 does), then each thread scores one
// position for all G rows, unpacking a 32-bit word (4 int8 or 8 int4 keys) at a
// time, warps reduce the running max / normalizer per row (online softmax,
// masked before the max update and again after it, as the TPU body does), and
// threads own (g, d) accumulator entries for P @ V.  Only tiles below cur_pos
// are visited: a skipped, fully masked tile is an exact no-op of the online
// softmax.  Staging keeps UNR loads in flight per thread: a loop with one load
// per trip waits out the full memory latency on every trip.  At batch 4 and 3
// KV heads this launches only 12 blocks on 132 SMs; the sequence-parallel
// path launches the partials epilogue once per shard of the S axis, and one
// launch over every shard (split S across blocks, then the merge) is the
// next step.  A dense stream is read with a row pitch (positions between
// batch rows), so a shard's slice k[:, i*S_l:(i+1)*S_l] of a (B, S, KV, D)
// cache is read where it lies; the whole cache passes its own S.  Paging is
// a template argument, so the dense variant is the dense kernel as it was.  The block table moves storage only: the tile
// walk (TS positions, whatever the page size; a tile may span pages) and the
// arithmetic are the dense ones, so a paged cache and its gathered dense copy
// give bit-identical outputs.  Each tile first maps its TS positions through
// the table once (one thread a position) into shared memory, so the staging
// loads carry no table lookup or division.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 128;  // positions per tile == threads per block
constexpr int UNR = 8;   // global loads in flight per thread while staging
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// element e of a 32-bit word of K/V storage: 4 int8 values (BITS 8) or 8
// packed int4 values, element e in bits [4e, 4e + 4) (BITS 4), sign-extended
template <int BITS>
__device__ __forceinline__ float word_elem(int w, int e) {
  if constexpr (BITS == 8) {
    return static_cast<float>(static_cast<int8_t>(w >> (8 * e)));
  } else {
    return static_cast<float>(static_cast<int>(static_cast<unsigned>(w) << (28 - 4 * e)) >> 28);
  }
}

// element d of one staged K/V row in its storage form
template <int BITS>
__device__ __forceinline__ float row_elem(const int8_t* row, int d) {
  if constexpr (BITS == 8) {
    return static_cast<float>(row[d]);
  } else {
    const int byte = row[d >> 1];
    return static_cast<float>((d & 1) ? (byte >> 4) : (((byte & 15) ^ 8) - 8));
  }
}

// pool row that holds position t of request b in a paged cache: the block
// table's page (clamped into the pool), offset t % P
__device__ __forceinline__ size_t paged_row(const int* table, int b, int t, int NB,
                                            int P, int n_pages) {
  const int page = min(max(table[b * NB + t / P], 0), n_pages - 1);
  return (size_t)page * P + t % P;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// GMAX: compile-time bound on the query rows per KV head (G <= GMAX);
// BITS: storage width of K/V (8, or 4 packed); PAGED: K/V are page pools read
// through the block table (else a dense (B, S, KV, D) stream, batch rows
// `pitch` positions apart); PARTIALS: the epilogue writes the raw flash state
// (acc, m_out, l_out) instead of the normalized output.
template <typename T, int GMAX, int BITS, bool PAGED, bool PARTIALS>
__global__ void __launch_bounds__(TS)
decode_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                        const int8_t* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ cur_pos,
                        const int* __restrict__ table, float* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int S, int pitch, int KV, int G, int D, int NB, int P,
                        int n_pages) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = min(cur_pos[b], S);
  constexpr int EPW = 32 / BITS;  // K/V elements per 32-bit word
  const int DP = D * BITS / 8;    // storage bytes per K/V row (D % 8 == 0)
  const int LD = DP + 4;          // bytes per staged K/V row
  const int words = DP / 4;

  size_t* rows = reinterpret_cast<size_t*>(smem);  // [TS] pool rows (PAGED)
  float* qs = smem + (PAGED ? 2 * TS : 0);        // [G][D] q * k_scale / sqrt(D)
  float* acc = qs + G * D;    // [G][D] running P @ V
  float* sc = acc + G * D;    // [G][TS] scores, then probabilities
  float* m = sc + G * TS;     // [G] running max
  float* l = m + G;           // [G] running normalizer
  float* cr = l + G;          // [G] this tile's correction exp(m_prev - m_new)
  int8_t* ks = reinterpret_cast<int8_t*>(cr + G);  // [TS][LD]
  int8_t* vs = ks + TS * LD;                       // [TS][LD]

  const float c = k_scale[h] * (1.0f / sqrtf(static_cast<float>(D)));
  const T* qb = q + ((size_t)b * KV + h) * G * D;
  for (int i = tid; i < G * D; i += TS) {
    qs[i] = to_f32(qb[i]) * c;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += TS) {
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int* k32 = reinterpret_cast<const int*>(k);
  const int* v32 = reinterpret_cast<const int*>(v);
  const int n_words = TS * words;
  for (int t0 = 0; t0 < len; t0 += TS) {
    if constexpr (PAGED) {
      // this tile's pool rows (the last tile's readers passed the barrier
      // that ends its P @ V phase)
      if (t0 + tid < len) rows[tid] = paged_row(table, b, t0 + tid, NB, P, n_pages);
      __syncthreads();
    }
    // stage the K/V tile, UNR loads of each in flight per thread (positions
    // at or past len load zeros; they are masked below)
    for (int base = tid; base < n_words; base += UNR * TS) {
      int kw[UNR], vw[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int i = base + u * TS;
        const int t = i / words, wd = i % words;
        kw[u] = 0;
        vw[u] = 0;
        if (i < n_words && t0 + t < len) {
          const size_t row = PAGED ? rows[t] : (size_t)b * pitch + t0 + t;
          const size_t off = ((row * KV + h) * DP) / 4 + wd;
          kw[u] = k32[off];
          vw[u] = v32[off];
        }
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int i = base + u * TS;
        if (i < n_words) {
          const int t = i / words, wd = i % words;
          reinterpret_cast<int*>(ks + t * LD)[wd] = kw[u];
          reinterpret_cast<int*>(vs + t * LD)[wd] = vw[u];
        }
      }
    }
    __syncthreads();

    // scores: thread t scores position t0 + t for every query row, EPW
    // keys (4 int8 or 8 int4) per 32-bit shared load
    {
      const int t = tid;
      const int* kr = reinterpret_cast<const int*>(ks + t * LD);
      float s[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
      for (int wd = 0; wd < words; ++wd) {
        const int kw = kr[wd];
        float kf[EPW];
#pragma unroll
        for (int e = 0; e < EPW; ++e) kf[e] = word_elem<BITS>(kw, e);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
#pragma unroll
            for (int j = 0; j < EPW / 4; ++j) {
              const float4 qv =
                  reinterpret_cast<const float4*>(qs + g * D)[wd * (EPW / 4) + j];
              s[g] += qv.x * kf[4 * j] + qv.y * kf[4 * j + 1] + qv.z * kf[4 * j + 2] +
                      qv.w * kf[4 * j + 3];
            }
          }
        }
      }
      const bool valid = t0 + t < len;
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) sc[g * TS + t] = valid ? s[g] : NEG_INF;
    }
    __syncthreads();

    // online-softmax update, one warp per query row
    for (int g = warp; g < G; g += TS / 32) {
      float mx = NEG_INF;
      for (int t = lane; t < TS; t += 32) mx = fmaxf(mx, sc[g * TS + t]);
      mx = warp_max(mx);
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < TS; t += 32) {
        // re-mask: an all-masked tile has s == m_new == NEG_INF, exp(0) == 1
        const float p = (t0 + t < len) ? expf(sc[g * TS + t] - m_new) : 0.f;
        sc[g * TS + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cr[g] = corr;
        l[g] = l[g] * corr + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V over this tile's live positions
    const int tmax = min(TS, len - t0);
    for (int i = tid; i < G * D; i += TS) {
      const int g = i / D, d = i % D;
      const float* pr = sc + g * TS;
      float a[4] = {0.f, 0.f, 0.f, 0.f};  // four independent FMA chains
      int t = 0;
      for (; t + 4 <= tmax; t += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          a[u] += pr[t + u] * row_elem<BITS>(vs + (t + u) * LD, d);
      }
      for (; t < tmax; ++t) a[0] += pr[t] * row_elem<BITS>(vs + t * LD, d);
      acc[i] = acc[i] * cr[g] + ((a[0] + a[1]) + (a[2] + a[3]));
    }
    __syncthreads();
  }

  // epilogue: value dequant once, then normalize (l == 0 -> exact zeros), or
  // (PARTIALS) leave acc unnormalized and emit the running max and normalizer
  const float vsc = v_scale[h];
  float* ob = out + ((size_t)b * KV + h) * G * D;
  if constexpr (PARTIALS) {
    for (int i = tid; i < G * D; i += TS) ob[i] = acc[i] * vsc;
    for (int g = tid; g < G; g += TS) {
      m_out[((size_t)b * KV + h) * G + g] = m[g];
      l_out[((size_t)b * KV + h) * G + g] = l[g];
    }
  } else {
    for (int i = tid; i < G * D; i += TS) ob[i] = acc[i] * vsc / fmaxf(l[i / D], 1e-30f);
  }
}

// the paged layout's block table (nullptr: a dense stream) and its shape
struct Paging {
  const int* table;
  int NB, P, n_pages;
};

// where the results go: the (B, KV, G, D) output, and for the partials
// epilogue the (B, KV, G) running max and normalizer (nullptr: normalize);
// pitch: positions between the batch rows of a dense stream
struct Outputs {
  float* out;
  float* m;
  float* l;
  int pitch;
};

template <typename T, int GMAX, int BITS, bool PAGED, bool PARTIALS>
int launch_variant(const void* q, const void* k, const void* v, const void* k_scale,
                   const void* v_scale, const void* cur_pos, int B, int S, int KV,
                   int G, int D, Paging pg, Outputs o, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * G * D + G * TS + 3 * G) +
                      2 * (size_t)TS * (D * BITS / 8 + 4) +
                      (PAGED ? sizeof(size_t) * TS : 0);
  auto kern = decode_attention_kernel<T, GMAX, BITS, PAGED, PARTIALS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(KV, B), TS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(cur_pos), pg.table,
      o.out, o.m, o.l, S, o.pitch, KV, G, D, pg.NB, pg.P, pg.n_pages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GMAX, int BITS, bool PARTIALS>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* cur_pos, int B, int S, int KV, int G, int D,
           Paging pg, Outputs o, cudaStream_t st) {
  if (pg.table != nullptr)
    return launch_variant<T, GMAX, BITS, true, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S,
                                                         KV, G, D, pg, o, st);
  return launch_variant<T, GMAX, BITS, false, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S,
                                                        KV, G, D, pg, o, st);
}

template <typename T, int BITS, bool PARTIALS>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* cur_pos, int B, int S, int KV, int G, int D,
             Paging pg, Outputs o, cudaStream_t st) {
  if (G <= 1)
    return launch<T, 1, BITS, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S, KV, G, D, pg, o, st);
  if (G <= 2)
    return launch<T, 2, BITS, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S, KV, G, D, pg, o, st);
  if (G <= 4)
    return launch<T, 4, BITS, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S, KV, G, D, pg, o, st);
  if (G <= 8)
    return launch<T, 8, BITS, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S, KV, G, D, pg, o, st);
  return launch<T, 16, BITS, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S, KV, G, D, pg, o, st);
}

// q: (B, KV, G, D) f32 (q_bf16 == 0) or bf16; k/v: (B, S, KV, D) int8 (bits
// == 8) or (B, S, KV, D/2) packed int4 (bits == 4) with batch rows o.pitch
// positions apart (pitch >= S; rows of KV * D or D/2 contiguous bytes) when
// the table is null, else pools (n_pages, P, KV, D or D/2) read through the
// (B, NB) int32 block table, with S == NB * P; k_scale/v_scale: (KV,) f32;
// cur_pos: (B,) int32 valid positions; o.out: (B, KV, G, D) f32, normalized,
// or (PARTIALS) the unnormalized accumulator with o.m / o.l: (B, KV, G) f32.
// Requires G <= 16, D % 8 == 0, D <= 128.
template <bool PARTIALS>
int run_decode_attention(const void* q, int q_bf16, const void* k, const void* v,
                         const void* k_scale, const void* v_scale, const void* cur_pos,
                         int B, int S, int KV, int G, int D, int bits, Paging pg,
                         Outputs o, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (PARTIALS && (o.m == nullptr || o.l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pg.table == nullptr && o.pitch < S) return static_cast<int>(cudaErrorInvalidValue);
  if (bits != 8 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (q_bf16) {
    if (bits == 8)
      return dispatch<__nv_bfloat16, 8, PARTIALS>(q, k, v, k_scale, v_scale, cur_pos, B,
                                                  S, KV, G, D, pg, o, st);
    return dispatch<__nv_bfloat16, 4, PARTIALS>(q, k, v, k_scale, v_scale, cur_pos, B, S,
                                                KV, G, D, pg, o, st);
  }
  if (bits == 8)
    return dispatch<float, 8, PARTIALS>(q, k, v, k_scale, v_scale, cur_pos, B, S, KV, G,
                                        D, pg, o, st);
  return dispatch<float, 4, PARTIALS>(q, k, v, k_scale, v_scale, cur_pos, B, S, KV, G, D,
                                      pg, o, st);
}

}  // namespace
