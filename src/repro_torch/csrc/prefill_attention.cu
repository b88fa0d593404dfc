// Flash-prefill attention over a quantized K/V stream, for Hopper (sm_90a).
//
//   out[b, i, h, g] = v_scale[h] * softmax_{k visible to i}((q[b, i, h, g] * k_scale[h]
//                     / sqrt(D)) . K[b, k, h]) @ V[b, :, h]
//   visible: k < kv_len[b], k <= q_start[b] + i (causal), q_start[b] + i - k < window;
//   a row with no visible key is zeros.
// K/V hold int8 values (bits == 8) or int4 values packed two per byte along D
// (bits == 4: element 2i in the low nibble of byte i, D/2 bytes a row).  They
// are a dense (B, Sk, KV, D) stream (table == nullptr), or a paged pool (pages,
// P, KV, D) with a (B, NB) block table: key position t of request b is pool
// row table[b * NB + t / P] * P + t % P.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py::prefill_attention_tiles
// (body `_kernel`, both kv_bits branches; its dense entry prefill_attention_int8
// is the null table here, chunked prefill into a paged cache the real table).
//
// What bounds it on an H100: operations.  A causal prompt of S tokens does
// ~2 * S^2 * D * H flops over 2 * S * D * KV * bits / 8 bytes of K/V, far above
// the card's ridge (with the float32 output counted, the byte bound is close
// at S = 512).  Design: one block per (request, KV head, query tile).  As in the
// TPU kernel the G query heads of a KV head are flattened into rows (row r
// sits at position q_lo + r / G), so each staged K/V tile serves G times as
// many rows.  Per key tile of BK positions: K^T and V are staged dequant-free
// as float (the scales fold into q and into the epilogue; an int4 scale T/7
// folds exactly as T/127 does), each 32-bit global load carrying 4 int8 or 8
// packed int4 values that the staging step unpacks; every thread
// computes an 8-row x 4-key block of scores from float4 reads of q^T and K^T
// (12 shared loads per 32 FMAs) and updates the online softmax of its rows
// in registers, the 16 lanes of a row group meeting in shuffles (masked keys
// take no part in the max and get p = 0, as the TPU body's re-mask does);
// every thread keeps an 8-row x 4-column block of the output accumulator in
// registers for P @ V.  The key-tile loop runs only from the window's
// first live tile to min(kv_len, causal frontier): the TPU body's `live`
// skip (the counterpart of the TPU kernel's dma_skip clamp), and an exact no-op
// for the tiles it drops.  Paging is a template argument, so the dense variant
// is the dense kernel as it was.  A paged key tile may span pages: each tile
// first maps its BK key positions through the table once into shared memory,
// and the tile walk and arithmetic are the dense ones, so a paged pool and
// its gathered dense copy give bit-identical outputs.  Staging keeps UNR global
// loads in flight per thread.  The math is float32 on the CUDA cores;
// tensor-core MMA (wgmma) and TMA pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads per block: 8 row groups x 16 column groups
constexpr int BK = 64;         // keys per tile
constexpr int ROWS = 64;       // flattened (position, group) rows per block
constexpr int LDS = BK + 4;    // score row stride (floats)
constexpr int UNR = 8;         // global loads in flight per thread while staging
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

// pool row that holds key position t of request b in a paged cache: the
// block table's page (clamped into the pool), offset t % P
__device__ __forceinline__ size_t paged_row(const int* table, int b, int t, int NB,
                                            int P, int n_pages) {
  const int page = min(max(table[b * NB + t / P], 0), n_pages - 1);
  return (size_t)page * P + t % P;
}

__device__ __forceinline__ bool visible(int kp, int qp, int klen, int causal,
                                        int window) {
  bool ok = kp < klen;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

// DCH: 64-wide column chunks of the head dim held per thread (D <= 64 * DCH);
// BITS: storage width of K/V (8, or 4 packed); PAGED: K/V are page pools read
// through the block table (else a dense (B, Sk, KV, D) stream).
template <typename T, int DCH, int BITS, bool PAGED>
__global__ void __launch_bounds__(NT)
prefill_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ q_start,
                         const int* __restrict__ kv_len,
                         const int* __restrict__ table, float* __restrict__ out,
                         int Sq, int Sk, int KV, int G, int D, int BQ,
                         int causal, int window, int NB, int P, int n_pages) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = BQ * G;
  constexpr int EPW = 32 / BITS;  // K/V elements per 32-bit word
  const int DP = D * BITS / 8;    // storage bytes per K/V row (D % 8 == 0)
  const int words = DP / 4;

  size_t* krow = reinterpret_cast<size_t*>(smem);  // [BK] pool rows (PAGED)
  float* qT = smem + (PAGED ? 2 * BK : 0);        // [D][ROWS] q^T * k_scale / sqrt(D)
  float* kT = qT + D * ROWS;     // [D][BK] K tile^T
  float* vt = kT + D * BK;       // [BK][D] V tile
  float* sc = vt + BK * D;       // [ROWS][LDS] scores, then probabilities
  float* m = sc + ROWS * LDS;    // [ROWS] running max
  float* l = m + ROWS;           // [ROWS] running normalizer

  const int i0 = qt * BQ;                  // first query index of the tile
  const int n_pos = min(BQ, Sq - i0);      // real query positions in the tile
  const int q_lo = q_start[b] + i0;        // absolute position of row 0
  const int q_hi = q_lo + n_pos - 1;
  const int klen = min(kv_len[b], Sk);

  const float c = k_scale[h] * (1.0f / sqrtf(static_cast<float>(D)));
  for (int base = tid; base < ROWS * D; base += UNR * NT) {
    float val[UNR];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int i = base + u * NT;
      const int r = i % ROWS, d = i / ROWS;
      const int qi = i0 + r / G;
      val[u] = 0.f;
      if (i < ROWS * D && r < rows && qi < Sq)
        val[u] = to_f32(q[((((size_t)b * Sq + qi) * KV + h) * G + r % G) * D + d]) * c;
    }
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int i = base + u * NT;
      if (i < ROWS * D) qT[i] = val[u];  // i = d * ROWS + r
    }
  }
  for (int r = tid; r < ROWS; r += NT) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  int k_end = klen;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - (window - 1));

  const int tc = tid % 16;  // key columns tc*4.. (scores), head-dim columns (P @ V)
  const int tr = tid / 16;  // rows tr*8..tr*8+7
  const int* k32 = reinterpret_cast<const int*>(k);
  const int* v32 = reinterpret_cast<const int*>(v);
  const int n_words = BK * words;
  int qp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) qp[i] = q_lo + (tr * 8 + i) / G;
  float acc[DCH][8][4];
#pragma unroll
  for (int ch = 0; ch < DCH; ++ch)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[ch][i][j] = 0.f;
  __syncthreads();

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    if constexpr (PAGED) {
      // this tile's pool rows (the last tile's readers passed the barrier
      // that ends its P @ V phase)
      if (tid < BK && k0 + tid < Sk) krow[tid] = paged_row(table, b, k0 + tid, NB, P, n_pages);
      __syncthreads();
    }
    // stage K^T and V as float, UNR loads of each in flight per thread
    // (positions past Sk are zeros, masked below), unpacking each word's EPW
    // values.  K goes key-fastest and V word-fastest, so both shared stores
    // are free of bank conflicts.
    for (int base = tid; base < n_words; base += UNR * NT) {
      int kw[UNR], vw[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int i = base + u * NT;
        const int tk = i % BK, wk = i / BK;
        const int tv = i / words, wv = i % words;
        kw[u] = 0;
        vw[u] = 0;
        if (i < n_words && k0 + tk < Sk) {
          const size_t row = PAGED ? krow[tk] : (size_t)b * Sk + k0 + tk;
          kw[u] = k32[((row * KV + h) * DP) / 4 + wk];
        }
        if (i < n_words && k0 + tv < Sk) {
          const size_t row = PAGED ? krow[tv] : (size_t)b * Sk + k0 + tv;
          vw[u] = v32[((row * KV + h) * DP) / 4 + wv];
        }
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int i = base + u * NT;
        if (i >= n_words) continue;
        const int tk = i % BK, wk = i / BK;
        const int tv = i / words, wv = i % words;
#pragma unroll
        for (int e = 0; e < EPW; ++e)
          kT[(EPW * wk + e) * BK + tk] = word_elem<BITS>(kw[u], e);
#pragma unroll
        for (int j = 0; j < EPW / 4; ++j)
          reinterpret_cast<float4*>(vt + tv * D)[wv * (EPW / 4) + j] = make_float4(
              word_elem<BITS>(vw[u], 4 * j), word_elem<BITS>(vw[u], 4 * j + 1),
              word_elem<BITS>(vw[u], 4 * j + 2), word_elem<BITS>(vw[u], 4 * j + 3));
      }
    }
    __syncthreads();

    // scores: rows tr*8..+7 x keys k0 + tc*4..+3, then the online-softmax
    // update in registers: the 16 lanes that share a row group (one half of
    // a warp) reduce each row's max and sum with shuffles
    {
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float4 qa = *reinterpret_cast<const float4*>(qT + d * ROWS + tr * 8);
        const float4 qb = *reinterpret_cast<const float4*>(qT + d * ROWS + tr * 8 + 4);
        const float4 kk = *reinterpret_cast<const float4*>(kT + d * BK + tc * 4);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
      }
      uint32_t vis = 0;  // bit 4 * i + j: key k0 + tc*4 + j visible to row i
      float m_prev[8], m_new[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m_prev[i] = m[tr * 8 + i];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (visible(k0 + tc * 4 + j, qp[i], klen, causal, window)) {
            vis |= 1u << (4 * i + j);
            mx = fmaxf(mx, s[i][j]);
          }
        }
        m_new[i] = mx;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], o));
      float sum[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m_new[i] = fmaxf(m_prev[i], m_new[i]);
        float4 pv;
        // masked keys get p = 0 (an all-masked row has m_new == NEG_INF)
        pv.x = (vis >> (4 * i + 0)) & 1u ? expf(s[i][0] - m_new[i]) : 0.f;
        pv.y = (vis >> (4 * i + 1)) & 1u ? expf(s[i][1] - m_new[i]) : 0.f;
        pv.z = (vis >> (4 * i + 2)) & 1u ? expf(s[i][2] - m_new[i]) : 0.f;
        pv.w = (vis >> (4 * i + 3)) & 1u ? expf(s[i][3] - m_new[i]) : 0.f;
        sum[i] = (pv.x + pv.y) + (pv.z + pv.w);
        *reinterpret_cast<float4*>(sc + (tr * 8 + i) * LDS + tc * 4) = pv;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float corr = expf(m_prev[i] - m_new[i]);
#pragma unroll
        for (int ch = 0; ch < DCH; ++ch)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[ch][i][j] *= corr;
        if (tc == 0) {
          const int r = tr * 8 + i;
          l[r] = l[r] * corr + sum[i];
          m[r] = m_new[i];
        }
      }
    }
    // P rows tr*8..+7 were written by this half-warp only
    __syncwarp();

    // acc += P @ V for rows tr*8..+7, columns ch*64 + tc*4..+3
    for (int t = 0; t < BK; ++t) {
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = sc[(tr * 8 + i) * LDS + t];
#pragma unroll
      for (int ch = 0; ch < DCH; ++ch) {
        const int d = ch * 64 + tc * 4;
        if (d < D) {
          const float4 vv = *reinterpret_cast<const float4*>(vt + t * D + d);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[ch][i][0] += p[i] * vv.x;
            acc[ch][i][1] += p[i] * vv.y;
            acc[ch][i][2] += p[i] * vv.z;
            acc[ch][i][3] += p[i] * vv.w;
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: value dequant once, normalize (l == 0 -> exact zeros)
  const float vsc = v_scale[h];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tr * 8 + i;
    const int qi = i0 + r / G;
    if (r >= rows || qi >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = out + ((((size_t)b * Sq + qi) * KV + h) * G + r % G) * D;
#pragma unroll
    for (int ch = 0; ch < DCH; ++ch) {
      const int d = ch * 64 + tc * 4;
      if (d < D) {
#pragma unroll
        for (int j = 0; j < 4; ++j) orow[d + j] = acc[ch][i][j] * vsc / den;
      }
    }
  }
}

// the paged layout's block table (nullptr: a dense stream) and its shape
struct Paging {
  const int* table;
  int NB, P, n_pages;
};

template <typename T, int DCH, int BITS, bool PAGED>
int launch_variant(const void* q, const void* k, const void* v, const void* k_scale,
                   const void* v_scale, const void* q_start, const void* kv_len,
                   void* out, int B, int Sq, int Sk, int KV, int G, int D, int causal,
                   int window, Paging pg, cudaStream_t stream) {
  const int BQ = ROWS / G > 0 ? ROWS / G : 1;
  const size_t smem = sizeof(float) *
      ((size_t)D * ROWS + (size_t)D * BK + (size_t)BK * D + ROWS * LDS + 2 * ROWS) +
      (PAGED ? sizeof(size_t) * BK : 0);
  auto kern = prefill_attention_kernel<T, DCH, BITS, PAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, KV, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(q_start),
      static_cast<const int*>(kv_len), pg.table, static_cast<float*>(out), Sq, Sk, KV,
      G, D, BQ, causal, window, pg.NB, pg.P, pg.n_pages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DCH, int BITS>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* q_start, const void* kv_len, void* out, int B,
           int Sq, int Sk, int KV, int G, int D, int causal, int window, Paging pg,
           cudaStream_t st) {
  if (pg.table != nullptr)
    return launch_variant<T, DCH, BITS, true>(q, k, v, ks, vs, q_start, kv_len, out, B,
                                              Sq, Sk, KV, G, D, causal, window, pg, st);
  return launch_variant<T, DCH, BITS, false>(q, k, v, ks, vs, q_start, kv_len, out, B,
                                             Sq, Sk, KV, G, D, causal, window, pg, st);
}

template <typename T, int BITS>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* q_start, const void* kv_len, void* out,
             int B, int Sq, int Sk, int KV, int G, int D, int causal, int window,
             Paging pg, cudaStream_t st) {
  if (D <= 64)
    return launch<T, 1, BITS>(q, k, v, ks, vs, q_start, kv_len, out, B, Sq, Sk, KV,
                              G, D, causal, window, pg, st);
  return launch<T, 2, BITS>(q, k, v, ks, vs, q_start, kv_len, out, B, Sq, Sk, KV, G,
                            D, causal, window, pg, st);
}

template <typename T>
int dispatch_bits(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* q_start, const void* kv_len,
                  void* out, int B, int Sq, int Sk, int KV, int G, int D,
                  int causal, int window, int bits, Paging pg, cudaStream_t st) {
  if (bits == 8)
    return dispatch<T, 8>(q, k, v, ks, vs, q_start, kv_len, out, B, Sq, Sk, KV, G, D,
                          causal, window, pg, st);
  if (bits == 4)
    return dispatch<T, 4>(q, k, v, ks, vs, q_start, kv_len, out, B, Sq, Sk, KV, G, D,
                          causal, window, pg, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, Sq, KV, G, D) f32 (q_bf16 == 0) or bf16; k/v: (B, Sk, KV, D) int8
// (bits == 8) or (B, Sk, KV, D/2) packed int4 (bits == 4) when table is null,
// else pools (n_pages, P, KV, D or D/2) read through the (B, NB) int32 block
// table, with Sk == NB * P; k_scale/v_scale: (KV,) f32; q_start, kv_len: (B,)
// int32; window <= 0 means no window; out: (B, Sq, KV, G, D) f32.  Requires
// G <= 64, D % 8 == 0, D <= 128.
extern "C" int repro_prefill_attention(const void* q, int q_bf16, const void* k,
                                       const void* v, const void* k_scale,
                                       const void* v_scale, const void* q_start,
                                       const void* kv_len, void* out, int B,
                                       int Sq, int Sk, int KV, int G, int D,
                                       int causal, int window, int bits,
                                       const void* table, int NB, int P,
                                       int n_pages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Paging pg{static_cast<const int*>(table), NB, P, n_pages};
  if (q_bf16)
    return dispatch_bits<__nv_bfloat16>(q, k, v, k_scale, v_scale, q_start, kv_len,
                                        out, B, Sq, Sk, KV, G, D, causal, window,
                                        bits, pg, st);
  return dispatch_bits<float>(q, k, v, k_scale, v_scale, q_start, kv_len, out, B, Sq,
                              Sk, KV, G, D, causal, window, bits, pg, st);
}
