// One-token flash-decode attention over the quantized KV cache, for Hopper (sm_90a):
// the kernel body shared by decode_attention.cu (normalized output, PARTIALS
// false) and decode_attention_partials.cu (raw flash state, PARTIALS true),
// each for D <= 128, and their _wide twins for 128 < D <= 256.  Each entry
// file instantiates one epilogue at one head-dim class, so the four build in
// parallel.
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
// What bounds it on an H100: in principle the quantized K/V stream, 2 * cur_pos
// * D * bits / 8 bytes per (request, KV head) and step (~2 flops a byte, far
// below the card's ridge); at the serving shapes that is under 1 MB, a few
// tenths of a microsecond, so in practice the kernel is bound by latency: the
// chain of dependent memory round trips, barriers and instruction steps
// between its launch and its last store, at one or two warps a scheduler.
// The design spreads a row over many blocks and keeps that chain short.
//
// Chunks.  The sequence axis is cut into chunks of SPLIT positions, fixed by
// position alone (chunk c holds positions [c * SPLIT, (c + 1) * SPLIT)), and
// each block takes one chunk of one (KV head, request): the grid is (KV, B,
// ceil(S / SPLIT)).  A block whose chunk starts at or past cur_pos[b] leaves at
// once (chunk 0 always runs, so a row with cur_pos == 0 still writes its zeros
// or its identity).  The chunk boundaries depend on the position only, never
// on S, the page size, the grid or the card, so a paged pool and its gathered
// dense copy, the same rows in caches of different capacity, and one shard of
// partials over the whole cache and the normalized kernel all give the same
// bits.  Within a block (NT threads, NT / 32 warps of PPW positions each):
//  - staging: every global load goes out at once, before cur_pos is known:
//    the scalars, q, and the chunk's K and V in 16-byte pieces (single words
//    where a row is not a multiple of 16 bytes); positions past cur_pos are
//    masked below.  Paged, each piece first reads its page from the table.
//    q * k_scale * log2(e) / sqrt(D) goes to shared memory, and so do K and
//    V, rows padded so that the scores meet no bank conflict.  One barrier;
//  - per warp, no barrier: QPP lanes score a position (each a strided share
//    of its words, for all G query rows, summed by a butterfly of shuffles;
//    K/V widened by a float bit trick, the byte or nibble as the low bits of
//    2^23 + v + bias, not by I2F), the warp's max and the probabilities 2^(s
//    - max) (MUFU ex2; scores are in log2 units) and their sum by butterflies,
//    then P @ V over the warp's own positions: up to D = 128, lanes in groups
//    of D / 4, each lane 4 values of D for all G rows, the groups' sums added
//    in group order by shuffles; past it (DMAX 256) one group, each lane
//    4 values of D in each of D / 128 (rounded up) column blocks 128 apart;
//  - the chunk's state: one barrier, then each output rescales the warps'
//    states to the chunk's max and adds them in warp order.
//
// In-order merge.  A chunk's raw state (acc, then (m, l) pairs) goes to a
// scratch buffer (B, KV, chunks, G * (D + 2)); after a barrier one thread
// fences and bumps the (request, KV head)'s arrival counter (atomicInc, which
// wraps it back to 0 on the last arrival), and the last of the row's live
// chunks to arrive merges all of them in chunk order: M = max_c m_c, acc =
// sum_c acc_c 2^(m_c - M), l = sum_c l_c 2^(m_c - M), CB chunks a batch (each
// batch's loads clamped into range and unconditional: one L2 round trip; past
// CB the sums so far are rescaled to the new max), read through L2 (ld.cg).
// It writes the normalized output (B1) or (acc * v_scale, M ln 2, l)
// (PARTIALS).  No atomic touches the arithmetic, so the result is the same on
// every run whatever order the blocks ran in.  A row whose live positions fit
// in one chunk skips the scratch and the counter: its one chunk is the merge,
// bit for bit (2^0 == 1).  The counters are an int32 buffer of at least B * KV
// entries per device that the wrapper allocates once, zeroed; every launch
// leaves them at 0.  They assume that launches sharing the buffer run one
// after another: on one stream, as the port's wrappers launch.
//
// A dense stream is read with a row pitch (positions between batch rows), so a
// shard's slice k[:, i*S_l:(i+1)*S_l] of a (B, S, KV, D) cache is read where
// it lies; the whole cache passes its own S.  Paging is a template argument:
// the block table moves storage only, the chunks and the arithmetic are the
// dense ones.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SPLIT = 64;             // positions per chunk, one block each
constexpr int NT = 256;               // threads per block
constexpr int NWARP = NT / 32;
constexpr int PPW = SPLIT / NWARP;    // positions per warp
constexpr int QPP = 32 / PPW;         // lanes scoring one position
constexpr int CB = 16;                // chunk states the merge reads at once
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(QPP * PPW == 32, "chunk, block and warp sizes");

// K (and V) words a thread stages, at most, for rows of D <= DMAX int8
// values
__host__ __device__ constexpr int stage_words(int dmax) { return SPLIT * (dmax / 4) / NT; }
static_assert(stage_words(128) % 4 == 0 && stage_words(256) % 4 == 0, "staging pieces");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 2^x (MUFU.EX2, within 2 ulp; 2^-huge == 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the sign bits flipped by `flip` turn a stored value v into v + 128 (int8)
// or v + 8 (int4), the low bits of the float 2^23 + that; subtracting it back
// is exact
template <int BITS>
__device__ __forceinline__ constexpr uint32_t flip() {
  return BITS == 8 ? 0x80808080u : 0x88888888u;
}

// element e of a flipped 32-bit word of K/V storage: byte e (BITS 8) or the
// nibble in bits [4e, 4e + 4) (BITS 4), as a float
template <int BITS>
__device__ __forceinline__ float word_elem(uint32_t wf, int e) {
  if constexpr (BITS == 8) {
    return __int_as_float(static_cast<int>(__byte_perm(wf, 0x4B000000u, 0x7650u | e))) -
           8388736.0f;
  } else {
    return __int_as_float(static_cast<int>(((wf >> (4 * e)) & 0xFu) | 0x4B000000u)) -
           8388616.0f;
  }
}

// floor(i / d) for i >= 0 and i + d < 2^20, from inv = 1 / d rounded: (i +
// 0.5) / d is at least 0.5 / d from an integer, far beyond the rounding
__device__ __forceinline__ int div_by(int i, float inv) {
  return __float2int_rz((static_cast<float>(i) + 0.5f) * inv);
}

// pool row that holds position t of request b in a paged cache: the block
// table's page (clamped into the pool), offset t % P
__device__ __forceinline__ size_t paged_row(const int* table, int b, int t, int NB,
                                            int P, int n_pages) {
  const int page = min(max(table[b * NB + t / P], 0), n_pages - 1);
  return (size_t)page * P + t % P;
}

// staged K/V row stride in words: the least stride >= words that is 4 modulo
// 8, so the QPP lanes of 8 neighbouring positions score from 32 distinct
// banks (and 16-byte pieces stay aligned)
__host__ __device__ constexpr int row_words(int words) { return (words + 3) / 8 * 8 + 4; }

// dynamic shared memory of one block, in bytes (host and device agree)
__host__ __device__ constexpr size_t smem_bytes(int G, int D, int bits) {
  return sizeof(float) * ((size_t)G * D + (size_t)G * SPLIT + 2 * NWARP * G +
                          (size_t)NWARP * G * D) +
         sizeof(uint32_t) * 2 * SPLIT * row_words(D * bits / 32);
}

// GMAX: compile-time bound on the query rows per KV head (G <= GMAX);
// DMAX: compile-time bound on the head dim (128, or 256 with P @ V in column
// blocks); BITS: storage width of K/V (8, or 4 packed); PAGED: K/V are page pools read
// through the block table (else a dense (B, S, KV, D) stream, batch rows
// `pitch` positions apart); PARTIALS: the epilogue writes the raw flash state
// (acc, m_out, l_out) instead of the normalized output.
template <typename T, int GMAX, int DMAX, int BITS, bool PAGED, bool PARTIALS>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                        const int8_t* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ cur_pos,
                        const int* __restrict__ table, float* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ scratch, unsigned* __restrict__ counters,
                        int S, int pitch, int KV, int G, int D, int NB, int P,
                        int n_pages) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int merge_here;
  constexpr int QR = (GMAX * DMAX + NT - 1) / NT;  // q values (and outputs) a thread takes
  constexpr int STAGE = stage_words(DMAX);
  // the partials epilogue at DMAX 256 stages single words straight to
  // shared memory: held in registers, they spill there (ptxas -v, G <= 1,
  // int4, paged); everywhere else they are held, and nothing spills
  constexpr bool NARROW_DIRECT = PARTIALS && DMAX > 128;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int c0 = c * SPLIT;                 // the chunk's first position
  const int n_in = min(S - c0, SPLIT);      // its positions inside the stream
  const size_t bh = (size_t)b * KV + h;
  const int GD = G * D;
  const int words = D * BITS / 32;          // 32-bit words per K/V row
  const int LDW = row_words(words);
  const int UPR = D / 4;                    // 4-value units per row (P @ V)
  const int NG = 32 / UPR;                  // P @ V position groups per warp
  const float invD = __frcp_rn(static_cast<float>(D));

  float* qs = smem;                                        // [G][D] folded q
  float* ps = qs + GD;                                     // [G][SPLIT] probabilities
  float* red = ps + G * SPLIT;                             // [2][NWARP][G] warp max, sum
  float* pacc = red + 2 * NWARP * G;                       // [NWARP][G][D] P @ V
  uint32_t* ks = reinterpret_cast<uint32_t*>(pacc + NWARP * GD);  // [SPLIT][LDW]
  uint32_t* vs = ks + SPLIT * LDW;                                     // [SPLIT][LDW]

  // every global load of the chunk goes out at once: the scalars, q, and
  // the K/V words (paged: after the table, one round trip)
  const int len = min(cur_pos[b], S);
  const float ksc = k_scale[h], vsc = v_scale[h];
  float qv[QR];
  {
    const T* qb = q + bh * GD;
#pragma unroll
    for (int r = 0; r < QR; ++r) qv[r] = tid + r * NT < GD ? to_f32(qb[tid + r * NT]) : 0.f;
  }
  // K/V: 16-byte pieces of 4 words where the rows allow, else single words;
  // piece i = tid + u * NT is piece i % pr of position i / pr (pr a row)
  const uint32_t* k32 = reinterpret_cast<const uint32_t*>(k);
  const uint32_t* v32 = reinterpret_cast<const uint32_t*>(v);
  const bool vec = words % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int pr = vec ? words / 4 : words;
  const float inv_pr = __frcp_rn(static_cast<float>(pr));
  const int n_pieces = n_in * pr;
  auto word_at = [&](int i, int per) {   // first word of piece i (per words)
    const int t = div_by(i, inv_pr);
    const size_t row = PAGED ? paged_row(table, b, c0 + t, NB, P, n_pages)
                             : (size_t)b * pitch + c0 + t;
    return (row * KV + h) * words + (size_t)(i - t * pr) * per;
  };
  uint32_t kw[STAGE], vw[STAGE];
  if (vec) {
#pragma unroll
    for (int u = 0; u < STAGE / 4; ++u) {
      const int i = tid + u * NT;
      if (i < n_pieces) {
        const size_t off = word_at(i, 4);
        const uint4 kx = *reinterpret_cast<const uint4*>(k32 + off);
        const uint4 vx = *reinterpret_cast<const uint4*>(v32 + off);
        kw[4 * u] = kx.x; kw[4 * u + 1] = kx.y; kw[4 * u + 2] = kx.z; kw[4 * u + 3] = kx.w;
        vw[4 * u] = vx.x; vw[4 * u + 1] = vx.y; vw[4 * u + 2] = vx.z; vw[4 * u + 3] = vx.w;
      }
    }
  } else if constexpr (!NARROW_DIRECT) {
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = tid + u * NT;
      if (i < n_pieces) {
        const size_t off = word_at(i, 1);
        kw[u] = k32[off];
        vw[u] = v32[off];
      }
    }
  } else {
    // single words (a row width or base the 16-byte pieces do not fit):
    // straight to shared memory, so that the twice as many words in flight
    // hold no registers beside their addresses
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = tid + u * NT;
      if (i < n_pieces) {
        const size_t off = word_at(i, 1);
        const int t = div_by(i, inv_pr);
        ks[t * LDW + i - t * pr] = k32[off];
        vs[t * LDW + i - t * pr] = v32[off];
      }
    }
  }
  // chunks at or past the row's live range leave; chunk 0 always runs
  const int n_live = max((len + SPLIT - 1) / SPLIT, 1);
  if (c >= n_live) return;
  const int plen = min(max(len - c0, 0), SPLIT);  // live positions of the chunk
  {
    // q * k_scale / sqrt(D), in log2 units (the softmax runs on exp2)
    const float cq = ksc * (1.0f / sqrtf(static_cast<float>(D))) * LOG2E;
#pragma unroll
    for (int r = 0; r < QR; ++r)
      if (tid + r * NT < GD) qs[tid + r * NT] = qv[r] * cq;
    if (vec) {
#pragma unroll
      for (int u = 0; u < STAGE / 4; ++u) {
        const int i = tid + u * NT;
        if (i < n_pieces) {
          const int t = div_by(i, inv_pr);
          const int at = t * LDW + (i - t * pr) * 4;
          *reinterpret_cast<uint4*>(ks + at) =
              make_uint4(kw[4 * u], kw[4 * u + 1], kw[4 * u + 2], kw[4 * u + 3]);
          *reinterpret_cast<uint4*>(vs + at) =
              make_uint4(vw[4 * u], vw[4 * u + 1], vw[4 * u + 2], vw[4 * u + 3]);
        }
      }
    } else if constexpr (!NARROW_DIRECT) {
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int i = tid + u * NT;
        if (i < n_pieces) {
          const int t = div_by(i, inv_pr);
          const int at = t * LDW + i - t * pr;
          ks[at] = kw[u];
          vs[at] = vw[u];
        }
      }
    }
  }
  __syncthreads();

  // per warp, its PPW positions: scores (QPP lanes a position, each a
  // strided share of its words, summed by a butterfly), the warp's max,
  // the probabilities and their sum
  const int p = warp * PPW + lane / QPP, part = lane % QPP;
  const bool valid = p < plen;
  float s[GMAX], mw[GMAX];
  {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    constexpr int EPW = 32 / BITS;
    const uint32_t* kr = ks + p * LDW;
#pragma unroll 2
    for (int wd = part; wd < words; wd += QPP) {
      const uint32_t w = kr[wd] ^ flip<BITS>();
      float kf[EPW];
#pragma unroll
      for (int e = 0; e < EPW; ++e) kf[e] = word_elem<BITS>(w, e);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
#pragma unroll
          for (int j = 0; j < EPW / 4; ++j) {
            const float4 qf = reinterpret_cast<const float4*>(qs + g * D)[wd * (EPW / 4) + j];
            s[g] += qf.x * kf[4 * j] + qf.y * kf[4 * j + 1] + qf.z * kf[4 * j + 2] +
                    qf.w * kf[4 * j + 3];
          }
        }
      }
    }
#pragma unroll
    for (int o = 1; o < QPP; o <<= 1)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) mw[g] = s[g] = valid ? s[g] : NEG_INF;
#pragma unroll
    for (int o = QPP; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) mw[g] = fmaxf(mw[g], __shfl_xor_sync(0xffffffffu, mw[g], o));
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      s[g] = valid ? exp2_approx(s[g] - mw[g]) : 0.f;
      if (part == 0 && g < G) ps[g * SPLIT + p] = s[g];
    }
#pragma unroll
    for (int o = QPP; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
    if (lane < G) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g == lane) {
          red[warp * G + g] = mw[g];
          red[(NWARP + warp) * G + g] = s[g];
        }
      }
    }
  }
  __syncwarp();

  // P @ V over the warp's positions: its lanes form NG position groups of
  // UPR lanes; a lane owns values 4u .. 4u + 3 of D for all G rows and takes
  // the group's positions grp, grp + NG, ...
  if constexpr (DMAX <= 128) {
    const int grp = div_by(lane, 4.0f * invD), u = lane - grp * UPR;
    float a[GMAX][4];
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[g][e] = 0.f;
    if (grp < NG) {
      const int wcol = BITS == 8 ? u : u / 2;
      const int shift = BITS == 8 ? 0 : 16 * (u % 2);
      const int pend = min(plen, (warp + 1) * PPW);
      for (int pp = warp * PPW + grp; pp < pend; pp += NG) {
        const uint32_t w = (vs[pp * LDW + wcol] ^ flip<BITS>()) >> shift;
        float vf[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) vf[e] = word_elem<BITS>(w, e);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            const float pp_g = ps[g * SPLIT + pp];
#pragma unroll
            for (int e = 0; e < 4; ++e) a[g][e] += pp_g * vf[e];
          }
        }
      }
    }
    // the groups' sums meet in group 0, added in group order; each shuffle
    // reads a group's own sum, never one already added to
    float own[GMAX][4];
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) own[g][e] = a[g][e];
    for (int j = 1; j < NG; ++j) {
      const int from = min(lane + j * UPR, 31);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[g][e] += __shfl_sync(0xffffffffu, own[g][e], from);
    }
    if (grp == 0) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G)
          *reinterpret_cast<float4*>(pacc + warp * GD + g * D + 4 * u) =
              make_float4(a[g][0], a[g][1], a[g][2], a[g][3]);
    }
  } else {
    // D > 128: UPR > 32 units, so one group: lane owns units lane + 32 j
    // (j < UPL) for all G rows and takes every position of the warp in order
    constexpr int UPL = DMAX / 128;
    float a[GMAX][UPL][4];
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int j = 0; j < UPL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[g][j][e] = 0.f;
    const int pend = min(plen, (warp + 1) * PPW);
    for (int pp = warp * PPW; pp < pend; ++pp) {
#pragma unroll
      for (int j = 0; j < UPL; ++j) {
        const int u = lane + 32 * j;
        if (u < UPR) {
          const int wcol = BITS == 8 ? u : u / 2;
          const int shift = BITS == 8 ? 0 : 16 * (u % 2);
          const uint32_t w = (vs[pp * LDW + wcol] ^ flip<BITS>()) >> shift;
          float vf[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) vf[e] = word_elem<BITS>(w, e);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
              const float pp_g = ps[g * SPLIT + pp];
#pragma unroll
              for (int e = 0; e < 4; ++e) a[g][j][e] += pp_g * vf[e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < UPL; ++j) {
      const int u = lane + 32 * j;
      if (u < UPR) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G)
            *reinterpret_cast<float4*>(pacc + warp * GD + g * D + 4 * u) =
                make_float4(a[g][j][0], a[g][j][1], a[g][j][2], a[g][j][3]);
      }
    }
  }
  __syncthreads();

  // the chunk's state: the warps' states rescaled to the chunk's max and
  // added in warp order; then
  // the epilogue here (one live chunk), or the scratch and the merge.
  // m is kept in log2 units until it is written out.
  float* ob = out + bh * GD;
  auto emit = [&](int i, int g, float a, float m2, float l) {
    if constexpr (PARTIALS) {
      ob[i] = a * vsc;
      if (i == g * D) {
        m_out[bh * G + g] = m2 <= NEG_INF ? NEG_INF : m2 * LN2;
        l_out[bh * G + g] = l;
      }
    } else {
      ob[i] = a * vsc / fmaxf(l, 1e-30f);
    }
  };
  const int ST = GD + 2 * G;                        // floats of one chunk's state
  float* sb = scratch + bh * gridDim.z * ST;        // this row's chunk states
#pragma unroll
  for (int r = 0; r < QR; ++r) {
    const int i = tid + r * NT;
    if (i < GD) {
      const int g = div_by(i, invD);
      float mw[NWARP], lw[NWARP], aw[NWARP];
#pragma unroll
      for (int w = 0; w < NWARP; ++w) {
        mw[w] = red[w * G + g];
        lw[w] = red[(NWARP + w) * G + g];
        aw[w] = pacc[w * GD + i];
      }
      float m = mw[0];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) m = fmaxf(m, mw[w]);
      float a = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) {
        const float e = exp2_approx(mw[w] - m);
        a += aw[w] * e;
        l += lw[w] * e;
      }
      if (n_live == 1) {
        emit(i, g, a, m, l);
      } else {
        float* st = sb + c * ST;
        st[i] = a;
        if (i == g * D) *reinterpret_cast<float2*>(st + GD + 2 * g) = make_float2(m, l);
      }
    }
  }
  if (n_live == 1) return;
  // the last live chunk to arrive merges (release: the barrier, then one
  // thread's fence before its atomic, as a grid barrier does)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    merge_here = atomicInc(counters + bh, n_live - 1) == n_live - 1;
    if (merge_here) __threadfence();
  }
  __syncthreads();
  if (!merge_here) return;
  // the merge: CB chunks' states are read at once (indices clamped, so every
  // load is unconditional: one L2 round trip); each output adds its chunks in
  // chunk order, weighted by 2^(m_c - M); past CB chunks the sums so far are
  // rescaled to the new max
#pragma unroll
  for (int r = 0; r < QR; ++r) {
    const int i = tid + r * NT;
    if (i < GD) {
      const int g = div_by(i, invD);
      float a = 0.f, l = 0.f, mc = NEG_INF;
      for (int c1 = 0; c1 < n_live; c1 += CB) {
        float av[CB], mv[CB], lv[CB];
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          const float* st = sb + min(c1 + j, n_live - 1) * ST;
          av[j] = __ldcg(st + i);
          const float2 ml = __ldcg(reinterpret_cast<const float2*>(st + GD + 2 * g));
          mv[j] = ml.x;
          lv[j] = ml.y;
        }
        float mb = mc;
#pragma unroll
        for (int j = 0; j < CB; ++j) mb = fmaxf(mb, mv[j]);
        const float rs = exp2_approx(mc - mb);  // 0 before the first batch (a = l = 0)
        a *= rs;
        l *= rs;
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          const float e = c1 + j < n_live ? exp2_approx(mv[j] - mb) : 0.f;
          a += av[j] * e;
          l += lv[j] * e;
        }
        mc = mb;
      }
      emit(i, g, a, mc, l);
    }
  }
}

// the paged layout's block table (nullptr: a dense stream) and its shape
struct Paging {
  const int* table;
  int NB, P, n_pages;
};

// where the results go: the (B, KV, G, D) output, and for the partials
// epilogue the (B, KV, G) running max and normalizer (nullptr: normalize);
// pitch: positions between the batch rows of a dense stream; scratch: the
// chunk states, (B, KV, ceil(S / SPLIT), G * (D + 2)) floats; counters: B *
// KV zeroed arrival counters
struct Outputs {
  float* out;
  float* m;
  float* l;
  int pitch;
  float* scratch;
  unsigned* counters;
};

template <typename T, int GMAX, int DMAX, int BITS, bool PAGED, bool PARTIALS>
int launch_variant(const void* q, const void* k, const void* v, const void* k_scale,
                   const void* v_scale, const void* cur_pos, int B, int S, int KV,
                   int G, int D, Paging pg, Outputs o, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, D, BITS);
  auto kern = decode_attention_kernel<T, GMAX, DMAX, BITS, PAGED, PARTIALS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(KV, B, (S + SPLIT - 1) / SPLIT), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(cur_pos), pg.table,
      o.out, o.m, o.l, o.scratch, o.counters, S, o.pitch, KV, G, D, pg.NB, pg.P,
      pg.n_pages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int GMAX, int DMAX, int BITS, bool PARTIALS>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* cur_pos, int B, int S, int KV, int G, int D,
           Paging pg, Outputs o, cudaStream_t st) {
  if (pg.table != nullptr)
    return launch_variant<T, GMAX, DMAX, BITS, true, PARTIALS>(q, k, v, ks, vs, cur_pos, B,
                                                               S, KV, G, D, pg, o, st);
  return launch_variant<T, GMAX, DMAX, BITS, false, PARTIALS>(q, k, v, ks, vs, cur_pos, B,
                                                              S, KV, G, D, pg, o, st);
}

template <typename T, int DMAX, int BITS, bool PARTIALS>
int dispatch_g(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* cur_pos, int B, int S, int KV, int G, int D,
               Paging pg, Outputs o, cudaStream_t st) {
  if (G <= 1)
    return launch<T, 1, DMAX, BITS, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S, KV, G, D, pg,
                                              o, st);
  if (G <= 2)
    return launch<T, 2, DMAX, BITS, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S, KV, G, D, pg,
                                              o, st);
  if (G <= 4)
    return launch<T, 4, DMAX, BITS, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S, KV, G, D, pg,
                                              o, st);
  if (G <= 8)
    return launch<T, 8, DMAX, BITS, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S, KV, G, D, pg,
                                              o, st);
  return launch<T, 16, DMAX, BITS, PARTIALS>(q, k, v, ks, vs, cur_pos, B, S, KV, G, D, pg,
                                             o, st);
}


// q: (B, KV, G, D) f32 (q_bf16 == 0) or bf16; k/v: (B, S, KV, D) int8 (bits
// == 8) or (B, S, KV, D/2) packed int4 (bits == 4) with batch rows o.pitch
// positions apart (pitch >= S; rows of KV * D or D/2 contiguous bytes) when
// the table is null, else pools (n_pages, P, KV, D or D/2) read through the
// (B, NB) int32 block table, with S == NB * P; k_scale/v_scale: (KV,) f32;
// cur_pos: (B,) int32 valid positions; o.out: (B, KV, G, D) f32, normalized,
// or (PARTIALS) the unnormalized accumulator with o.m / o.l: (B, KV, G) f32;
// o.scratch and o.counters as in Outputs; split: the caller's SPLIT, checked.
// Requires G <= 16, D % 8 == 0 and D <= DMAX: 128 in the libraries built by
// decode_attention.cu and decode_attention_partials.cu, and 128 < D <= 256
// in their _wide twins (one library a head-dim class, so that the four
// compile in parallel).
template <bool PARTIALS, int DMAX>
int run_decode_attention(const void* q, int q_bf16, const void* k, const void* v,
                         const void* k_scale, const void* v_scale, const void* cur_pos,
                         int B, int S, int KV, int G, int D, int bits, int split,
                         Paging pg, Outputs o, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (PARTIALS && (o.m == nullptr || o.l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (split != SPLIT || o.scratch == nullptr || o.counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pg.table == nullptr && o.pitch < S) return static_cast<int>(cudaErrorInvalidValue);
  if (bits != 8 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (G < 1 || G > 16 || D % 8 || D > DMAX || (DMAX > 128 && D <= 128) || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_bf16) {
    if (bits == 8)
      return dispatch_g<__nv_bfloat16, DMAX, 8, PARTIALS>(q, k, v, k_scale, v_scale,
                                                          cur_pos, B, S, KV, G, D, pg, o, st);
    return dispatch_g<__nv_bfloat16, DMAX, 4, PARTIALS>(q, k, v, k_scale, v_scale, cur_pos,
                                                        B, S, KV, G, D, pg, o, st);
  }
  if (bits == 8)
    return dispatch_g<float, DMAX, 8, PARTIALS>(q, k, v, k_scale, v_scale, cur_pos, B, S,
                                                KV, G, D, pg, o, st);
  return dispatch_g<float, DMAX, 4, PARTIALS>(q, k, v, k_scale, v_scale, cur_pos, B, S, KV,
                                              G, D, pg, o, st);
}

}  // namespace
