// Flash-prefill attention over a quantized, bf16 or float32 K/V stream, for Hopper
// (sm_90a).
//
//   out[b, i, h, g] = v_scale[h] * softmax_{k visible to i}((q[b, i, h, g] * k_scale[h]
//                     / sqrt(D)) . K[b, k, h]) @ V[b, :, h]
//   visible: k < kv_len[b], k <= q_start[b] + i (causal), q_start[b] + i - k < window;
//   a row with no visible key is zeros.
// K/V hold int8 values (bits == 8), int4 values packed two per byte along D
// (bits == 4: element 2i in the low nibble of byte i, D/2 bytes a row) or bf16
// values (bits == 16: 2 D bytes a row) or float32 values (bits == 32: 4 D bytes a
// row; bits 16 and 32 are a float cache, served with k_scale == v_scale == 1).
// They are a dense (B, Sk, KV, D) stream (table == nullptr), or
// a paged pool (pages, P, KV, D) with a (B, NB) block table: key position t of
// request b is pool row table[b * NB + t / P] * P + t % P.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py::prefill_attention_tiles
// (body `_kernel`: both kv_bits branches and the float K/V stream with unit
// scales; its dense entry prefill_attention_int8 is the null table here,
// chunked prefill into a paged cache the real table).
//
// What bounds it on an H100: bytes, at the serving shapes.  At B 4, S 512,
// KV 3, G 3, D 64 the call must move 7.86 MB (bf16 q 2.36, int8 K/V 0.79, the
// float32 output 4.72: 60% of it), 2.35 us at 3.35 TB/s, while its 1.21
// GFLOP take 1.22 us on the bf16 tensor cores.  In practice it is bound by
// latency: few blocks, and a chain of dependent phases in each.  A bf16 K/V
// stream doubles the K/V bytes (1.57 MB at that shape).
//
// Design.  One block per (query tile, KV head, request).  As in the TPU
// kernel the G query heads of a KV head are flattened into rows (row r sits
// at position q_lo + r / G); a block holds 64 rows in 4 row groups of 16, one
// warp each, and splits every step of keys between parts(D) warps per row
// group (4 at D <= 64: 16 warps; 2 at D <= 128; 1 at D <= 256, where a
// lane's accumulator holds up to 128 floats, as many as the registers allow,
// and two steps of 128 keys would not fit in shared memory), each taking 64
// keys and keeping its own online-softmax state; the parts merge through
// shared memory at the end.  Both products run on the tensor cores as
// mma.sync.m16n8k16 with float32 sums, at the float32 reference's accuracy:
//  - Q @ K^T in bf16.  int8 (|v| <= 127) and int4 values are exact in bf16,
//    and so is a bf16 q, which goes in unscaled; each score is multiplied by
//    k_scale[h] / sqrt(D) (and log2 e, for exp2) after its MMA.  A float32 q
//    is split into hi = bf16(q) and lo = bf16(q - hi), two MMAs.  q is staged
//    once in shared memory and read by ldmatrix.
//  - P @ V in fp16.  V is exact in fp16; the probabilities stay in registers
//    (the m16n8 C fragments of two neighbouring key tiles are the m16n8k16 A
//    fragment) and are split into hi = fp16(p) and lo = fp16(p - hi), two
//    MMAs: one 16-bit P would put 2^-12 (fp16) or 2^-9 (bf16) relative error
//    into every weight, above the tolerance.
//  - A bf16 K/V stream: K is exact in bf16 as before.  A bf16 V can lie
//    outside fp16's range, so P @ V runs in bf16, and P is split into three
//    bf16 pieces, hi + mid + lo, three MMAs: two bf16 pieces leave 2^-18 of
//    each weight, an error of up to 2^-18 max|V| that the data, not the
//    kernel, would hold under the tolerance; three leave 2^-27, below
//    float32's own rounding.  The pieces go one a pass over the key step
//    (the scores keep what is left), so one piece is live at a time: the
//    D <= 64 variants stay within their 128 registers.
//  - A float32 K/V stream (bits == 32, D <= 128) is not exact in bf16 or fp16, so
//    both products run as 3xTF32 (the split CUTLASS uses for float32 GEMMs):
//    mma.sync.m16n8k8 with tf32 operands, each float32 operand x split into
//    big = tf32(x) and small = tf32(x - big) (round to nearest, x - big exact),
//    and a.b as big.big + big.small + small.big.  Each operand's split leaves
//    |x - big - small| <= 2^-22 |x|, the dropped small.small term is below
//    2^-22 |a.b|, so each product term carries at most ~3 x 2^-22 of its size
//    (every sum accumulates in float32): 7e-7 relative, against the plain
//    float32 version's 2^-24 rounding.  The scores' error is at most 7e-7 x
//    sum |q k| / sqrt(D) (log units), P @ V's at most 7e-7 x sum p |v|, both
//    well inside the tolerance 1e-5 x (1 + max |out|).  Rows are float32 in
//    shared memory, copied by cp.async as they are (K rows LDK = 8 mod 32
//    floats apart, V rows LDV = 4 mod 16: conflict-free fragment loads), q is
//    staged once as big and small words; each lane splits its K and V words as
//    it loads them.  The contraction order within an MMA is free, so the k8
//    step's logical column j is D column 2j (j < 4) or 2(j - 4) + 1: a lane's
//    q and K words are float2 neighbours, and P's C fragment (keys 2t, 2t + 1)
//    is the tf32 A fragment as it stands, with V's rows 2t and 2t + 1.  The
//    float32 tiles take twice the bf16 stream's shared memory, so a row group's
//    keys are split over half as many warps (2 at D <= 64, 1 at D <= 128); the
//    wide library (D > 128) has no float32 branch: its tiles would not fit.
//  - The online softmax runs in registers: a lane holds 2 rows x 16 keys of
//    its 64; a row's max and sum meet across the 4 lanes of a quad.  Masked
//    keys get -inf, so p = 0 and they take no part in the max (a 64-key
//    block every row of the warp sees skips the mask); a row with no visible
//    key keeps m = -1e30, l = 0 and ends as zeros.
//  - Staging: the raw int8 (or packed int4) bytes of step t + 1 are copied by
//    cp.async (zero-filled past the live range) while step t computes; once
//    they land, each thread widens its share to a bf16 K tile and an fp16 V
//    tile (float or fp16 bit tricks, no I2F) in the second of two tile
//    buffers, right after issuing step t's P @ V MMAs.  A bf16 row needs no
//    widening: cp.async copies it straight into the second tile buffer, so
//    the raw buffers and the widening step drop out.  Tile rows are padded
//    by 16 bytes, so ldmatrix reads K (plain) and V (.trans) without bank
//    conflicts.  D that is not a multiple of 16 is zero-padded in K and q
//    (in a bf16 stream the padding columns are zeroed once: no copy writes
//    them).  The one variant whose tiles do not fit shared memory with that
//    padding (a float32 q over int8 K/V at D > 240) drops it: its ldmatrix
//    reads meet bank conflicts, the arithmetic is the same.
//  - Registers at D > 128: q and each widening step are staged in rounds,
//    so that the staging registers never sit beside the 128-float
//    accumulator.
//  - The key walk runs only from the window's first live tile to
//    min(kv_len, causal frontier): the TPU body's `live` skip.  A warp whose
//    16 rows see none of its 64 keys skips them, an exact no-op.  Query tiles
//    run longest first.
//  - Paged (a template argument): each step maps its key positions through
//    the table once, into shared memory, and the copy reads each key's row
//    from its pool row; the walk and the arithmetic are the dense ones, so a
//    paged pool and its gathered dense copy give bit-identical outputs.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// REPRO_WIDE: this library's head dims: 0 (the default) D <= 128, 1 (the
// build's _wide library, this file compiled again) 128 < D <= 256
#ifndef REPRO_WIDE
#define REPRO_WIDE 0
#endif

namespace {

constexpr int ROW_WARPS = 4;           // row groups of 16 rows
constexpr int ROWS = 16 * ROW_WARPS;   // flattened (position, group) rows per block
constexpr int HALF = 64;               // keys a warp takes of each step
constexpr int NKT = HALF / 8;          // n8 key tiles of a warp's scores
// warps a row group's keys are split over: 4 at D <= 64 (16 warps and 128
// registers a thread), 2 at D <= 128 (whose accumulator needs more), 1 past
// it (a lane's accumulator is up to 128 floats, and one step of 64 keys
// fills shared memory); half of that over a float32 stream (bits == 32),
// whose tiles take twice the shared memory
__host__ __device__ constexpr int parts(int dch, int bits) {
  return (dch == 1 ? 4 : dch == 2 ? 2 : 1) / (bits == 32 ? 2 : 1);
}

// float32 row strides (floats) of the bits == 32 tiles: K (and q) rows 8 mod
// 32 floats apart, V rows 4 mod 16 apart, each at least D; both multiples of
// 4 (16-byte cp.async rows)
__host__ __device__ constexpr int ld_k32(int d) { return (d + 23) / 32 * 32 + 8; }
__host__ __device__ constexpr int ld_v32(int d) { return (d + 11) / 16 * 16 + 4; }

// 16-bit tile row stride for D16 = D rounded up to 16: 16 bytes of padding
// (conflict-free ldmatrix), but none for a float32 q over int8 K/V at D16 >
// 240, whose tiles do not fit shared memory with it
__host__ __device__ constexpr int tile_ld(int d16, bool qf32, int bits) {
  return d16 + (qf32 && bits == 8 && d16 > 240 ? 0 : 8);
}
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi = bf16(x0, x1); lo = bf16 of what hi leaves out
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  const __nv_bfloat162 hh = __halves2bfloat162(h0, h1);
  hi = *reinterpret_cast<const uint32_t*>(&hh);
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

__device__ __forceinline__ __half2 u32_as_half2(uint32_t x) {
  return *reinterpret_cast<const __half2*>(&x);
}
__device__ __forceinline__ uint32_t half2_as_u32(__half2 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// the bf16 pair (a, b) of two floats that bf16 holds exactly: their upper halves
__device__ __forceinline__ uint32_t upper_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// 4 int8 values (a 32-bit word) -> 4 bf16: each value + 128 as the low
// byte of the float 2^23 + (v + 128), which is exact
__device__ __forceinline__ uint2 widen_int8(uint32_t w) {
  w ^= 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __int_as_float(static_cast<int>(__byte_perm(w, 0x4B000000u, 0x7650u | i))) -
           8388736.0f;
  return make_uint2(upper_halves(f[0], f[1]), upper_halves(f[2], f[3]));
}

// 8 packed int4 values (element e in bits [4e, 4e + 4)) -> 8 bf16, the same
// way: the float 2^23 + (v + 8)
__device__ __forceinline__ uint4 widen_int4(uint32_t w) {
  w ^= 0x88888888u;
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = __int_as_float(static_cast<int>(((w >> (4 * e)) & 0xFu) | 0x4B000000u)) -
           8388616.0f;
  return make_uint4(upper_halves(f[0], f[1]), upper_halves(f[2], f[3]),
                    upper_halves(f[4], f[5]), upper_halves(f[6], f[7]));
}

// 4 int8 values -> 4 fp16: each value + 128 as the low byte of the fp16
// 1024 + (v + 128), minus 1152 (exact)
__device__ __forceinline__ uint2 widen_int8_f16(uint32_t w) {
  w ^= 0x80808080u;
  const __half2 bias = __float2half2_rn(1152.0f);
  __half2 a = u32_as_half2(__byte_perm(w, 0x64646464u, 0x5140u));
  __half2 b = u32_as_half2(__byte_perm(w, 0x64646464u, 0x5342u));
  return make_uint2(half2_as_u32(__hsub2(a, bias)), half2_as_u32(__hsub2(b, bias)));
}

// 8 packed int4 values -> 8 fp16: nibbles e and e + 4 (16 bits apart) into
// the fp16 pair (1024 + v + 8), minus 1032, then the pairs regrouped in order
__device__ __forceinline__ uint4 widen_int4_f16(uint32_t w) {
  w ^= 0x88888888u;
  const __half2 bias = __float2half2_rn(1032.0f);
  uint32_t p[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    p[e] = half2_as_u32(
        __hsub2(u32_as_half2(((w >> (4 * e)) & 0x000F000Fu) | 0x64006400u), bias));
  return make_uint4(__byte_perm(p[0], p[1], 0x5410u), __byte_perm(p[2], p[3], 0x5410u),
                    __byte_perm(p[0], p[1], 0x7632u), __byte_perm(p[2], p[3], 0x7632u));
}

// hi = fp16(x0, x1); lo = fp16 of what hi leaves out
__device__ __forceinline__ void split_f16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 back = __half22float2(h);
  hi = half2_as_u32(h);
  lo = half2_as_u32(__floats2half2_rn(x0 - back.x, x1 - back.y));
}

// 2^x (ex2.approx: relative error ~2^-22; -inf -> 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a @ b: m16n8k16, bf16 operands (F16: fp16), float32 accumulate
template <bool F16 = false>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (F16)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a @ b: m16n8k8, tf32 operands, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// big = tf32(x), small = tf32(x - big), both rounded to nearest (x - big is exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// a += p.q, three tf32 products (big.big + big.small + small.big), the small
// ones first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0,
                                           uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// cw bytes (4, 8 or 16) global -> shared; n == 0 zero-fills without reading
__device__ __forceinline__ void cp_async(void* dst, const void* src, int cw, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (cw == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(n)
                 : "memory");
  else if (cw == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(n)
                 : "memory");
}

__device__ __forceinline__ bool visible(int kp, int qp, int klen, int causal,
                                        int window) {
  bool ok = kp < klen;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (qp - kp) < window;
  return ok;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// DCH: 64-wide chunks of the head dim held in registers (D <= 64 * DCH);
// BITS: storage of K/V (8 int8, 4 packed int4, 16 bf16, 32 float32); PAGED: K/V are page
// pools read through the block table (else a dense (B, Sk, KV, D) stream).
// k and v are addressed in bytes.
template <typename T, int DCH, int BITS, bool PAGED>
__global__ void __launch_bounds__(32 * ROW_WARPS * parts(DCH, BITS), 1)
prefill_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ q_start,
                         const int* __restrict__ kv_len,
                         const int* __restrict__ table, float* __restrict__ out,
                         int Sq, int Sk, int KV, int G, int D, int BQ,
                         int causal, int window, int NB, int P, int n_pages,
                         int cw) {
  constexpr bool QF32 = std::is_same<T, float>::value;
  constexpr bool DIRECT = BITS >= 16;  // bf16 and float32 rows go straight into the tiles
  constexpr bool F32KV = BITS == 32;   // float32 K/V: 3xTF32 products
  constexpr int PARTS = parts(DCH, BITS);
  constexpr int NT = 32 * ROW_WARPS * PARTS;  // threads
  constexpr int BK = HALF * PARTS;            // keys staged per step
  constexpr int KSM = 4 * DCH;  // 16-wide k-steps of the score MMA, at most
  constexpr int NDM = 8 * DCH;  // n8 column tiles of the output, at most
  constexpr int NV = 4 * NDM + 4;  // floats a lane hands over in the merge
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = warp % ROW_WARPS;   // row group: rows 16 wr .. 16 wr + 15
  const int kh = warp / ROW_WARPS;   // key part: keys 64 kh .. of each step
  const int g = lane >> 2, tig = lane & 3;  // quad (row) and lane in the quad
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest key walks start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = BQ * G;
  const int D16 = (D + 15) & ~15;  // D zero-padded to the MMA's k-step
  const int KS = D16 / 16;
  const int ND = D / 8;
  const int LDT = tile_ld(D16, QF32, BITS);  // 16-bit tile row stride
  const int DP = D * BITS / 8;     // storage bytes per K/V row (D % 8 == 0)

  uint16_t* ks = reinterpret_cast<uint16_t*>(smem);  // [2][BK][LDT] K, bf16
  uint16_t* vs = ks + 2 * BK * LDT;                  // [2][BK][LDT] V, fp16 (DIRECT: bf16)
  uint16_t* qs = vs + 2 * BK * LDT;  // [ROWS][LDT] q, bf16 (hi), then [ROWS][LDT] lo
  int8_t* kraw = reinterpret_cast<int8_t*>(qs + (QF32 ? 2 : 1) * ROWS * LDT);  // [BK][DP]
  int8_t* vraw = kraw + (DIRECT ? 0 : BK * DP);                 // [BK][DP] raw V
  // F32KV: [2][BK][LDK] K, [2][BK][LDV] V, then q as [ROWS][LDK] big and
  // [ROWS][LDK] small tf32 words, in place of all the above
  const int LDK = ld_k32(D), LDV = ld_v32(D);
  float* kf = reinterpret_cast<float*>(smem);
  float* vf = kf + 2 * BK * LDK;
  uint32_t* qf32 = reinterpret_cast<uint32_t*>(vf + 2 * BK * LDV);
  size_t* koff = reinterpret_cast<size_t*>(  // [BK] (PAGED)
      F32KV ? reinterpret_cast<int8_t*>(qf32 + 2 * ROWS * LDK) : vraw + (DIRECT ? 0 : BK * DP));

  const int i0 = qt * BQ;                  // first query index of the tile
  const int n_pos = min(BQ, Sq - i0);      // real query positions in the tile
  const int q_lo = q_start[b] + i0;        // absolute position of row 0
  const int q_hi = q_lo + n_pos - 1;
  const int klen = min(kv_len[b], Sk);

  int k_end = klen;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - (window - 1));
  const int k_first = (k_begin / HALF) * HALF;

  // keys of the step at k0 that are staged: whole parts up to k_end (a part
  // is read whole; its keys past k_end are masked, and zeros)
  auto staged = [&](int k0) { return min(BK, k_end - k0 + HALF - 1) / HALF * HALF; };
  // this step's pool rows, as byte offsets of (row, h)
  auto map_rows = [&](int k0) {
    if (tid < BK && k0 + tid < k_end) {
      const int t = k0 + tid;
      const int page = min(max(table[b * NB + t / P], 0), n_pages - 1);
      koff[tid] = (((size_t)page * P + t % P) * KV + h) * DP;
    }
  };
  // cp.async of the K and V bytes of the step at k0, cw bytes a copy
  // (zero-filled past k_end): into the raw buffers, or (DIRECT) into the
  // rows of tile buffer `buf`
  const int chunks = DP / cw;
  auto issue = [&](int k0, int buf) {
    const int n = staged(k0) * chunks;
    for (int i = tid; i < n; i += NT) {
      const int t = i / chunks, x = i - t * chunks;
      const bool ok = k0 + t < k_end;
      size_t off = (size_t)x * cw;
      if (ok) off += PAGED ? koff[t] : (((size_t)b * Sk + k0 + t) * KV + h) * DP;
      if constexpr (F32KV) {
        cp_async(reinterpret_cast<int8_t*>(kf + (buf * BK + t) * LDK) + x * cw, k + off, cw,
                 ok ? cw : 0);
        cp_async(reinterpret_cast<int8_t*>(vf + (buf * BK + t) * LDV) + x * cw, v + off, cw,
                 ok ? cw : 0);
        continue;
      }
      const int at = DIRECT ? 2 * (buf * BK + t) * LDT + x * cw : t * DP + x * cw;
      int8_t* kdst = DIRECT ? reinterpret_cast<int8_t*>(ks) : kraw;
      int8_t* vdst = DIRECT ? reinterpret_cast<int8_t*>(vs) : vraw;
      cp_async(kdst + at, k + off, cw, ok ? cw : 0);
      cp_async(vdst + at, v + off, cw, ok ? cw : 0);
    }
    cp_async_commit();
  };

  // q, unscaled, to registers first (its loads depend on nothing before
  // them), then to shared memory as bf16 pairs (a float32 q as hi and lo
  // parts; F32KV: big and small tf32 words) once the first K/V copy is
  // issued; zeros past D and the real rows.  In rounds of QUB pairs a thread
  // (one round up to D = 128).
  constexpr int QU = ROWS * 32 * DCH / NT;  // pairs a thread stages, at most
  constexpr int QUB = DCH <= 2 ? QU : 16;   // ... a round
  const int pairs = F32KV ? D / 2 : D16 / 2;
#pragma unroll 1
  for (int u0 = 0; u0 < QU; u0 += QUB) {
    uint32_t qv[QUB];
    float qf[QF32 || F32KV ? QUB : 1][2];
    int qat[QUB];  // the pair's offset in qs (F32KV: qf32), or -1
#pragma unroll
    for (int u = 0; u < QUB; ++u) {
      const int i = tid + (u0 + u) * NT;
      const int r = i / pairs, c = 2 * (i - r * pairs);
      const int qi = i0 + r / G;
      const bool ok = r < rows && c < D && qi < Sq;
      qat[u] = u0 + u < QU && r < ROWS ? r * (F32KV ? LDK : LDT) + c : -1;
      const T* p = q + ((((size_t)b * Sq + qi) * KV + h) * G + r % G) * D + c;
      if constexpr (QF32) {
        qf[u][0] = ok ? p[0] : 0.f;
        qf[u][1] = ok ? p[1] : 0.f;
      } else {
        qv[u] = ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
        if constexpr (F32KV) {
          qf[u][0] = __uint_as_float(qv[u] << 16);
          qf[u][1] = __uint_as_float(qv[u] & 0xffff0000u);
        }
      }
    }
    if (u0 == 0) {
      // the first step's copy is in flight while q is staged
      if (k_first < k_end) {
        if constexpr (PAGED) {
          map_rows(k_first);
          __syncthreads();
        }
        issue(k_first, 0);
      }
      if constexpr (BITS == 16) {
        // no copy writes the padding columns D..D16 of a bf16 tile: zero
        // them once, in both buffers
        if (D16 != D) {
          for (int r = tid; r < 2 * BK; r += NT) {
            *reinterpret_cast<uint4*>(ks + r * LDT + D) = make_uint4(0u, 0u, 0u, 0u);
            *reinterpret_cast<uint4*>(vs + r * LDT + D) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
    }
    // q to shared memory
#pragma unroll
    for (int u = 0; u < QUB; ++u) {
      if (qat[u] < 0) continue;
      if constexpr (F32KV) {
        uint32_t b0, s0, b1, s1;
        split_tf32(qf[u][0], b0, s0);
        split_tf32(qf[u][1], b1, s1);
        *reinterpret_cast<uint2*>(qf32 + qat[u]) = make_uint2(b0, b1);
        *reinterpret_cast<uint2*>(qf32 + ROWS * LDK + qat[u]) = make_uint2(s0, s1);
        continue;
      }
      if constexpr (QF32) {
        uint32_t lo;
        split_bf16(qf[u][0], qf[u][1], qv[u], lo);
        *reinterpret_cast<uint32_t*>(qs + ROWS * LDT + qat[u]) = lo;
      }
      *reinterpret_cast<uint32_t*>(qs + qat[u]) = qv[u];
    }
  }

  // scores in log2 units: exp(x) == exp2(x * log2(e))
  const float c2 = k_scale[h] * (1.0f / sqrtf(static_cast<float>(D))) * 1.4426950408889634f;
  // this lane's rows r0 = 16 wr + g and r0 + 8 and their positions, and the
  // positions of the warp's rows
  const int r0 = wr * 16 + g;
  const int qp[2] = {q_lo + r0 / G, q_lo + (r0 + 8) / G};
  const int w_lo = q_lo + (wr * 16) / G;
  const int w_hi = q_lo + min(wr * 16 + 15, rows - 1) / G;

  float acc[NDM][4];
#pragma unroll
  for (int n = 0; n < NDM; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // widen the raw step at k0 into a bf16 K tile and an fp16 V tile, one
  // 32-bit word (4 int8 or 8 int4 values) at a time, each thread's shared
  // loads of a round (all of them up to D = 128) in flight together;
  // columns D..D16 are zeros
  auto widen = [&](int k0, uint16_t* kdst, uint16_t* vdst) {
    constexpr int EPW = 32 / BITS;                 // values per word
    constexpr int CU = BK * 2 * DCH * BITS / NT;   // words a thread widens, at most
    constexpr int CUB = DCH <= 2 ? CU : 8;         // ... a round
    const int words = DP / 4;
    const int n = staged(k0);
    int t = tid / words, w = tid % words;
    const int dt = NT / words, dw = NT % words;
#pragma unroll 1
    for (int u0 = 0; u0 < CU; u0 += CUB) {
      uint32_t kw[CUB], vw[CUB];
      int at[CUB];  // the word's first column in the tiles, or -1
#pragma unroll
      for (int u = 0; u < CUB; ++u) {
        const bool here = u0 + u < CU && t < n;
        at[u] = here ? t * LDT + EPW * w : -1;
        if (here) {
          kw[u] = *reinterpret_cast<const uint32_t*>(kraw + t * DP + 4 * w);
          vw[u] = *reinterpret_cast<const uint32_t*>(vraw + t * DP + 4 * w);
        }
        t += dt;
        w += dw;
        if (w >= words) {
          w -= words;
          t += 1;
        }
      }
#pragma unroll
      for (int u = 0; u < CUB; ++u) {
        if (at[u] < 0) continue;
        if constexpr (BITS == 8) {
          *reinterpret_cast<uint2*>(kdst + at[u]) = widen_int8(kw[u]);
          *reinterpret_cast<uint2*>(vdst + at[u]) = widen_int8_f16(vw[u]);
        } else if constexpr (BITS == 4) {
          *reinterpret_cast<uint4*>(kdst + at[u]) = widen_int4(kw[u]);
          *reinterpret_cast<uint4*>(vdst + at[u]) = widen_int4_f16(vw[u]);
        }
      }
    }
    if (D16 != D) {
      for (int r = tid; r < n; r += NT) {
        *reinterpret_cast<uint4*>(kdst + r * LDT + D) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vdst + r * LDT + D) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  // prologue: the first step's tiles, the second step's copy in flight
  if (k_first < k_end) {
    cp_async_wait_all();
    __syncthreads();
    if constexpr (!DIRECT) widen(k_first, ks, vs);
    if constexpr (PAGED) {
      if (k_first + BK < k_end) map_rows(k_first + BK);
    }
    __syncthreads();
    if (k_first + BK < k_end) issue(k_first + BK, 1);
  }

  // step at k0: its tiles are in buffer `buf`, the next step's raw
  // bytes (DIRECT: its tiles, in the other buffer) in flight.  Scores and
  // softmax; then, once the copy has landed, this step's P @ V MMAs go out
  // and the next step is widened into the other buffer while they run.
  for (int k0 = k_first, buf = 0; k0 < k_end; k0 += BK, buf ^= 1) {
    const int k_next = k0 + BK;
    // this warp's 64 keys; a warp whose rows see none of them skips them
    // (an exact no-op)
    const int ka = k0 + HALF * kh;
    const bool live = !(ka >= k_end || (causal && ka > w_hi) ||
                        (window > 0 && ka + HALF - 1 < w_lo - (window - 1)));
    const uint16_t* kt = ks + (buf * BK + HALF * kh) * LDT;
    const uint16_t* vt = vs + (buf * BK + HALF * kh) * LDT;
    float s[NKT][4];
    if (live) {
      // scores: 16 rows x 64 keys, C fragment of key tile n: s[n][0..1] row r0,
      // keys ka + 8 n + 2 tig + {0, 1}; s[n][2..3] row r0 + 8
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
      if constexpr (F32KV) {
        // k8 step st: lane (g, tig) holds q rows g, g + 8 and key g of each
        // key tile at D columns 8 st + 2 tig, + 1 (the A / B columns tig and
        // tig + 4)
        const uint32_t* qrow = qf32 + (wr * 16 + g) * LDK + 2 * tig;
        const float* krow = kf + (buf * BK + HALF * kh + g) * LDK + 2 * tig;
#pragma unroll
        for (int st = 0; st < NDM; ++st) {
          if (st < ND) {
            const uint2 b0 = *reinterpret_cast<const uint2*>(qrow + 8 * st);
            const uint2 b1 = *reinterpret_cast<const uint2*>(qrow + 8 * LDK + 8 * st);
            const uint2 s0 = *reinterpret_cast<const uint2*>(qrow + ROWS * LDK + 8 * st);
            const uint2 s1 =
                *reinterpret_cast<const uint2*>(qrow + (ROWS + 8) * LDK + 8 * st);
            const uint32_t qbig[4] = {b0.x, b1.x, b0.y, b1.y};
            const uint32_t qsmall[4] = {s0.x, s1.x, s0.y, s1.y};
#pragma unroll
            for (int n = 0; n < NKT; ++n) {
              const float2 kw = *reinterpret_cast<const float2*>(krow + 8 * n * LDK + 8 * st);
              uint32_t kb0, ks0, kb1, ks1;
              split_tf32(kw.x, kb0, ks0);
              split_tf32(kw.y, kb1, ks1);
              mma_3xtf32(s[n], qbig, qsmall, kb0, kb1, ks0, ks1);
            }
          }
        }
      }
#pragma unroll
      for (int st = 0; st < KSM; ++st) {
        if (!F32KV && st < KS) {
          // q's A fragment: rows 16 wr + (lane & 15), columns 16 st + 8 (lane >> 4)
          uint32_t qa[4];
          const uint16_t* qrow = qs + (wr * 16 + (lane & 15)) * LDT + 16 * st + 8 * (lane >> 4);
          ldsm_x4(qa, qrow);
          uint32_t ql[4];
          if constexpr (QF32) ldsm_x4(ql, qrow + ROWS * LDT);
#pragma unroll
          for (int np = 0; np < NKT / 2; ++np) {
            // B fragments of key tiles 2 np, 2 np + 1 (K rows are B's columns)
            uint32_t bf[4];
            const int mi = lane >> 3;
            ldsm_x4(bf, kt + (16 * np + 8 * (mi >> 1) + (lane & 7)) * LDT + 16 * st + 8 * (mi & 1));
            mma(s[2 * np], qa, bf[0], bf[1]);
            mma(s[2 * np + 1], qa, bf[2], bf[3]);
            if constexpr (QF32) {
              mma(s[2 * np], ql, bf[0], bf[1]);
              mma(s[2 * np + 1], ql, bf[2], bf[3]);
            }
          }
        }
      }

      // online softmax in registers; the 4 lanes of a quad share the rows.
      // Masked keys get -inf (p = 0); a block of keys every row of the warp
      // sees needs no mask.
      const bool whole = ka + HALF - 1 < klen && (!causal || ka + HALF - 1 <= w_lo) &&
                         (window <= 0 || ka >= w_hi - (window - 1));
      const float minus_inf = __int_as_float(0xff800000);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = ka + 8 * n + 2 * tig + (j & 1);
          s[n][j] *= c2;
          if (!whole && !visible(kp, qp[j >> 1], klen, causal, window)) s[n][j] = minus_inf;
          mx[j >> 1] = fmaxf(mx[j >> 1], s[n][j]);
        }
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mx[i] = fmaxf(m[i], mx[i]);
        corr[i] = exp2_approx(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // masked keys are -inf: p = 0, also in a row that sees no key yet
          s[n][j] = exp2_approx(s[n][j] - m[j >> 1]);
          sum[j >> 1] += s[n][j];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * corr[i] + sum[i];
      }
      // no rescale while the warp's row maxima stand still
      if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
        for (int n = 0; n < NDM; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[n][j] *= corr[j >> 1];
      }
    }
    if (k_next < k_end) {
      cp_async_wait_all();
      // the next step's copy has landed for every thread
      __syncthreads();
    }
    if (live) {
      // acc += P @ V: key tiles 2 kk, 2 kk + 1 form the A fragment of the
      // 16-key step kk, split into hi + lo fp16 (DIRECT: hi + mid + lo bf16,
      // one piece a pass: each pass rounds what the scores still hold and
      // leaves the rest in them, so only one piece is live at a time)
      if constexpr (F32KV) {
        // key tile n: P's C fragment (keys 2 tig, 2 tig + 1 of rows g, g + 8)
        // is the A fragment; V rows 2 tig and 2 tig + 1 at column g of each
        // column tile are B's
        const float* vrow = vf + (buf * BK + HALF * kh + 2 * tig) * LDV + g;
#pragma unroll
        for (int n = 0; n < NKT; ++n) {
          uint32_t pb[4], ps[4];
          split_tf32(s[n][0], pb[0], ps[0]);
          split_tf32(s[n][2], pb[1], ps[1]);
          split_tf32(s[n][1], pb[2], ps[2]);
          split_tf32(s[n][3], pb[3], ps[3]);
#pragma unroll
          for (int j = 0; j < NDM; ++j) {
            if (j < ND) {
              uint32_t vb0, vs0, vb1, vs1;
              split_tf32(vrow[8 * n * LDV + 8 * j], vb0, vs0);
              split_tf32(vrow[(8 * n + 1) * LDV + 8 * j], vb1, vs1);
              mma_3xtf32(acc[j], pb, ps, vb0, vb1, vs0, vs1);
            }
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < (F32KV ? 0 : NKT / 2); ++kk) {
        if constexpr (DIRECT) {
          constexpr int NP = 3;
#pragma unroll
          for (int pi = 0; pi < NP; ++pi) {
            uint32_t pa[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float& x0 = s[2 * kk + (j >> 1)][2 * (j & 1)];
              float& x1 = s[2 * kk + (j >> 1)][2 * (j & 1) + 1];
              pa[j] = pack_bf16(x0, x1);
              if (pi < NP - 1) {
                x0 -= __uint_as_float(pa[j] << 16);
                x1 -= __uint_as_float(pa[j] & 0xffff0000u);
              }
            }
#pragma unroll
            for (int dp = 0; dp < NDM / 2; ++dp) {
              if (2 * dp < ND) {
                // B fragments of column tiles 2 dp, 2 dp + 1 (V rows are
                // B's rows)
                uint32_t bf[4];
                const int mi = lane >> 3;
                ldsm_x4_trans(bf, vt + (16 * kk + 8 * (mi & 1) + (lane & 7)) * LDT +
                                      16 * dp + 8 * (mi >> 1));
                mma(acc[2 * dp], pa, bf[0], bf[1]);
                if (2 * dp + 1 < ND) mma(acc[2 * dp + 1], pa, bf[2], bf[3]);
              }
            }
          }
        } else {
          uint32_t ph[4], pl[4];
          split_f16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split_f16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split_f16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split_f16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int dp = 0; dp < NDM / 2; ++dp) {
            if (2 * dp < ND) {
              // B fragments of column tiles 2 dp, 2 dp + 1 (V rows are B's rows)
              uint32_t bf[4];
              const int mi = lane >> 3;
              ldsm_x4_trans(bf, vt + (16 * kk + 8 * (mi & 1) + (lane & 7)) * LDT + 16 * dp +
                                    8 * (mi >> 1));
              mma<true>(acc[2 * dp], ph, bf[0], bf[1]);
              mma<true>(acc[2 * dp], pl, bf[0], bf[1]);
              if (2 * dp + 1 < ND) {
                mma<true>(acc[2 * dp + 1], ph, bf[2], bf[3]);
                mma<true>(acc[2 * dp + 1], pl, bf[2], bf[3]);
              }
            }
          }
        }
      }
    }
    if (k_next < k_end) {
      if constexpr (!DIRECT)
        widen(k_next, ks + (buf ^ 1) * BK * LDT, vs + (buf ^ 1) * BK * LDT);
      if constexpr (PAGED) {
        if (k_next + BK < k_end) map_rows(k_next + BK);
      }
    }
    // the next step's tiles (and pool rows) are in place, this step's are
    // read, and the raw buffer (DIRECT: this step's tile buffer) is free
    __syncthreads();
    if (k_next + BK < k_end) issue(k_next + BK, buf);
  }

  // merge the key parts: the warps of parts 1.. hand their state to the
  // warp of part 0 of their row group through shared memory (the tiles'
  // space), lane by lane
  __syncthreads();
  // part p's hand-over: [ROW_WARPS][NV][32] floats at (p - 1) * ROW_WARPS * NV * 32
  float* xfer = reinterpret_cast<float*>(smem) + wr * NV * 32 + lane;
  if (kh > 0) {
    xfer += (kh - 1) * ROW_WARPS * NV * 32;
#pragma unroll
    for (int n = 0; n < NDM; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) xfer[(4 * n + j) * 32] = acc[n][j];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xfer[(4 * NDM + i) * 32] = m[i];
      xfer[(4 * NDM + 2 + i) * 32] = l[i];
    }
  }
  __syncthreads();
  if (kh > 0) return;
#pragma unroll
  for (int part = 1; part < PARTS; ++part) {
    const float* x = xfer + (part - 1) * ROW_WARPS * NV * 32;
    float a0[2], a1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = x[(4 * NDM + i) * 32];
      const float mt = fmaxf(m[i], m1);
      a0[i] = exp2_approx(m[i] - mt);
      a1[i] = exp2_approx(m1 - mt);
      l[i] = l[i] * a0[i] + x[(4 * NDM + 2 + i) * 32] * a1[i];
      m[i] = mt;
    }
#pragma unroll
    for (int n = 0; n < NDM; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[n][j] = acc[n][j] * a0[j >> 1] + x[(4 * n + j) * 32] * a1[j >> 1];
  }

  // epilogue: value dequant once, normalize (l == 0 -> exact zeros)
  const float vsc = v_scale[h];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const int qi = i0 + r / G;
    if (r >= rows || qi >= Sq) continue;
    const float f = vsc / fmaxf(l[i], 1e-30f);
    float* orow = out + ((((size_t)b * Sq + qi) * KV + h) * G + r % G) * D;
#pragma unroll
    for (int n = 0; n < NDM; ++n) {
      if (n < ND)
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * tig) =
            make_float2(acc[n][2 * i] * f, acc[n][2 * i + 1] * f);
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
  constexpr int PARTS = parts(DCH, BITS);
  constexpr int BK = HALF * PARTS;
  const int BQ = ROWS / G > 0 ? ROWS / G : 1;
  const int LDT = tile_ld((D + 15) & ~15, std::is_same<T, float>::value, BITS);
  const int DP = D * BITS / 8;
  // the widest cp.async that the row width and both base addresses allow
  const uintptr_t al = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                       static_cast<uintptr_t>(DP);
  const int cw = al % 16 == 0 ? 16 : al % 8 == 0 ? 8 : 4;
  const int q_tiles = std::is_same<T, float>::value ? 2 : 1;
  // a bf16 stream (BITS == 16) is copied straight into the tiles: no raw
  // buffers
  // a float32 stream (BITS == 32) into float32 tiles, q as two word tiles
  const size_t tiles =
      (BITS == 32 ? sizeof(float) * (2 * BK * (ld_k32(D) + ld_v32(D)) + 2 * ROWS * ld_k32(D))
                  : sizeof(uint16_t) * (4 * BK + q_tiles * ROWS) * LDT +
                        (BITS == 16 ? 0 : 2 * (size_t)BK * DP)) +
      (PAGED ? sizeof(size_t) * BK : 0);
  // the merge's hand-over, (PARTS - 1) x [ROW_WARPS][NV][32] floats, reuses
  // that space
  const size_t xfer = sizeof(float) * (PARTS - 1) * ROW_WARPS * (32 * DCH + 4) * 32;
  const size_t smem = tiles > xfer ? tiles : xfer;
  auto kern = prefill_attention_kernel<T, DCH, BITS, PAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, KV, B);
  kern<<<grid, 32 * ROW_WARPS * PARTS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(q_start),
      static_cast<const int*>(kv_len), pg.table, static_cast<float*>(out), Sq, Sk, KV,
      G, D, BQ, causal, window, pg.NB, pg.P, pg.n_pages, cw);
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
  if constexpr (REPRO_WIDE) {
    if (D <= 192)
      return launch<T, 3, BITS>(q, k, v, ks, vs, q_start, kv_len, out, B, Sq, Sk, KV, G,
                                D, causal, window, pg, st);
    return launch<T, 4, BITS>(q, k, v, ks, vs, q_start, kv_len, out, B, Sq, Sk, KV, G,
                              D, causal, window, pg, st);
  } else {
    if (D <= 64)
      return launch<T, 1, BITS>(q, k, v, ks, vs, q_start, kv_len, out, B, Sq, Sk, KV,
                                G, D, causal, window, pg, st);
    return launch<T, 2, BITS>(q, k, v, ks, vs, q_start, kv_len, out, B, Sq, Sk, KV, G,
                              D, causal, window, pg, st);
  }
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
  if (bits == 16)
    return dispatch<T, 16>(q, k, v, ks, vs, q_start, kv_len, out, B, Sq, Sk, KV, G, D,
                           causal, window, pg, st);
  if constexpr (!REPRO_WIDE) {  // the wide library has no float32 branch
    if (bits == 32)
      return dispatch<T, 32>(q, k, v, ks, vs, q_start, kv_len, out, B, Sq, Sk, KV, G, D,
                             causal, window, pg, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, Sq, KV, G, D) f32 (q_bf16 == 0) or bf16; bits, the K/V storage code:
// 8 int8, 4 packed int4, 16 bf16, 32 float32 (not in the REPRO_WIDE library);
// k/v: (B, Sk, KV, D) int8, bf16 or float32, or (B, Sk,
// KV, D/2) packed int4, when table is null, else pools (n_pages, P, KV, D or
// D/2) read through the (B, NB) int32 block table, with Sk == NB * P;
// k_scale/v_scale: (KV,) f32; q_start, kv_len: (B,) int32; window <= 0 means no
// window; out: (B, Sq, KV, G, D) f32.  Requires G <= 64, D % 8 == 0 and D <=
// 128 (REPRO_WIDE: 128 < D <= 256).
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
  if (D % 8 || D > (REPRO_WIDE ? 256 : 128) || (REPRO_WIDE && D <= 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_bf16)
    return dispatch_bits<__nv_bfloat16>(q, k, v, k_scale, v_scale, q_start, kv_len,
                                        out, B, Sq, Sk, KV, G, D, causal, window,
                                        bits, pg, st);
  return dispatch_bits<float>(q, k, v, k_scale, v_scale, q_start, kv_len, out, B, Sq,
                              Sk, KV, G, D, causal, window, bits, pg, st);
}
