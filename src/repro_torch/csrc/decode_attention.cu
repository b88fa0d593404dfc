// One-token flash-decode attention over the quantized KV cache, normalized
// (the decode path's kernel; the body and its design are in
// decode_attention.cuh).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention_tiles.
// REPRO_DMAX: the head dims of this library, D <= 128 by default; the
// build's _wide library compiles this file again with 256 (128 < D <= 256)
#ifndef REPRO_DMAX
#define REPRO_DMAX 128
#endif
#include "decode_attention.cuh"

// q: (B, KV, G, D) f32 (q_bf16 == 0) or bf16; k/v: (B, S, KV, D) int8 (bits
// == 8) or (B, S, KV, D/2) packed int4 (bits == 4) when table is null, else
// pools (n_pages, P, KV, D or D/2) read through the (B, NB) int32 block table,
// with S == NB * P; k_scale/v_scale: (KV,) f32; cur_pos: (B,) int32 valid
// positions; out: (B, KV, G, D) f32; scratch: (B, KV, ceil(S / split), G *
// (D + 2)) f32; counters: >= B * KV int32, zeroed (every launch leaves them
// so); split: the chunk length the caller sized the scratch for (== SPLIT).
// Requires G <= 16, D % 8 == 0, D <= REPRO_DMAX
// (the _wide library: 128 < D <= 256).
extern "C" int repro_decode_attention(const void* q, int q_bf16, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale, const void* cur_pos,
                                      void* out, void* scratch, void* counters,
                                      int B, int S, int KV, int G, int D, int bits,
                                      int split, const void* table, int NB, int P,
                                      int n_pages, void* stream) {
  const Paging pg{static_cast<const int*>(table), NB, P, n_pages};
  const Outputs o{static_cast<float*>(out), nullptr, nullptr, S,
                  static_cast<float*>(scratch), static_cast<unsigned*>(counters)};
  return run_decode_attention<false, REPRO_DMAX>(q, q_bf16, k, v, k_scale, v_scale, cur_pos, B, S,
                                     KV, G, D, bits, split, pg, o, stream);
}
