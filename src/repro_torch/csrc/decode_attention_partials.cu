// One-token flash-decode attention over ONE shard of a sequence-split
// quantized KV cache, emitting the raw flash state (acc unnormalized and
// value-dequantized, running max m, normalizer l) for the cross-shard merge
// of the sequence-parallel decode.  The tile walk and online softmax are the
// decode kernel's (decode_attention.cuh); only the epilogue differs, so
// acc / max(l, 1e-30) is the decode kernel's output bit for bit.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention_partials_tiles
// (its dense entry decode_attention_partials is a shard's slice read in
// place through the row pitch; a paged pool goes through the block table).
// What bounds it: latency, as for the decode kernel; the shard's chunks run
// as blocks of their own and merge in chunk order within the launch.
// REPRO_DMAX: the head dims of this library, D <= 128 by default; the
// build's _wide library compiles this file again with 256 (128 < D <= 256)
#ifndef REPRO_DMAX
#define REPRO_DMAX 128
#endif
#include "decode_attention.cuh"

// The arguments of repro_decode_attention, plus: pitch, the positions
// between batch rows of a dense k/v (the global cache's S for a slice
// k[:, lo:hi] of it; >= S), and m_out / l_out: (B, KV, G) f32.  out holds
// the unnormalized accumulator; a row with cur_pos == 0 writes (0, -1e30, 0).
extern "C" int repro_decode_attention_partials(
    const void* q, int q_bf16, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* cur_pos, void* out, void* m_out, void* l_out,
    void* scratch, void* counters, int B, int S, int pitch, int KV, int G, int D,
    int bits, int split, const void* table, int NB, int P, int n_pages,
    void* stream) {
  const Paging pg{static_cast<const int*>(table), NB, P, n_pages};
  const Outputs o{static_cast<float*>(out), static_cast<float*>(m_out),
                  static_cast<float*>(l_out), pitch, static_cast<float*>(scratch),
                  static_cast<unsigned*>(counters)};
  return run_decode_attention<true, REPRO_DMAX>(q, q_bf16, k, v, k_scale, v_scale, cur_pos, B, S,
                                    KV, G, D, bits, split, pg, o, stream);
}
