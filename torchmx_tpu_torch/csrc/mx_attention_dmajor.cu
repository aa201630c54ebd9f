// K6 mx_cached_attention_dmajor: causal attention of bf16 queries over an MX
// KV cache in the d-major layout, prefill, chunks and decode alike.
//
// Replaces torchmx_tpu/ops/pallas_attention.py::_attn_kernel_dmajor (:490),
// launched by _mx_cached_attention_dmajor (:610).
//
// Inputs: q (b, hq, sq, d) bf16; K/V codes (b, hkv, dp, L), the sequence on
// the last axis: one byte per element and dp = d for fp8, fp6 and int8; for
// fp4 dp = d/2 and byte row p holds element p in its high nibble and element
// p + d/2 in its low nibble; scales (b, hkv, d/32, L) uint8 (for fp4, rows
// [0, d/64) scale the high plane); q_off, kv_len (b,) int32 or one number
// each.  Output (b, hq, sq, d) bf16.
//
// The kernel is the d-major instantiation of the cluster kernel that K4
// shares (csrc/mx_attention_tile.cuh, which states the arithmetic, what
// bounds it and the design), so on the same cache content K6 equals K4 bit
// for bit.  A fill of the ring is two TMA boxes: the code rows x 64
// positions and the four scale rows x 64 positions, from 2-D tensor maps
// over (b hkv dp, L) and (b hkv 4, L), encoded once per buffer and kept,
// keyed by pointer, shape and box.
#include "mx_attention_tile.cuh"

// See mx_tile::run for the arguments (codes (b, hkv, dp, L)).
extern "C" int mx_cached_attention_dmajor_launch(const void* q, const void* kd, const void* ks, const void* vd,
                                                 const void* vs, const void* q_off, const void* kv_len, int q_off_n,
                                                 int kv_len_n, void* out, int b, int hq, int hkv, int sq, int L,
                                                 int d, int lt, int P, int ctas, int wide, float sm_scale, int elem,
                                                 int fault, void* stream) {
  return mx_tile::run<mx_tile::kDmajor>(q, kd, ks, vd, vs, q_off, kv_len, q_off_n, kv_len_n, out, b, hq, hkv, sq, L,
                                        d, lt, P, ctas, wide, sm_scale, elem, fault, (cudaStream_t)stream);
}
