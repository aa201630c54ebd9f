// K4 mx_cached_attention: causal attention of bf16 queries over an MX KV
// cache in the seq layout, prefill, chunks and decode alike.
//
// Replaces torchmx_tpu/ops/pallas_attention.py::_attn_kernel (:115),
// launched by _mx_cached_attention (:279).
//
// Inputs: q (b, hq, sq, d) bf16; K/V codes (b, hkv, L, d), one byte each
// (fp8 e4m3, fp6 e3m2 or e2m3, or int8), and scales (b, hkv, L, d/32)
// uint8; q_off, kv_len (b,) int32 or one number each.  Output (b, hq, sq, d)
// bf16.
//
// The kernel is the seq-layout instantiation of the cluster kernel that K6
// shares (csrc/mx_attention_tile.cuh, which states the arithmetic, what
// bounds it and the design): p rounded to bf16 against JAX's running maximum
// through each of JAX's tiles, the cache split into shares across a
// thread-block cluster, the shares' maxima exchanged and the shares combined
// in the same launch.  A fill of the ring is one bulk copy of 64 positions'
// codes (64 x 128 bytes) and one of their scale rows.
#include "mx_attention_tile.cuh"

// See mx_tile::run for the arguments (codes (b, hkv, L, d)).
extern "C" int mx_cached_attention_launch(const void* q, const void* kd, const void* ks, const void* vd,
                                          const void* vs, const void* q_off, const void* kv_len, int q_off_n,
                                          int kv_len_n, void* out, int b, int hq, int hkv, int sq, int L, int d,
                                          int lt, int P, int ctas, int wide, float sm_scale, int elem, int fault,
                                          void* stream) {
  if (elem == mx::kFp4E2M1) return (int)cudaErrorInvalidValue;  // fp4 caches are d-major only
  return mx_tile::run<mx_tile::kSeq>(q, kd, ks, vd, vs, q_off, kv_len, q_off_n, kv_len_n, out, b, hq, hkv, sq, L, d,
                                     lt, P, ctas, wide, sm_scale, elem, fault, (cudaStream_t)stream);
}
