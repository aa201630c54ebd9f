// K5 mx_cached_attention_chunkdot: decode attention (one query position per
// batch row) of bf16 queries over an int8 MX KV cache in the seq layout, with
// the per-32-block scales factored out of the dots.
//
// Replaces torchmx_tpu/ops/pallas_attention.py::_attn_kernel_chunkdot (:307),
// launched by _mx_cached_attention_chunkdot (:401).
//
// Inputs: q (b, hq, 1, d) bf16; K/V codes (b, hkv, L, d) int8 and scales
// (b, hkv, L, d/32) uint8; q_off, kv_len (b,) int32.  Output (b, hq, 1, d)
// bf16.  For the G = hq / hkv query rows of a KV head and position j:
//   s[r, j]  = sm_scale * sum_c 2^(se_k[j,c]-127) * (q_c[r] . k_c[j])
//   out_c[r] = sum_j bf16(p[r, j] * 2^(se_v[j,c]-127)) . v_c[j]
// over the d/32 chunks c: the codes enter the dots bare (int8 -> float is
// exact), the K scale multiplies each chunk's fp32 partial sum once, the V
// scale folds into p and that product is rounded to bf16 before the dot.  A
// scale is the float whose bits are se << 23, so se == 0 (a never-written
// slot) is +0.0.  Position j is visible when j <= q_off and j < kv_len;
// online softmax in fp32; a row with no visible key outputs 0.
//
// What bounds it on an H100: the cache bytes of the visible prefix (264 bytes
// per position and KV head).  Design: a K or V row is 128 bytes, one 4-byte
// load per lane of a warp, so each group of 8 lanes holds exactly one
// 32-element chunk.  The G rows' partial sums are reduced inside the group
// together: at each of the three shuffle steps a lane hands the half of the
// rows it no longer follows to its partner, so a lane ends with one row's
// chunk sum after G - 1 + (3 - log2 G) shuffles, not 3 G; the scale multiplies
// it once, and two more shuffle steps add the four chunks.  A warp takes 32
// positions at a time (one score per lane for the softmax) and loads them 16
// rows ahead of their use, so that enough bytes are in flight; scores and p
// go through shared memory, and every lane keeps the fp32 output of its own
// 4 elements of d for all G rows: the P.V product needs no reduction across
// lanes.  The tiles of a (batch row, KV head) pair are dealt round-robin to
// the 8 warps of `splits` CTAs, so a short visible prefix still spreads over
// all of them; each CTA merges its warps' (max, sum, output) in warp order
// through shared memory, and with splits > 1 a second kernel merges the
// CTAs' partials in CTA order: no atomics, the result is deterministic.
#include "mx_common.cuh"

namespace {

constexpr int kD = 128;      // head_dim: 32 lanes x 4 codes
constexpr int kTile = 32;    // KV positions per warp step
constexpr int kBatch = 16;   // positions whose codes are loaded before any is used
constexpr int kWarps = 8;    // warps per CTA
constexpr int kPart = kD + 2;  // a partial: d outputs, running max, running sum
constexpr float kNegInf = -1e30f;

using mx::halve;
using mx::pow2_scale;
using mx::warp_max;
using mx::warp_sum;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The four int8 codes of one 4-byte word, as floats.
__device__ __forceinline__ void unpack_codes(int w, float* c) {
  c[0] = (float)(int8_t)(w & 0xFF);
  c[1] = (float)(int8_t)((w >> 8) & 0xFF);
  c[2] = (float)(int8_t)((w >> 16) & 0xFF);
  c[3] = (float)(w >> 24);
}

// Sum each of the G values of v over the 8 lanes of a chunk group; returns
// the sum of row group_row<G>(lane).
template <int G>
__device__ __forceinline__ float group_sum(float* v, int lane) {
  if constexpr (G >= 2) halve<G>(v, lane & 1, 1);
  else v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  if constexpr (G >= 4) halve<G / 2>(v, lane & 2, 2);
  else v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  if constexpr (G >= 8) halve<G / 4>(v, lane & 4, 4);
  else v[0] += __shfl_xor_sync(0xffffffffu, v[0], 4);
  return v[0];
}

template <int G>
__device__ __forceinline__ int group_row(int lane) {
  int r = 0;
  if (G >= 2 && (lane & 1)) r += G / 2;
  if (G >= 4 && (lane & 2)) r += G / 4;
  if (G >= 8 && (lane & 4)) r += G / 8;
  return r;
}

template <int G>
__global__ void __launch_bounds__(kWarps * 32, 2)
chunkdot_kernel(const uint16_t* __restrict__ q, const int8_t* __restrict__ kd,
                const uint8_t* __restrict__ ks, const int8_t* __restrict__ vd,
                const uint8_t* __restrict__ vs, const int* __restrict__ q_off_p,
                const int* __restrict__ kv_len_p, uint16_t* __restrict__ out,
                float* __restrict__ ws, int hkv, int L, float sm_scale) {
  __shared__ float P[kWarps][G][kTile];
  __shared__ float part[kWarps][G][kPart];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sp = blockIdx.x, splits = gridDim.x, ih = blockIdx.y, ib = blockIdx.z;
  const int chunk = lane / 8;
  const int hq = hkv * G;
  const int kv_end = min(min(kv_len_p[ib], q_off_p[ib] + 1), L);
  const long long kv_head = (long long)ib * hkv + ih;
  const int8_t* kd_h = kd + kv_head * L * kD;
  const int8_t* vd_h = vd + kv_head * L * kD;
  const uint8_t* ks_h = ks + kv_head * L * (kD / 32);
  const uint8_t* vs_h = vs + kv_head * L * (kD / 32);
  const long long q_row0 = ((long long)ib * hq + (long long)ih * G) * kD;

  // This lane's 4 elements of every query row, and its 4 output elements.
  float qf[G][4], acc[G][4], m_run[G], l_run[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    uint2 w = *reinterpret_cast<const uint2*>(q + q_row0 + r * kD + 4 * lane);
    qf[r][0] = __uint_as_float(w.x << 16);
    qf[r][1] = __uint_as_float(w.x & 0xFFFF0000u);
    qf[r][2] = __uint_as_float(w.y << 16);
    qf[r][3] = __uint_as_float(w.y & 0xFFFF0000u);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }

  // The lanes that write a row's score: one per row, in the first chunk group.
  constexpr int kRowBits = (G >= 2 ? 1 : 0) | (G >= 4 ? 2 : 0) | (G >= 8 ? 4 : 0);
  const bool writes_score = (lane & ~kRowBits) == 0;
  const int my_row = group_row<G>(lane);

  const int unit = sp * kWarps + warp, units = splits * kWarps;
  for (int t0 = unit * kTile; t0 < kv_end; t0 += units * kTile) {
    const int n = min(kTile, kv_end - t0);  // visible positions of the tile (warp-uniform)
    // Lane j holds the four chunk scales of position t0 + j.
    const long long spos = (long long)(t0 + lane) * (kD / 32);
    const int ksw = lane < n ? *reinterpret_cast<const int*>(ks_h + spos) : 0;
    const int vsw = lane < n ? *reinterpret_cast<const int*>(vs_h + spos) : 0;
#pragma unroll
    for (int h = 0; h < kTile; h += kBatch) {
      if (h >= n) break;
      int kw[kBatch];
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj)
        kw[jj] = h + jj < n
                     ? *reinterpret_cast<const int*>(kd_h + (long long)(t0 + h + jj) * kD + 4 * lane)
                     : 0;
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int j = h + jj;
        if (j >= n) break;
        const int sw = __shfl_sync(0xffffffffu, ksw, j);
        const float ksc = pow2_scale((sw >> (8 * chunk)) & 0xFF);
        float kc[4], d[G];
        unpack_codes(kw[jj], kc);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          d[r] = qf[r][0] * kc[0];
          d[r] = fmaf(qf[r][1], kc[1], d[r]);
          d[r] = fmaf(qf[r][2], kc[2], d[r]);
          d[r] = fmaf(qf[r][3], kc[3], d[r]);
        }
        float x = group_sum<G>(d, lane) * ksc;   // the chunk's partial sum, scaled once
        x += __shfl_xor_sync(0xffffffffu, x, 8);  // the four chunks
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (writes_score) P[warp][my_row][j] = x * sm_scale;
      }
    }
    __syncwarp();
    // Online softmax, lane = position of the tile.
    float s[G];
#pragma unroll
    for (int r = 0; r < G; ++r) s[r] = lane < n ? P[warp][r][lane] : kNegInf;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float m_new = fmaxf(m_run[r], warp_max(s[r]));
      const float alpha = expf(m_run[r] - m_new);
      const float p = lane < n ? expf(s[r] - m_new) : 0.f;
      l_run[r] = l_run[r] * alpha + warp_sum(p);
      m_run[r] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= alpha;
      P[warp][r][lane] = p;
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < kTile; h += kBatch) {
      if (h >= n) break;
      int vw[kBatch];
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj)
        vw[jj] = h + jj < n
                     ? *reinterpret_cast<const int*>(vd_h + (long long)(t0 + h + jj) * kD + 4 * lane)
                     : 0;
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int j = h + jj;
        if (j >= n) break;
        const int sw = __shfl_sync(0xffffffffu, vsw, j);
        const float vsc = pow2_scale((sw >> (8 * chunk)) & 0xFF);
        float vc[4];
        unpack_codes(vw[jj], vc);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const float ps = round_bf16(P[warp][r][j] * vsc);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(ps, vc[e], acc[r][e]);
        }
      }
    }
    __syncwarp();
  }

  // Merge the CTA's warps in warp order.
#pragma unroll
  for (int r = 0; r < G; ++r) {
#pragma unroll
    for (int e = 0; e < 4; ++e) part[warp][r][4 * lane + e] = acc[r][e];
    if (lane == 0) {
      part[warp][r][kD] = m_run[r];
      part[warp][r][kD + 1] = l_run[r];
    }
  }
  __syncthreads();
  mx::merge_warps<G, kWarps, kD>(part, out + q_row0,
                                 splits == 1 ? nullptr : ws + (kv_head * splits + sp) * G * kPart);
}

template <int G>
cudaError_t run(const void* q, const void* kd, const void* ks, const void* vd, const void* vs,
                const void* q_off, const void* kv_len, void* out, void* ws, int b, int hkv, int L,
                float sm_scale, int splits, cudaStream_t stream) {
  chunkdot_kernel<G><<<dim3(splits, hkv, b), kWarps * 32, 0, stream>>>(
      (const uint16_t*)q, (const int8_t*)kd, (const uint8_t*)ks, (const int8_t*)vd,
      (const uint8_t*)vs, (const int*)q_off, (const int*)kv_len, (uint16_t*)out, (float*)ws, hkv,
      L, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  mx::merge_splits_kernel<kD><<<dim3(hkv, b), kD, 0, stream>>>((const float*)ws, (uint16_t*)out, G,
                                                              splits);
  return cudaGetLastError();
}

}  // namespace

// ws: fp32 scratch of b * hkv * splits * (hq / hkv) * (d + 2) elements (unused
// when splits == 1).  hq / hkv is 1, 2, 4 or 8.
extern "C" int mx_cached_attention_chunkdot_launch(const void* q, const void* kd, const void* ks,
                                                   const void* vd, const void* vs,
                                                   const void* q_off, const void* kv_len,
                                                   void* out, void* ws, int b, int hq, int hkv,
                                                   int L, int d, float sm_scale, int splits,
                                                   void* stream) {
  if (d != kD || hkv <= 0 || hq % hkv || splits < 1 || L < 1) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hq / hkv) {
    case 1: return run<1>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, b, hkv, L, sm_scale, splits, s);
    case 2: return run<2>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, b, hkv, L, sm_scale, splits, s);
    case 4: return run<4>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, b, hkv, L, sm_scale, splits, s);
    case 8: return run<8>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, b, hkv, L, sm_scale, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}
