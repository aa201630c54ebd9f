// K4 mx_cached_attention: causal attention of bf16 queries over an MX KV
// cache in the seq layout, prefill and decode alike.
//
// Replaces torchmx_tpu/ops/pallas_attention.py::_attn_kernel (:115),
// launched by _mx_cached_attention (:279).
//
// Inputs: q (b, hq, sq, d) bf16; K/V codes (b, hkv, L, d), one byte each
// (fp8 e4m3, fp6 e3m2 or e2m3, or int8), and scales (b, hkv, L, d/32)
// uint8; q_off, kv_len (b,) int32.  Output (b, hq, sq, d)
// bf16.  GQA is folded: the rows of one KV head are ordered (query
// position, head in group), row r sees positions <= q_off + r / G and
// < kv_len.
//
// What bounds it on an H100: at decode the cache bytes (each code and scale
// read once per KV head); at prefill the two dots, 4 * rows * kv * d
// operations per head.  Design (flash-attention 2): one CTA per (64-row tile,
// KV head, batch row), four warps of 16 rows.  Each KV tile of 64 positions
// is read as 16-byte vectors, decoded in-kernel (scale folded into the bf16
// exponent field, as decode_codes_to_bf16(dot_operand=True)) into shared
// memory, K row-major and V transposed, so both dots are mma.sync m16n8k16
// bf16 -> fp32 with conflict-free fragment loads.  Running max, sum and
// output stay fp32 in registers; p is rounded to bf16 before the P.V dot as
// in the reference; masked scores are -1e30; tiles past the causal frontier
// or the visible prefix are skipped; a row with no visible key outputs 0.
// No split over the KV length yet (decode at small batch leaves SMs idle).
#include "mx_common.cuh"

namespace {

constexpr int kD = 128;           // head_dim
constexpr int kRows = 64;         // query rows per CTA (4 warps x 16)
constexpr int kL = 64;            // KV positions per tile
constexpr int kKPad = kD + 8;     // Ks row stride (bf16)
constexpr int kVPad = kL + 8;     // Vt row stride (bf16)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int E>
__global__ void __launch_bounds__(128)
attention_kernel(const uint16_t* __restrict__ q, const uint8_t* __restrict__ kd,
                 const uint8_t* __restrict__ ks, const uint8_t* __restrict__ vd,
                 const uint8_t* __restrict__ vs, const int* __restrict__ q_off_p,
                 const int* __restrict__ kv_len_p, uint16_t* __restrict__ out, int hq, int hkv,
                 int sq, int L, float sm_scale) {
  __shared__ __align__(16) uint16_t Ks[kL][kKPad];
  __shared__ __align__(16) uint16_t Vt[kD][kVPad];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int ib = blockIdx.z, ih = blockIdx.y;
  const int G = hq / hkv;
  const int rows_total = sq * G;
  const int row_base = blockIdx.x * kRows;
  const int q_off = q_off_p[ib], kv_len = kv_len_p[ib];
  const long long kv_head = (long long)ib * hkv + ih;
  const uint8_t* kd_h = kd + kv_head * L * kD;
  const uint8_t* vd_h = vd + kv_head * L * kD;
  const uint8_t* ks_h = ks + kv_head * L * (kD / 32);
  const uint8_t* vs_h = vs + kv_head * L * (kD / 32);

  // This thread's two rows (g and g + 8 of its warp's 16).
  int row[2], qpos[2];
  long long qidx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = row_base + warp * 16 + g + h * 8;
    int r = min(row[h], rows_total - 1);
    int si = r / G, gi = r % G;
    qpos[h] = q_off + si;
    qidx[h] = (((long long)ib * hq + ih * G + gi) * sq + si) * kD;
  }
  // Q fragments for the 8 k-steps over d, kept in registers.
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    int c0 = kk * 16 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bool ok = row[h] < rows_total;
      qa[kk][h] = ok ? *reinterpret_cast<const uint32_t*>(q + qidx[h] + c0) : 0u;
      qa[kk][2 + h] = ok ? *reinterpret_cast<const uint32_t*>(q + qidx[h] + c0 + 8) : 0u;
    }
  }

  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  // Highest query position of the CTA: tiles above it, or at/after kv_len, are dead.
  const int q_hi = q_off + (min(rows_total, row_base + kRows) - 1) / G;
  const int kv_end = min(min(kv_len, q_hi + 1), L);

  for (int kt0 = 0; kt0 < kv_end; kt0 += kL) {
    // Decode K and V tiles: 64 positions x 128 codes, 16 codes per step.
    for (int c = tid; c < kL * kD / 16; c += 128) {
      int p = c / (kD / 16), d0 = (c % (kD / 16)) * 16;
      int pos = kt0 + p;
      uint4 kb = *reinterpret_cast<const uint4*>(kd_h + (long long)pos * kD + d0);
      uint4 vb = *reinterpret_cast<const uint4*>(vd_h + (long long)pos * kD + d0);
      int kse = ks_h[(long long)pos * (kD / 32) + d0 / 32];
      int vse = vs_h[(long long)pos * (kD / 32) + d0 / 32];
      const uint8_t* kbb = reinterpret_cast<const uint8_t*>(&kb);
      const uint8_t* vbb = reinterpret_cast<const uint8_t*>(&vb);
      bool live = pos < kv_len;  // never let stale codes reach the dots
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        float k0 = live ? mx::decode_code_dot<E>(kbb[j], kse) : 0.f;
        float k1 = live ? mx::decode_code_dot<E>(kbb[j + 1], kse) : 0.f;
        *reinterpret_cast<uint32_t*>(&Ks[p][d0 + j]) = pack_bf16(k0, k1);
        float v0 = live ? mx::decode_code_dot<E>(vbb[j], vse) : 0.f;
        float v1 = live ? mx::decode_code_dot<E>(vbb[j + 1], vse) : 0.f;
        Vt[d0 + j][p] = __bfloat16_as_ushort(__float2bfloat16_rn(v0));
        Vt[d0 + j + 1][p] = __bfloat16_as_ushort(__float2bfloat16_rn(v1));
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 positions.
    float s[kL / 8][4];
#pragma unroll
    for (int j = 0; j < kL / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&Ks[j * 8 + g][kk * 16 + 2 * t]);
        b[1] = *reinterpret_cast<const uint32_t*>(&Ks[j * 8 + g][kk * 16 + 2 * t + 8]);
        mx::mma_bf16_16816(s[j], qa[kk], b);
      }
    }
    // Scale, mask, online softmax (fp32).
    float mx_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mloc = kNegInf;
#pragma unroll
      for (int j = 0; j < kL / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int kv_pos = kt0 + j * 8 + 2 * t + e;
          float v = s[j][2 * h + e] * sm_scale;
          bool valid = kv_pos <= qpos[h] && kv_pos < kv_len;
          v = valid ? v : kNegInf;
          s[j][2 * h + e] = v;
          mloc = fmaxf(mloc, v);
        }
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
      mx_new[h] = fmaxf(m_run[h], mloc);
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      alpha[h] = expf(m_run[h] - mx_new[h]);
#pragma unroll
      for (int j = 0; j < kL / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = expf(s[j][2 * h + e] - mx_new[h]);
          s[j][2 * h + e] = p;
          psum[h] += p;
        }
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + psum[h];
      m_run[h] = mx_new[h];
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += bf16(P) V: the S accumulator layout is the A fragment layout.
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&Vt[j * 8 + g][kk * 16 + 2 * t]);
        b[1] = *reinterpret_cast<const uint32_t*>(&Vt[j * 8 + g][kk * 16 + 2 * t + 8]);
        mx::mma_bf16_16816(o[j], pa, b);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= rows_total) continue;
    float inv = 1.f / (l_run[h] == 0.f ? 1.f : l_run[h]);
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      __nv_bfloat162 v = __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(out + qidx[h] + j * 8 + 2 * t) = v;
    }
  }
}

}  // namespace

extern "C" int mx_cached_attention_launch(const void* q, const void* kd, const void* ks,
                                          const void* vd, const void* vs, const void* q_off,
                                          const void* kv_len, void* out, int b, int hq, int hkv,
                                          int sq, int L, int d, float sm_scale, int elem,
                                          void* stream) {
  if (d != kD || hq % hkv || L % kL) return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  dim3 grid((sq * (hq / hkv) + kRows - 1) / kRows, hkv, b);
  decltype(&attention_kernel<mx::kInt8>) kernel;
  switch (elem) {
    case mx::kFp8E4M3: kernel = attention_kernel<mx::kFp8E4M3>; break;
    case mx::kFp6E3M2: kernel = attention_kernel<mx::kFp6E3M2>; break;
    case mx::kFp6E2M3: kernel = attention_kernel<mx::kFp6E2M3>; break;
    case mx::kInt8: kernel = attention_kernel<mx::kInt8>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)q, (const uint8_t*)kd, (const uint8_t*)ks, (const uint8_t*)vd,
      (const uint8_t*)vs, (const int*)q_off, (const int*)kv_len, (uint16_t*)out, hq, hkv, sq, L,
      sm_scale);
  return cudaGetLastError();
}
