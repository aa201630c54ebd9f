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
// [0, d/64) scale the high plane); q_off, kv_len (b,) int32.  Output
// (b, hq, sq, d) bf16.  The function is K4's (csrc/mx_attention.cu): GQA
// folded, row r of a KV head sees positions <= q_off + r / G and < kv_len,
// fp32 online softmax over tiles of 64 positions taken from position 0
// upwards (a row's result depends on its own position only), p rounded to
// bf16 before P.V, masked scores -1e30, a row with no visible key gives 0.
//
// What bounds it on an H100: at decode the cache bytes of the visible prefix;
// at prefill the two dots.  Design: K4's CTA (64 query rows, four warps of
// 16, mma.sync m16n8k16 bf16 -> fp32).  What the layout changes is the tile
// decode.  A code row is contiguous along the sequence, so a thread reads 16
// positions of one d-row as one 16-byte vector (and their 16 scales as
// another; a warp covers 8 d-rows x 64 positions, every 32-byte sector used
// in full) and writes them as one row segment of a [d][position] bf16 tile:
// K and V decode alike, and an fp4 byte row yields two tile rows.  For P.V the
// contraction runs over positions, so the V tile is read as K4 reads its
// transposed V tile.  For q.K^T the contraction runs over d, the strided
// axis: the B fragments come from the same [d][position] tile through
// ldmatrix.trans, with no transposing store.  Decoded values and the order
// of every sum are K4's, so on the same cache content the two kernels agree
// bit for bit.  No split over the KV length yet (decode at small batch
// leaves SMs idle).
#include "mx_common.cuh"

namespace {

constexpr int kD = 128;         // head_dim
constexpr int kRows = 64;       // query rows per CTA (4 warps x 16)
constexpr int kL = 64;          // KV positions per tile
constexpr int kSeg = 16;        // positions per vector load
constexpr int kTPad = kL + 8;   // tile row stride (bf16): 144 bytes, conflict-free for ldmatrix
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 decoded values -> one 32-byte row segment of a tile.
__device__ __forceinline__ void store_segment(uint16_t* dst, const float* v) {
  uint4 lo, hi;
  lo.x = pack_bf16(v[0], v[1]);
  lo.y = pack_bf16(v[2], v[3]);
  lo.z = pack_bf16(v[4], v[5]);
  lo.w = pack_bf16(v[6], v[7]);
  hi.x = pack_bf16(v[8], v[9]);
  hi.y = pack_bf16(v[10], v[11]);
  hi.z = pack_bf16(v[12], v[13]);
  hi.w = pack_bf16(v[14], v[15]);
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

// Decode the 16 positions [pos0, pos0 + 16) of code row `row` of one head's
// buffer into the tile at columns [p0, p0 + 16).  Positions at or past
// kv_len decode to 0: stale codes never reach the dots.
template <int E>
__device__ __forceinline__ void decode_segment(uint16_t (*tile)[kTPad], const uint8_t* codes_h,
                                               const uint8_t* scales_h, int row, int L, int pos0,
                                               int p0, int kv_len) {
  const uint4 cv = *reinterpret_cast<const uint4*>(codes_h + (long long)row * L + pos0);
  const uint8_t* c = reinterpret_cast<const uint8_t*>(&cv);
  float v[kSeg];
  if constexpr (E == mx::kFp4E2M1) {
    const uint4 sh = *reinterpret_cast<const uint4*>(scales_h + (long long)(row / 32) * L + pos0);
    const uint4 sl =
        *reinterpret_cast<const uint4*>(scales_h + (long long)(row / 32 + kD / 64) * L + pos0);
    const uint8_t* seh = reinterpret_cast<const uint8_t*>(&sh);
    const uint8_t* sel = reinterpret_cast<const uint8_t*>(&sl);
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      v[j] = pos0 + j < kv_len ? mx::decode_code_dot<E>(c[j] >> 4, seh[j]) : 0.f;
    store_segment(&tile[row][p0], v);
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      v[j] = pos0 + j < kv_len ? mx::decode_code_dot<E>(c[j] & 0xF, sel[j]) : 0.f;
    store_segment(&tile[row + kD / 2][p0], v);
  } else {
    const uint4 sv = *reinterpret_cast<const uint4*>(scales_h + (long long)(row / 32) * L + pos0);
    const uint8_t* se = reinterpret_cast<const uint8_t*>(&sv);
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      v[j] = pos0 + j < kv_len ? mx::decode_code_dot<E>(c[j], se[j]) : 0.f;
    store_segment(&tile[row][p0], v);
  }
}

template <int E>
__global__ void __launch_bounds__(128)
attention_dmajor_kernel(const uint16_t* __restrict__ q, const uint8_t* __restrict__ kd,
                        const uint8_t* __restrict__ ks, const uint8_t* __restrict__ vd,
                        const uint8_t* __restrict__ vs, const int* __restrict__ q_off_p,
                        const int* __restrict__ kv_len_p, uint16_t* __restrict__ out, int hq,
                        int hkv, int sq, int L, float sm_scale) {
  __shared__ __align__(16) uint16_t Kt[kD][kTPad];  // [d][position]
  __shared__ __align__(16) uint16_t Vt[kD][kTPad];

  constexpr int kCodeRows = E == mx::kFp4E2M1 ? kD / 2 : kD;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int ib = blockIdx.z, ih = blockIdx.y;
  const int G = hq / hkv;
  const int rows_total = sq * G;
  const int row_base = blockIdx.x * kRows;
  const int q_off = q_off_p[ib], kv_len = kv_len_p[ib];
  const long long kv_head = (long long)ib * hkv + ih;
  const uint8_t* kd_h = kd + kv_head * kCodeRows * L;
  const uint8_t* vd_h = vd + kv_head * kCodeRows * L;
  const uint8_t* ks_h = ks + kv_head * (kD / 32) * L;
  const uint8_t* vs_h = vs + kv_head * (kD / 32) * L;

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
    // Decode the K and V tiles: a warp step covers 8 code rows x 64 positions.
    for (int idx = tid; idx < kCodeRows * (kL / kSeg); idx += 128) {
      const int seg = idx % (kL / kSeg), crow = idx / (kL / kSeg);
      decode_segment<E>(Kt, kd_h, ks_h, crow, L, kt0 + seg * kSeg, seg * kSeg, kv_len);
      decode_segment<E>(Vt, vd_h, vs_h, crow, L, kt0 + seg * kSeg, seg * kSeg, kv_len);
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
        mx::ldmatrix_x2_trans(b, &Kt[kk * 16 + (lane & 15)][j * 8]);
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

template <int E>
cudaError_t run(const void* q, const void* kd, const void* ks, const void* vd, const void* vs,
                const void* q_off, const void* kv_len, void* out, int b, int hq, int hkv, int sq,
                int L, float sm_scale, cudaStream_t stream) {
  dim3 grid((sq * (hq / hkv) + kRows - 1) / kRows, hkv, b);
  attention_dmajor_kernel<E><<<grid, 128, 0, stream>>>(
      (const uint16_t*)q, (const uint8_t*)kd, (const uint8_t*)ks, (const uint8_t*)vd,
      (const uint8_t*)vs, (const int*)q_off, (const int*)kv_len, (uint16_t*)out, hq, hkv, sq, L,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Codes are (b, hkv, d, L) bytes, (b, hkv, d/2, L) for fp4; L % 64 == 0.
extern "C" int mx_cached_attention_dmajor_launch(const void* q, const void* kd, const void* ks,
                                                 const void* vd, const void* vs,
                                                 const void* q_off, const void* kv_len, void* out,
                                                 int b, int hq, int hkv, int sq, int L, int d,
                                                 float sm_scale, int elem, void* stream) {
  if (d != kD || hkv <= 0 || hq % hkv || L % kL) return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3:
      return run<mx::kFp8E4M3>(q, kd, ks, vd, vs, q_off, kv_len, out, b, hq, hkv, sq, L, sm_scale, s);
    case mx::kFp4E2M1:
      return run<mx::kFp4E2M1>(q, kd, ks, vd, vs, q_off, kv_len, out, b, hq, hkv, sq, L, sm_scale, s);
    case mx::kFp6E3M2:
      return run<mx::kFp6E3M2>(q, kd, ks, vd, vs, q_off, kv_len, out, b, hq, hkv, sq, L, sm_scale, s);
    case mx::kFp6E2M3:
      return run<mx::kFp6E2M3>(q, kd, ks, vd, vs, q_off, kv_len, out, b, hq, hkv, sq, L, sm_scale, s);
    case mx::kInt8:
      return run<mx::kInt8>(q, kd, ks, vd, vs, q_off, kv_len, out, b, hq, hkv, sq, L, sm_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
