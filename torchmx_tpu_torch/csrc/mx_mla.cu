// B13 mx_mla_attention: absorbed multi-head latent attention (DeepSeek-V3
// MLA) over the seq-layout latent cache, prefill and decode alike.
//
// Replaces torchmx_tpu/ops/pallas_mla.py::_mla_kernel (:75), launched by
// _mla_cached_attention (:197).
//
// Inputs: q_lat (b, rows, 512) and q_rot (b, rows, 64) bf16, rows = sq * n
// ordered (query position, head); the latent cache (b, L, 512) and the rope
// key cache (b, L, 64): bf16 (no scales), one code per byte (fp8 e4m3, fp6
// e3m2 / e2m3, int8) with (b, L, w/32) uint8 scales, or fp4 halves-packed
// (b, L, w/2) bytes, byte j holding element j (high nibble) and element
// j + w/2 (low nibble); q_off, kv_len (b,) int32.  Output (b, rows, 512)
// bf16:  out = softmax(sm_scale * (q_lat . lat^T + q_rot . rot^T)) . lat,
// row (i, h) seeing positions <= q_off + i and < kv_len; masked scores are
// -1e30; the softmax is online over tiles of 32 positions, fp32, with p
// rounded to bf16 before the P.lat product; a row with no visible key
// outputs 0.
//
// What bounds it on an H100: at decode the cache bytes of the visible prefix
// (the latent is shared by all heads: 576 codes a position); at prefill the
// dots, 2 * rows * kv * (512 + 64 + 512) operations.  Design: one CTA of four
// warps per (16-row tile, batch row).  Each visible tile of 32 positions is
// decoded ONCE into shared memory as bf16 (the scale folds into the code,
// mx_common.cuh), and that one tile is both K and V.  Scores: warp w takes
// latent columns [128w, 128w + 128) and rope columns [16w, 16w + 16) of all
// 16 rows (mma.sync m16n8k16 bf16 -> fp32, q fragments in registers); the
// four partials meet in shared memory and are added in warp order.  The
// softmax: warp w owns rows 4w .. 4w + 3, one position a lane.  P.lat: warp
// w keeps output columns [128w, 128w + 128) in fp32 registers, B fragments
// by ldmatrix.trans straight from the decoded tile.  A row's arithmetic
// depends on its own positions only (tiles in position order, fully masked
// tiles change nothing), never on b or sq.  No KV split yet: decode at b=1
// runs one CTA.
#include "mx_common.cuh"

namespace {

constexpr int kR = 512;          // latent rank (kv_lora_rank)
constexpr int kDr = 64;          // rope key width (qk_rope_head_dim)
constexpr int kRows = 16;        // query rows per CTA (one m16 tile)
constexpr int kWarps = 4;
constexpr int kT = 32;           // KV positions per tile
constexpr int kCols = kR / kWarps;    // latent columns per warp
constexpr int kRotCols = kDr / kWarps;
constexpr int kLatPad = kR + 8;  // tile row strides (bf16): 16-byte rows for ldmatrix
constexpr int kRotPad = kDr + 8;
constexpr int kPPad = kT + 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Decode `width` values of one cached position into dst (bf16 bits): E < 0
// copies bf16, kFp4E2M1 reads halves-packed bytes, else one code per byte.
template <int E, int W>
__device__ __forceinline__ void decode_row(const uint8_t* __restrict__ data, const uint8_t* __restrict__ scale,
                                           uint16_t* dst, int v, bool live) {
  // v: the 16-byte vector of the row this thread decodes.
  if constexpr (E < 0) {
    uint4 d = live ? reinterpret_cast<const uint4*>(data)[v] : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dst + v * 8) = d;
  } else if constexpr (E == mx::kFp4E2M1) {
    uint4 d = live ? reinterpret_cast<const uint4*>(data)[v] : make_uint4(0, 0, 0, 0);
    const uint8_t* db = reinterpret_cast<const uint8_t*>(&d);
    const int j0 = v * 16;
    const int se_hi = live ? scale[j0 / 32] : 0, se_lo = live ? scale[(j0 + W / 2) / 32] : 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      dst[j0 + j] = live ? mx::decode_fp4(db[j] >> 4, se_hi) : 0;
      dst[j0 + W / 2 + j] = live ? mx::decode_fp4(db[j] & 0xF, se_lo) : 0;
    }
  } else {
    uint4 d = live ? reinterpret_cast<const uint4*>(data)[v] : make_uint4(0, 0, 0, 0);
    const uint8_t* db = reinterpret_cast<const uint8_t*>(&d);
    const int j0 = v * 16;
    const int se = live ? scale[j0 / 32] : 0;
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      const uint16_t a = live ? mx::decode_bf16_bits<E>(db[j], se) : 0;
      const uint16_t b = live ? mx::decode_bf16_bits<E>(db[j + 1], se) : 0;
      *reinterpret_cast<uint32_t*>(dst + j0 + j) = (uint32_t)a | ((uint32_t)b << 16);
    }
  }
}

// Bytes of one cached row of width W, and its 16-byte vectors.
template <int E, int W> struct RowGeom {
  static constexpr int bytes = E < 0 ? 2 * W : (E == mx::kFp4E2M1 ? W / 2 : W);
  static constexpr int vecs = bytes / 16;
};

template <int E>
__global__ void __launch_bounds__(kWarps * 32)
mla_kernel(const uint16_t* __restrict__ ql, const uint16_t* __restrict__ qr,
           const uint8_t* __restrict__ ld, const uint8_t* __restrict__ ls,
           const uint8_t* __restrict__ rd, const uint8_t* __restrict__ rs,
           const int* __restrict__ q_off_p, const int* __restrict__ kv_len_p,
           uint16_t* __restrict__ out, int rows_total, int n_heads, int L, float sm_scale,
           int v_from_rot) {
  __shared__ __align__(16) uint16_t Lat[kT][kLatPad];
  __shared__ __align__(16) uint16_t Rot[kT][kRotPad];
  __shared__ float Sp[kWarps][kRows][kT + 1];
  __shared__ __align__(16) uint16_t P[kRows][kPPad];
  __shared__ float alpha_s[kRows], l_s[kRows];

  using LG = RowGeom<E, kR>;
  using RG = RowGeom<E, kDr>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int ib = blockIdx.y;
  const int row_base = blockIdx.x * kRows;
  const int q_off = q_off_p[ib], kv_len = kv_len_p[ib];
  const uint8_t* ld_b = ld + (long long)ib * L * LG::bytes;
  const uint8_t* rd_b = rd + (long long)ib * L * RG::bytes;
  const uint8_t* ls_b = ls + (long long)ib * L * (kR / 32);
  const uint8_t* rs_b = rs + (long long)ib * L * (kDr / 32);

  // q fragments of this warp's score columns, rows g and g + 8.
  uint32_t qa[kCols / 16][4], qra[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + g + 8 * h;
    const bool ok = row < rows_total;
    const uint16_t* qlr = ql + ((long long)ib * rows_total + (ok ? row : 0)) * kR;
    const uint16_t* qrr = qr + ((long long)ib * rows_total + (ok ? row : 0)) * kDr;
#pragma unroll
    for (int kk = 0; kk < kCols / 16; ++kk) {
      const int c0 = warp * kCols + kk * 16 + 2 * t;
      qa[kk][h] = ok ? *reinterpret_cast<const uint32_t*>(qlr + c0) : 0u;
      qa[kk][2 + h] = ok ? *reinterpret_cast<const uint32_t*>(qlr + c0 + 8) : 0u;
    }
    const int c0 = warp * kRotCols + 2 * t;
    qra[h] = ok ? *reinterpret_cast<const uint32_t*>(qrr + c0) : 0u;
    qra[2 + h] = ok ? *reinterpret_cast<const uint32_t*>(qrr + c0 + 8) : 0u;
  }

  float o[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // Softmax state of the rows this warp owns (4 * warp + i), the same in every lane.
  float m_run[4], l_run[4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
    const int row = min(row_base + 4 * warp + i, rows_total - 1);
    qpos[i] = q_off + row / n_heads;
  }

  const int q_hi = q_off + (min(rows_total, row_base + kRows) - 1) / n_heads;
  const int kv_end = min(min(kv_len, q_hi + 1), L);

  for (int kt0 = 0; kt0 < kv_end; kt0 += kT) {
    // Decode the tile once: latent and rope key, positions past kv_len as 0.
    for (int c = tid; c < kT * (LG::vecs + RG::vecs); c += kWarps * 32) {
      const int p = c / (LG::vecs + RG::vecs), v = c % (LG::vecs + RG::vecs);
      const int pos = kt0 + p;
      const bool live = pos < kv_len;
      if (v < LG::vecs)
        decode_row<E, kR>(ld_b + (long long)pos * LG::bytes, ls_b + (long long)pos * (kR / 32), &Lat[p][0], v,
                          live);
      else
        decode_row<E, kDr>(rd_b + (long long)pos * RG::bytes, rs_b + (long long)pos * (kDr / 32), &Rot[p][0],
                           v - LG::vecs, live);
    }
    __syncthreads();

    // This warp's partial scores over its columns: 16 rows x 32 positions.
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        uint32_t b[2];
        const int c0 = warp * kCols + kk * 16 + 2 * t;
        b[0] = *reinterpret_cast<const uint32_t*>(&Lat[j * 8 + g][c0]);
        b[1] = *reinterpret_cast<const uint32_t*>(&Lat[j * 8 + g][c0 + 8]);
        mx::mma_bf16_16816(s, qa[kk], b);
      }
      uint32_t b[2];
      const int c0 = warp * kRotCols + 2 * t;
      b[0] = *reinterpret_cast<const uint32_t*>(&Rot[j * 8 + g][c0]);
      b[1] = *reinterpret_cast<const uint32_t*>(&Rot[j * 8 + g][c0 + 8]);
      mx::mma_bf16_16816(s, qra, b);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        Sp[warp][g][j * 8 + 2 * t + e] = s[e];
        Sp[warp][g + 8][j * 8 + 2 * t + e] = s[2 + e];
      }
    }
    __syncthreads();

    // Online softmax of the 4 rows this warp owns; lane = position in the tile.
    const int pos = kt0 + lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * warp + i;
      float v = __fadd_rn(__fadd_rn(__fadd_rn(Sp[0][r][lane], Sp[1][r][lane]), Sp[2][r][lane]), Sp[3][r][lane]);
      v = __fmul_rn(v, sm_scale);
      const bool valid = pos <= qpos[i] && pos < kv_len;
      v = valid ? v : kNegInf;
      const float m_new = fmaxf(m_run[i], mx::warp_max(v));
      const float alpha = expf(m_run[i] - m_new);
      const float p = valid ? expf(v - m_new) : 0.f;
      l_run[i] = __fadd_rn(__fmul_rn(l_run[i], alpha), mx::warp_sum(p));
      m_run[i] = m_new;
      P[r][lane] = __bfloat16_as_ushort(__float2bfloat16_rn(p));
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // O = O * alpha + bf16(P) . lat over this warp's output columns.
    const float a0 = alpha_s[g], a1 = alpha_s[g + 8];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = *reinterpret_cast<const uint32_t*>(&P[g][kk * 16 + 2 * t]);
      pa[1] = *reinterpret_cast<const uint32_t*>(&P[g + 8][kk * 16 + 2 * t]);
      pa[2] = *reinterpret_cast<const uint32_t*>(&P[g][kk * 16 + 2 * t + 8]);
      pa[3] = *reinterpret_cast<const uint32_t*>(&P[g + 8][kk * 16 + 2 * t + 8]);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        uint32_t b[2];
        const int col = warp * kCols + j * 8;
        if (v_from_rot)  // a planted fault for the model check: V read from the rope key
          mx::ldmatrix_x2_trans(b, &Rot[kk * 16 + (lane & 15)][col % kDr]);
        else
          mx::ldmatrix_x2_trans(b, &Lat[kk * 16 + (lane & 15)][col]);
        mx::mma_bf16_16816(o[j], pa, b);
      }
    }
    __syncthreads();
  }

  if (lane == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) l_s[4 * warp + i] = l_run[i];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + g + 8 * h;
    if (row >= rows_total) continue;
    const float l = l_s[g + 8 * h];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    uint16_t* orow = out + ((long long)ib * rows_total + row) * kR + warp * kCols + 2 * t;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) = pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
  }
}

template <int E>
cudaError_t run(const void* ql, const void* qr, const void* ld, const void* ls, const void* rd, const void* rs,
                const void* q_off, const void* kv_len, void* out, int b, int rows, int n, int L, float sm_scale,
                int v_from_rot, cudaStream_t stream) {
  dim3 grid((rows + kRows - 1) / kRows, b);
  mla_kernel<E><<<grid, kWarps * 32, 0, stream>>>(
      (const uint16_t*)ql, (const uint16_t*)qr, (const uint8_t*)ld, (const uint8_t*)ls, (const uint8_t*)rd,
      (const uint8_t*)rs, (const int*)q_off, (const int*)kv_len, (uint16_t*)out, rows, n, L, sm_scale, v_from_rot);
  return cudaGetLastError();
}

}  // namespace

// elem: -1 for a bf16 cache (ls / rs unused), else an mx::ElemCode.  r must
// be 512 and dr 64; L a multiple of 32; rows = sq * n.
extern "C" int mx_mla_attention_launch(const void* ql, const void* qr, const void* ld, const void* ls,
                                       const void* rd, const void* rs, const void* q_off, const void* kv_len,
                                       void* out, int b, int rows, int n, int L, int r, int dr, float sm_scale,
                                       int elem, int v_from_rot, void* stream) {
  if (r != kR || dr != kDr || L % kT || n <= 0 || rows % n) return (int)cudaErrorInvalidValue;
  if (b == 0 || rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case -1: return (int)run<-1>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, b, rows, n, L, sm_scale, v_from_rot, s);
    case mx::kFp8E4M3:
      return (int)run<mx::kFp8E4M3>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, b, rows, n, L, sm_scale, v_from_rot, s);
    case mx::kFp4E2M1:
      return (int)run<mx::kFp4E2M1>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, b, rows, n, L, sm_scale, v_from_rot, s);
    case mx::kFp6E3M2:
      return (int)run<mx::kFp6E3M2>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, b, rows, n, L, sm_scale, v_from_rot, s);
    case mx::kFp6E2M3:
      return (int)run<mx::kFp6E2M3>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, b, rows, n, L, sm_scale, v_from_rot, s);
    case mx::kInt8:
      return (int)run<mx::kInt8>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, b, rows, n, L, sm_scale, v_from_rot, s);
  }
  return (int)cudaErrorInvalidValue;
}
