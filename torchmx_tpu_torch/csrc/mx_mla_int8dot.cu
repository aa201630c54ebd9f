// B14 mx_mla_attention_int8dot: absorbed MLA decode (one query position per
// batch row) over an int8 latent cache in the d-major layout, both dots in
// int8.
//
// Replaces torchmx_tpu/ops/pallas_mla.py::_mla_kernel_int8dot (:343),
// launched by _mla_cached_attention_int8dot (:456); the wrapper
// (ops/cuda_mla.mx_mla_attention_int8dot) quantizes q as _mla_int8dot_attention
// (:513) does: int8 with one scale per row, sm_scale folded into the f32 row
// scales.
//
// Inputs: q_lat codes (b, n, 512) int8 and scales (b, n) f32; q_rot codes
// (b, n, 64) int8 and scales (b, n) f32; the latent (b, 512, L) and rope key
// (b, 64, L) int8 codes, the sequence on the last axis, with per-position
// E8M0 scales (b, L) uint8 (one exponent over a position's whole latent, and
// one over its rope key); q_off, kv_len (b,) int32.  Output (b, n, 512)
// bf16.  With pk(e) the float whose bits are e << 23 (0 gives +0.0, 255
// +inf), for head r and position j:
//   s[r,j]  = (dot(ql[r], lat[:,j]) * qlsc[r]) * pk(el[j])
//           + (dot(qr[r], rot[:,j]) * qrsc[r]) * pk(er[j])      exact int32 dots
//   j is visible when j <= q_off and j < kv_len; online softmax in fp32
//   per tile of 32 positions:  p3 = p * pk(el[j]),  mx = max_j p3 (1 where
//   0),  pq = round_half_even(p3 * (127 / mx)) as int8,  pv = pq . lat^T
//   (exact int32),  acc = acc * alpha + pv * (mx * (1/127))
// and the output is acc / l (l = 1 where 0).  A hidden position is skipped
// (p3 = 0), never multiplied by its scale: the JAX kernel multiplies (p *
// pk_l, :439), so a stale 255 scale past the prefix gives 0 * inf = NaN
// there; this kernel and its plain version do not.
//
// What bounds it on an H100: the cache bytes of the visible prefix (578 per
// position: 576 codes and two scales); the integer work is small.  Design:
// one CTA of four warps per (16 heads, batch row).  Each tile of 32
// positions is read once into shared memory in both orientations: as it is
// (latent dim, position), the B operand of P.lat, and transposed by 4x4 byte
// blocks (__byte_perm) into (position, latent dim), the B operand of the
// scores.  Scores: warp w takes latent dims [128w, 128w + 128) and warps 0-1
// the rope dims [32w, 32w + 32), mma.sync m16n8k32 s8 -> exact int32, summed
// across warps by shared-memory atomics (exact in any order).  The softmax
// and the requantization of p: warp w owns heads 4w .. 4w + 3, one position
// a lane.  P.lat: warp w keeps output dims [128w, 128w + 128) in fp32
// registers, one exact int32 mma per tile.
#include "mx_common.cuh"

namespace {

constexpr int kR = 512;          // latent rank
constexpr int kDr = 64;          // rope key width
constexpr int kRows = 16;        // heads per CTA
constexpr int kWarps = 4;
constexpr int kT = 32;           // positions per tile
constexpr int kCols = kR / kWarps;
constexpr int kTPad = kR + 4;    // LatT row stride (bytes)
constexpr int kRTPad = kDr + 4;  // RotT row stride
constexpr int kDPad = kT + 4;    // LatD row stride
constexpr float kNegInf = -1e30f;

using mx::pow2_scale;

__global__ void __launch_bounds__(kWarps * 32)
mla_int8dot_kernel(const int8_t* __restrict__ qld, const float* __restrict__ qlsc, const int8_t* __restrict__ qrd,
                   const float* __restrict__ qrsc, const int8_t* __restrict__ ld, const uint8_t* __restrict__ ls,
                   const int8_t* __restrict__ rd, const uint8_t* __restrict__ rs,
                   const int* __restrict__ q_off_p, const int* __restrict__ kv_len_p, uint16_t* __restrict__ out,
                   int n, int L) {
  __shared__ __align__(16) int8_t LatT[kT][kTPad];   // (position, latent dim)
  __shared__ __align__(16) int8_t RotT[kT][kRTPad];  // (position, rope dim)
  __shared__ __align__(16) int8_t LatD[kR][kDPad];   // (latent dim, position)
  __shared__ int Sl[kRows][kT + 1];   // exact int32 scores, summed over the warps
  __shared__ int Sr[kRows][kT + 1];
  __shared__ __align__(16) int8_t PQ[kRows][kT + 4];
  __shared__ float pkl[kT], pkr[kT], alpha_s[kRows], fac_s[kRows], l_s[kRows];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int ib = blockIdx.y, head0 = blockIdx.x * kRows;
  const int q_off = q_off_p[ib], kv_len = kv_len_p[ib];
  const int kv_end = min(min(kv_len, q_off + 1), L);
  const int8_t* ld_b = ld + (long long)ib * kR * L;
  const int8_t* rd_b = rd + (long long)ib * kDr * L;

  // q fragments (m16n8k32 s8): this warp's latent dims and, in warps 0-1, rope dims.
  uint32_t qa[kCols / 32][4], qra[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int head = head0 + g + 8 * h;
    const bool ok = head < n;
    const int8_t* qlr = qld + ((long long)ib * n + (ok ? head : 0)) * kR;
    const int8_t* qrr = qrd + ((long long)ib * n + (ok ? head : 0)) * kDr;
#pragma unroll
    for (int kk = 0; kk < kCols / 32; ++kk) {
      const int c0 = warp * kCols + kk * 32 + 4 * t;
      qa[kk][h] = ok ? *reinterpret_cast<const uint32_t*>(qlr + c0) : 0u;
      qa[kk][2 + h] = ok ? *reinterpret_cast<const uint32_t*>(qlr + c0 + 16) : 0u;
    }
    const int c0 = (warp & 1) * 32 + 4 * t;
    qra[h] = ok && warp < 2 ? *reinterpret_cast<const uint32_t*>(qrr + c0) : 0u;
    qra[2 + h] = ok && warp < 2 ? *reinterpret_cast<const uint32_t*>(qrr + c0 + 16) : 0u;
  }
  // Row scales of the 4 heads this warp owns.
  float m_run[4], l_run[4], sl[4], sr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int head = min(head0 + 4 * warp + i, n - 1);
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
    sl[i] = qlsc[(long long)ib * n + head];
    sr[i] = qrsc[(long long)ib * n + head];
  }
  float acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt0 = 0; kt0 < kv_end; kt0 += kT) {
    // Load the tile: 4 dims x 4 positions a step, kept as read and transposed.
    for (int c = tid; c < (kR + kDr) / 4 * (kT / 4); c += kWarps * 32) {
      const int d4 = c / (kT / 4), p4 = (c % (kT / 4)) * 4;
      const bool rot = d4 >= kR / 4;
      const int d0 = (rot ? d4 - kR / 4 : d4) * 4;
      const int8_t* src = (rot ? rd_b : ld_b) + (long long)d0 * L + kt0 + p4;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t v = *reinterpret_cast<const uint32_t*>(src + (long long)i * L);
#pragma unroll
        for (int j = 0; j < 4; ++j)  // positions at or past kv_len read as 0
          if (kt0 + p4 + j >= kv_len) v &= ~(0xFFu << (8 * j));
        w[i] = v;
        if (!rot) *reinterpret_cast<uint32_t*>(&LatD[d0 + i][p4]) = v;
      }
      mx::transpose_4x4_bytes(w);  // w[j]: position p4 + j, dims d0 .. d0 + 3
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (rot)
          *reinterpret_cast<uint32_t*>(&RotT[p4 + j][d0]) = w[j];
        else
          *reinterpret_cast<uint32_t*>(&LatT[p4 + j][d0]) = w[j];
      }
    }
    for (int c = tid; c < kRows * (kT + 1); c += kWarps * 32) {
      (&Sl[0][0])[c] = 0;
      (&Sr[0][0])[c] = 0;
    }
    if (tid < kT) {
      const int pos = kt0 + tid;
      pkl[tid] = pow2_scale(ls[(long long)ib * L + pos]);
      pkr[tid] = pow2_scale(rs[(long long)ib * L + pos]);
    }
    __syncthreads();

    // Exact int32 partial scores of this warp's dims: 16 heads x 32 positions.
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      int s[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < kCols / 32; ++kk) {
        uint32_t b[2];
        const int c0 = warp * kCols + kk * 32 + 4 * t;
        b[0] = *reinterpret_cast<const uint32_t*>(&LatT[j * 8 + g][c0]);
        b[1] = *reinterpret_cast<const uint32_t*>(&LatT[j * 8 + g][c0 + 16]);
        int c[4];
        mx::mma_s8_16832(c, qa[kk], b);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += c[e];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // integer sums: the same in any order
        atomicAdd(&Sl[g][j * 8 + 2 * t + e], s[e]);
        atomicAdd(&Sl[g + 8][j * 8 + 2 * t + e], s[2 + e]);
      }
      if (warp < 2) {
        uint32_t b[2];
        const int c0 = warp * 32 + 4 * t;
        b[0] = *reinterpret_cast<const uint32_t*>(&RotT[j * 8 + g][c0]);
        b[1] = *reinterpret_cast<const uint32_t*>(&RotT[j * 8 + g][c0 + 16]);
        int c[4];
        mx::mma_s8_16832(c, qra, b);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          atomicAdd(&Sr[g][j * 8 + 2 * t + e], c[e]);
          atomicAdd(&Sr[g + 8][j * 8 + 2 * t + e], c[2 + e]);
        }
      }
    }
    __syncthreads();

    // Online softmax and the requantization of p, 4 heads per warp, lane = position.
    const int pos = kt0 + lane;
    const bool valid = pos <= q_off && pos < kv_len;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * warp + i;
      const int si = Sl[r][lane], sri = Sr[r][lane];
      float v = __fadd_rn(__fmul_rn(__fmul_rn((float)si, sl[i]), pkl[lane]),
                          __fmul_rn(__fmul_rn((float)sri, sr[i]), pkr[lane]));
      v = valid ? v : kNegInf;
      const float m_new = fmaxf(m_run[i], mx::warp_max(v));
      const float alpha = expf(m_run[i] - m_new);
      const float p = valid ? expf(v - m_new) : 0.f;
      l_run[i] = __fadd_rn(__fmul_rn(l_run[i], alpha), mx::warp_sum(p));
      m_run[i] = m_new;
      const float p3 = valid ? __fmul_rn(p, pkl[lane]) : 0.f;
      float mxv = mx::warp_max(p3);
      mxv = mxv == 0.f ? 1.f : mxv;
      PQ[r][lane] = (int8_t)(int)rintf(__fmul_rn(p3, __fdiv_rn(127.f, mxv)));
      if (lane == 0) {
        alpha_s[r] = alpha;
        fac_s[r] = __fmul_rn(mxv, 1.f / 127.f);
      }
    }
    __syncthreads();

    // acc = acc * alpha + (pq . lat^T) * (mx / 127), exact int32 products.
    uint32_t pa[4];
    pa[0] = *reinterpret_cast<const uint32_t*>(&PQ[g][4 * t]);
    pa[1] = *reinterpret_cast<const uint32_t*>(&PQ[g + 8][4 * t]);
    pa[2] = *reinterpret_cast<const uint32_t*>(&PQ[g][16 + 4 * t]);
    pa[3] = *reinterpret_cast<const uint32_t*>(&PQ[g + 8][16 + 4 * t]);
    const float al0 = alpha_s[g], al1 = alpha_s[g + 8], f0 = fac_s[g], f1 = fac_s[g + 8];
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      uint32_t b[2];
      const int d = warp * kCols + j * 8 + g;
      b[0] = *reinterpret_cast<const uint32_t*>(&LatD[d][4 * t]);
      b[1] = *reinterpret_cast<const uint32_t*>(&LatD[d][16 + 4 * t]);
      int c[4];
      mx::mma_s8_16832(c, pa, b);
      acc[j][0] = __fadd_rn(__fmul_rn(acc[j][0], al0), __fmul_rn((float)c[0], f0));
      acc[j][1] = __fadd_rn(__fmul_rn(acc[j][1], al0), __fmul_rn((float)c[1], f0));
      acc[j][2] = __fadd_rn(__fmul_rn(acc[j][2], al1), __fmul_rn((float)c[2], f1));
      acc[j][3] = __fadd_rn(__fmul_rn(acc[j][3], al1), __fmul_rn((float)c[3], f1));
    }
    __syncthreads();
  }

  if (lane == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) l_s[4 * warp + i] = l_run[i];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int head = head0 + g + 8 * h;
    if (head >= n) continue;
    float l = l_s[g + 8 * h];
    l = l == 0.f ? 1.f : l;
    uint16_t* orow = out + ((long long)ib * n + head) * kR + warp * kCols + 2 * t;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      __nv_bfloat162 v = __floats2bfloat162_rn(__fdiv_rn(acc[j][2 * h], l), __fdiv_rn(acc[j][2 * h + 1], l));
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = v;
    }
  }
}

}  // namespace

// r must be 512 and dr 64, L a multiple of 32.
extern "C" int mx_mla_attention_int8dot_launch(const void* qld, const void* qlsc, const void* qrd, const void* qrsc,
                                               const void* ld, const void* ls, const void* rd, const void* rs,
                                               const void* q_off, const void* kv_len, void* out, int b, int n,
                                               int L, int r, int dr, void* stream) {
  if (r != kR || dr != kDr || L % kT || n <= 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  dim3 grid((n + kRows - 1) / kRows, b);
  mla_int8dot_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)qld, (const float*)qlsc, (const int8_t*)qrd, (const float*)qrsc, (const int8_t*)ld,
      (const uint8_t*)ls, (const int8_t*)rd, (const uint8_t*)rs, (const int*)q_off, (const int*)kv_len,
      (uint16_t*)out, n, L);
  return cudaGetLastError();
}
