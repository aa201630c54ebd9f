// K7 mx_cached_attention_int8dot: decode attention (one query position per
// batch row) over an int8 MX KV cache in the d-major layout, with both dots
// taken in int8: q arrives MXINT8-quantized, p is requantized to 8 bits.
//
// Replaces torchmx_tpu/ops/pallas_attention.py::_attn_kernel_int8dot (:638),
// launched by _mx_cached_attention_int8dot (:754); the wrapper
// (ops/cuda_attention.mx_cached_attention_int8dot) quantizes q with K1, as
// _int8dot_attention (:796) does with quantize_mx: the codes are K1's, bit
// for bit, and this kernel only reads them.
//
// Inputs: q codes (b, hkv, G, d) int8 and scales (b, hkv, G, d/32) uint8 for
// the G = hq / hkv query rows of a KV head; K/V codes (b, hkv, d, L) int8 and
// scales (b, hkv, d/32, L) uint8, the sequence on the last axis; q_off,
// kv_len (b,) int32.  Output (b, hq, 1, d) bf16.  For row r, position j and
// the d/32 chunks c, a scale being the float whose bits are e << 23 (0 gives
// +0.0, 255 gives +inf):
//   dots[c,r,j] = q_c[r] . k_c[j]                       exact int32
//   s[r,j]      = sm_scale * sum_c dots * 2^(eq[c,r]-127) * 2^(ek[c,j]-127)
//   j is visible when j <= q_off and j < kv_len; online softmax in fp32
//   p3[c,r,j]   = p[r,j] * 2^(ev[c,j]-127)
//   per KV tile of 128 positions:  mx[c,r] = max_j p3 (1 where 0),
//   pq = round_half_even(p3 * (127 / mx)) as int8,  pv[c,r,:] = pq . v_c (exact
//   int32),  acc = acc * alpha + pv * (mx * (1/127))
// and the output is acc / l (l = 1 where 0): a row with no visible key gives
// 0.  A hidden position is skipped, never multiplied by 0: a stale scale of
// 255 past the prefix cannot turn into 0 * inf.
//
// What bounds it on an H100: the cache bytes of the visible prefix (264 bytes
// per position and KV head); the integer work is small (128 dp4a per position
// and query row).  Design: a warp takes one KV tile of 128 positions at a
// time, each lane 4 consecutive positions, so every load of a d-row is one
// 4-byte word per lane, 128 contiguous bytes per warp.  q.K^T contracts over
// d, the strided axis: four d-rows of four positions are turned by a 4x4 byte
// transpose (__byte_perm) into four words of four consecutive d each, which
// dp4a takes against q's words from shared memory.  P.V contracts over
// positions, the contiguous axis: a lane's V word goes into dp4a as it is,
// against the lane's four requantized p; the 32 partial sums of a chunk's
// 32 d-rows are then reduced across the warp jointly, in 31 shuffles, after
// which lane i holds element i of the chunk.  Row maxima for the softmax and
// for mx are warp reductions; p, pq and the fp32 output stay in registers.
// The tiles of a (batch row, KV head) pair are dealt round-robin to the 8
// warps of `splits` CTAs and merged in a fixed order (mx_common.cuh): no
// atomics, the result is deterministic and depends on shapes only.  pq does
// not depend on the running maximum a warp has seen (p3 and mx scale
// together), so the plain version, which takes the same tiles in sequence,
// differs only in fp32 rounding and in ties of pq.
#include "mx_common.cuh"

namespace {

constexpr int kD = 128;        // head_dim
constexpr int kNc = kD / 32;   // chunks
constexpr int kTile = 128;     // KV positions per warp step: 32 lanes x 4
constexpr int kWarps = 8;      // warps per CTA
constexpr int kPart = kD + 2;  // a partial: d outputs, running max, running sum
constexpr float kNegInf = -1e30f;

using mx::pow2_scale;
using mx::warp_max;
using mx::warp_sum;

// Sum each of the 32 values of v over the warp; lane i returns the sum of v[i].
__device__ __forceinline__ int warp_sum_32(int* v, int lane) {
  mx::halve<32>(v, lane & 16, 16);
  mx::halve<16>(v, lane & 8, 8);
  mx::halve<8>(v, lane & 4, 4);
  mx::halve<4>(v, lane & 2, 2);
  mx::halve<2>(v, lane & 1, 1);
  return v[0];
}

template <int G>
__global__ void __launch_bounds__(kWarps * 32)
int8dot_kernel(const int8_t* __restrict__ qd, const uint8_t* __restrict__ qs,
               const int8_t* __restrict__ kd, const uint8_t* __restrict__ ks,
               const int8_t* __restrict__ vd, const uint8_t* __restrict__ vs,
               const int* __restrict__ q_off_p, const int* __restrict__ kv_len_p,
               uint16_t* __restrict__ out, float* __restrict__ ws, int hkv, int L,
               float sm_scale) {
  __shared__ int qw[G][kD / 4];      // q codes, four consecutive d per word
  __shared__ float qsc[G][kNc];      // q scales as floats
  __shared__ float part[kWarps][G][kPart];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sp = blockIdx.x, splits = gridDim.x, ih = blockIdx.y, ib = blockIdx.z;
  const int kv_end = min(min(kv_len_p[ib], q_off_p[ib] + 1), L);
  const long long kv_head = (long long)ib * hkv + ih;
  const int8_t* kd_h = kd + kv_head * kD * L;
  const int8_t* vd_h = vd + kv_head * kD * L;
  const uint8_t* ks_h = ks + kv_head * kNc * L;
  const uint8_t* vs_h = vs + kv_head * kNc * L;

  for (int i = threadIdx.x; i < G * (kD / 4); i += kWarps * 32)
    qw[i / (kD / 4)][i % (kD / 4)] = reinterpret_cast<const int*>(qd + kv_head * G * kD)[i];
  for (int i = threadIdx.x; i < G * kNc; i += kWarps * 32)
    qsc[i / kNc][i % kNc] = pow2_scale(qs[kv_head * G * kNc + i]);
  __syncthreads();

  // Lane i keeps element c * 32 + i of every chunk c of every row's output.
  float acc[kNc][G], m_run[G], l_run[G];  // l_run: this lane's share of the sum
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc[c][r] = 0.f;
  }

  const int unit = sp * kWarps + warp, units = splits * kWarps;
  for (int t0 = unit * kTile; t0 < kv_end; t0 += units * kTile) {
    const int p0 = t0 + 4 * lane;      // this lane's positions p0 .. p0 + 3
    const bool live = p0 < kv_end;     // lanes wholly past the prefix load nothing

    // Scores: per chunk, exact int32 dots, then the two scales.
    float s[4][G];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < G; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      int dot[4][G];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < G; ++r) dot[j][r] = 0;
      uint32_t kw[8][4];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        kw[i / 4][i % 4] =
            live ? *reinterpret_cast<const uint32_t*>(kd_h + (long long)(c * 32 + i) * L + p0) : 0u;
#pragma unroll
      for (int gq = 0; gq < 8; ++gq) {
        mx::transpose_4x4_bytes(kw[gq]);  // kw[gq][j]: position p0 + j, d = c*32 + gq*4 .. +3
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const int qv = qw[r][c * 8 + gq];
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[j][r] = __dp4a((int)kw[gq][j], qv, dot[j][r]);
        }
      }
      const uint32_t ksw = live ? *reinterpret_cast<const uint32_t*>(ks_h + (long long)c * L + p0) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ksc = pow2_scale((ksw >> (8 * j)) & 0xFF);
#pragma unroll
        for (int r = 0; r < G; ++r) s[j][r] += (float)dot[j][r] * qsc[r][c] * ksc;
      }
    }

    // Online softmax over the tile (fp32); p replaces s.
    float alpha[G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float mloc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][r] = p0 + j < kv_end ? s[j][r] * sm_scale : kNegInf;
        mloc = fmaxf(mloc, s[j][r]);
      }
      const float m_new = fmaxf(m_run[r], warp_max(mloc));
      alpha[r] = expf(m_run[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][r] = p0 + j < kv_end ? expf(s[j][r] - m_new) : 0.f;
        psum += s[j][r];
      }
      l_run[r] = l_run[r] * alpha[r] + psum;
      m_run[r] = m_new;
    }

    // Per chunk: fold the V scale into p, requantize against the tile's
    // maximum, and take P.V in int8.
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      const uint32_t vsw = live ? *reinterpret_cast<const uint32_t*>(vs_h + (long long)c * L + p0) : 0u;
      int vw[32];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        vw[i] = live ? *reinterpret_cast<const int*>(vd_h + (long long)(c * 32 + i) * L + p0) : 0;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float p3[4], mloc = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p3[j] = p0 + j < kv_end ? s[j][r] * pow2_scale((vsw >> (8 * j)) & 0xFF) : 0.f;
          mloc = fmaxf(mloc, p3[j]);
        }
        float mx_cr = warp_max(mloc);
        mx_cr = mx_cr == 0.f ? 1.f : mx_cr;
        const float inv = 127.f / mx_cr;
        uint32_t pq = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) pq |= (uint32_t)(__float2int_rn(p3[j] * inv) & 0xFF) << (8 * j);
        int part_sum[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) part_sum[i] = __dp4a(vw[i], (int)pq, 0);
        const int pv = warp_sum_32(part_sum, lane);
        acc[c][r] = acc[c][r] * alpha[r] + (float)pv * (mx_cr * (1.f / 127.f));
      }
    }
  }

  // Merge the CTA's warps in warp order.
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const float l = warp_sum(l_run[r]);
#pragma unroll
    for (int c = 0; c < kNc; ++c) part[warp][r][c * 32 + lane] = acc[c][r];
    if (lane == 0) {
      part[warp][r][kD] = m_run[r];
      part[warp][r][kD + 1] = l;
    }
  }
  __syncthreads();
  mx::merge_warps<G, kWarps, kD>(part, out + kv_head * G * kD,
                                 splits == 1 ? nullptr : ws + (kv_head * splits + sp) * G * kPart);
}

template <int G>
cudaError_t run(const void* qd, const void* qs, const void* kd, const void* ks, const void* vd,
                const void* vs, const void* q_off, const void* kv_len, void* out, void* ws, int b,
                int hkv, int L, float sm_scale, int splits, cudaStream_t stream) {
  int8dot_kernel<G><<<dim3(splits, hkv, b), kWarps * 32, 0, stream>>>(
      (const int8_t*)qd, (const uint8_t*)qs, (const int8_t*)kd, (const uint8_t*)ks,
      (const int8_t*)vd, (const uint8_t*)vs, (const int*)q_off, (const int*)kv_len, (uint16_t*)out,
      (float*)ws, hkv, L, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  mx::merge_splits_kernel<kD><<<dim3(hkv, b), kD, 0, stream>>>((const float*)ws, (uint16_t*)out, G,
                                                              splits);
  return cudaGetLastError();
}

}  // namespace

// ws: fp32 scratch of b * hkv * splits * (hq / hkv) * (d + 2) elements (unused
// when splits == 1).  hq / hkv is 1, 2, 4 or 8; L % 128 == 0.
extern "C" int mx_cached_attention_int8dot_launch(const void* qd, const void* qs, const void* kd,
                                                  const void* ks, const void* vd, const void* vs,
                                                  const void* q_off, const void* kv_len, void* out,
                                                  void* ws, int b, int hq, int hkv, int L, int d,
                                                  float sm_scale, int splits, void* stream) {
  if (d != kD || hkv <= 0 || hq % hkv || splits < 1 || L < 1 || L % kTile)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hq / hkv) {
    case 1: return run<1>(qd, qs, kd, ks, vd, vs, q_off, kv_len, out, ws, b, hkv, L, sm_scale, splits, s);
    case 2: return run<2>(qd, qs, kd, ks, vd, vs, q_off, kv_len, out, ws, b, hkv, L, sm_scale, splits, s);
    case 4: return run<4>(qd, qs, kd, ks, vd, vs, q_off, kv_len, out, ws, b, hkv, L, sm_scale, splits, s);
    case 8: return run<8>(qd, qs, kd, ks, vd, vs, q_off, kv_len, out, ws, b, hkv, L, sm_scale, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}
