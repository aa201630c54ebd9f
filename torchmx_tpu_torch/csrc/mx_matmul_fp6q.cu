// B8 mx_matmul_fp6q: out (M, N) bf16 = fq(x) (M, K) @ W (K, N) with W MXFP6
// (e3m2 or e2m3) in the planar "quarters" layout: three byte planes P0, P1,
// P2 of K/4 rows each (rows [0, K/4), [K/4, K/2), [K/2, 3K/4) of w) hold the
// 6-bit codes q0..q3 of the four K quarters as
//   P0 = q0 << 2 | q3 >> 4,  P1 = q1 << 2 | (q3 >> 2) & 3,  P2 = q2 << 2 | q3 & 3
// (4 codes per 3 bytes); scale (K/32, N), rows [i K/128, (i+1) K/128) for
// quarter i.
//
// Replaces torchmx_tpu/ops/pallas_matmul.py::_linear_kernel_fp6q (:568),
// launched by _pallas_matmul_fp6q (:699).
//
// What bounds it on an H100: at decode the weight bytes (3/4 K*N + K*N/32),
// a quarter less than one byte per code; at prefill the tensor-core
// operations.  Design: B6's (csrc/mx_matmul_1byte.cu) with 128 K elements
// per iteration: 32 rows of each plane give one 32-element MX block of each
// quarter; the four codes of a (row, column) are rebuilt with shifts, each
// quarter decoded against its own scale row (mx::decode_code_dot), and x
// is read as four contiguous 32-column slices, one per quarter, like K3
// reads two halves.  Per-block partial products added in block order, K
// split over blockIdx.z, a second kernel sums the splits in order.  Tiles of
// 16 or 64 rows (the 128-element K tile keeps both in 48 KB of static
// shared memory).
#include "mx_common.cuh"

namespace {

constexpr int kKTile = 128;       // K elements per iteration: one block of each quarter
constexpr int kPad = kKTile + 8;  // smem row stride in bf16
constexpr int BN = 64;

__device__ __forceinline__ uint16_t decode_fp6(int elem, int code, int se) {
  return elem == mx::kFp6E3M2 ? mx::decode_bf16_bits<mx::kFp6E3M2>(code, se)
                              : mx::decode_bf16_bits<mx::kFp6E2M3>(code, se);
}

template <int BM, int WM, int WN, int ACT>
__global__ void __launch_bounds__(WM * WN * 32)
matmul_fp6q_kernel(const uint16_t* __restrict__ x, const uint8_t* __restrict__ w,
                   const uint8_t* __restrict__ scale, uint16_t* __restrict__ out,
                   float* __restrict__ ws, int M, int N, int K, int splits, int elem) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int kWarps = WM * WN;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  constexpr int A = ACT < 0 ? 0 : ACT;
  __shared__ __align__(16) uint16_t Xs[BM][kPad];
  __shared__ __align__(16) uint16_t Ws[BN][kPad];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, t = lane % 4;
  const int n_base = blockIdx.x * BN, m_base = blockIdx.y * BM;
  const int quarter = K / 4;
  const int iters = quarter / 32;
  const int per = (iters + splits - 1) / splits;
  const int it0 = blockIdx.z * per, it1 = min(iters, it0 + per);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int it = it0; it < it1; ++it) {
    const int p0 = it * 32;
    // x: BM rows x four 32-element blocks (one per quarter), one warp per (row, block).
    for (int rb = warp; rb < BM * 4; rb += kWarps) {
      int row = rb / 4, q = rb % 4;
      int m = m_base + row;
      int bits = m < M ? x[(long long)m * K + q * quarter + p0 + lane] : 0;
      if (ACT >= 0) {
        int emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)((bits >> 7) & 0xFF));
        bits = mx::fq_magic<A>(bits, mx::block_scale(emax, mx::Elem<A>::max_pow2));
      }
      Xs[row][q * 32 + lane] = (uint16_t)bits;
    }
    // W: 32 rows of each plane x BN columns, 16 columns per thread per step.
    for (int c = tid; c < 32 * BN / 16; c += kThreads) {
      int r = c / (BN / 16), n0 = (c % (BN / 16)) * 16;
      int n = n_base + n0;
      uint4 pb[3], sb[4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        pb[p] = *reinterpret_cast<const uint4*>(w + (long long)(p * quarter + p0 + r) * N + n);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sb[q] = *reinterpret_cast<const uint4*>(scale + (long long)(q * (quarter / 32) + p0 / 32) * N + n);
      const uint8_t* b0 = reinterpret_cast<const uint8_t*>(&pb[0]);
      const uint8_t* b1 = reinterpret_cast<const uint8_t*>(&pb[1]);
      const uint8_t* b2 = reinterpret_cast<const uint8_t*>(&pb[2]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        int q3 = ((b0[j] & 3) << 4) | ((b1[j] & 3) << 2) | (b2[j] & 3);
        Ws[n0 + j][r] = decode_fp6(elem, b0[j] >> 2, reinterpret_cast<const uint8_t*>(&sb[0])[j]);
        Ws[n0 + j][32 + r] = decode_fp6(elem, b1[j] >> 2, reinterpret_cast<const uint8_t*>(&sb[1])[j]);
        Ws[n0 + j][64 + r] = decode_fp6(elem, b2[j] >> 2, reinterpret_cast<const uint8_t*>(&sb[2])[j]);
        Ws[n0 + j][96 + r] = decode_fp6(elem, q3, reinterpret_cast<const uint8_t*>(&sb[3])[j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) {
      float part[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int c0 = blk * 32 + kk * 16 + 2 * t;
        uint32_t a[MT][4], b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          int r0 = wm * WTM + i * 16 + g;
          a[i][0] = *reinterpret_cast<const uint32_t*>(&Xs[r0][c0]);
          a[i][1] = *reinterpret_cast<const uint32_t*>(&Xs[r0 + 8][c0]);
          a[i][2] = *reinterpret_cast<const uint32_t*>(&Xs[r0][c0 + 8]);
          a[i][3] = *reinterpret_cast<const uint32_t*>(&Xs[r0 + 8][c0 + 8]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          int n0 = wn * WTN + j * 8 + g;
          b[j][0] = *reinterpret_cast<const uint32_t*>(&Ws[n0][c0]);
          b[j][1] = *reinterpret_cast<const uint32_t*>(&Ws[n0][c0 + 8]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mx::mma_bf16_16816(part[i][j], a[i], b[j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int m = m_base + wm * WTM + i * 16 + g + h * 8;
        int n = n_base + wn * WTN + j * 8 + 2 * t;
        if (m >= M) continue;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * N + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(ws + ((long long)blockIdx.z * M + m) * N + n) = make_float2(v0, v1);
        }
      }
}

__global__ void reduce_splits_fp6q_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out,
                                          long long mn, int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int BM, int WM, int WN, int ACT>
cudaError_t run(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N,
                int K, int elem, int splits, cudaStream_t stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  matmul_fp6q_kernel<BM, WM, WN, ACT><<<grid, WM * WN * 32, 0, stream>>>(
      (const uint16_t*)x, (const uint8_t*)w, (const uint8_t*)scale, (uint16_t*)out, (float*)ws, M, N,
      K, splits, elem);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  long long mn = (long long)M * N;
  reduce_splits_fp6q_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>((const float*)ws,
                                                                             (uint16_t*)out, mn, splits);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t dispatch_tile(const void* x, const void* w, const void* scale, void* out, void* ws, int M,
                          int N, int K, int elem, int bm, int splits, cudaStream_t s) {
  switch (bm) {
    case 16: return run<16, 1, 4, ACT>(x, w, scale, out, ws, M, N, K, elem, splits, s);
    case 64: return run<64, 2, 2, ACT>(x, w, scale, out, ws, M, N, K, elem, splits, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// elem: mx::kFp6E3M2 or kFp6E2M3.  act_fq: -1 for none or mx::kFp8E4M3.
// bm: 16 or 64 (64-column tiles).  w: the (3K/4, N) planes.
extern "C" int mx_matmul_fp6q_launch(const void* x, const void* w, const void* scale, void* out,
                                     void* ws, int M, int N, int K, int elem, int act_fq, int bm,
                                     int splits, void* stream) {
  if (M == 0) return 0;
  if (elem != mx::kFp6E3M2 && elem != mx::kFp6E2M3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (act_fq) {
    case -1: return dispatch_tile<-1>(x, w, scale, out, ws, M, N, K, elem, bm, splits, s);
    case mx::kFp8E4M3: return dispatch_tile<mx::kFp8E4M3>(x, w, scale, out, ws, M, N, K, elem, bm, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}
