// B9 mx_matmul_int8dot (and mx_matmul_fp8dot): out (M, N) bf16 from x and W
// both as MX codes: xc (M, K) int8 (or e4m3) codes with E8M0 scales sx
// (M, K/32), W (K, N) int8 (or e4m3) codes with scales sw (K/32, N):
//   out[m][n] = sum over blocks b of dot32(xc[m, b], W[b, n]) * 2^(sx-127) * 2^(sw-127)
// The wrapper (ops/cuda_matmul_formats.py) quantizes a bf16 x with K1.
//
// Replaces torchmx_tpu/ops/pallas_matmul.py::_int8dot_kernel (:728),
// launched by _pallas_matmul_int8dot (:810), with fp8=False and True.
//
// What bounds it on an H100: at decode the weight bytes (K*N + K*N/32);
// the operations (2*M*N*K at 1979 dense int8 / fp8 TOP/s) only near M =
// 256, the largest M it is given.  Design: one 32-element MX block is one
// mma.sync m16n8k32 (s8 x s8 -> s32: an exact int32 block sum; e4m3 x e4m3
// -> f32 from a zero accumulator), so no code is decoded at all.  Each
// block sum is converted to f32, multiplied by px[m] = 2^(sx-127) and then
// by pw[n] = 2^(sw-127) (f32 factors built from the exponent bits; scale
// byte 0 gives +0, as the JAX kernel documents at :783-792) and added to the
// f32 accumulator in block order.  K tiles of 64 (two blocks), split over
// blockIdx.z by ops/cuda_matmul._plan, partials summed in split order: the
// order B6 (csrc/mx_matmul_1byte.cu) adds its per-block partials in, so an
// int8 row gets the same bytes from either kernel.  Tiles of 16 or 64 rows
// (M <= 256) by 64 columns; W is staged in shared memory transposed to
// [n][k] bytes (a 4x4 byte transpose per thread) so that each B fragment
// register holds four consecutive k of one column.
#include "mx_common.cuh"

namespace {

constexpr int kKTile = 64;           // K elements per iteration: two MX blocks
constexpr int kWords = kKTile / 4;   // 32-bit words per row of a tile
constexpr int kStride = kWords + 4;  // smem row stride in words: conflict-free fragment loads
constexpr int BN = 64;

template <int BM, int WM, int WN, bool FP8>
__global__ void __launch_bounds__(WM * WN * 32)
matmul_int8dot_kernel(const uint8_t* __restrict__ xc, const uint8_t* __restrict__ sx,
                      const uint8_t* __restrict__ w, const uint8_t* __restrict__ sw,
                      uint16_t* __restrict__ out, float* __restrict__ ws, int M, int N, int K,
                      int splits) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  __shared__ __align__(16) uint32_t Xs[BM][kStride];
  __shared__ __align__(16) uint32_t Ws[BN][kStride];
  __shared__ float Px[2][BM];
  __shared__ float Pw[2][BN];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, t = lane % 4;
  const int n_base = blockIdx.x * BN, m_base = blockIdx.y * BM;
  const int nb = K / 32;
  const int iters = K / kKTile;
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
    const int k0 = it * kKTile;
    // x codes: BM rows x 64 bytes, 16 bytes per thread; rows past M are 0.
    for (int c = tid; c < BM * 4; c += kThreads) {
      int row = c / 4, q = c % 4, m = m_base + row;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M) v = *reinterpret_cast<const uint4*>(xc + (long long)m * K + k0 + q * 16);
      *reinterpret_cast<uint4*>(&Xs[row][q * 4]) = v;
    }
    for (int c = tid; c < BM * 2; c += kThreads) {
      int row = c / 2, b = c % 2, m = m_base + row;
      Px[b][row] = m < M ? mx::pow2_scale(sx[(long long)m * nb + k0 / 32 + b]) : 0.f;
    }
    for (int c = tid; c < 2 * BN; c += kThreads) {
      int b = c / BN, n = c % BN;
      Pw[b][n] = mx::pow2_scale(sw[(long long)(k0 / 32 + b) * N + n_base + n]);
    }
    // W codes: 64 k rows x BN columns; a thread takes 4 k rows x 4 columns
    // and stores them as 4 words of [n][k] bytes.
    for (int c = tid; c < kWords * (BN / 4); c += kThreads) {
      int kq = c / (BN / 4), nq = c % (BN / 4);
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const uint32_t*>(w + (long long)(k0 + kq * 4 + i) * N + n_base + nq * 4);
      mx::transpose_4x4_bytes(r);
#pragma unroll
      for (int j = 0; j < 4; ++j) Ws[nq * 4 + j][kq] = r[j];
    }
    __syncthreads();
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        int r0 = wm * WTM + i * 16 + g;
        a[i][0] = Xs[r0][blk * 8 + t];
        a[i][1] = Xs[r0 + 8][blk * 8 + t];
        a[i][2] = Xs[r0][blk * 8 + 4 + t];
        a[i][3] = Xs[r0 + 8][blk * 8 + 4 + t];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        int n0 = wn * WTN + j * 8 + g;
        b[j][0] = Ws[n0][blk * 8 + t];
        b[j][1] = Ws[n0][blk * 8 + 4 + t];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = wm * WTM + i * 16 + g;
        const float px0 = Px[blk][r0], px1 = Px[blk][r0 + 8];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n0 = wn * WTN + j * 8 + 2 * t;
          const float pw0 = Pw[blk][n0], pw1 = Pw[blk][n0 + 1];
          float s[4];
          if constexpr (FP8) {
            mx::mma_e4m3_16832(s, a[i], b[j]);
          } else {
            int si[4];
            mx::mma_s8_16832(si, a[i], b[j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) s[e] = (float)si[e];
          }
          acc[i][j][0] += __fmul_rn(__fmul_rn(s[0], px0), pw0);
          acc[i][j][1] += __fmul_rn(__fmul_rn(s[1], px0), pw1);
          acc[i][j][2] += __fmul_rn(__fmul_rn(s[2], px1), pw0);
          acc[i][j][3] += __fmul_rn(__fmul_rn(s[3], px1), pw1);
        }
      }
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

__global__ void reduce_splits_int8dot_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out,
                                             long long mn, int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int BM, int WM, int WN, bool FP8>
cudaError_t run(const void* xc, const void* sx, const void* w, const void* sw, void* out, void* ws,
                int M, int N, int K, int splits, cudaStream_t stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  matmul_int8dot_kernel<BM, WM, WN, FP8><<<grid, WM * WN * 32, 0, stream>>>(
      (const uint8_t*)xc, (const uint8_t*)sx, (const uint8_t*)w, (const uint8_t*)sw, (uint16_t*)out,
      (float*)ws, M, N, K, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  long long mn = (long long)M * N;
  reduce_splits_int8dot_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>((const float*)ws,
                                                                                (uint16_t*)out, mn, splits);
  return cudaGetLastError();
}

template <bool FP8>
int launch(const void* xc, const void* sx, const void* w, const void* sw, void* out, void* ws, int M,
           int N, int K, int bm, int splits, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bm) {
    case 16: return (int)run<16, 1, 4, FP8>(xc, sx, w, sw, out, ws, M, N, K, splits, s);
    case 64: return (int)run<64, 2, 2, FP8>(xc, sx, w, sw, out, ws, M, N, K, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// int8 codes (x and W), bm 16 or 64 (64-column tiles).
extern "C" int mx_matmul_int8dot_launch(const void* xc, const void* sx, const void* w, const void* sw,
                                        void* out, void* ws, int M, int N, int K, int bm, int splits,
                                        void* stream) {
  return launch<false>(xc, sx, w, sw, out, ws, M, N, K, bm, splits, stream);
}

// The same with e4m3 codes (TORCHMX_FP8_DOT).
extern "C" int mx_matmul_fp8dot_launch(const void* xc, const void* sx, const void* w, const void* sw,
                                       void* out, void* ws, int M, int N, int K, int bm, int splits,
                                       void* stream) {
  return launch<true>(xc, sx, w, sw, out, ws, M, N, K, bm, splits, stream);
}
