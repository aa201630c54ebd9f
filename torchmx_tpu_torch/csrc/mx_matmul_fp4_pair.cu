// B7 mx_matmul_fp4_pair: out (M, N) bf16 = fq(x) (M, K) @ W (K, N) with W
// MXFP4 in the reference's "pair" packing: byte p of column n holds element
// 2p (high nibble) and element 2p + 1 (low nibble); scale (K/32, N) uint8.
//
// Replaces torchmx_tpu/ops/pallas_matmul.py::_linear_kernel_fp4 (:473),
// launched by _pallas_matmul_fp4 (:1021).  The JAX kernel takes x split into
// its even and odd K planes and runs two dots per tile; here x's even and
// odd elements are neighbours in memory, so each weight byte decodes to two
// consecutive K rows of the tile and x is read as it is.
//
// What bounds it on an H100: at decode the weight bytes (K*N/2 + K*N/32); at
// prefill the tensor-core operations, 2*M*N*K.  Design (K3's, over the pair
// bytes): each iteration takes 32 packed rows of W (64 consecutive K
// elements) and the matching 64 columns of x, decodes the nibbles to bf16
// straight into shared memory (the scale folds into the bf16 exponent
// field), optionally fake-quantizes each 32-element x block in the same
// prologue (fp8 e4m3 or int8: one warp per block, the block max by warp
// reduction), then runs mma.sync m16n8k16 bf16 -> fp32; one bf16 rounding at
// the end.  K need not be a multiple of 64: a last iteration of 32 elements
// fills the rest of the tile with zeros.  Decode-sized M gives too few output
// tiles to fill 132 SMs, so K is split over blockIdx.z on the plan of
// ops/cuda_matmul._plan (a function of N and K only, so a row's bytes do not
// depend on M), and the fp32 partials are summed in split order by a second
// kernel.  No TMA, no wgmma, no pipelining yet.
#include "mx_common.cuh"

namespace {

constexpr int kKTile = 64;        // K elements per iteration (32 packed rows)
constexpr int kPad = kKTile + 8;  // smem row stride in bf16

template <int BM, int BN, int WM, int WN, int ACT>
__global__ void __launch_bounds__(WM * WN * 32)
matmul_fp4_pair_kernel(const uint16_t* __restrict__ x, const uint8_t* __restrict__ w,
                       const uint8_t* __restrict__ scale, uint16_t* __restrict__ out, float* __restrict__ ws, int M,
                       int N, int K, int splits) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int kWarps = WM * WN;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  __shared__ __align__(16) uint16_t Xs[BM][kPad];
  __shared__ __align__(16) uint16_t Ws[BN][kPad];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, t = lane % 4;
  const int n_base = blockIdx.x * BN, m_base = blockIdx.y * BM;
  const int iters = (K + kKTile - 1) / kKTile;
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
    const int kval = min(kKTile, K - k0);  // 64, or 32 in a last short iteration
    // x: BM rows x two 32-element blocks, one warp per (row, block).
    for (int rb = warp; rb < BM * 2; rb += kWarps) {
      const int row = rb / 2, hb = rb % 2;
      const int m = m_base + row;
      const bool ok = m < M && hb * 32 < kval;
      int bits = ok ? x[(long long)m * K + k0 + hb * 32 + lane] : 0;
      if (ACT >= 0) {
        int emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)((bits >> 7) & 0xFF));
        int se = mx::block_scale(emax, mx::Elem<(ACT < 0 ? 0 : ACT)>::max_pow2);
        bits = ok ? mx::fq_magic<(ACT < 0 ? 0 : ACT)>(bits, se) : 0;
      }
      Xs[row][hb * 32 + lane] = (uint16_t)bits;
    }
    // W: 32 packed rows x BN columns, 16 bytes per thread per step; byte
    // row r holds K rows k0 + 2r (high nibble) and k0 + 2r + 1 (low).
    const int p0 = k0 / 2;
    for (int c = tid; c < 32 * BN / 16; c += kThreads) {
      const int r = c / (BN / 16), n0 = (c % (BN / 16)) * 16;
      const int n = n_base + n0;
      const bool ok = 2 * r < kval;
      uint4 wb = make_uint4(0, 0, 0, 0), sb = make_uint4(0, 0, 0, 0);
      if (ok) {
        wb = *reinterpret_cast<const uint4*>(w + (long long)(p0 + r) * N + n);
        sb = *reinterpret_cast<const uint4*>(scale + (long long)((k0 + 2 * r) / 32) * N + n);
      }
      const uint8_t* wbb = reinterpret_cast<const uint8_t*>(&wb);
      const uint8_t* sbb = reinterpret_cast<const uint8_t*>(&sb);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t even = ok ? mx::decode_fp4(wbb[j] >> 4, sbb[j]) : 0u;
        const uint32_t odd = ok ? mx::decode_fp4(wbb[j] & 0xF, sbb[j]) : 0u;
        *reinterpret_cast<uint32_t*>(&Ws[n0 + j][2 * r]) = even | (odd << 16);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = wm * WTM + i * 16 + g, c0 = kk * 16 + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&Xs[r0][c0]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&Xs[r0 + 8][c0]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&Xs[r0][c0 + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&Xs[r0 + 8][c0 + 8]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n0 = wn * WTN + j * 8 + g, c0 = kk * 16 + 2 * t;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&Ws[n0][c0]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&Ws[n0][c0 + 8]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mx::mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m_base + wm * WTM + i * 16 + g + h * 8;
        const int n = n_base + wn * WTN + j * 8 + 2 * t;
        if (m >= M) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * N + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(ws + ((long long)blockIdx.z * M + m) * N + n) = make_float2(v0, v1);
        }
      }
}

__global__ void reduce_splits_fp4p_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out, long long mn,
                                          int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int BM, int BN, int WM, int WN, int ACT>
cudaError_t run(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N, int K,
                int splits, cudaStream_t stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  matmul_fp4_pair_kernel<BM, BN, WM, WN, ACT><<<grid, WM * WN * 32, 0, stream>>>(
      (const uint16_t*)x, (const uint8_t*)w, (const uint8_t*)scale, (uint16_t*)out, (float*)ws, M, N, K, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  reduce_splits_fp4p_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>((const float*)ws, (uint16_t*)out, mn,
                                                                              splits);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t dispatch_tile(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N, int K,
                          int bm, int splits, cudaStream_t s) {
  switch (bm) {
    case 16: return run<16, 64, 1, 4, ACT>(x, w, scale, out, ws, M, N, K, splits, s);
    case 64: return run<64, 64, 2, 2, ACT>(x, w, scale, out, ws, M, N, K, splits, s);
    case 128: return run<128, 128, 2, 4, ACT>(x, w, scale, out, ws, M, N, K, splits, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// act_fq: -1 for none, mx::kFp8E4M3 or mx::kInt8.  bm: 16, 64 (64-column
// tiles) or 128 (128-column tiles, N % 128 == 0).  K a multiple of 32, N of 64.
extern "C" int mx_matmul_fp4_pair_launch(const void* x, const void* w, const void* scale, void* out, void* ws,
                                         int M, int N, int K, int act_fq, int bm, int splits, void* stream) {
  if (K % 32 || N % 64 || (bm == 128 && N % 128)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (act_fq) {
    case -1: return (int)dispatch_tile<-1>(x, w, scale, out, ws, M, N, K, bm, splits, s);
    case mx::kFp8E4M3: return (int)dispatch_tile<mx::kFp8E4M3>(x, w, scale, out, ws, M, N, K, bm, splits, s);
    case mx::kInt8: return (int)dispatch_tile<mx::kInt8>(x, w, scale, out, ws, M, N, K, bm, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}
