// B6 mx_matmul_1byte: out (M, N) bf16 = fq(x) (M, K) @ W (K, N) with W one
// code per byte, K-major: fp8 e4m3, fp6 e3m2 or e2m3 (flat), or int8; scale
// (K/32, N) E8M0 bytes.
//
// Replaces torchmx_tpu/ops/pallas_matmul.py::_linear_kernel_1byte (:419),
// launched by _pallas_matmul_1byte (:1000).
//
// What bounds it on an H100: at decode (M up to 32) the weight bytes (K*N +
// K*N/32); at prefill (M in the thousands) the tensor-core operations,
// 2*M*N*K.  Design: K3's (csrc/mx_matmul.cu) with one code per byte.  Each
// iteration takes 64 rows of W (two 32-element MX blocks) and the matching
// 64 columns of x, decodes W to bf16 straight into shared memory as a dot
// operand (mx::decode_code_dot: the scale folds into the exponent;
// int8 codes times 2^(se-127)), optionally fake-quantizes each x block in
// the same prologue (fp8 or int8, mx::fq_magic, one warp per block), then
// runs mma.sync m16n8k16 bf16 -> fp32.  Each MX block's product is formed in
// a zeroed fragment (two k16 steps) and added to the accumulator in block
// order; K is split over blockIdx.z as ops/cuda_matmul._plan says, and the
// partials are summed in split order by a second kernel.  B9
// (csrc/mx_matmul_int8dot.cu) adds its exact block sums in the same order
// over the same splits, so for int8 weights and an int8-grid x the two give
// the same bytes.  The element format is a run-time argument (a uniform
// branch in the decode), the activation format and tile a template one.
#include "mx_common.cuh"

namespace {

constexpr int kKTile = 64;        // K elements per iteration: two MX blocks
constexpr int kPad = kKTile + 8;  // smem row stride in bf16

__device__ __forceinline__ uint16_t decode_1byte(int elem, int code, int se) {
  switch (elem) {
    case mx::kFp8E4M3: return mx::decode_bf16_bits<mx::kFp8E4M3>(code, se);
    case mx::kFp6E3M2: return mx::decode_bf16_bits<mx::kFp6E3M2>(code, se);
    case mx::kFp6E2M3: return mx::decode_bf16_bits<mx::kFp6E2M3>(code, se);
    default: return mx::decode_bf16_bits<mx::kInt8>(code, se);
  }
}

template <int BM, int BN, int WM, int WN, int ACT>
__global__ void __launch_bounds__(WM * WN * 32)
matmul_1byte_kernel(const uint16_t* __restrict__ x, const uint8_t* __restrict__ w,
                    const uint8_t* __restrict__ scale, uint16_t* __restrict__ out,
                    float* __restrict__ ws, int M, int N, int K, int splits, int elem) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int kWarps = WM * WN;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int MT = WTM / 16, NT = WTN / 8;   // mma tiles per warp
  constexpr int A = ACT < 0 ? 0 : ACT;
  __shared__ __align__(16) uint16_t Xs[BM][kPad];
  __shared__ __align__(16) uint16_t Ws[BN][kPad];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, t = lane % 4;
  const int n_base = blockIdx.x * BN, m_base = blockIdx.y * BM;
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
    // x: BM rows x two 32-element blocks, one warp per (row, block).
    for (int rb = warp; rb < BM * 2; rb += kWarps) {
      int row = rb / 2, hb = rb % 2;
      int m = m_base + row;
      int bits = m < M ? x[(long long)m * K + k0 + hb * 32 + lane] : 0;
      if (ACT >= 0) {
        int emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)((bits >> 7) & 0xFF));
        bits = mx::fq_magic<A>(bits, mx::block_scale(emax, mx::Elem<A>::max_pow2));
      }
      Xs[row][hb * 32 + lane] = (uint16_t)bits;
    }
    // W: 64 rows x BN columns, 16 codes per thread per step.
    for (int c = tid; c < kKTile * BN / 16; c += kThreads) {
      int r = c / (BN / 16), n0 = (c % (BN / 16)) * 16;
      int n = n_base + n0;
      uint4 wb = *reinterpret_cast<const uint4*>(w + (long long)(k0 + r) * N + n);
      uint4 sb = *reinterpret_cast<const uint4*>(scale + (long long)((k0 + r) / 32) * N + n);
      const uint8_t* wbb = reinterpret_cast<const uint8_t*>(&wb);
      const uint8_t* sbb = reinterpret_cast<const uint8_t*>(&sb);
#pragma unroll
      for (int j = 0; j < 16; ++j) Ws[n0 + j][r] = decode_1byte(elem, wbb[j], sbb[j]);
    }
    __syncthreads();
#pragma unroll
    for (int blk = 0; blk < kKTile / 32; ++blk) {
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

__global__ void reduce_splits_1byte_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out,
                                           long long mn, int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int BM, int BN, int WM, int WN, int ACT>
cudaError_t run(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N,
                int K, int elem, int splits, cudaStream_t stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  matmul_1byte_kernel<BM, BN, WM, WN, ACT><<<grid, WM * WN * 32, 0, stream>>>(
      (const uint16_t*)x, (const uint8_t*)w, (const uint8_t*)scale, (uint16_t*)out, (float*)ws, M, N,
      K, splits, elem);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  long long mn = (long long)M * N;
  reduce_splits_1byte_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>((const float*)ws,
                                                                              (uint16_t*)out, mn, splits);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t dispatch_tile(const void* x, const void* w, const void* scale, void* out, void* ws, int M,
                          int N, int K, int elem, int bm, int splits, cudaStream_t s) {
  switch (bm) {
    case 16: return run<16, 64, 1, 4, ACT>(x, w, scale, out, ws, M, N, K, elem, splits, s);
    case 64: return run<64, 64, 2, 2, ACT>(x, w, scale, out, ws, M, N, K, elem, splits, s);
    case 128: return run<128, 128, 2, 4, ACT>(x, w, scale, out, ws, M, N, K, elem, splits, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// elem: mx::kFp8E4M3, kFp6E3M2, kFp6E2M3 or kInt8 (w then holds int8 codes).
// act_fq: -1 for none, mx::kFp8E4M3 or mx::kInt8.  bm: 16, 64 (64-column
// tiles) or 128 (128-column tiles).
extern "C" int mx_matmul_1byte_launch(const void* x, const void* w, const void* scale, void* out,
                                      void* ws, int M, int N, int K, int elem, int act_fq, int bm,
                                      int splits, void* stream) {
  if (M == 0) return 0;
  if (elem != mx::kFp8E4M3 && elem != mx::kFp6E3M2 && elem != mx::kFp6E2M3 && elem != mx::kInt8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (act_fq) {
    case -1: return dispatch_tile<-1>(x, w, scale, out, ws, M, N, K, elem, bm, splits, s);
    case mx::kFp8E4M3: return dispatch_tile<mx::kFp8E4M3>(x, w, scale, out, ws, M, N, K, elem, bm, splits, s);
    case mx::kInt8: return dispatch_tile<mx::kInt8>(x, w, scale, out, ws, M, N, K, elem, bm, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}
