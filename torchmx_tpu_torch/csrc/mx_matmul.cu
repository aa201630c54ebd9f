// K3 mx_matmul_fp4_halves: out (M, N) bf16 = fq(x) (M, K) @ W (K, N) with W
// MXFP4 in the K-major "halves" layout: byte p of column n holds element p
// (high nibble) and element p + K/2 (low nibble); scale rows [0, K/64) cover
// the first half, [K/64, K/32) the second.  mx_matmul_fp8_halves is the same
// kernel over MXFP8 halves: uint16 word p of column n holds the code of
// element p (high byte) and of element p + K/2 (low byte), decoded as a dot
// operand (mx::decode_code_dot<kFp8E4M3>); same bytes per element as the
// flat layout, read as two contiguous halves of x like the fp4 layout.
//
// Replaces torchmx_tpu/ops/pallas_matmul.py::_linear_kernel_fp4_halves
// (:504), launched by _pallas_matmul_fp4_halves (:1110), with
// elem_name "float4_e2m1" and "float8_e4m3".
//
// What bounds it on an H100: at decode (M = batch, up to 32) the weight
// bytes (K*N/2 + K*N/32); at prefill (M in the thousands) the tensor-core
// operations, 2*M*N*K.  Design: each iteration takes 32 packed rows of W (64
// K elements: 32 from each half) and the two matching 32-column slices of x
// (contiguous, no strided access), decodes W nibbles to bf16 straight into
// shared memory (the scale folds into the bf16 exponent field: no multiply),
// optionally fake-quantizes each 32-element x block in the same prologue
// (one warp per block, the block max by warp reduction), then runs
// mma.sync m16n8k16 bf16 -> fp32.  The accumulator stays fp32 until one
// bf16 rounding at the end.  Decode-sized M gives too few output tiles to
// fill 132 SMs, so K is split over blockIdx.z; the fp32 partials are summed
// in a fixed order by a second small kernel (deterministic).  No TMA, no
// wgmma, no pipelining yet: a later change.
#include "mx_common.cuh"

namespace {

constexpr int kKTile = 64;           // K elements per iteration (32 per half)
constexpr int kPad = kKTile + 8;     // smem row stride in bf16: conflict-free fragment loads

// E: the weight's element format (mx::kFp4E2M1 bytes or mx::kFp8E4M3 words).
template <int E, int BM, int BN, int WM, int WN, int ACT>
__device__ __forceinline__ void halves_body(const uint16_t* __restrict__ x, const void* __restrict__ wv,
                                            const uint8_t* __restrict__ scale, uint16_t* __restrict__ out,
                                            float* __restrict__ ws, int M, int N, int K, int splits) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int kWarps = WM * WN;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int MT = WTM / 16, NT = WTN / 8;   // mma tiles per warp
  __shared__ __align__(16) uint16_t Xs[BM][kPad];
  __shared__ __align__(16) uint16_t Ws[BN][kPad];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4, t = lane % 4;
  const int n_base = blockIdx.x * BN, m_base = blockIdx.y * BM;
  const int half = K / 2;
  const int iters = half / 32;
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
    // x: BM rows x two 32-element blocks, one warp per (row, block).
    for (int rb = warp; rb < BM * 2; rb += kWarps) {
      int row = rb / 2, hb = rb % 2;
      int m = m_base + row;
      int col = (hb ? half : 0) + p0 + lane;
      int bits = m < M ? x[(long long)m * K + col] : 0;
      if (ACT >= 0) {
        int emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)((bits >> 7) & 0xFF));
        int se = mx::block_scale(emax, mx::Elem<(ACT < 0 ? 0 : ACT)>::max_pow2);
        bits = mx::fq_magic<(ACT < 0 ? 0 : ACT)>(bits, se);
      }
      Xs[row][hb * 32 + lane] = (uint16_t)bits;
    }
    if constexpr (E == mx::kFp4E2M1) {
      // W: 32 packed rows x BN columns, 16 bytes per thread per step.
      const uint8_t* w = static_cast<const uint8_t*>(wv);
      for (int c = tid; c < 32 * BN / 16; c += kThreads) {
        int r = c / (BN / 16), n0 = (c % (BN / 16)) * 16;
        int n = n_base + n0;
        uint4 wb = *reinterpret_cast<const uint4*>(w + (long long)(p0 + r) * N + n);
        uint4 sa = *reinterpret_cast<const uint4*>(scale + (long long)(p0 / 32) * N + n);
        uint4 sb = *reinterpret_cast<const uint4*>(scale + (long long)(half / 32 + p0 / 32) * N + n);
        const uint8_t* wbb = reinterpret_cast<const uint8_t*>(&wb);
        const uint8_t* sab = reinterpret_cast<const uint8_t*>(&sa);
        const uint8_t* sbb = reinterpret_cast<const uint8_t*>(&sb);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          Ws[n0 + j][r] = mx::decode_fp4(wbb[j] >> 4, sab[j]);
          Ws[n0 + j][32 + r] = mx::decode_fp4(wbb[j] & 0xF, sbb[j]);
        }
      }
    } else {
      // W: 32 rows of u16 words x BN columns, 8 words (16 bytes) per thread per step.
      const uint16_t* w = static_cast<const uint16_t*>(wv);
      for (int c = tid; c < 32 * BN / 8; c += kThreads) {
        int r = c / (BN / 8), n0 = (c % (BN / 8)) * 8;
        int n = n_base + n0;
        uint4 wb = *reinterpret_cast<const uint4*>(w + (long long)(p0 + r) * N + n);
        uint2 sa = *reinterpret_cast<const uint2*>(scale + (long long)(p0 / 32) * N + n);
        uint2 sb = *reinterpret_cast<const uint2*>(scale + (long long)(half / 32 + p0 / 32) * N + n);
        const uint16_t* wbw = reinterpret_cast<const uint16_t*>(&wb);
        const uint8_t* sab = reinterpret_cast<const uint8_t*>(&sa);
        const uint8_t* sbb = reinterpret_cast<const uint8_t*>(&sb);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          Ws[n0 + j][r] = mx::decode_bf16_bits<mx::kFp8E4M3>(wbw[j] >> 8, sab[j]);
          Ws[n0 + j][32 + r] = mx::decode_bf16_bits<mx::kFp8E4M3>(wbw[j] & 0xFF, sbb[j]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        int r0 = wm * WTM + i * 16 + g, c0 = kk * 16 + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&Xs[r0][c0]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&Xs[r0 + 8][c0]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&Xs[r0][c0 + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&Xs[r0 + 8][c0 + 8]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        int n0 = wn * WTN + j * 8 + g, c0 = kk * 16 + 2 * t;
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
        int m = m_base + wm * WTM + i * 16 + g + h * 8;
        int n = n_base + wn * WTN + j * 8 + 2 * t;
        if (m >= M) continue;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (splits == 1) {
          __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * N + n) = o;
        } else {
          float2* dst = reinterpret_cast<float2*>(ws + ((long long)blockIdx.z * M + m) * N + n);
          *dst = make_float2(v0, v1);
        }
      }
}

// Distinct kernel names per weight format, so that a profile tells them apart.
template <int BM, int BN, int WM, int WN, int ACT>
__global__ void __launch_bounds__(WM * WN * 32)
matmul_fp4_halves_kernel(const uint16_t* __restrict__ x, const void* __restrict__ w,
                         const uint8_t* __restrict__ scale, uint16_t* __restrict__ out,
                         float* __restrict__ ws, int M, int N, int K, int splits) {
  halves_body<mx::kFp4E2M1, BM, BN, WM, WN, ACT>(x, w, scale, out, ws, M, N, K, splits);
}

template <int BM, int BN, int WM, int WN, int ACT>
__global__ void __launch_bounds__(WM * WN * 32)
matmul_fp8_halves_kernel(const uint16_t* __restrict__ x, const void* __restrict__ w,
                         const uint8_t* __restrict__ scale, uint16_t* __restrict__ out,
                         float* __restrict__ ws, int M, int N, int K, int splits) {
  halves_body<mx::kFp8E4M3, BM, BN, WM, WN, ACT>(x, w, scale, out, ws, M, N, K, splits);
}

// Sum the split-K partials in split order and round once to bf16.
__global__ void reduce_splits_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out,
                                     long long mn, int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void reduce_splits_fp8h_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out,
                                          long long mn, int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int E, int BM, int BN, int WM, int WN, int ACT>
cudaError_t run(const void* x, const void* w, const void* scale, void* out, void* ws, int M,
                int N, int K, int splits, cudaStream_t stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  auto kernel = E == mx::kFp4E2M1 ? matmul_fp4_halves_kernel<BM, BN, WM, WN, ACT>
                                  : matmul_fp8_halves_kernel<BM, BN, WM, WN, ACT>;
  kernel<<<grid, WM * WN * 32, 0, stream>>>((const uint16_t*)x, w, (const uint8_t*)scale,
                                            (uint16_t*)out, (float*)ws, M, N, K, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  long long mn = (long long)M * N;
  auto reduce = E == mx::kFp4E2M1 ? reduce_splits_kernel : reduce_splits_fp8h_kernel;
  reduce<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>((const float*)ws, (uint16_t*)out, mn, splits);
  return cudaGetLastError();
}

template <int E, int ACT>
cudaError_t dispatch_tile(const void* x, const void* w, const void* scale, void* out, void* ws,
                          int M, int N, int K, int bm, int splits, cudaStream_t s) {
  switch (bm) {
    case 16: return run<E, 16, 64, 1, 4, ACT>(x, w, scale, out, ws, M, N, K, splits, s);
    case 64: return run<E, 64, 64, 2, 2, ACT>(x, w, scale, out, ws, M, N, K, splits, s);
    case 128: return run<E, 128, 128, 2, 4, ACT>(x, w, scale, out, ws, M, N, K, splits, s);
  }
  return cudaErrorInvalidValue;
}

template <int E>
int launch(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N,
           int K, int act_fq, int bm, int splits, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (act_fq) {
    case -1: return dispatch_tile<E, -1>(x, w, scale, out, ws, M, N, K, bm, splits, s);
    case mx::kFp8E4M3: return dispatch_tile<E, mx::kFp8E4M3>(x, w, scale, out, ws, M, N, K, bm, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// act_fq: -1 for none, or mx::kFp8E4M3 to fake-quantize the activation to
// MXFP8 (the only activation format the port serves and checks on the card).
// bm: 16, 64 (64-column tiles) or 128 (128-column tiles).
extern "C" int mx_matmul_fp4_halves_launch(const void* x, const void* w, const void* scale,
                                           void* out, void* ws, int M, int N, int K, int act_fq,
                                           int bm, int splits, void* stream) {
  return launch<mx::kFp4E2M1>(x, w, scale, out, ws, M, N, K, act_fq, bm, splits, stream);
}

// The same over fp8 halves: w is (K/2, N) uint16 words.
extern "C" int mx_matmul_fp8_halves_launch(const void* x, const void* w, const void* scale,
                                           void* out, void* ws, int M, int N, int K, int act_fq,
                                           int bm, int splits, void* stream) {
  return launch<mx::kFp8E4M3>(x, w, scale, out, ws, M, N, K, act_fq, bm, splits, stream);
}
