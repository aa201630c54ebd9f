// K1 mx_quantize and K2 mx_fake_quantize: one warp per 32-element MX block;
// mx_quantize_rows: one warp per row, one exponent a row.  K1 also writes in
// B9's dot order (mx_quantize_dot_launch): the codes of each block permuted
// as B9's W fragments come out, the scales transposed as f32 factors.  K2 also writes in
// B7's plane order (mx_fake_quantize_planes_launch): the row's even
// elements, then its odd ones, each plane zero-padded, quantized or copied.
//
// K1 and K2 replace torchmx_tpu/ops/pallas_quantize.py::_quantize_kernel
// (:137) and ::_fake_quantize_kernel / _fake_quantize_lane_kernel (:217,
// :225).  mx_quantize_rows replaces no TPU kernel: JAX quantizes MLA's
// per-row operands (block = the row's width) as jnp ops under XLA
// (torchmx_tpu/ops/pallas_mla.py:522-527, models/deepseek.py:316-321); it
// is a repair of the port, which ran them as dozens of small PyTorch kernels.
//
// What bounds them on an H100: bytes.  Each element is read once (2 bytes)
// and written once (1 byte of codes or 2 bytes of bf16), against a few dozen
// integer operations.  The TPU kernels transposed the tensor so the 32-block
// reduce ran over sublanes; here the block max is one warp reduction
// (__reduce_max_sync), each lane keeps one element in registers, and fp4
// codes pair-pack by a shuffle with the neighbouring lane (high nibble =
// even element) before the store.  No shared memory.
#include "mx_common.cuh"

namespace {

constexpr int kWarps = 8;

template <int E>
__global__ void quantize_kernel(const uint16_t* __restrict__ x, uint8_t* __restrict__ scale,
                                uint8_t* __restrict__ codes, long long nblocks) {
  long long blk = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (blk >= nblocks) return;  // whole warps exit together
  int lane = threadIdx.x % 32;
  int bits = x[blk * 32 + lane];
  int emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)((bits >> 7) & 0xFF));
  int se = mx::block_scale(emax, mx::Elem<E>::max_pow2);
  if (lane == 0) scale[blk] = (uint8_t)se;
  if (E == mx::kInt8) {
    codes[blk * 32 + lane] = (uint8_t)(int8_t)mx::cast_int8(bits, se);
    return;
  }
  int code = mx::cast_hw_exact<E>(bits, se);
  if (E == mx::kFp4E2M1) {
    int next = __shfl_down_sync(0xffffffffu, code, 1);
    if ((lane & 1) == 0) codes[blk * 16 + lane / 2] = (uint8_t)((code << 4) | (next & 0xF));
  } else {
    codes[blk * 32 + lane] = (uint8_t)code;
  }
}

// K1 in B9's dot order (csrc/mx_matmul_int8dot.cu): block b of row m as K1
// quantizes it, its code of element 16h + k stored at position 16h + 4 ((k &
// 7) >> 1) + (k & 1) + 2 (k >> 3) of the block (the order in which B9's W
// fragments come out of ldmatrix.trans), its scale as the f32 factor 2^(se
// - 127) (bits se << 23; se = 0 gives +0) at pxT[b][m] (K/32 x Mp: a stage's
// two rows are one TMA box, read by B9 as they are); the warps of rows m >=
// rows write the pad factors (0) of columns rows .. Mp - 1.  One warp per
// (row, block).
template <int E>
__global__ void quantize_dot_kernel(const uint16_t* __restrict__ x, uint32_t* __restrict__ pxT,
                                    uint8_t* __restrict__ codes, int rows, int nb, int Mp) {
  const long long blk = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (blk >= (long long)Mp * nb) return;  // whole warps exit together
  const int lane = threadIdx.x % 32, m = (int)(blk / nb), b = (int)(blk % nb);
  if (m >= rows) {
    if (lane == 0) pxT[(long long)b * Mp + m] = 0;
    return;
  }
  const int bits = x[blk * 32 + lane];
  const int emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)((bits >> 7) & 0xFF));
  const int se = mx::block_scale(emax, mx::Elem<E>::max_pow2);
  if (lane == 0) pxT[(long long)b * Mp + m] = (uint32_t)se << 23;
  const int code = E == mx::kInt8 ? mx::cast_int8(bits, se) : mx::cast_hw_exact<E>(bits, se);
  const int k = lane & 15;
  codes[blk * 32 + (lane & 16) + 4 * ((k & 7) >> 1) + (k & 1) + 2 * (k >> 3)] = (uint8_t)code;
}

template <int E>
cudaError_t launch_quantize_dot(const void* x, void* pxT, void* codes, int rows, int nb, int Mp,
                                cudaStream_t stream) {
  unsigned grid = (unsigned)(((long long)Mp * nb + kWarps - 1) / kWarps);
  quantize_dot_kernel<E><<<grid, kWarps * 32, 0, stream>>>((const uint16_t*)x, (uint32_t*)pxT, (uint8_t*)codes,
                                                           rows, nb, Mp);
  return cudaGetLastError();
}

template <int E>
__global__ void fake_quantize_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
                                     long long nblocks) {
  long long blk = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (blk >= nblocks) return;
  int lane = threadIdx.x % 32;
  int bits = x[blk * 32 + lane];
  int emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)((bits >> 7) & 0xFF));
  int se = mx::block_scale(emax, mx::Elem<E>::max_pow2);
  out[blk * 32 + lane] = mx::fq_magic<E>(bits, se);
}

// K2 in plane order, for B7 (csrc/mx_matmul.cu): element k of a row goes to
// column k / 2 of the even plane (k even) or Kp/2 + k / 2 of the odd plane
// of out (rows, Kp); columns K/2 .. Kp/2 - 1 of each plane are zeros.  A
// block's scale is taken over its 32 consecutive elements of the row, 16 of
// each plane: the joint scale of JAX's _fq_xT_pair.  E < 0: a copy into the
// planes, no quantize.  One warp per 32 columns of the padded row (blockIdx.x
// the row, blockIdx.y kWarps blocks of it): the 16 even lanes store 32
// consecutive bytes of the even plane, the odd lanes of the odd plane; the
// warps past K store the zeros.
template <int E>
__global__ void fake_quantize_planes_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out, int K,
                                            int Kp) {
  const int b = blockIdx.y * kWarps + threadIdx.x / 32;
  if (32 * b >= Kp) return;  // whole warps exit together
  const int lane = threadIdx.x % 32;
  const long long row = blockIdx.x;
  int bits = 0;
  if (32 * b < K) {  // the whole warp: K % 32 == 0
    bits = x[row * K + 32 * b + lane];
    if constexpr (E >= 0) {
      int emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)((bits >> 7) & 0xFF));
      bits = mx::fq_magic<E>(bits, mx::block_scale(emax, mx::Elem<E>::max_pow2));
    }
  }
  out[row * Kp + (lane & 1) * (Kp / 2) + 16 * b + (lane >> 1)] = (uint16_t)bits;
}

template <int E>
cudaError_t launch_planes(const void* x, void* out, long long rows, int K, int Kp, cudaStream_t stream) {
  dim3 grid((unsigned)rows, (unsigned)((Kp / 32 + kWarps - 1) / kWarps));
  fake_quantize_planes_kernel<E><<<grid, kWarps * 32, 0, stream>>>((const uint16_t*)x, (uint16_t*)out, K, Kp);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_quantize(const void* x, void* scale, void* codes, long long nblocks,
                            cudaStream_t stream) {
  unsigned grid = (unsigned)((nblocks + kWarps - 1) / kWarps);
  quantize_kernel<E><<<grid, kWarps * 32, 0, stream>>>(
      (const uint16_t*)x, (uint8_t*)scale, (uint8_t*)codes, nblocks);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_fq(const void* x, void* out, long long nblocks, cudaStream_t stream) {
  unsigned grid = (unsigned)((nblocks + kWarps - 1) / kWarps);
  fake_quantize_kernel<E><<<grid, kWarps * 32, 0, stream>>>(
      (const uint16_t*)x, (uint16_t*)out, nblocks);
  return cudaGetLastError();
}

// mx_quantize_rows: MX quantization with one E8M0 exponent per row (block =
// the row's width w, w % 32 == 0, w <= 1024), bit for bit
// quantize_mx_plain(x, elem, w).  Each row holds a pair of inputs (widths w1
// and w2: MLA's latent and rope key, or B14's q_lat and q_rot), so a call
// site is one launch.  One warp a row: lane l keeps elements l, l + 32, ...
// in registers (coalesced loads), the row's exponent max is one warp
// reduction, each element is cast as K1 casts it.  Bytes and launches bound
// it; there is nothing to tile.  Two outputs:
//   row-major (B14's query): codes (rows, w) and f32 row scales
//     pk(se) * sm_scale in one rounding;
//   d-major (the latent cache write): row (b, t) of b x s new positions goes
//     to column clamp(pos[b], 0, L - s) + t of codes (b, w, L) and scales
//     (b, 1, L), as _write_rows clamps (models/deepseek.py).
struct RowPair {
  const uint16_t* x;  // (rows, w) bf16 bits
  uint8_t* codes;     // row-major (rows, w) or d-major (b, w, L)
  void* scale;        // f32 (rows,) or uint8 (b, 1, L)
  int w;
};

template <int E, bool kDmajor>
__device__ __forceinline__ void quantize_row_to(const RowPair& p, long long row, long long bi, long long col, int L,
                                                float sm_scale, int lane) {
  const uint16_t* x = p.x + row * p.w;
  if (kDmajor) {
    uint8_t* base = p.codes + bi * p.w * L + col;
    int se = mx::quantize_row<E>(x, p.w, lane, [&](int e, int c) { base[(long long)e * L] = (uint8_t)c; });
    if (lane == 0) ((uint8_t*)p.scale)[bi * L + col] = (uint8_t)se;
  } else {
    uint8_t* base = p.codes + row * p.w;
    int se = mx::quantize_row<E>(x, p.w, lane, [&](int e, int c) { base[e] = (uint8_t)c; });
    if (lane == 0) ((float*)p.scale)[row] = __fmul_rn(mx::pow2_scale(se), sm_scale);
  }
}

template <int E, bool kDmajor>
__global__ void quantize_rows_kernel(RowPair a, RowPair b, const int* __restrict__ pos, long long rows, int s,
                                     int L, float sm_scale) {
  long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps exit together
  int lane = threadIdx.x % 32;
  long long bi = 0, col = 0;
  if (kDmajor) {
    bi = row / s;
    col = min(max(pos[bi], 0), L - s) + row % s;
  }
  quantize_row_to<E, kDmajor>(a, row, bi, col, L, sm_scale, lane);
  quantize_row_to<E, kDmajor>(b, row, bi, col, L, sm_scale, lane);
}

template <int E>
cudaError_t launch_rows(RowPair a, RowPair b, const int* pos, long long rows, int s, int L, float sm_scale,
                        bool dmajor, cudaStream_t stream) {
  unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
  if (dmajor)
    quantize_rows_kernel<E, true><<<grid, kWarps * 32, 0, stream>>>(a, b, pos, rows, s, L, sm_scale);
  else
    quantize_rows_kernel<E, false><<<grid, kWarps * 32, 0, stream>>>(a, b, pos, rows, s, L, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mx_quantize_launch(const void* x, void* scale, void* codes, long long rows, int K,
                                  int elem, void* stream) {
  long long nblocks = rows * (K / 32);
  if (nblocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3: return launch_quantize<mx::kFp8E4M3>(x, scale, codes, nblocks, s);
    case mx::kFp4E2M1: return launch_quantize<mx::kFp4E2M1>(x, scale, codes, nblocks, s);
    case mx::kFp6E3M2: return launch_quantize<mx::kFp6E3M2>(x, scale, codes, nblocks, s);
    case mx::kFp6E2M3: return launch_quantize<mx::kFp6E2M3>(x, scale, codes, nblocks, s);
    case mx::kInt8: return launch_quantize<mx::kInt8>(x, scale, codes, nblocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K1 in B9's dot order: x (rows, K) -> codes (rows, K) in dot order and
// the f32 scale factors pxT (K/32, Mp) (Mp % 16 == 0, Mp >= rows; columns
// past rows 0); elem: mx::kInt8 or mx::kFp8E4M3.
extern "C" int mx_quantize_dot_launch(const void* x, void* pxT, void* codes, long long rows, int K, int Mp,
                                      int elem, void* stream) {
  if (K <= 0 || K % 32 || Mp % 16 || Mp < rows || rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3: return launch_quantize_dot<mx::kFp8E4M3>(x, pxT, codes, (int)rows, K / 32, Mp, s);
    case mx::kInt8: return launch_quantize_dot<mx::kInt8>(x, pxT, codes, (int)rows, K / 32, Mp, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int mx_fake_quantize_launch(const void* x, void* out, long long rows, int K, int elem,
                                       void* stream) {
  long long nblocks = rows * (K / 32);
  if (nblocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3: return launch_fq<mx::kFp8E4M3>(x, out, nblocks, s);
    case mx::kFp4E2M1: return launch_fq<mx::kFp4E2M1>(x, out, nblocks, s);
    case mx::kFp6E3M2: return launch_fq<mx::kFp6E3M2>(x, out, nblocks, s);
    case mx::kFp6E2M3: return launch_fq<mx::kFp6E2M3>(x, out, nblocks, s);
    case mx::kInt8: return launch_fq<mx::kInt8>(x, out, nblocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

// x (rows, K) -> out (rows, Kp) in B7's plane order; elem: mx::kFp8E4M3,
// mx::kInt8, or -1 for a copy without quantize.  K % 32 == 0, Kp % 64 == 0,
// Kp >= K.
extern "C" int mx_fake_quantize_planes_launch(const void* x, void* out, long long rows, int K, int Kp, int elem,
                                              void* stream) {
  if (K <= 0 || K % 32 || Kp % 64 || Kp < K || rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case -1: return launch_planes<-1>(x, out, rows, K, Kp, s);
    case mx::kFp8E4M3: return launch_planes<mx::kFp8E4M3>(x, out, rows, K, Kp, s);
    case mx::kInt8: return launch_planes<mx::kInt8>(x, out, rows, K, Kp, s);
  }
  return (int)cudaErrorInvalidValue;
}

// rows = b * s rows of the pair (x1: w1 wide, x2: w2 wide); dmajor = 0:
// codes (rows, w) and f32 scales (rows,), pos, s and L unread; dmajor = 1:
// codes (b, w, L) and uint8 scales (b, 1, L) at int32 positions pos (b,).
extern "C" int mx_quantize_rows_launch(const void* x1, const void* x2, void* codes1, void* scale1, void* codes2,
                                       void* scale2, const void* pos, long long rows, int s, int L, int w1, int w2,
                                       int elem, float sm_scale, int dmajor, void* stream) {
  if (w1 % 32 || w2 % 32 || w1 <= 0 || w2 <= 0 || w1 > 32 * mx::kMaxRowLanes || w2 > 32 * mx::kMaxRowLanes)
    return (int)cudaErrorInvalidValue;
  if (dmajor && (s <= 0 || s > L || rows % s)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  RowPair a{(const uint16_t*)x1, (uint8_t*)codes1, scale1, w1};
  RowPair b{(const uint16_t*)x2, (uint8_t*)codes2, scale2, w2};
  const int* p = (const int*)pos;
  cudaStream_t st = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3: return launch_rows<mx::kFp8E4M3>(a, b, p, rows, s, L, sm_scale, dmajor, st);
    case mx::kFp6E3M2: return launch_rows<mx::kFp6E3M2>(a, b, p, rows, s, L, sm_scale, dmajor, st);
    case mx::kFp6E2M3: return launch_rows<mx::kFp6E2M3>(a, b, p, rows, s, L, sm_scale, dmajor, st);
    case mx::kInt8: return launch_rows<mx::kInt8>(a, b, p, rows, s, L, sm_scale, dmajor, st);
  }
  return (int)cudaErrorInvalidValue;  // fp4 rows are not taken (fp4 MLA caches stay seq)
}
