// K1 mx_quantize and K2 mx_fake_quantize: one warp per 32-element MX block.
//
// Replace torchmx_tpu/ops/pallas_quantize.py::_quantize_kernel (:137) and
// ::_fake_quantize_kernel / _fake_quantize_lane_kernel (:217, :225).
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
