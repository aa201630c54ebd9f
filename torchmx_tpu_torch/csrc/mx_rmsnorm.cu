// mx_rmsnorm: out = x * rsqrt(mean(x * x) + eps) * w over the last dim, bf16
// in and out, fp32 throughout, one bf16 rounding (the formula of
// torchmx_tpu/models/llama.py:521-526, plain jnp there: no TPU kernel).
//
// It repairs a fault of the port: PyTorch's fp32 mean over 4096 sums in
// another order at 3-15 rows than at other row counts, so a row's bytes
// depended on how many rows shared the call, and the engine's whole =
// chunked = prefixed identity did not hold for admissions of 3-15 tokens.
// Here one warp takes one row: lane l sums the squares of elements l*8 +
// 256*i + j (i, j in order), then a fixed xor butterfly; the sum is the same
// whatever the other rows are.  Memory-bound (2 bytes in and out per
// element): 16-byte loads and stores.
#include "mx_common.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block

__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w, uint16_t* __restrict__ out,
               long long rows, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const uint16_t* xr = x + row * D;
  float s = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const uint16_t* h = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __uint_as_float((uint32_t)h[j] << 16);
      s = __fadd_rn(s, __fmul_rn(f, f));
    }
  }
  s = mx::warp_sum(s);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(s, (float)D), eps));
  uint16_t* orow = out + row * D;
  for (int c = lane * 8; c < D; c += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    uint4 wv = *reinterpret_cast<const uint4*>(w + c);
    const uint16_t* h = reinterpret_cast<const uint16_t*>(&v);
    const uint16_t* wh = reinterpret_cast<const uint16_t*>(&wv);
    uint4 o;
    uint16_t* oh = reinterpret_cast<uint16_t*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __fmul_rn(__uint_as_float((uint32_t)h[j] << 16), r);
      f = __fmul_rn(f, __uint_as_float((uint32_t)wh[j] << 16));
      oh[j] = __bfloat16_as_ushort(__float2bfloat16_rn(f));
    }
    *reinterpret_cast<uint4*>(orow + c) = o;
  }
}

}  // namespace

// x, out: rows x D bf16 (D % 256 == 0); w: D bf16.
extern "C" int mx_rmsnorm_launch(const void* x, const void* w, void* out, long long rows, int D, float eps,
                                 void* stream) {
  if (rows == 0) return 0;
  if (D % 256) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const uint16_t*)w, (uint16_t*)out, rows, D, eps);
  return (int)cudaGetLastError();
}
