// mx_rmsnorm: out = x * rsqrt(mean(x * x) + eps) * w over the last dim, bf16
// in and out, fp32 throughout, one bf16 rounding (the formula of
// torchmx_tpu/models/llama.py:521-526, plain jnp there: no TPU kernel).
//
// It repairs a fault of the port: PyTorch's fp32 mean over 4096 sums in
// another order at 3-15 rows than at other row counts, so a row's bytes
// depended on how many rows shared the call, and the engine's whole =
// chunked = prefixed identity did not hold for admissions of 3-15 tokens.
// Here one CTA takes one row, T = min(D/8, 512) threads rounded up to whole
// warps: thread t sums the squares of elements 8 t + 8 T i + j (i, j in
// order; a thread past the row's end adds nothing), a fixed xor butterfly
// sums a warp, and every thread adds the warps' sums in warp order; the sum
// is the same whatever the other rows are.  Any width that is a multiple of
// 32 (896 = 112 threads of 8 elements: three and a half warps, so the CTA
// takes four and the last half warp idles): every thread runs every pass of
// the loops, so a warp's shuffles always find all 32 lanes, and a 32-element
// MX block (four threads) is live or dead as a whole.  Memory-bound (2
// bytes in and out per element): 16-byte loads and stores, and at decode's
// few rows the row's work spread over its CTA (one warp a row left a
// 4096-wide row 16 dependent passes, and a fused K2 doubled the time).
//
// With an activation format (E >= 0) the kernel also applies K2's
// fake-quantize (csrc/mx_quantize.cu) to the row it has rounded to bf16:
// a thread's 8 consecutive elements and its three neighbours' make one
// 32-element MX block, whose exponent maximum is two xor shuffles, and each
// element takes mx::fq_magic in registers.  The result is K2 of this
// kernel's output, bit for bit, with one launch and without writing the
// normed row and reading it back (the layers whose linears share one K2).
#include "mx_common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // threads a row (a CTA): D/8 up to this, then each thread takes more vectors

template <int E>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w, uint16_t* __restrict__ out, int D,
               float eps) {
  __shared__ float warp_sums[kMaxThreads / 32];
  const int step = blockDim.x * 8;
  const uint16_t* xr = x + (long long)blockIdx.x * D;
  float s = 0.f;
  for (int c = threadIdx.x * 8; c < D; c += step) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const uint16_t* h = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __uint_as_float((uint32_t)h[j] << 16);
      s = __fadd_rn(s, __fmul_rn(f, f));
    }
  }
  s = mx::warp_sum(s);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  s = 0.f;
  for (int i = 0; i < (int)blockDim.x / 32; ++i) s = __fadd_rn(s, warp_sums[i]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(s, (float)D), eps));
  uint16_t* orow = out + (long long)blockIdx.x * D;
  for (int c0 = 0; c0 < D; c0 += step) {  // every thread every pass: the block's shuffles need the whole warp
    const int c = c0 + threadIdx.x * 8;
    const bool live = c < D;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    uint4 v = live ? *reinterpret_cast<const uint4*>(xr + c) : zero;
    uint4 wv = live ? *reinterpret_cast<const uint4*>(w + c) : zero;
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
    if constexpr (E >= 0) {  // the threads 4k .. 4k + 3 hold one MX block (c .. c + 31)
      int emax = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) emax = max(emax, (oh[j] >> 7) & 0xFF);
      emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, 1));
      emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, 2));
      const int se = mx::block_scale(emax, mx::Elem<E>::max_pow2);
#pragma unroll
      for (int j = 0; j < 8; ++j) oh[j] = mx::fq_magic<E>(oh[j], se);
    }
    if (live) *reinterpret_cast<uint4*>(orow + c) = o;
  }
}

template <int E>
cudaError_t launch(const void* x, const void* w, void* out, long long rows, int D, float eps, cudaStream_t stream) {
  const int threads = D / 8 < kMaxThreads ? (D / 8 + 31) / 32 * 32 : kMaxThreads;
  rmsnorm_kernel<E><<<(unsigned)rows, threads, 0, stream>>>((const uint16_t*)x, (const uint16_t*)w, (uint16_t*)out,
                                                            D, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: rows x D bf16 (D % 32 == 0); w: D bf16; elem: -1 (the norm alone)
// or the activation format of the fused fake-quantize (an mx::ElemCode).
extern "C" int mx_rmsnorm_launch(const void* x, const void* w, void* out, long long rows, int D, float eps, int elem,
                                 void* stream) {
  if (rows == 0) return 0;
  if (D <= 0 || D % 32 || rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case -1: return (int)launch<-1>(x, w, out, rows, D, eps, s);
    case mx::kFp8E4M3: return (int)launch<mx::kFp8E4M3>(x, w, out, rows, D, eps, s);
    case mx::kFp4E2M1: return (int)launch<mx::kFp4E2M1>(x, w, out, rows, D, eps, s);
    case mx::kFp6E3M2: return (int)launch<mx::kFp6E3M2>(x, w, out, rows, D, eps, s);
    case mx::kFp6E2M3: return (int)launch<mx::kFp6E2M3>(x, w, out, rows, D, eps, s);
    case mx::kInt8: return (int)launch<mx::kInt8>(x, w, out, rows, D, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
