// mx_router_logits: the MoE router's logits, out (T, E) bf16 = x (T, H) bf16
// @ W (E, H)^T with f32 sums and one bf16 rounding (the formula of
// torchmx_tpu/layers/mx_mixtral_moe.py:249-250, a plain jnp matmul there:
// no TPU kernel).
//
// It repairs a fault of the port: cuBLAS sums a row's products in another
// order at other row counts, so a token's logits, and at a near tie the
// experts it is sent to, depended on how many tokens shared the call; the
// engine's whole = chunked = prefixed identity did not hold for MoE models.
// Here one block of 8 warps takes one row: warp w takes the w-th eighth of
// the row's 256-element chunks, lane l sums, for each expert, the products
// of elements l*8 + j of each chunk (chunks, then j, in order), a fixed xor
// butterfly sums the lanes, and thread e adds the 8 warps' sums in warp
// order.  The sum is the same whatever the other rows are.  Memory-bound
// (the rows of x once, W from L2): 16-byte loads, all of a warp's chunks in
// flight at once.
#include "mx_common.cuh"

namespace {

constexpr int kWarps = 8;   // warps per row
constexpr int kMaxE = 16;   // experts

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

template <int E>
__global__ void __launch_bounds__(kWarps * 32)
router_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w, uint16_t* __restrict__ out, int H) {
  __shared__ float part[kWarps][E];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long row = blockIdx.x;
  const uint16_t* xr = x + row * H;
  const int chunks = H / 256;
  const int c0 = warp * chunks / kWarps, c1 = (warp + 1) * chunks / kWarps;
  float s[E];
#pragma unroll
  for (int e = 0; e < E; ++e) s[e] = 0.f;
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    const int k = c * 256 + lane * 8;
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + k);
    const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint4 wv = *reinterpret_cast<const uint4*>(w + (long long)e * H + k);
      const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[e] = __fadd_rn(s[e], __fmul_rn(bf16_lo(xw[j]), bf16_lo(ww[j])));
        s[e] = __fadd_rn(s[e], __fmul_rn(bf16_hi(xw[j]), bf16_hi(ww[j])));
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float t = mx::warp_sum(s[e]);
    if (lane == 0) part[warp][e] = t;
  }
  __syncthreads();
  if (threadIdx.x < E) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t = __fadd_rn(t, part[i][threadIdx.x]);
    out[row * E + threadIdx.x] = __bfloat16_as_ushort(__float2bfloat16_rn(t));
  }
}

template <int E>
cudaError_t run(const void* x, const void* w, void* out, long long rows, int H, cudaStream_t stream) {
  router_kernel<E><<<(unsigned)rows, kWarps * 32, 0, stream>>>((const uint16_t*)x, (const uint16_t*)w,
                                                               (uint16_t*)out, H);
  return cudaGetLastError();
}

}  // namespace

// x (rows, H) bf16, w (E, H) bf16, out (rows, E) bf16; H a multiple of 256,
// E one of 2, 4, 8, 16.
extern "C" int mx_router_logits_launch(const void* x, const void* w, void* out, long long rows, int H, int E,
                                       void* stream) {
  if (rows == 0) return 0;
  if (H % 256 || rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (E) {
    case 2: return (int)run<2>(x, w, out, rows, H, s);
    case 4: return (int)run<4>(x, w, out, rows, H, s);
    case 8: return (int)run<8>(x, w, out, rows, H, s);
    case kMaxE: return (int)run<kMaxE>(x, w, out, rows, H, s);
  }
  return (int)cudaErrorInvalidValue;
}
