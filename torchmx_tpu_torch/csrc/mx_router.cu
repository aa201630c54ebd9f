// mx_router_logits: the MoE router's logits, out (T, E) = x (T, H) bf16 @
// W (E, H)^T with f32 sums, either rounded once to bf16 (Mixtral: the
// formula of torchmx_tpu/layers/mx_mixtral_moe.py:249-250) or kept in f32
// (DeepSeek-V3: torchmx_tpu/models/deepseek.py:613-614, whose sigmoid scores
// see no bf16 rounding).  Both are plain jnp matmuls there: no TPU kernel.
//
// It repairs a fault of the port: cuBLAS sums a row's products in another
// order at other row counts, so a token's logits, and at a near tie the
// experts it is sent to, depended on how many tokens shared the call; the
// engine's whole = chunked = prefixed identity did not hold for MoE models.
// Here the order is fixed and the same as the plain version's
// (ops/cuda_moe.mx_router_logits_plain), bit for bit: every product of two
// bf16 values is exact in f32; a row is cut into chunks of 256 elements;
// within a chunk a pairwise tree over consecutive elements (lane l holds
// elements 8l .. 8l + 7: three levels in the lane, five by xor shuffles,
// which add the same two values in both lanes of a pair); the chunk sums
// are added in chunk order.  One block of 8 warps per row, warp w takes
// experts w, w + 8, ...  Memory-bound (the rows of x once, W from L2):
// 16-byte loads.
#include "mx_common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per row

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

__global__ void __launch_bounds__(kWarps * 32)
router_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w, void* __restrict__ out, int H, int E,
              int f32_out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long row = blockIdx.x;
  const uint16_t* xr = x + row * H;
  const int chunks = H / 256;
  for (int e = warp; e < E; e += kWarps) {
    const uint16_t* wr = w + (long long)e * H;
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const int k = c * 256 + lane * 8;
      const uint4 xv = *reinterpret_cast<const uint4*>(xr + k);
      const uint4 wv = *reinterpret_cast<const uint4*>(wr + k);
      const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w}, ww[4] = {wv.x, wv.y, wv.z, wv.w};
      float p[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[2 * j] = __fmul_rn(bf16_lo(xw[j]), bf16_lo(ww[j]));
        p[2 * j + 1] = __fmul_rn(bf16_hi(xw[j]), bf16_hi(ww[j]));
      }
      float s = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                          __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      acc = __fadd_rn(acc, s);
    }
    if (lane == 0) {
      if (f32_out)
        static_cast<float*>(out)[row * E + e] = acc;
      else
        static_cast<uint16_t*>(out)[row * E + e] = __bfloat16_as_ushort(__float2bfloat16_rn(acc));
    }
  }
}

}  // namespace

// x (rows, H) bf16, w (E, H) bf16, out (rows, E) bf16 or, with f32_out, f32;
// H a multiple of 256, 1 <= E <= 256.
extern "C" int mx_router_logits_launch(const void* x, const void* w, void* out, long long rows, int H, int E,
                                       int f32_out, void* stream) {
  if (rows == 0) return 0;
  if (H % 256 || E < 1 || E > 256 || rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  router_kernel<<<(unsigned)rows, kWarps * 32, 0, (cudaStream_t)stream>>>((const uint16_t*)x, (const uint16_t*)w,
                                                                          out, H, E, f32_out);
  return cudaGetLastError();
}
