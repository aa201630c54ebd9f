// The decode of MX code words into wgmma's A fragments, shared by the
// kernels that compute out^T = W^T x^T with W decoded in registers: B6
// (csrc/mx_matmul_1byte.cu, one code a byte), B8 (csrc/mx_matmul_fp6q.cu,
// fp6 codes rebuilt from the quarters planes), K3 (csrc/mx_matmul.cu, fp4
// nibbles and fp8 bytes of the halves layout) and B7 (the same file, fp4
// nibbles of the pair layout, a scale word per k16 step).
//
// A thread's raw operand of one 32-row MX block is four words r[q], from one
// ldmatrix.x4.trans of a [K][n] byte tile (matrix q: K rows 8q .. 8q + 7 of
// the block, the warp's 16 columns): byte hi + 2 i of r[q] is the code at K
// 8q + 2t + i, column 2g + hi of the warp (g = lane / 4, t = lane % 4), and
// s holds the scale bytes of columns 2g (low) and 2g + 1 (high).  Every
// decoded value equals mx::decode_bf16_bits bit for bit (fp4:
// mx::decode_fp4, whose sub-bf16-normal results flush to a signed zero).
#pragma once

#include "mx_common.cuh"

namespace mx {

// Scales at which decode_fast is exact: every decoded value is bf16-normal
// and finite.  int8: [16, 224] (2^23 + 255 times 2^(se-127) is finite in
// fp32); fp: [16, 127 + bias], where 2^(se - bias) is one bf16.
constexpr uint32_t kSafeLo = 16;
template <int E>
__device__ __forceinline__ constexpr uint32_t safe_hi() {
  return E == kInt8 ? 224u : 127u + Elem<E>::bias;
}

// One code as bf16 bits: decode_fp4 for an fp4 nibble (bits above it
// ignored), else decode_bf16_bits.
template <int E>
__device__ __forceinline__ uint32_t decode_one(int code, int se) {
  if constexpr (E == kFp4E2M1) return decode_fp4(code, se);
  else return decode_bf16_bits<E>(code, se);
}

// Two decoded codes as bf16x2: bytes hi and 2 + hi of r (K 2t and 2t + 1
// of one column), with that column's scale se.
template <int E>
__device__ __forceinline__ uint32_t decode_exact(uint32_t r, int hi, int se) {
  return decode_one<E>((int)((r >> (8 * hi)) & 0xFF), se) |
         (decode_one<E>((int)((r >> (16 + 8 * hi)) & 0xFF), se) << 16);
}

// The same where the scale is safe, with no conversion instruction (16 a
// clock on an SM): the bf16 bits are built by integer ops.  int8: the float
// 2^23 + (code + 128) from its bits, times 2^(se-127) less (2^23 + 128)
// 2^(se-127) in one exact fma, then the upper halves of two floats packed.
// fp: each code's sign, exponent and mantissa fields land in a bf16 lane
// (the code's value times 2^(bias-127), a subnormal code a bf16 subnormal),
// then one exact bf16 multiply by scale2 = 2^(se - bias).  Bits above an fp
// code's sign bit are ignored, so an fp4 byte's low nibble decodes as it
// is and its high nibble after a shift.  For fp4 at safe scales this is
// decode_fp4's integer result: every value is normal, and a zero code keeps
// its sign.
template <int E>
__device__ __forceinline__ uint32_t decode_fast(uint32_t r, int hi, float sf, float sneg, uint32_t scale2) {
  if (E == kInt8) {
    const uint32_t u = r ^ 0x80808080u;
    const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + hi));
    const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442 + hi));
    return __byte_perm(__float_as_uint(fmaf(a, sf, sneg)), __float_as_uint(fmaf(b, sf, sneg)), 0x7632);
  } else {
    constexpr int mb = Elem<E>::mb, nb = Elem<E>::mb + Elem<E>::eb;
    constexpr uint32_t mag = 0x01010101u * ((1u << nb) - 1), sgn = 0x01010101u * (1u << nb);
    // bytes hi and 2 + hi into each 16-bit lane: the fields into the low
    // byte, the sign (moved to bit 7 of its byte) into the high byte
    const uint32_t f = __byte_perm(r & mag, 0u, 0x4240 + 0x101 * hi);
    const uint32_t sg = __byte_perm((r & sgn) << (7 - nb), 0u, 0x2404 + 0x1010 * hi);
    uint32_t v = (f << (7 - mb)) + sg;
    __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
    x = __hmul2(x, *reinterpret_cast<const __nv_bfloat162*>(&scale2));
    return *reinterpret_cast<const uint32_t*>(&x);
  }
}

// Whether a scale byte is one at which decode_fast is exact.
template <int E>
__device__ __forceinline__ bool scale_safe(int se) {
  return (uint32_t)se - kSafeLo <= safe_hi<E>() - kSafeLo;
}

// The A fragments of one k16 step, f, from its two raw words (r0: K 0-7 of
// the step, r1: K 8-15) at the scale bytes s_lo / s_hi of the thread's
// columns 2g / 2g + 1, by decode_fast (fast: every scale of the warp is
// safe) or decode_exact.
template <int E>
__device__ __forceinline__ void decode_step(uint32_t (&f)[4], uint32_t r0, uint32_t r1, int s_lo, int s_hi,
                                            bool fast) {
  if (fast) {
    const float sf_lo = __uint_as_float((uint32_t)s_lo << 23), sf_hi = __uint_as_float((uint32_t)s_hi << 23);
    const float sneg_lo = -8388736.0f * sf_lo, sneg_hi = -8388736.0f * sf_hi;  // -(2^23 + 128) 2^(se-127)
    constexpr int rebias = 127 - Elem<E>::bias;
    const uint32_t sc_lo = (uint32_t)(s_lo + rebias) * 0x00800080u;  // bf16x2 2^(se - bias)
    const uint32_t sc_hi = (uint32_t)(s_hi + rebias) * 0x00800080u;
    f[0] = decode_fast<E>(r0, 0, sf_lo, sneg_lo, sc_lo);
    f[1] = decode_fast<E>(r0, 1, sf_hi, sneg_hi, sc_hi);
    f[2] = decode_fast<E>(r1, 0, sf_lo, sneg_lo, sc_lo);
    f[3] = decode_fast<E>(r1, 1, sf_hi, sneg_hi, sc_hi);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = decode_exact<E>(q >> 1 ? r1 : r0, q & 1, q & 1 ? s_hi : s_lo);
  }
}

// The A fragments of a block from its raw operand: f[kk] for the block's
// k16 step kk, both at the scale word s (column 2g's byte low, 2g + 1's
// high).  Where all of the warp's scales are safe, decode_fast; elsewhere
// decode_exact.
template <int E>
__device__ __forceinline__ void decode_fragments(uint32_t (&f)[2][4], const uint32_t (&r)[4], uint32_t s) {
  const int s_lo = s & 0xFF, s_hi = (s >> 8) & 0xFF;  // columns 2g and 2g + 1
  if (__all_sync(0xffffffffu, scale_safe<E>(s_lo) && scale_safe<E>(s_hi))) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) decode_step<E>(f[kk], r[2 * kk], r[2 * kk + 1], s_lo, s_hi, true);
  } else {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) decode_step<E>(f[kk], r[2 * kk], r[2 * kk + 1], s_lo, s_hi, false);
  }
}

// The same where each k16 step has a scale word of its own (s[kk]: the
// block's rows 16 kk .. 16 kk + 15 lie in another MX block than the other
// step's, as in B7's pair layout): the safe test runs per step.
template <int E>
__device__ __forceinline__ void decode_fragments(uint32_t (&f)[2][4], const uint32_t (&r)[4], const uint32_t (&s)[2]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int s_lo = s[kk] & 0xFF, s_hi = (s[kk] >> 8) & 0xFF;
    const bool fast = __all_sync(0xffffffffu, scale_safe<E>(s_lo) && scale_safe<E>(s_hi));
    decode_step<E>(f[kk], r[2 * kk], r[2 * kk + 1], s_lo, s_hi, fast);
  }
}

}  // namespace mx
