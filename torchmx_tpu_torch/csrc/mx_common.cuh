// Shared device code of the MX kernels: element format constants, the
// per-element hw-exact cast, the fake-quantize "magic number" cast and the
// code -> bf16 decoders (each mirrors a plain PyTorch version in
// torchmx_tpu_torch/, named in its comment, bit for bit); then what the
// attention kernels share: the mma and ldmatrix wrappers, the 4x4 byte
// transpose and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mx {

// Element format codes (ELEM_CODES in ops/cuda_lib.py).
enum ElemCode { kFp8E4M3 = 0, kFp4E2M1 = 1, kFp6E3M2 = 2, kFp6E2M3 = 3, kInt8 = 4 };

template <int E> struct Elem;
// mb: mantissa bits, eb: exponent bits, max_pow2: largest binade,
// tmant: fp32 mantissa field of max / 2^max_pow2 (the clamp threshold).
template <> struct Elem<kFp8E4M3> { static constexpr int mb = 3, eb = 4, bias = 7, max_pow2 = 8, tmant = 0x600000; };
template <> struct Elem<kFp4E2M1> { static constexpr int mb = 1, eb = 2, bias = 1, max_pow2 = 2, tmant = 0x400000; };
template <> struct Elem<kFp6E3M2> { static constexpr int mb = 2, eb = 3, bias = 3, max_pow2 = 4, tmant = 0x600000; };
template <> struct Elem<kFp6E2M3> { static constexpr int mb = 3, eb = 2, bias = 1, max_pow2 = 2, tmant = 0x700000; };
template <> struct Elem<kInt8>    { static constexpr int mb = 7, eb = 0, bias = 0, max_pow2 = 6, tmant = 0x7E0000; };

__device__ __forceinline__ float f32_from_bits(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ uint32_t f32_bits(float f) { return __float_as_uint(f); }

// Position of the leading one of a 7-bit mantissa, -1 for 0
// (mx_quantization.leading_one_position).
__device__ __forceinline__ int leading_one(int m) { return m ? 31 - __clz(m) : -1; }

// Shared E8M0 exponent from the block's max biased bf16 exponent
// (mx_quantization.get_e8m0_shared_exponent).
__device__ __forceinline__ int block_scale(int emax, int max_pow2) {
  if (emax == 255) return 255;
  return min(max(emax - max_pow2, 0), 254);
}

// Drop `shift_in` low bits with round-half-to-even (mx_quantization.round_to_even).
__device__ __forceinline__ int round_to_even(int m, int shift_in) {
  int shift = min(max(shift_in, 1), 25);
  int reduced = m >> shift;
  int rem = m & ((1 << shift) - 1);
  int round_bit = rem >> (shift - 1);
  bool sticky = (rem & ((1 << (shift - 1)) - 1)) != 0;
  bool up = round_bit > 0 && ((reduced & 1) || sticky);
  return shift_in <= 0 ? m : reduced + (up ? 1 : 0);
}

// The hw-exact element cast of one bf16 value against its block's shared
// exponent; returns the unpacked code
// (mx_quantization.quantize_mx_with_e8m0_shared_exponent_hw_exact).
template <int E>
__device__ __forceinline__ int cast_hw_exact(int bits, int se) {
  constexpr int mb = Elem<E>::mb, eb = Elem<E>::eb, bias = Elem<E>::bias;
  int sign = (bits >> 15) & 1;
  int exponent = (bits >> 7) & 0xFF;
  int mant = bits & 0x7F;
  bool nan_scale = se == 255;
  if (nan_scale) sign = 0;
  bool zero = exponent == 0 && mant == 0;
  if (exponent == 0 && !zero) {  // normalise bf16 subnormal inputs
    int lo = leading_one(mant);
    mant = (mant << min(max(7 - lo, 0), 8)) & 0x7F;
    exponent = -(6 - lo);
  }
  int ne = exponent - se + bias;
  int rounded = ne > 0 ? round_to_even(mant, 7 - mb) : 0;
  bool osub = ne <= 0 && ne >= -mb && !zero;
  if (osub) {
    int sticky = (mant & 0xF) != 0;
    int subz = (1 << 6) | ((mant >> 4) << 3) | (sticky << 2);
    rounded = round_to_even(subz, 7 - mb - ne);
  }
  if (rounded > (1 << mb) - 1) {  // mantissa overflow carries
    rounded = 0;
    ne += 1;
  }
  osub = ne <= 0 && ne >= -mb && !zero;
  bool underflow = ne < -mb || nan_scale || zero;
  bool sat = ne > (1 << eb) - 1;
  int max_normal = (1 << (mb + eb)) - 1;
  if (E == kFp8E4M3) {  // S.1111.111 is NaN; 448 is S.1111.110
    sat = sat || (ne == 15 && rounded == 7);
    max_normal = 0x7E;
  }
  bool normal = !(sat || underflow || osub);
  int z = osub ? rounded : 0;
  if (normal) z = (min(max(ne, 1), (1 << eb) - 1) << mb) | rounded;
  if (sat) z = max_normal;
  if (underflow) z = 0;
  return (sign << (mb + eb)) | z;
}

// int8 codes: x / 2^(se-127), clamp, round half to even, NaN (and NaN-scale
// blocks) to 0 (mx_quantization.quantize_mx_with_e8m0_shared_exponent_simulated).
__device__ __forceinline__ int cast_int8(int bits, int se) {
  if (se == 255) return 0;
  int sign = (bits >> 15) & 1, e = (bits >> 7) & 0xFF, m = bits & 0x7F;
  uint32_t b32 = (uint32_t)bits << 16;
  int prescale = 0;
  if (e == 0 && m > 0) {  // exact normal view of a subnormal, times 2^64
    int p = leading_one(m);
    b32 = ((uint32_t)sign << 31) | ((uint32_t)(p - 133 + 64 + 127) << 23) |
          ((uint32_t)((m << (7 - p)) & 0x7F) << 16);
    prescale = 64;
  }
  int shift = 127 - se - prescale;
  float inv1 = f32_from_bits((uint32_t)((shift >> 1) + 127) << 23);
  float inv2 = f32_from_bits((uint32_t)((shift - (shift >> 1)) + 127) << 23);
  float v = __fmul_rn(__fmul_rn(f32_from_bits(b32), inv1), inv2);
  if (isnan(v)) return 0;
  v = fminf(fmaxf(v, -127.f), 127.f);
  return (int)rintf(v);
}

// One E8M0 exponent a row (mx_quantize_rows in csrc/mx_quantize.cu, and B14's
// query in csrc/mx_mla_int8dot.cu): the row's w bf16 values (w % 32 == 0, w
// <= 32 * kMaxRowLanes) quantized by one warp, bit for bit quantize_mx_plain(x,
// elem, w).  Lane l keeps elements l, l + 32, ... in registers; the row's
// exponent max is one warp reduction; each element is cast as K1 casts it.
// Hands (element index, code) to `store` and returns the row's exponent.
// quantize_row_bits takes the lane's elements already loaded (bits[i] =
// element 32 i + lane).
constexpr int kMaxRowLanes = 32;  // w / 32 elements a lane, w <= 1024

template <int E>
__device__ __forceinline__ int cast_code(int bits, int se) {
  if (E == kInt8) return cast_int8(bits, se);
  return cast_hw_exact<E>(bits, se);
}

template <int E, typename Store>
__device__ __forceinline__ int quantize_row_bits(const int (&bits)[kMaxRowLanes], int w, int lane, Store store) {
  int emax = 0;
#pragma unroll
  for (int i = 0; i < kMaxRowLanes; ++i)
    if (i * 32 < w) emax = max(emax, (bits[i] >> 7) & 0xFF);
  emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)emax);
  int se = block_scale(emax, Elem<E>::max_pow2);
#pragma unroll
  for (int i = 0; i < kMaxRowLanes; ++i)
    if (i * 32 < w) store(i * 32 + lane, cast_code<E>(bits[i], se));
  return se;
}

template <int E, typename Store>
__device__ __forceinline__ int quantize_row(const uint16_t* __restrict__ x, int w, int lane, Store store) {
  int bits[kMaxRowLanes];
#pragma unroll
  for (int i = 0; i < kMaxRowLanes; ++i)
    if (i * 32 < w) bits[i] = x[i * 32 + lane];
  return quantize_row_bits<E>(bits, w, lane, store);
}

// Fake-quantize one bf16 value against its block's shared exponent: clamp to
// max * 2^(se-127), then round to the MX grid's quantum 2^qe with the fp32
// magic-number add (|x| + M) - M, M = 1.5 * 2^(23+qe).  Subnormal operands
// are honoured (-ftz=false); results below the fp32 normal range flush to a
// signed zero, as dequantize_mx does (ops.cuda_quantize.mx_fake_quantize_plain).
// Returns bf16 bits.
template <int E>
__device__ __forceinline__ uint16_t fq_magic(int bits, int se) {
  constexpr int mb = Elem<E>::mb, bias = Elem<E>::bias, max_pow2 = Elem<E>::max_pow2;
  if (se == 255) return 0x7FC0;  // NaN-scale block
  int tfield = se + max_pow2;
  float t = f32_from_bits(tfield >= 255 ? 0x7F800000u : ((uint32_t)tfield << 23) | Elem<E>::tmant);
  float a = fminf(fabsf(f32_from_bits((uint32_t)bits << 16)), t);
  int qe;
  if (E == kInt8) {
    qe = se - 127;
  } else {
    int ex = (bits >> 7) & 0xFF, man = bits & 0x7F;
    int e_eff = (ex == 0 && man != 0) ? leading_one(man) - 6 : ex;
    qe = max(e_eff - 127 - mb, se + (1 - bias - mb) - 127);
  }
  bool big = qe > 100;  // keep the magic constant fp32-normal
  int qe_eff = big ? qe - 64 : qe;
  float mg = f32_from_bits(((uint32_t)(qe_eff + 150) << 23) | 0x400000u);
  if (big) a = __fmul_rn(a, 0x1p-64f);
  float r = __fsub_rn(__fadd_rn(a, mg), mg);
  if (big) r = __fmul_rn(r, 0x1p64f);
  uint32_t sgn = ((uint32_t)bits & 0x8000u) << 16;
  if (E == kInt8 && r == 0.f) sgn = 0;  // int8 has no signed zero
  if (r < 0x1p-126f) r = 0.f;
  __nv_bfloat16 y = __float2bfloat16_rn(f32_from_bits(f32_bits(r) | sgn));
  return __bfloat16_as_ushort(y);
}

// fp4 (e2m1) nibble times 2^(se-127) -> bf16 bits; results below the bf16
// normal range flush to zero (ops.cuda_matmul.decode_fp4_to_bf16).
__device__ __forceinline__ uint16_t decode_fp4(int nib, int se) {
  int c = nib & 7;
  int b = 0x3EC0 + (c << 6) + ((c >= 2) << 6) + ((se - 127) << 7);
  if (c == 0 || b < 0x80) b = 0;
  return (uint16_t)(b | ((nib & 8) << 12));
}

// Generic fp code times 2^(se-127) -> float, for a dot operand: signed
// zeros and the fp8 NaN code are not reproduced, sub-bf16-normal results
// flush to zero (the values of mx_array.dequantize_mx where those are
// bf16-normal).
template <int E>
__device__ __forceinline__ float decode_code_dot(int code, int se) {
  constexpr int mb = Elem<E>::mb, eb = Elem<E>::eb, bias = Elem<E>::bias;
  int mag = (code & ((1 << (mb + eb)) - 1)) << (7 - mb);
  int sub = mag < 0x80;
  int fshift = (se - bias + sub) << 7;
  int b = mag + fshift;
  bool dead = b < 0x80;
  float f = dead ? 0.f : __uint_as_float((uint32_t)b << 16);
  float c = (sub && !dead) ? __uint_as_float((uint32_t)fshift << 16) : 0.f;
  float v = f - c;
  return ((code >> (mb + eb)) & 1) ? -v : v;
}

// int8 code times 2^(se-127) -> float, exact (|code| <= 127); the scale is
// the float whose bits are se << 23, so se == 0 (a never-written slot) gives
// +0.0 (torchmx_tpu/ops/pallas_matmul.py::decode_int8_to_bf16 for every
// value the quantizer can write).
template <>
__device__ __forceinline__ float decode_code_dot<kInt8>(int code, int se) {
  return (float)(int8_t)code * __uint_as_float((uint32_t)se << 23);
}

// D += A (16x16 bf16, row) * B (16x8 bf16, col), fp32 accumulators.
// Fragment layout (g = lane / 4, t = lane % 4): a0 = A[g][2t..2t+1],
// a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..];
// b0 = B[2t..2t+1][g], b1 = B[2t+8..][g]; c0,c1 = C[g][2t..], c2,c3 = C[g+8][2t..].
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D = A (16x32 8-bit, row) * B (32x8 8-bit, col) from a zero accumulator:
// one 32-element MX block.  Fragments (g = lane / 4, t = lane % 4): a0 =
// A[g][4t..4t+3], a1 = A[g+8][4t..], a2 = A[g][16+4t..], a3 = A[g+8][16+4t..]
// (lowest byte first); b0 = B[4t..4t+3][g], b1 = B[16+4t..][g]; c as in
// mma_bf16_16816.  s8: exact int32 sums.  e4m3: f32 sums of exact products.
__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a, const uint32_t* b) {
  c[0] = c[1] = c[2] = c[3] = 0;
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_e4m3_16832(float* c, const uint32_t* a, const uint32_t* b) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A decoded dot operand as bf16 bits (exact: every decoded value is
// bf16-representable).
template <int E>
__device__ __forceinline__ uint16_t decode_bf16_bits(int code, int se) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(decode_code_dot<E>(code, se)));
}

// Sum the split-K partials of element i in split order and round once to
// bf16 (the matmul kernels' second pass; the same arithmetic for all of
// them, so that kernels with the same splits give the same bytes).
__device__ __forceinline__ void reduce_splits(const float* __restrict__ ws, uint16_t* __restrict__ out,
                                              long long mn, int splits, long long i) {
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += ws[k * mn + i];
  out[i] = __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

// The two B fragments (k16 x n8) of mma_bf16_16816 from a [k][n] row-major
// bf16 tile in shared memory: lane l (0..15) passes the address of row k = l
// (8 elements, 16 bytes, 16-byte aligned); lanes 16..31 pass any valid row.
// .trans hands lane (g, t) the elements [k = 2t, 2t+1][n = g] of each 8x8
// block: b0 from rows 0..7, b1 from rows 8..15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* b, const void* smem_row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// 4x4 byte transpose: byte j of w[i] becomes byte i of w[j].
__device__ __forceinline__ void transpose_4x4_bytes(uint32_t* w) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t b = __byte_perm(w[0], w[1], 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t c = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t d = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(a, c, 0x5410);
  w[1] = __byte_perm(a, c, 0x7632);
  w[2] = __byte_perm(b, d, 0x5410);
  w[3] = __byte_perm(b, d, 0x7632);
}

// E8M0 exponent -> the fp32 whose bits are se << 23: 2^(se-127), +0.0 for
// se == 0 (a never-written slot), +inf for 255 (ops.cuda_attention._pow2_scale).
__device__ __forceinline__ float pow2_scale(int se) { return __uint_as_float((uint32_t)se << 23); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace mx
