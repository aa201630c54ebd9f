// K1 mx_quantize and K2 mx_fake_quantize, in all their modes, and
// mx_quantize_rows (one exponent a row).
//
// K1 and K2 replace torchmx_tpu/ops/pallas_quantize.py::_quantize_kernel
// (:137) and ::_fake_quantize_kernel / _fake_quantize_lane_kernel (:217,
// :225).  mx_quantize_rows replaces no TPU kernel: JAX quantizes MLA's
// per-row operands (block = the row's width) as jnp ops under XLA
// (torchmx_tpu/ops/pallas_mla.py:522-527, models/deepseek.py:316-321); it
// is a repair of the port, which ran them as dozens of small PyTorch kernels.
//
// What bounds K1 and K2 on an H100: bytes, and at decode sizes the launch.
// Each element is read once (2 bytes) and written once (1 byte of codes,
// half a byte of fp4, or 2 bytes of bf16), against a few dozen integer
// operations.  The TPU kernels transposed the tensor so the 32-block reduce
// ran over sublanes.  Here one body serves every mode: a thread takes 8
// consecutive elements with one 16-byte load, four neighbouring lanes hold
// one 32-element block, and the block's exponent maximum is two xor
// shuffles among them; the thread casts its 8 elements in registers and
// stores them as one vector (8 code bytes in one 8-byte store, 8 fp4 codes
// packed in one 4-byte store, 8 bf16 in one 16-byte store).  A warp takes 8
// blocks a pass; the grid is sized from the SM count and walks the tensor in
// grid stride, whole warps at a time, so every shuffle has all 32 lanes.
// The modes differ only in where a thread's vector goes:
//  - K1 row-major: the codes as the tensor lies, one scale byte a block;
//  - K1 in B9's dot order (csrc/mx_matmul_int8dot.cu): the codes of each
//    block permuted as B9's W fragments come out of ldmatrix.trans, the
//    scales transposed as f32 factors; the two threads of a half block swap
//    half their code pairs (one shuffle) and each stores 8 bytes;
//  - K1's cache write: a layer's new K and V straight into MXLayerKVCache's
//    four buffers, seq or d-major, at per-row positions clamped as XLA clamps
//    dynamic_update_slice; in the d-major layout a token's codes land L bytes
//    apart (byte stores), and fp4's d-halves bytes pair element p with
//    element p + d/2, which another lane of the warp holds (one shuffle);
//  - K2: the bf16 quantize-dequantize;
//  - K2 in B7's plane order (csrc/mx_matmul.cu): a thread's even elements
//    (8 bytes) into the even plane, its odd ones into the odd plane.
// The casts are those of mx_common.cuh, bit for bit the plain versions
// (ops/cuda_quantize.py); no shared memory.
#include "mx_common.cuh"

namespace {

constexpr int kThreads = 256;  // threads a CTA
constexpr int kCtasPerSm = 8;  // CTAs of a grid at most per SM: enough loads in flight
constexpr unsigned kFull = 0xffffffffu;

// CTAs for `units` groups of 8 elements: one unit a thread, at most
// kCtasPerSm CTAs an SM (the rest in grid stride).
unsigned grid_for(long long units, int sms) {
  const long long ctas = (units + kThreads - 1) / kThreads, cap = (long long)(sms > 0 ? sms : 1) * kCtasPerSm;
  return (unsigned)(ctas < 1 ? 1 : ctas < cap ? ctas : cap);
}

// body(u, live) for the units of [0, units) this thread takes: lane l of a
// warp takes unit base + l, the warps walk in grid stride together, so the
// shuffles of a pass find all 32 lanes (live is false past the end; units %
// 4 == 0, so a block's four lanes are live together).
template <typename Body>
__device__ __forceinline__ void for_units(long long units, Body body) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = ((long long)blockIdx.x * kThreads + threadIdx.x) & ~31LL; base < units; base += stride) {
    const long long u = base + threadIdx.x % 32;
    body(u, u < units);
  }
}

__device__ __forceinline__ uint4 load8(const uint16_t* p) { return *reinterpret_cast<const uint4*>(p); }

// Element j of the 8 bf16 bit patterns in v.
__device__ __forceinline__ int bits_at(const uint4& v, int j) {
  const uint32_t w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return (int)((w >> (16 * (j & 1))) & 0xFFFF);
}

// The shared exponent of the thread's block: the largest biased exponent of
// its 8 elements, then of the block's four lanes (xor 1, xor 2).
template <int E>
__device__ __forceinline__ int group_scale(const uint4& v) {
  int emax = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) emax = max(emax, (bits_at(v, j) >> 7) & 0xFF);
  emax = max(emax, __shfl_xor_sync(kFull, emax, 1));
  emax = max(emax, __shfl_xor_sync(kFull, emax, 2));
  return mx::block_scale(emax, mx::Elem<E>::max_pow2);
}

// The 8 one-byte codes, element j in byte j.
template <int E>
__device__ __forceinline__ uint2 codes8(const uint4& v, int se) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j / 4] |= (uint32_t)(mx::cast_code<E>(bits_at(v, j), se) & 0xFF) << (8 * (j % 4));
  return make_uint2(w[0], w[1]);
}

// The 8 fp4 codes, element j in bits 4 j .. 4 j + 3.
__device__ __forceinline__ uint32_t nibbles8(const uint4& v, int se) {
  uint32_t n = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) n |= (uint32_t)(mx::cast_hw_exact<mx::kFp4E2M1>(bits_at(v, j), se) & 0xF) << (4 * j);
  return n;
}

// Pair-packed fp4 bytes: byte j holds element 2 j in its high nibble.
__device__ __forceinline__ uint32_t pair_pack(uint32_t n) { return ((n & 0x0F0F0F0Fu) << 4) | ((n >> 4) & 0x0F0F0F0Fu); }

// The 8 elements fake-quantized, bf16 bits in place.
template <int E>
__device__ __forceinline__ uint4 fq8(const uint4& v, int se) {
  uint32_t o[4];
#pragma unroll
  for (int w = 0; w < 4; ++w)
    o[w] = (uint32_t)mx::fq_magic<E>(bits_at(v, 2 * w), se) | ((uint32_t)mx::fq_magic<E>(bits_at(v, 2 * w + 1), se) << 16);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <int E>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const uint16_t* __restrict__ x, uint8_t* __restrict__ scale, uint8_t* __restrict__ codes,
                long long units) {
  for_units(units, [&](long long u, bool live) {
    const uint4 v = live ? load8(x + 8 * u) : make_uint4(0u, 0u, 0u, 0u);
    const int se = group_scale<E>(v);
    if (!live) return;
    if ((u & 3) == 0) scale[u >> 2] = (uint8_t)se;
    if constexpr (E == mx::kFp4E2M1)
      *reinterpret_cast<uint32_t*>(codes + 4 * u) = pair_pack(nibbles8(v, se));
    else
      *reinterpret_cast<uint2*>(codes + 8 * u) = codes8<E>(v, se);
  });
}

// K1 in B9's dot order: block b of row m as K1 quantizes it, its code of
// element 16h + k stored at position 16h + 4 ((k & 7) >> 1) + (k & 1) + 2 (k
// >> 3) of the block (the order in which B9's W fragments come out of
// ldmatrix.trans), its scale as the f32 factor 2^(se - 127) (bits se << 23;
// se = 0 gives +0) at pxT[b][m] (K/32 x Mp: a stage's two rows are one TMA
// box, read by B9 as they are).  The units of rows m >= rows load nothing:
// their scale is 0, the pad factor of columns rows .. Mp - 1.  The threads
// 2h and 2h + 1 of a block hold elements 16h .. 16h + 15; position 16h + 4q
// + j takes the even thread's element 16h + 2q + j (j < 2) or the odd
// thread's 16h + 8 + 2q + j - 2, so the even thread stores words q = 0, 1
// and the odd one q = 2, 3, each its own half and half of its partner's.
template <int E>
__global__ void __launch_bounds__(kThreads)
quantize_dot_kernel(const uint16_t* __restrict__ x, uint32_t* __restrict__ pxT, uint8_t* __restrict__ codes,
                    int rows, int K, int Mp) {
  const int nb = K / 32;
  const long long data_units = (long long)rows * (K / 8);
  for_units((long long)Mp * (K / 8), [&](long long u, bool live) {
    const bool data = u < data_units;
    const uint4 v = data ? load8(x + 8 * u) : make_uint4(0u, 0u, 0u, 0u);
    const int se = group_scale<E>(v);
    const uint2 c = codes8<E>(v, se);
    const bool odd = u & 1;
    const uint32_t recv = __shfl_xor_sync(kFull, odd ? c.x : c.y, 1);
    if (!live) return;
    const long long blk = u >> 2;
    if ((u & 3) == 0) pxT[(blk % nb) * Mp + blk / nb] = (uint32_t)se << 23;
    if (!data) return;
    const uint32_t a = odd ? recv : c.x, b = odd ? c.y : recv;
    *reinterpret_cast<uint2*>(codes + 8 * u) = make_uint2(__byte_perm(a, b, 0x5410), __byte_perm(a, b, 0x7632));
  });
}

template <int E>
__global__ void __launch_bounds__(kThreads)
fake_quantize_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out, long long units) {
  for_units(units, [&](long long u, bool live) {
    const uint4 v = live ? load8(x + 8 * u) : make_uint4(0u, 0u, 0u, 0u);
    const int se = group_scale<E>(v);
    if (live) *reinterpret_cast<uint4*>(out + 8 * u) = fq8<E>(v, se);
  });
}

// K2 in plane order, for B7 (csrc/mx_matmul.cu): element k of a row goes to
// column k / 2 of the even plane (k even) or Kp/2 + k / 2 of the odd plane
// of out (rows, Kp); columns K/2 .. Kp/2 - 1 of each plane are zeros.  A
// block's scale is taken over its 32 consecutive elements of the row, 16 of
// each plane: the joint scale of JAX's _fq_xT_pair.  E < 0: a copy into the
// planes, no quantize.  Unit cu of a row (Kp / 8 a row) holds elements 8 cu
// .. 8 cu + 7, or, past K, the zeros of columns 4 cu .. 4 cu + 3 of each plane.
template <int E>
__global__ void __launch_bounds__(kThreads)
fake_quantize_planes_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out, long long rows, int K,
                            int Kp) {
  const int per_row = Kp / 8;
  for_units(rows * per_row, [&](long long u, bool live) {
    const long long row = u / per_row;
    const int cu = (int)(u % per_row);
    const bool data = live && 8 * cu < K;
    uint4 v = data ? load8(x + row * K + 8 * cu) : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (E >= 0) {
      const int se = group_scale<E>(v);
      if (data) v = fq8<E>(v, se);
    }
    if (!live) return;
    uint16_t* o = out + row * Kp + 4 * cu;
    *reinterpret_cast<uint2*>(o) = make_uint2(__byte_perm(v.x, v.y, 0x5410), __byte_perm(v.z, v.w, 0x5410));
    *reinterpret_cast<uint2*>(o + Kp / 2) = make_uint2(__byte_perm(v.x, v.y, 0x7632), __byte_perm(v.z, v.w, 0x7632));
  });
}

// K1's cache write: a layer's new K (blockIdx.y 0) or V (1), (b, hkv, s, d)
// bf16 with element strides sb, sh, ss and d contiguous, quantized along d
// into MXLayerKVCache's buffers at positions clamp(pos, 0, L - s) + t (pos
// pos_p[batch row], or pos_n for every row):
//   seq: codes (b, hkv, L, d), scales (b, hkv, L, d/32);
//   d-major: codes (b, hkv, dp, L), scales (b, hkv, d/32, L); dp = d, or d/2
//     for fp4, whose byte p holds element p (high nibble) and p + d/2 (low).
struct KvNew {
  const uint16_t* x;
  long long sb, sh, ss;
};
struct KvBufs {
  uint8_t* data;
  uint8_t* scale;
};

template <int E, bool kDmajor>
__global__ void __launch_bounds__(kThreads)
cache_write_kernel(KvNew k, KvNew v, KvBufs kb, KvBufs vb, const int* __restrict__ pos_p, int pos_n, int hkv, int s,
                   int d, int L, long long units) {
  const KvNew in = blockIdx.y ? v : k;
  const KvBufs out = blockIdx.y ? vb : kb;
  const int per_row = d / 8;
  for_units(units, [&](long long u, bool live) {
    const long long r = u / per_row;  // row (batch row, head, t)
    const int e0 = 8 * (int)(u % per_row), t = (int)(r % s), h = (int)((r / s) % hkv);
    const long long bi = r / ((long long)s * hkv), head = bi * hkv + h;
    const uint4 x = live ? load8(in.x + bi * in.sb + h * in.sh + t * in.ss + e0) : make_uint4(0u, 0u, 0u, 0u);
    const int se = group_scale<E>(x);
    if constexpr (E == mx::kFp4E2M1) {  // d-major only (checked at launch)
      const uint32_t n = nibbles8(x, se);
      const uint32_t other = __shfl_xor_sync(kFull, n, d / 16);  // elements e0 +- d/2 of the same row
      if (!live) return;
      const long long col = min(max(pos_p ? pos_p[bi] : pos_n, 0), L - s) + t;
      if ((u & 3) == 0) out.scale[(head * (d / 32) + e0 / 32) * L + col] = (uint8_t)se;
      if (e0 < d / 2) {
        uint8_t* p = out.data + (head * (d / 2) + e0) * L + col;
#pragma unroll
        for (int j = 0; j < 8; ++j) p[(long long)j * L] = (uint8_t)((((n >> (4 * j)) & 0xF) << 4) | ((other >> (4 * j)) & 0xF));
      }
    } else {
      const uint2 c = codes8<E>(x, se);
      if (!live) return;
      const long long col = min(max(pos_p ? pos_p[bi] : pos_n, 0), L - s) + t;
      if constexpr (kDmajor) {
        if ((u & 3) == 0) out.scale[(head * (d / 32) + e0 / 32) * L + col] = (uint8_t)se;
        uint8_t* p = out.data + (head * d + e0) * L + col;
#pragma unroll
        for (int j = 0; j < 8; ++j) p[(long long)j * L] = (uint8_t)(((j < 4 ? c.x : c.y) >> (8 * (j % 4))) & 0xFF);
      } else {
        if ((u & 3) == 0) out.scale[(head * L + col) * (d / 32) + e0 / 32] = (uint8_t)se;
        *reinterpret_cast<uint2*>(out.data + (head * L + col) * d + e0) = c;
      }
    }
  });
}

template <int E>
cudaError_t launch_quantize(const void* x, void* scale, void* codes, long long units, int sms, cudaStream_t stream) {
  quantize_kernel<E><<<grid_for(units, sms), kThreads, 0, stream>>>((const uint16_t*)x, (uint8_t*)scale,
                                                                    (uint8_t*)codes, units);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_quantize_dot(const void* x, void* pxT, void* codes, int rows, int K, int Mp, int sms,
                                cudaStream_t stream) {
  quantize_dot_kernel<E><<<grid_for((long long)Mp * (K / 8), sms), kThreads, 0, stream>>>(
      (const uint16_t*)x, (uint32_t*)pxT, (uint8_t*)codes, rows, K, Mp);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_fq(const void* x, void* out, long long units, int sms, cudaStream_t stream) {
  fake_quantize_kernel<E><<<grid_for(units, sms), kThreads, 0, stream>>>((const uint16_t*)x, (uint16_t*)out, units);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_planes(const void* x, void* out, long long rows, int K, int Kp, int sms, cudaStream_t stream) {
  fake_quantize_planes_kernel<E><<<grid_for(rows * (Kp / 8), sms), kThreads, 0, stream>>>(
      (const uint16_t*)x, (uint16_t*)out, rows, K, Kp);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_cache_write(KvNew k, KvNew v, KvBufs kb, KvBufs vb, const int* pos_p, int pos_n, int b, int hkv,
                               int s, int d, int L, bool dmajor, int sms, cudaStream_t stream) {
  const long long units = (long long)b * hkv * s * (d / 8);
  const dim3 grid(grid_for(units, sms), 2);
  if (dmajor)
    cache_write_kernel<E, true><<<grid, kThreads, 0, stream>>>(k, v, kb, vb, pos_p, pos_n, hkv, s, d, L, units);
  else if constexpr (E != mx::kFp4E2M1)
    cache_write_kernel<E, false><<<grid, kThreads, 0, stream>>>(k, v, kb, vb, pos_p, pos_n, hkv, s, d, L, units);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

constexpr int kWarps = 8;  // rows a CTA of mx_quantize_rows (one warp a row)

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

// x (rows, K) bf16 -> scale (rows, K/32) and codes (rows, K), fp4 (rows, K/2)
// pair-packed; sms: the card's SM count (the grid's size).
extern "C" int mx_quantize_launch(const void* x, void* scale, void* codes, long long rows, int K, int elem, int sms,
                                  void* stream) {
  if (K <= 0 || K % 32 || (uintptr_t)x % 16 || (uintptr_t)codes % 8) return (int)cudaErrorInvalidValue;
  const long long units = rows * (K / 8);
  if (units == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3: return launch_quantize<mx::kFp8E4M3>(x, scale, codes, units, sms, s);
    case mx::kFp4E2M1: return launch_quantize<mx::kFp4E2M1>(x, scale, codes, units, sms, s);
    case mx::kFp6E3M2: return launch_quantize<mx::kFp6E3M2>(x, scale, codes, units, sms, s);
    case mx::kFp6E2M3: return launch_quantize<mx::kFp6E2M3>(x, scale, codes, units, sms, s);
    case mx::kInt8: return launch_quantize<mx::kInt8>(x, scale, codes, units, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K1 in B9's dot order: x (rows, K) -> codes (rows, K) in dot order and
// the f32 scale factors pxT (K/32, Mp) (Mp % 16 == 0, Mp >= rows; columns
// past rows 0); elem: mx::kInt8 or mx::kFp8E4M3.
extern "C" int mx_quantize_dot_launch(const void* x, void* pxT, void* codes, long long rows, int K, int Mp,
                                      int elem, int sms, void* stream) {
  if (K <= 0 || K % 32 || Mp % 16 || Mp < rows || rows >= (1LL << 31) || (uintptr_t)x % 16 || (uintptr_t)codes % 8)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3: return launch_quantize_dot<mx::kFp8E4M3>(x, pxT, codes, (int)rows, K, Mp, sms, s);
    case mx::kInt8: return launch_quantize_dot<mx::kInt8>(x, pxT, codes, (int)rows, K, Mp, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int mx_fake_quantize_launch(const void* x, void* out, long long rows, int K, int elem, int sms,
                                       void* stream) {
  if (K <= 0 || K % 32 || (uintptr_t)x % 16 || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  const long long units = rows * (K / 8);
  if (units == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3: return launch_fq<mx::kFp8E4M3>(x, out, units, sms, s);
    case mx::kFp4E2M1: return launch_fq<mx::kFp4E2M1>(x, out, units, sms, s);
    case mx::kFp6E3M2: return launch_fq<mx::kFp6E3M2>(x, out, units, sms, s);
    case mx::kFp6E2M3: return launch_fq<mx::kFp6E2M3>(x, out, units, sms, s);
    case mx::kInt8: return launch_fq<mx::kInt8>(x, out, units, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

// x (rows, K) -> out (rows, Kp) in B7's plane order; elem: mx::kFp8E4M3,
// mx::kInt8, or -1 for a copy without quantize.  K % 32 == 0, Kp % 64 == 0,
// Kp >= K.
extern "C" int mx_fake_quantize_planes_launch(const void* x, void* out, long long rows, int K, int Kp, int elem,
                                              int sms, void* stream) {
  if (K <= 0 || K % 32 || Kp % 64 || Kp < K || rows >= (1LL << 31) || (uintptr_t)x % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case -1: return launch_planes<-1>(x, out, rows, K, Kp, sms, s);
    case mx::kFp8E4M3: return launch_planes<mx::kFp8E4M3>(x, out, rows, K, Kp, sms, s);
    case mx::kInt8: return launch_planes<mx::kInt8>(x, out, rows, K, Kp, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K1's cache write: k and v (b, hkv, s, d) bf16 at element strides (kb, kh,
// ks) / (vb, vh, vs) of their first three dims (multiples of 8; d
// contiguous) into the cache buffers kd, ksc, vd, vsc (seq or d-major, see
// cache_write_kernel) at pos (b,) int32, or pos_n for every row where pos
// is null; 0 < s <= L, d % 32 == 0; fp4 in the d-major layout only, at d =
// 32, 64, 128 or 256.
extern "C" int mx_cache_write_launch(const void* k, long long kb, long long kh, long long ks, const void* v,
                                     long long vb, long long vh, long long vs, void* kd, void* ksc, void* vd, void* vsc,
                                     const void* pos, int pos_n, int b, int hkv, int s, int d, int L, int elem,
                                     int dmajor, int sms, void* stream) {
  const bool fp4 = elem == mx::kFp4E2M1;
  if (d <= 0 || d % 32 || s <= 0 || s > L || hkv <= 0 || b < 0 || (fp4 && (!dmajor || (d != 32 && d != 64 && d != 128 && d != 256))))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k | (uintptr_t)v) % 16 || (kb | kh | ks | vb | vh | vs) % 8 || (!dmajor && ((uintptr_t)kd | (uintptr_t)vd) % 8))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const KvNew kn{(const uint16_t*)k, kb, kh, ks}, vn{(const uint16_t*)v, vb, vh, vs};
  const KvBufs kbuf{(uint8_t*)kd, (uint8_t*)ksc}, vbuf{(uint8_t*)vd, (uint8_t*)vsc};
  const int* p = (const int*)pos;
  cudaStream_t st = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3: return launch_cache_write<mx::kFp8E4M3>(kn, vn, kbuf, vbuf, p, pos_n, b, hkv, s, d, L, dmajor, sms, st);
    case mx::kFp4E2M1: return launch_cache_write<mx::kFp4E2M1>(kn, vn, kbuf, vbuf, p, pos_n, b, hkv, s, d, L, dmajor, sms, st);
    case mx::kFp6E3M2: return launch_cache_write<mx::kFp6E3M2>(kn, vn, kbuf, vbuf, p, pos_n, b, hkv, s, d, L, dmajor, sms, st);
    case mx::kFp6E2M3: return launch_cache_write<mx::kFp6E2M3>(kn, vn, kbuf, vbuf, p, pos_n, b, hkv, s, d, L, dmajor, sms, st);
    case mx::kInt8: return launch_cache_write<mx::kInt8>(kn, vn, kbuf, vbuf, p, pos_n, b, hkv, s, d, L, dmajor, sms, st);
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
