// B9 mx_matmul_int8dot (and mx_matmul_fp8dot): out (M, N) bf16 from x and W
// both as MX codes: x's int8 (or e4m3) codes xd (M, K) in K1's dot order
// with their scales transposed as f32 factors 2^(sx-127), pxT (K/32, Mp), Mp
// = M rounded up to 16; W (K, N) int8 (or e4m3) codes with E8M0 scales sw
// (K/32, N):
//   out[m][n] = sum over blocks b of dot32(x[m, b], W[b, n]) * 2^(sx-127) * 2^(sw-127)
// The wrapper (ops/cuda_matmul_formats.py) quantizes a bf16 x with K1's
// dot-order mode (csrc/mx_quantize.cu).
//
// Replaces torchmx_tpu/ops/pallas_matmul.py::_int8dot_kernel (:728),
// launched by _pallas_matmul_int8dot (:805), with fp8=False and True.
//
// What bounds it on an H100: at decode the weight bytes (K N + K N / 32);
// the operations (2 M N K at 1979 dense int8 / fp8 TOP/s) never, at the M
// <= 256 it is given; above 64 rows the CUDA cores' work on the block
// partials (about four instructions a partial, M N K / 32 of them).  The
// design is B6's TMA + wgmma mainloop with K3's producer warp, and nothing
// to decode:
//  1. out^T = W^T x^T.  W's codes are the A operand, in registers: 64
//     columns of W a consumer warpgroup, two warpgroups, 128 columns a CTA.
//     x's codes are B, K-major in shared memory as TMA lands them.  A CTA
//     takes 64 rows of x.  int8: each MX block is one wgmma.mma_async
//     m64n64k32 on the raw codes (s8.s8 -> s32, the exact block sum) with
//     scale-d = 0, into a partial fragment read only after wait_group 0.
//     e4m3: each MX block is eight mma.sync m16n8k32 a warp (e4m3.e4m3 ->
//     f32, sums of exact products), B from ldmatrix of the same tile: wgmma's
//     e4m3 form keeps fewer bits in its sums, and the 2-layer FP8_DOT model
//     then flips a decisive token against the exact plain path
//     (chip_smoke.py's model check).  The same tile and instructions at
//     every M (x's box is M rows at M <= 64): a row's bytes do not depend on
//     the rows beside it.  The row tiles of a column are neighbours in the
//     grid, so they share its W stream in L2.
//  2. ptxas serializes every wgmma of a kernel that reads one wgmma's
//     accumulator while another is in flight (C7514, even one that has
//     retired under wait_group 1), that starts one in a branch (C7518), or
//     that reads only part of an accumulator (C7511, for the row groups past
//     M).  So each int8 block is started, waited for (wait_group 0) and
//     added, every row group of it; the A fragment of the next block is
//     loaded while a block's wgmma runs, and the two warpgroups run out of
//     phase, so one's wgmma overlaps the other's adds.  The partials are
//     added to the f32 accumulator in block order as acc = fma(s * px[m],
//     pw[n], acc), px = 2^(sx-127) (K1 writes it), pw = 2^(sw-127) built
//     from the exponent bits (scale byte 0 gives +0): (s * px) * pw is exact
//     wherever it is normal, so this is the order and the rounding of the
//     plain version and of B6 (csrc/mx_matmul_1byte.cu).  An int8 block sum
//     has |s| <= 32 * 128 * 128 = 2^19, so s converts exactly as
//     __int_as_float(0x4B400000 + s) - 1.5 * 2^23 (IADD + FADD, valid for
//     |s| < 2^22), not by I2F, which issues 16 a clock an SM.
//  3. K order.  Outside f16 / bf16 wgmma takes A and B K-major only, and W
//     is stored (K, N), N contiguous (the same tensor serves B6 above 256
//     rows; no K-major copy).  One ldmatrix.x4.trans of the 128-byte
//     swizzled code tile (B6's) gives a thread the byte pairs (K 8q' + 2q,
//     8q' + 2q + 1) x (columns 2g, 2g + 1) of matrix q'; one byte permute of
//     matrices 0 and 1 (2 and 3) gives a register of four codes of one
//     column at K {2q, 2q + 1, 8 + 2q, 9 + 2q} (+ 16), where the instruction
//     expects K 4q .. 4q + 3.  A block's dot is a sum, so K1's dot-order mode
//     writes x's codes under the same permutation of K inside each 16 (x's
//     stored position 4q + j holds its element 2q + (j & 1) + 8 (j >> 1)):
//     the products pair up, the scales are untouched.  Lane shuffles would
//     cost the same permutes and more; a permuted copy of W would double
//     its memory.
//  4. Loads overlap the tensor cores: a ring of kStages stages filled by TMA
//     from a producer warp through full / empty mbarriers (K3's); no CTA
//     barrier in the mainloop.  A stage is 64 K: 64 x 64 bytes of x codes
//     (64-byte swizzled; at M < 64 the box is M rows, the rest zeros set
//     once), 64 x 128 bytes of W codes (128-byte swizzled), W's two scale
//     rows (128 bytes each) and x's two rows of f32 factors (one 2-D box of
//     pxT: K1 writes x's scales transposed): 12.8 KB, so the ring is deeper
//     than B6's.
//  5. K splits: ops/cuda_matmul.k_splits(N, K, sms), 64 K a stage, B6's
//     plan; summed ((0 + p0) + p1) + ... in split order (mx::reduce_splits).
//     Where the output tiles fill half the card a CTA walks its splits in
//     that order, adding each split's accumulator to a total held in shared
//     memory; otherwise blockIdx.z takes one split, its partial goes to the
//     fp32 workspace and the reduce kernel sums them.  With int8 codes every
//     partial is exact and both kernels add them in the same order, so an
//     int8 row gets B6's bytes.
// The epilogue stages the result through shared memory and stores 16 bytes
// a thread.
#include <type_traits>

#include "mx_common.cuh"
#include "mx_wgmma.cuh"

namespace {

// Built with -DB9_DATAPATH_ONLY (torchmx_tpu_torch/tools/b8_phase_profile.py
// --datapath-only), the consumers only wait for each stage to land and
// release its slot: no fragment, wgmma or partial, the output zeros.  It
// times the weight and x stream of the mainloop alone.

constexpr int kKT = 64;                          // K elements per stage: two MX blocks
constexpr int kBN = 128;                         // columns of W per CTA: two warpgroups of 64
constexpr int kBM = 64;                          // rows of x per CTA: wgmma m64n64k32
constexpr int kConsumers = 256;                  // two warpgroups: the dots and the partials
constexpr int kThreads = kConsumers + 32;        // and one producer warp: TMA
constexpr int kStages = 8;                       // TMA ring depth
constexpr int kOutStride = kBN + 8;              // fp32 staging row stride, in floats
constexpr int kXBytes = kBM * kKT;               // x codes: 64 rows of 64 bytes
constexpr int kWBytes = kKT * kBN;               // W codes: 64 K rows of 128 bytes
constexpr int kSwBytes = 2 * kBN;                // W's two scale rows (bytes)
constexpr int kSBytes = kSwBytes + 2 * kBM * 4;  // then x's two rows of f32 factors

// Dynamic shared memory (cuda_matmul_formats.b9_smem_bytes mirrors it): the
// x, W and scale rings, their full and empty mbarriers and the fp32 staging
// tile; 1024 bytes of slack align the swizzled tiles.
struct Smem {
  static constexpr int x = 0;
  static constexpr int w = kStages * kXBytes;
  static constexpr int s = w + kStages * kWBytes;
  static constexpr int full = s + kStages * kSBytes;  // a ring slot's fill has landed
  static constexpr int empty = full + 8 * kStages;    // a ring slot's readers are done
  static constexpr int out = empty + 8 * kStages;
  static constexpr int bytes = out + kBM * kOutStride * 4 + 1024;
};

// Start the TMA copies of K stage `it` into ring slot `slot` (one thread):
// x's codes (xrows rows from m0, K it*64 ..), W's codes, W's two scale rows
// and x's two rows of scale factors (sxw columns from m0); past M, N and Mp
// they come as zeros.
__device__ __forceinline__ void load_stage(uint32_t sbase, int slot, int it, int xrows, int sxw,
                                           const CUtensorMap* tx, const CUtensorMap* tw, const CUtensorMap* tsw,
                                           const CUtensorMap* tsx, int m0, int n0) {
  const uint32_t bar = sbase + Smem::full + slot * 8;
  mx::mbar_expect_tx(bar, xrows * kKT + kWBytes + kSwBytes + 2 * sxw * 4);
  mx::tma_load_2d(sbase + Smem::x + slot * kXBytes, tx, bar, it * kKT, m0);
  mx::tma_load_2d(sbase + Smem::w + slot * kWBytes, tw, bar, n0, it * kKT);
  const uint32_t sc = sbase + Smem::s + slot * kSBytes;
  mx::tma_load_2d(sc, tsw, bar, n0, 2 * it);
  mx::tma_load_2d(sc + kSwBytes, tsx, bar, m0, 2 * it);
}

// Block blk's A fragment of a stage, from one ldmatrix.x4.trans of K rows
// 32 blk + 8q' .. + 7 (matrix q'), the warp's 16 columns (chunk cn of a row;
// lane l passes row l % 8 of matrix l / 8): byte i of raw[q'] is (K 8q' + 2q
// + (i >> 1), column 2g + (i & 1)).  A row g stands for column 2g, row g + 8
// for column 2g + 1; each register takes the bytes of one column at K {2q,
// 2q + 1, 8 + 2q, 9 + 2q} (+ 16 for a[2], a[3]): K1's dot order.
__device__ __forceinline__ void fragment(uint32_t (&a)[4], uint32_t sbase, int slot, int blk, int cn, int lane) {
  uint32_t r[4];
  mx::ldmatrix_x4_trans(r, sbase + Smem::w + slot * kWBytes + mx::sw128(32 * blk + lane, cn));
  a[0] = __byte_perm(r[0], r[1], 0x6420);
  a[1] = __byte_perm(r[0], r[1], 0x7531);
  a[2] = __byte_perm(r[2], r[3], 0x6420);
  a[3] = __byte_perm(r[2], r[3], 0x7531);
}

// Start one MX block of int8 codes: p = its dot over the slot's 64 x rows
// (A from f, B the x tile at K offset 32 blk), one commit group.
__device__ __forceinline__ void start_block(int (&p)[32], const uint32_t (&f)[4], uint32_t xs, int blk) {
  mx::wgmma_fence();
  mx::wgmma_m64n64k32_s8_rs(p, f, mx::wgmma_desc_sw64(xs + 32 * blk));
  mx::wgmma_commit();
}

// One MX block of e4m3 codes over the slot's 64 x rows by mma.sync
// m16n8k32 (f32 sums of exact products; wgmma's e4m3 sums keep fewer bits):
// p[4j + 2c + i] as start_block's fragment, for the row tiles j < nt8 (the
// tiles past M are neither computed nor added).  A is this warp's slice of
// the warpgroup fragment f; B's registers come from ldmatrix of the 64-byte
// swizzled x tile: matrix q of tile pair jj holds rows 8 (2jj + (q >> 1))
// .., 16-byte chunk 2 blk + (q & 1), so a thread gets x row 8j + g's codes
// at K 4q' .. 4q' + 3 (+ 16), the dot order's positions, as the
// instruction's B fragment.
__device__ __forceinline__ void dot_block_e4m3(float (&p)[32], const uint32_t (&f)[4], uint32_t xs, int blk, int nt8,
                                               int lane) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    if (2 * jj < nt8) {
      const int q = lane >> 3, r = 8 * (2 * jj + (q >> 1)) + (lane & 7), c = 2 * blk + (q & 1);
      uint32_t b[4];
      mx::ldmatrix_x4(b, xs + r * kKT + ((c ^ ((r >> 1) & 3)) << 4));
      mx::mma_e4m3_16832(p + 8 * jj, f, b);
      if (2 * jj + 1 < nt8) mx::mma_e4m3_16832(p + 8 * jj + 4, f, b + 2);
    }
}

// The exact value of a block sum: int8's s32 by the magic-number conversion
// (|s| <= 2^19 < 2^22), e4m3's f32 as it is.
__device__ __forceinline__ float block_sum(int s) { return __fsub_rn(__int_as_float(0x4B400000 + s), 12582912.f); }
__device__ __forceinline__ float block_sum(float s) { return s; }

// acc += (s * px) * pw for the thread's partials of a retired block (blk of
// the stage slot ss).  p[4j + 2c + i] is x row 8j + 2q + i, W column nb + 2g
// + c; acc[4j + 2c + i] the same element.  s * px is exact, so (s * px) * pw
// is exact wherever it is normal and the fused multiply-add rounds once, as
// the separate add would.  W's scales are E8M0 bytes, x's the f32 factors
// 2^(sx - 127) K1 writes.  The first ng 8-row groups are added: all 8 for
// int8 (a wgmma whose partial is read in part is serialized by ptxas,
// C7511), those holding rows < M for e4m3 (mma.sync).
template <typename P>
__device__ __forceinline__ void add_block(float (&acc)[32], const P (&p)[32], const uint8_t* ss, int blk, int sxw,
                                          int nb, int g, int t, int ng) {
  const uint32_t wv = *reinterpret_cast<const uint16_t*>(ss + blk * kBN + nb + 2 * g);
  const float pw0 = __uint_as_float((wv << 23) & 0x7F800000u), pw1 = __uint_as_float((wv << 15) & 0x7F800000u);
  const float* px = reinterpret_cast<const float*>(ss + kSwBytes) + blk * sxw + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= ng) break;
    const float2 x = *reinterpret_cast<const float2*>(px + 8 * j);
    float* a = acc + 4 * j;
    a[0] = __fmaf_rn(__fmul_rn(block_sum(p[4 * j]), x.x), pw0, a[0]);
    a[1] = __fmaf_rn(__fmul_rn(block_sum(p[4 * j + 1]), x.y), pw0, a[1]);
    a[2] = __fmaf_rn(__fmul_rn(block_sum(p[4 * j + 2]), x.x), pw1, a[2]);
    a[3] = __fmaf_rn(__fmul_rn(block_sum(p[4 * j + 3]), x.y), pw1, a[3]);
  }
}

// A split ends: total (this thread's elements of the [m][n] staging tile)
// += acc, acc = 0.
__device__ __forceinline__ void flush_split(float (&acc)[32], float* total, int nb, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2* q = reinterpret_cast<float2*>(total + (8 * j + 2 * t + i) * kOutStride + nb + 2 * g);
      float2 v = *q;
      v.x += acc[4 * j + i];
      v.y += acc[4 * j + 2 + i];
      *q = v;
    }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
}

// A consumer warpgroup's mainloop over its nt >= 1 stages: block 0, then
// block 1 of each stage, so each row's partials come in block order.  A
// block's partial is read after wait_group 0 (no wgmma in flight: ptxas
// serializes nothing); while its wgmma runs, the CUDA cores load the next A
// fragment.  The two warpgroups run out of phase, so one's wgmma overlaps the
// other's adds.  The stage's slot is released once its second block has
// retired and its scales were read; k counts the stages of the current
// split.
template <bool FP8>
__device__ __forceinline__ void consume(float* total, uint8_t* smem, uint32_t sbase, int nt, int per, int sxw,
                                        int nt8, int tid) {
  using P = typename std::conditional<FP8, float, int>::type;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, nb = wg * 64 + warp * 16, cn = nb / 16;
  float acc[32];
  P p[32];  // written by wgmma only (scale-d = 0)
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0.f;
    p[i] = 0;
  }
  uint32_t f0[4], f1[4];  // the stage's A fragments of blocks 0 and 1
  mx::mbar_wait(sbase + Smem::full, 0);
  fragment(f0, sbase, 0, 0, cn, lane);
  for (int st = 0, k = 0; st < nt; ++st) {
    const int slot = st % kStages;
    const uint32_t xs = sbase + Smem::x + slot * kXBytes;
    const uint8_t* ss = smem + Smem::s + slot * kSBytes;
    if constexpr (FP8) {
      fragment(f1, sbase, slot, 1, cn, lane);
      dot_block_e4m3(p, f0, xs, 0, nt8, lane);
      add_block(acc, p, ss, 0, sxw, nb, g, t, nt8);
      dot_block_e4m3(p, f1, xs, 1, nt8, lane);
      if (st + 1 < nt) {
        const int nslot = (st + 1) % kStages;
        mx::mbar_wait(sbase + Smem::full + 8 * nslot, ((st + 1) / kStages) & 1);  // stage st + 1 has landed
        fragment(f0, sbase, nslot, 0, cn, lane);
      }
      add_block(acc, p, ss, 1, sxw, nb, g, t, nt8);
    } else {
      start_block(p, f0, xs, 0);
      fragment(f1, sbase, slot, 1, cn, lane);
      mx::wgmma_wait<0>();
      mx::fence_fragment(p);
      add_block(acc, p, ss, 0, sxw, nb, g, t, 8);
      start_block(p, f1, xs, 1);
      if (st + 1 < nt) {  // the next stage's first fragment, under block 1's wgmma
        const int nslot = (st + 1) % kStages;
        mx::mbar_wait(sbase + Smem::full + 8 * nslot, ((st + 1) / kStages) & 1);  // stage st + 1 has landed
        fragment(f0, sbase, nslot, 0, cn, lane);
      }
      mx::wgmma_wait<0>();
      mx::fence_fragment(p);
      add_block(acc, p, ss, 1, sxw, nb, g, t, 8);
    }
    __syncwarp();
    if (lane == 0) mx::mbar_arrive(sbase + Smem::empty + 8 * slot);
    if (st + 1 == nt || ++k == per) {  // the split ends
      flush_split(acc, total, nb, g, t);
      k = 0;
    }
  }
}

// blockIdx.x: the row tile, blockIdx.y: the column tile (the row tiles of a
// column run together and share its W stream in L2), blockIdx.z: the split.
template <bool FP8>
__device__ __forceinline__ void matmul_body(const CUtensorMap* tx, const CUtensorMap* tw, const CUtensorMap* tsw,
                                            const CUtensorMap* tsx, uint16_t* __restrict__ out,
                                            float* __restrict__ ws, int M, int N, int K, int splits, int xrows,
                                            int sxw) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = mx::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = mx::smem_addr(smem);
  float* total = reinterpret_cast<float*>(smem + Smem::out);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int iters = K / kKT, per = (iters + splits - 1) / splits;
  // gridDim.z == 1: this CTA walks every split in order; else split blockIdx.z.
  const int it0 = gridDim.z == 1 ? 0 : blockIdx.z * per;
  const int it1 = gridDim.z == 1 ? iters : min(iters, it0 + per);
  const int nt = max(it1 - it0, 0);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mx::mbar_init(sbase + Smem::full + 8 * s, 1);
      mx::mbar_init(sbase + Smem::empty + 8 * s, kConsumers / 32);  // one arrival a consumer warp
    }
    mx::mbar_init_fence();
  }
  for (int i = tid; i < kBM * kOutStride / 4; i += kThreads)
    reinterpret_cast<float4*>(total)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // x rows past the box (the box holds min(M, 64) rows) and the scale
  // factors past x's box are zeros that TMA never writes: set them once.
  for (int i = tid; i < kStages * (kBM - xrows) * 4; i += kThreads) {
    const int c = i & 3, r = xrows + (i >> 2) % (kBM - xrows), sl = (i >> 2) / (kBM - xrows);
    *reinterpret_cast<uint4*>(smem + Smem::x + sl * kXBytes + r * kKT + c * 16) = make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < kStages * kSBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem + Smem::s)[i] = make_uint4(0, 0, 0, 0);
  mx::fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer: stage st into slot st % kStages once the slot's readers
    // of stage st - kStages are done.
    if (tid == kConsumers)
      for (int st = 0; st < nt; ++st) {
        const int slot = st % kStages;
        if (st >= kStages) mx::mbar_wait(sbase + Smem::empty + 8 * slot, (st / kStages - 1) & 1);
        load_stage(sbase, slot, it0 + st, xrows, sxw, tx, tw, tsw, tsx, m0, n0);
      }
  } else {
#ifdef B9_DATAPATH_ONLY
    for (int st = 0; st < nt; ++st) {
      const int slot = st % kStages;
      mx::mbar_wait(sbase + Smem::full + 8 * slot, (st / kStages) & 1);
      if ((tid & 31) == 0) mx::mbar_arrive(sbase + Smem::empty + 8 * slot);
    }
#else
    if (nt > 0) consume<FP8>(total, smem, sbase, nt, per, sxw, (min(kBM, M - m0) + 7) / 8, tid);
#endif
  }
  __syncthreads();

  // Epilogue: 8 columns a thread, 16-byte stores.
  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float4 a = *reinterpret_cast<const float4*>(total + r * kOutStride + c);
    const float4 b = *reinterpret_cast<const float4*>(total + r * kOutStride + c + 4);
    if (gridDim.z == 1) {
      __nv_bfloat162 o[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                             __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
      *reinterpret_cast<uint4*>(out + (long long)m * N + n) = *reinterpret_cast<const uint4*>(o);
    } else {
      float* dst = ws + ((long long)blockIdx.z * M + m) * N + n;
      *reinterpret_cast<float4*>(dst) = a;
      *reinterpret_cast<float4*>(dst + 4) = b;
    }
  }
}

// Distinct kernel names per code format, so that a profile tells them apart.
__global__ void __launch_bounds__(kThreads, 1)
wgmma_int8dot_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tsw, const __grid_constant__ CUtensorMap tsx,
                     uint16_t* __restrict__ out, float* __restrict__ ws, int M, int N, int K, int splits, int xrows,
                     int sxw) {
  matmul_body<false>(&tx, &tw, &tsw, &tsx, out, ws, M, N, K, splits, xrows, sxw);
}

__global__ void __launch_bounds__(kThreads, 1)
wgmma_fp8dot_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tsw, const __grid_constant__ CUtensorMap tsx,
                    uint16_t* __restrict__ out, float* __restrict__ ws, int M, int N, int K, int splits, int xrows,
                    int sxw) {
  matmul_body<true>(&tx, &tw, &tsw, &tsx, out, ws, M, N, K, splits, xrows, sxw);
}

// Sum the split-K partials in split order and round once to bf16.
__global__ void reduce_splits_b9_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out, long long mn,
                                        int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void reduce_splits_b9_fp8_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out, long long mn,
                                            int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

template <typename Kernel>
int reduce_launch(Kernel kernel, const void* ws, void* out, long long mn, int splits, void* stream) {
  if (mn == 0) return 0;
  kernel<<<(unsigned)((mn + 255) / 256), 256, 0, (cudaStream_t)stream>>>((const float*)ws, (uint16_t*)out, mn,
                                                                         splits);
  return (int)cudaGetLastError();
}

template <bool FP8>
int launch(const void* xd, const void* pxT, const void* w, const void* sw, void* out, void* ws, int M, int N, int K,
           int Mp, int splits, int walk, int reduce, cudaStream_t stream) {
  if (M == 0) return 0;
  if (splits < 1 || K <= 0 || K % kKT || N % 64 || Mp % 16 || Mp < M) return (int)cudaErrorInvalidValue;
  walk = walk || splits == 1;
  if (!walk && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int xrows = min(M, kBM), sxw = min(Mp, kBM);  // past M: zeros set once in shared memory
  CUtensorMap tx, tw, tsw, tsx;
  if (!mx::tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, xd, K, M, K, kKT, xrows, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !mx::tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, kBN, kKT, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !mx::tensor_map(&tsw, CU_TENSOR_MAP_DATA_TYPE_UINT8, sw, N, K / 32, N, kBN, 2, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !mx::tensor_map(&tsx, CU_TENSOR_MAP_DATA_TYPE_UINT32, pxT, Mp, K / 32, (uint64_t)Mp * 4, sxw, 2,
                      CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  auto kernel = FP8 ? wgmma_fp8dot_kernel : wgmma_int8dot_kernel;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, walk ? 1 : splits);
  kernel<<<grid, kThreads, Smem::bytes, stream>>>(tx, tw, tsw, tsx, (uint16_t*)out, (float*)ws, M, N, K, splits,
                                                  xrows, sxw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || walk || !reduce) return (int)err;
  return reduce_launch(FP8 ? reduce_splits_b9_fp8_kernel : reduce_splits_b9_kernel, ws, out, (long long)M * N,
                       splits, stream);
}

}  // namespace

// B9 over int8 codes: xd (M, K) in K1's dot order, pxT (K/32, Mp) x's f32
// scale factors 2^(sx-127) (Mp % 16 == 0, Mp >= M), w (K, N) codes, sw (K/32,
// N) E8M0 scales; K % 64 == 0, N % 64 == 0.  walk != 0 (or splits == 1):
// each CTA walks all splits and writes out (ws is not read and may be null);
// else split s writes its fp32 partial to ws[s] (splits x M x N), and with
// reduce != 0 the same call launches the reduce that sums them into out
// (one host call for the served path), with reduce == 0 the main kernel
// alone runs (mx_matmul_int8dot_reduce_launch sums).
extern "C" int mx_matmul_int8dot_launch(const void* xd, const void* pxT, const void* w, const void* sw, void* out,
                                        void* ws, int M, int N, int K, int Mp, int splits, int walk, int reduce,
                                        void* stream) {
  return launch<false>(xd, pxT, w, sw, out, ws, M, N, K, Mp, splits, walk, reduce, (cudaStream_t)stream);
}

// The same with e4m3 codes (TORCHMX_FP8_DOT).
extern "C" int mx_matmul_fp8dot_launch(const void* xd, const void* pxT, const void* w, const void* sw, void* out,
                                       void* ws, int M, int N, int K, int Mp, int splits, int walk, int reduce,
                                       void* stream) {
  return launch<true>(xd, pxT, w, sw, out, ws, M, N, K, Mp, splits, walk, reduce, (cudaStream_t)stream);
}

// out (mn bf16) = the split partials ws (splits x mn fp32) summed in split order.
extern "C" int mx_matmul_int8dot_reduce_launch(const void* ws, void* out, long long mn, int splits, void* stream) {
  return reduce_launch(reduce_splits_b9_kernel, ws, out, mn, splits, stream);
}

extern "C" int mx_matmul_fp8dot_reduce_launch(const void* ws, void* out, long long mn, int splits, void* stream) {
  return reduce_launch(reduce_splits_b9_fp8_kernel, ws, out, mn, splits, stream);
}
