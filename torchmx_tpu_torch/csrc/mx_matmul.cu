// K3 mx_matmul_fp4_halves: out (M, N) bf16 = x (M, K) @ W (K, N) with W
// MXFP4 in the K-major "halves" layout: byte p of column n holds element p
// (high nibble) and element p + K/2 (low nibble); scale (K/32, N), rows
// [0, K/64) for the first half, [K/64, K/32) for the second.
// mx_matmul_fp8_halves is the same kernel over MXFP8 halves: uint16 word p
// of column n holds the code of element p (high byte) and of element p +
// K/2 (low byte).
// B7 mx_matmul_fp4_pair is the same kernel over MXFP4 in the reference's
// "pair" layout: byte p of column n holds element 2p (high nibble) and
// element 2p + 1 (low nibble); scale (K/32, N), row p / 16 for byte p.
//
// Replaces torchmx_tpu/ops/pallas_matmul.py::_linear_kernel_fp4_halves
// (:504), launched by _pallas_matmul_fp4_halves (:1110), with elem_name
// "float4_e2m1" and "float8_e4m3", and ::_linear_kernel_fp4 (:473),
// launched by _pallas_matmul_fp4 (:1021).
//
// What bounds it on an H100: at decode (M up to 64) the weight bytes (K N /
// 2 + K N / 32 for fp4, K N + K N / 32 for fp8); at prefill the tensor-core
// operations, 2 M N K at 989 TFLOP/s bf16.  The design is B8's mainloop
// (csrc/mx_matmul_fp6q.cu) with K3's operands:
//  1. x is read as it is: where the caller asks for an activation format
//     x is fake-quantized once by K2 first, at every M, so no column tile
//     repeats the quantize of its rows; the layers share that K2 among the
//     linears that read one x.  For the pair layout K2 writes x as two
//     planes, [even K | odd K], each zero-padded to Kp/2 columns (Kp = 128
//     ceil(K / 128)): as JAX's kernel takes x split into its even and odd K
//     planes, so the pair's high nibbles meet the first plane and its low
//     nibbles the second, exactly where the halves layout's two halves meet
//     x's two halves.
//  2. Loads overlap the tensor cores: a ring of kStages stages filled by TMA
//     from a producer warp (one thread starts a stage's copies once the
//     slot's "empty" mbarrier says every consumer warp is done with it; they
//     complete on its "full" mbarrier; zeros past M and N).  A stage is 128
//     K: 64 packed rows of W (one 128-byte swizzled box of 64 x 128 bytes
//     for fp4, two boxes of 64 x 64 words for fp8, the second left out
//     where it lies wholly past N), the four scale rows of those rows (halves:
//     one 3-D box, two rows of the first half and two of the second; pair:
//     one 2-D box of four consecutive rows, one per 16 packed rows, past the
//     true K/32 rows zeros), and the two matching 64-column x slices at
//     columns p0 and Kx/2 + p0 of x's Kx columns (128-byte swizzled K-major
//     tiles).  At M <= 128 the x box is M rows and the rows past M are zeros
//     set once in shared memory.  No CTA barrier in the mainloop: the two
//     consumer warpgroups run out of phase.
//  3. W is decoded in registers, straight into wgmma's A operand (the
//     kernel computes out^T = W^T x^T).  fp4: one ldmatrix.x4.trans of a
//     32-row tile gives each thread the bytes at K (2t, 2t + 1) of columns
//     2g and 2g + 1 (B6's fragment layout); the high nibbles make the first
//     half's (pair: the even plane's) fragments, the low nibbles the second
//     half's (the odd plane's).  In the halves layout a 32-row tile is one
//     MX block of each half; in the pair layout its two k16 steps lie in two
//     MX blocks, so each step decodes at its own scale word.  fp8: one
//     ldmatrix.x4.trans per k16 step gives the words at K (2t, 2t + 1) of
//     columns g and g + 8; a byte permute splits the high bytes (first
//     half) from the low ones (second half).  One load thus feeds two k16
//     products, against the two x slices.  All decode by
//     csrc/mx_wgmma_decode.cuh (no conversion instruction where the warp's
//     scales are safe), bit for bit mx::decode_fp4 and
//     mx::decode_bf16_bits<kFp8E4M3>; no decoded tile is stored.
//  4. One accumulator: wgmma.mma_async m64n128k16 bf16 -> f32, A from
//     registers, x K-major in shared memory as B, two warpgroups (128
//     columns of W) over 128 rows of x at every M, so a row's bytes do not
//     depend on M.  Every k16 product of a split goes straight into the
//     accumulator (the split's first with scale-d = 0).  One commit group
//     for one 32-row block of both halves (four k16 products); while it
//     runs, the CUDA cores decode the next block into the other of two
//     fragment buffers (wait_group 1 before a buffer is written again); the
//     accumulator is read only after wait_group 0.
//  5. K splits: ops/cuda_matmul.k_splits(N, Kx, sms, 128), a function of N
//     and K alone, summed ((0 + p0) + p1) + ... in split order
//     (mx::reduce_splits).  Where the output tiles fill the card
//     (gridDim.z == 1) a CTA walks its splits in that order itself, adding
//     each split's accumulator to a total held in shared memory.  Otherwise
//     blockIdx.z takes one split, its partial goes to the fp32 workspace and
//     the reduce kernel of the format sums them.
// The epilogue stages the result through shared memory and stores 16 bytes
// a thread.  The element format and the layout are template arguments.
#include "mx_common.cuh"
#include "mx_wgmma.cuh"
#include "mx_wgmma_decode.cuh"

namespace {

// Built with -DK3_PHASE_PROFILE (torchmx_tpu_torch/tools/b8_phase_profile.py
// --kernel k3), the kernel adds each mainloop phase's clock cycles, for
// threads 0 and 200, into the workspace, as B8's hooks do.
#ifdef K3_PHASE_PROFILE
#define K3_PHASE(i) (prof_t[i] += clock64() - prof_c, prof_c = clock64())
#else
#define K3_PHASE(i) ((void)0)
#endif
// Built with -DK3_DATAPATH_ONLY (b8_phase_profile.py --datapath-only), the
// consumers only wait for each stage to land and release its slot: no
// fetch, decode or wgmma, the output zeros.  It times the weight and x
// stream of the mainloop alone.

constexpr int kKT = 128;             // K elements per stage: 64 of each half
constexpr int kRows = 64;            // packed rows of W per stage
constexpr int kBN = 128;             // columns of W per CTA: two warpgroups of 64
constexpr int kBM = 128;             // rows of x per CTA: wgmma n128
constexpr int kConsumers = 256;      // two warpgroups: decode and wgmma
constexpr int kThreads = kConsumers + 32;  // and one producer warp: TMA
constexpr int kStages = 3;           // TMA ring depth
constexpr int kOutStride = kBN + 8;  // fp32 staging row stride, in floats
constexpr int kXSlice = kBM * 128;   // one half's 64 columns of x: kBM rows of 128 bytes
constexpr int kXBytes = 2 * kXSlice;
constexpr int kWBox = kRows * 128;   // one 64 x 128-byte box of W
constexpr int kSBytes = 4 * kBN;

enum Layout { kHalves, kPair };  // W's packing: K3's halves, B7's pair

// Dynamic shared memory (cuda_matmul.k3_smem_bytes mirrors it): the x, W and
// scale rings, their mbarriers and the fp32 staging tile; 1024 bytes of
// slack align the swizzled tiles.  A W stage is one box for fp4 (64 rows x
// 128 columns of bytes), two for fp8 (64 rows x 64 columns of words each).
template <int E>
struct Smem {
  static constexpr int wbytes = (E == mx::kFp4E2M1 ? 1 : 2) * kWBox;
  static constexpr int x = 0;
  static constexpr int w = kStages * kXBytes;
  static constexpr int s = w + kStages * wbytes;
  static constexpr int full = s + kStages * kSBytes;  // a ring slot's fill has landed
  static constexpr int empty = full + 32;             // a ring slot's readers are done
  static constexpr int out = full + 64;
  static constexpr int bytes = out + kBM * kOutStride * 4 + 1024;
};

// Start the TMA copies of K stage `it` into ring slot `slot` (one thread):
// W's packed rows 64 it .. + 63, their four scale rows (halves: rows 2 it and
// 2 it + 1 of both halves; pair: rows 4 it .. 4 it + 3), and x's columns
// 64 it .. and Kx/2 + 64 it .. (xrows rows from m0); past M, N and W's rows
// they come as zeros.
template <int E, int L>
__device__ __forceinline__ void load_stage(uint32_t sbase, int slot, int it, int Kx, int N, int xrows,
                                           const CUtensorMap* tx, const CUtensorMap* tw, const CUtensorMap* ts,
                                           int m0, int n0) {
  const uint32_t bar = sbase + Smem<E>::full + slot * 8;
  const bool second = E == mx::kFp8E4M3 && n0 + 64 < N;  // fp8's second word box lies (partly) inside N
  mx::mbar_expect_tx(bar, 2 * xrows * 128 + (second ? 2 : 1) * kWBox + kSBytes);
  const uint32_t w = sbase + Smem<E>::w + slot * Smem<E>::wbytes;
  mx::tma_load_2d(w, tw, bar, n0, kRows * it);
  if (second) mx::tma_load_2d(w + kWBox, tw, bar, n0 + 64, kRows * it);
  const uint32_t s = sbase + Smem<E>::s + slot * kSBytes;
  if (L == kPair) mx::tma_load_2d(s, ts, bar, n0, 4 * it);
  else mx::tma_load_3d(s, ts, bar, n0, 2 * it, 0);
  const uint32_t x = sbase + Smem<E>::x + slot * kXBytes;
  mx::tma_load_2d(x, tx, bar, kRows * it, m0);
  mx::tma_load_2d(x + kXSlice, tx, bar, Kx / 2 + kRows * it, m0);
}

// A stage's raw operands for this thread, fetched ahead of their decode.
// fp4: r[j][q] from one ldmatrix.x4.trans of rows 32 j .. + 31 (matrix q:
// rows 8q .. 8q + 7, the warp's 16 byte columns).  fp8: r[j][4 kk + q] from
// one ldmatrix.x4.trans per k16 step kk of rows 32 j + 16 kk .. + 15
// (matrices: rows + 0 / + 8 x the warp's columns + 0 / + 8).  s[i]: the
// scale bytes of the thread's two columns (low, high) in the stage's scale
// row i (halves: row j of half h at i = 2 h + j; pair: the MX block of
// packed rows 16 i .. 16 i + 15).  Warp w of warpgroup wg takes columns
// 64 wg + 16 w .. + 15.
template <int E>
struct Raw {
  uint32_t r[2][E == mx::kFp4E2M1 ? 4 : 8];
  uint32_t s[4];
};

template <int E>
__device__ __forceinline__ void fetch(Raw<E>& raw, const uint8_t* smem, uint32_t sbase, int slot, int wg, int warp,
                                      int lane) {
  const int nb = 64 * wg + 16 * warp, g = lane >> 2;
  const uint32_t w = sbase + Smem<E>::w + slot * Smem<E>::wbytes;
  const uint8_t* s = smem + Smem<E>::s + slot * kSBytes;
  if constexpr (E == mx::kFp4E2M1) {
#pragma unroll
    for (int j = 0; j < 2; ++j) mx::ldmatrix_x4_trans(raw.r[j], w + mx::sw128(32 * j + lane, nb / 16));
#pragma unroll
    for (int i = 0; i < 4; ++i) raw.s[i] = *reinterpret_cast<const uint16_t*>(s + i * kBN + nb + 2 * g);
  } else {
    const int m = lane >> 3;  // lane l: row l % 8 of matrix l / 8
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t v[4];
        mx::ldmatrix_x4_trans(v, w + wg * kWBox + mx::sw128(32 * j + 16 * kk + 8 * (m >> 1) + (lane & 7),
                                                             2 * warp + (m & 1)));
#pragma unroll
        for (int q = 0; q < 4; ++q) raw.r[j][4 * kk + q] = v[q];
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) raw.s[i] = s[i * kBN + nb + g] | (uint32_t)s[i * kBN + nb + g + 8] << 8;
  }
}

// Block J's A fragments, f[h] for half h (pair: plane h), from the raw
// operands, in the decode's byte layout: byte c + 2 i of word q is the code
// at K 8q + 2t + i of the thread's column c (fp4: nibbles past the code are
// ignored).  Pair: k16 step kk of the block (packed rows 32 J + 16 kk ..)
// takes scale row 2 J + kk, for both planes.
template <int E, int L, int J>
__device__ __forceinline__ void decode_block(uint32_t (&f)[2][2][4], const Raw<E>& raw) {
  uint32_t a[4], b[4];
  if constexpr (E == mx::kFp4E2M1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = raw.r[J][q] >> 4;
      b[q] = raw.r[J][q];
    }
  } else {
    // word pair (column g, column g + 8) at K 2t, 2t + 1: the high bytes
    // are the first half's codes, the low bytes the second half's.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t lo = raw.r[J][4 * kk + 2 * p], hi = raw.r[J][4 * kk + 2 * p + 1];
        a[2 * kk + p] = __byte_perm(lo, hi, 0x7351);
        b[2 * kk + p] = __byte_perm(lo, hi, 0x6240);
      }
  }
  if constexpr (L == kPair) {
    const uint32_t s[2] = {raw.s[2 * J], raw.s[2 * J + 1]};
    mx::decode_fragments<E>(f[0], a, s);
    mx::decode_fragments<E>(f[1], b, s);
  } else {
    mx::decode_fragments<E>(f[0], a, raw.s[J]);
    mx::decode_fragments<E>(f[1], b, raw.s[2 + J]);
  }
}

// Start block j of both halves: acc (+)= its four k16 products (A from f,
// B the x slices at xs and xs + kXSlice, 32 K in), one commit group;
// scale_d = 0 starts a split.
__device__ __forceinline__ void start_block(float (&acc)[64], const uint32_t (&f)[2][2][4], uint32_t xs, int j,
                                            int scale_d) {
  mx::wgmma_fence();
  mx::wgmma_m64n128k16_rs(acc, f[0][0], mx::wgmma_desc(xs + 64 * j, 16, 1024), scale_d);
  mx::wgmma_m64n128k16_rs(acc, f[0][1], mx::wgmma_desc(xs + 64 * j + 32, 16, 1024), 1);
  mx::wgmma_m64n128k16_rs(acc, f[1][0], mx::wgmma_desc(xs + kXSlice + 64 * j, 16, 1024), 1);
  mx::wgmma_m64n128k16_rs(acc, f[1][1], mx::wgmma_desc(xs + kXSlice + 64 * j + 32, 16, 1024), 1);
  mx::wgmma_commit();
}

// A split ends: total (this thread's elements of the [m][n] staging tile)
// += acc.  acc[4j + 2h + i] is row 8j + 2t + i and the thread's column h:
// nb + 2g + h for fp4, nb + g + 8h for fp8.
template <int E>
__device__ __forceinline__ void add_split(const float (&acc)[64], float* total, int nb, int g, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = total + (8 * j + 2 * t + i) * kOutStride;
      if constexpr (E == mx::kFp4E2M1) {
        float2* q = reinterpret_cast<float2*>(row + nb + 2 * g);
        float2 v = *q;
        v.x += acc[4 * j + i];
        v.y += acc[4 * j + 2 + i];
        *q = v;
      } else {
        row[nb + g] += acc[4 * j + i];
        row[nb + g + 8] += acc[4 * j + 2 + i];
      }
    }
}

// The kernel over x's Kx columns (halves: K; pair: Kx = the padded planes'
// width); W's and the scales' true rows are the tensor maps'.
template <int E, int L>
__device__ __forceinline__ void matmul_body(const CUtensorMap* tx, const CUtensorMap* tw, const CUtensorMap* ts,
                                            uint16_t* __restrict__ out, float* __restrict__ ws, int M, int N, int Kx,
                                            int splits, int xrows) {
#ifdef K3_PHASE_PROFILE
  long long prof_t[6] = {0, 0, 0, 0, 0, 0}, prof_0 = clock64(), prof_c = prof_0;
#endif
  using S = Smem<E>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = mx::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = mx::smem_addr(smem);
  float* total = reinterpret_cast<float*>(smem + S::out);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, nb = wg * 64 + warp * 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int iters = Kx / kKT, per = (iters + splits - 1) / splits;
  // gridDim.z == 1: this CTA walks every split in order; else split blockIdx.z.
  const int it0 = gridDim.z == 1 ? 0 : blockIdx.z * per;
  const int it1 = gridDim.z == 1 ? iters : min(iters, it0 + per);
  const int nt = max(it1 - it0, 0);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mx::mbar_init(sbase + S::full + 8 * s, 1);
      mx::mbar_init(sbase + S::empty + 8 * s, kConsumers / 32);  // one arrival a consumer warp
    }
    mx::mbar_init_fence();
  }
  for (int i = tid; i < kBM * kOutStride / 4; i += kThreads)
    reinterpret_cast<float4*>(total)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // x rows past the box (M <= kBM: the box holds the M rows) are zeros
  // that TMA never writes: set them once, for the whole ring.
  for (int i = tid; i < kStages * 2 * (kBM - xrows) * 8; i += kThreads) {
    const int c = i & 7, r = xrows + (i >> 3) % (kBM - xrows), sh = (i >> 3) / (kBM - xrows);
    *reinterpret_cast<uint4*>(smem + S::x + sh * kXSlice + r * 128 + c * 16) = make_uint4(0, 0, 0, 0);
  }
  mx::fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer: stage st into slot st % kStages once the slot's readers
    // of stage st - kStages are done.
    if (tid == kConsumers)
      for (int st = 0; st < nt; ++st) {
        const int slot = st % kStages;
        if (st >= kStages) mx::mbar_wait(sbase + S::empty + 8 * slot, (st / kStages - 1) & 1);
        load_stage<E, L>(sbase, slot, it0 + st, Kx, N, xrows, tx, tw, ts, m0, n0);
      }
  } else {
#ifdef K3_DATAPATH_ONLY
    for (int st = 0; st < nt; ++st) {
      const int slot = st % kStages;
      mx::mbar_wait(sbase + S::full + 8 * slot, (st / kStages) & 1);
      if (lane == 0) mx::mbar_arrive(sbase + S::empty + 8 * slot);
    }
#else
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t fa[2][2][4], fb[2][2][4];  // A fragments: block 0 of both halves in fa, block 1 in fb
    Raw<E> cur, nxt;                     // this stage's raw operands and the next's
    if (nt > 0) {
      mx::mbar_wait(sbase + S::full, 0);
      fetch<E>(cur, smem, sbase, 0, wg, warp, lane);
      decode_block<E, L, 0>(fa, cur);
    }

    // Stage st: block 0 in one commit group, block 1 in the next, into acc.
    // Before a fragment buffer is decoded into again, wait_group 1 retires
    // the group that read it (the one before the newest); the first such
    // wait of a stage retires the previous stage's last group, and the warp
    // then releases that stage's slot.  k counts the stages of the current
    // split.
    for (int st = 0, k = 0; st < nt; ++st) {
      const uint32_t xs = sbase + S::x + (st % kStages) * kXBytes;
      const bool next = st + 1 < nt;
      const int nslot = (st + 1) % kStages;
      K3_PHASE(5);
      start_block(acc, fa, xs, 0, k != 0);
      K3_PHASE(0);
      mx::wgmma_wait<1>();
      if (st > 0 && lane == 0) mx::mbar_arrive(sbase + S::empty + 8 * ((st - 1) % kStages));
      K3_PHASE(1);
      decode_block<E, L, 1>(fb, cur);
      K3_PHASE(2);
      if (next) {
        mx::mbar_wait(sbase + S::full + 8 * nslot, ((st + 1) / kStages) & 1);  // stage st + 1 has landed
        K3_PHASE(3);
        fetch<E>(nxt, smem, sbase, nslot, wg, warp, lane);
        K3_PHASE(4);
      }
      start_block(acc, fb, xs, 1, 1);
      K3_PHASE(0);
      if (!next || ++k == per) {  // the split ends
        // acc is read only here, after wait_group 0, and written only by
        // wgmma (scale-d = 0 starts a split): ptxas serializes nothing.
        mx::wgmma_wait<0>();
        add_split<E>(acc, total, nb, g, t);
        k = 0;
      }
      if (next) {
        cur = nxt;
        K3_PHASE(5);
        mx::wgmma_wait<1>();
        K3_PHASE(1);
        decode_block<E, L, 0>(fa, cur);
        K3_PHASE(2);
      }
    }
    mx::wgmma_wait<0>();  // without it ptxas injects the wait at the loop's exit (info C7517)
#ifdef K3_PHASE_PROFILE
    if (tid == 0 || tid == 200) {
      unsigned long long* c = reinterpret_cast<unsigned long long*>(ws) + (tid == 0 ? 0 : 8);
      for (int i = 0; i < 6; ++i) atomicAdd(c + i, (unsigned long long)prof_t[i]);
      atomicAdd(c + 6, (unsigned long long)(clock64() - prof_0));
      atomicAdd(c + 7, (unsigned long long)nt);
    }
#endif
#endif  // K3_DATAPATH_ONLY
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

// Distinct kernel names per weight format and layout, so that a profile
// tells them apart.
__global__ void __launch_bounds__(kThreads, 1)
matmul_fp4_halves_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap ts, uint16_t* __restrict__ out,
                         float* __restrict__ ws, int M, int N, int K, int splits, int xrows) {
  matmul_body<mx::kFp4E2M1, kHalves>(&tx, &tw, &ts, out, ws, M, N, K, splits, xrows);
}

__global__ void __launch_bounds__(kThreads, 1)
matmul_fp8_halves_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap ts, uint16_t* __restrict__ out,
                         float* __restrict__ ws, int M, int N, int K, int splits, int xrows) {
  matmul_body<mx::kFp8E4M3, kHalves>(&tx, &tw, &ts, out, ws, M, N, K, splits, xrows);
}

__global__ void __launch_bounds__(kThreads, 1)
matmul_fp4_pair_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap ts, uint16_t* __restrict__ out,
                       float* __restrict__ ws, int M, int N, int Kx, int splits, int xrows) {
  matmul_body<mx::kFp4E2M1, kPair>(&tx, &tw, &ts, out, ws, M, N, Kx, splits, xrows);
}

// Sum the split-K partials in split order and round once to bf16.
__global__ void reduce_splits_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out, long long mn,
                                     int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void reduce_splits_fp8h_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out, long long mn,
                                          int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void reduce_splits_fp4p_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out, long long mn,
                                          int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

// The pair layout's x width: each plane zero-padded to a multiple of 64
// columns (the stage's slice).
inline int pair_width(int K) { return (K + kKT - 1) / kKT * kKT; }

template <int E, int L>
cudaError_t run(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N, int K,
                int splits, int walk, cudaStream_t stream) {
  CUtensorMap tx, tw, ts;
  const int xrows = min(M, kBM);  // x rows a box: past M, zeros set once in shared memory
  const bool fp4 = E == mx::kFp4E2M1;
  const int Kx = L == kPair ? pair_width(K) : K;
  const bool scale_map =
      L == kPair ? mx::tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_UINT8, scale, N, K / 32, N, kBN, 4,
                                  CU_TENSOR_MAP_SWIZZLE_NONE)
                 : mx::tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_UINT8, scale, N, K / 64, N, kBN, 2,
                                  CU_TENSOR_MAP_SWIZZLE_NONE, 2, (uint64_t)(K / 64) * N);
  if (!mx::tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT16, x, Kx, M, (uint64_t)Kx * 2, 64, xrows,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !mx::tensor_map(&tw, fp4 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT16, w, N, K / 2,
                      (uint64_t)N * (fp4 ? 1 : 2), fp4 ? kBN : 64, kRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !scale_map)
    return cudaErrorInvalidValue;
  auto kernel = L == kPair ? matmul_fp4_pair_kernel : fp4 ? matmul_fp4_halves_kernel : matmul_fp8_halves_kernel;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<E>::bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, walk ? 1 : splits);
  kernel<<<grid, kThreads, Smem<E>::bytes, stream>>>(tx, tw, ts, (uint16_t*)out, (float*)ws, M, N, Kx, splits, xrows);
  return cudaGetLastError();
}

template <int E, int L>
int launch(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N, int K, int splits,
           int walk, void* stream) {
  if (M == 0) return 0;
  if (splits < 1 || K <= 0 || K % (L == kPair ? 32 : kKT) || N % 64) return (int)cudaErrorInvalidValue;
  return (int)run<E, L>(x, w, scale, out, ws, M, N, K, splits, walk || splits == 1, (cudaStream_t)stream);
}

template <typename Kernel>
int reduce_launch(Kernel kernel, const void* ws, void* out, long long mn, int splits, void* stream) {
  if (mn == 0) return 0;
  kernel<<<(unsigned)((mn + 255) / 256), 256, 0, (cudaStream_t)stream>>>((const float*)ws, (uint16_t*)out, mn,
                                                                         splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The main kernel alone over fp4 halves: w is (K/2, N) bytes; x as it is
// (the wrapper applies any activation quantize first).  walk != 0 (or
// splits == 1): each CTA walks all splits and writes out; else split s
// writes its fp32 partial to ws[s] (splits x M x N) and
// mx_matmul_fp4_halves_reduce_launch sums.
extern "C" int mx_matmul_fp4_halves_launch(const void* x, const void* w, const void* scale, void* out, void* ws,
                                           int M, int N, int K, int splits, int walk, void* stream) {
  return launch<mx::kFp4E2M1, kHalves>(x, w, scale, out, ws, M, N, K, splits, walk, stream);
}

// The same over fp8 halves: w is (K/2, N) uint16 words.
extern "C" int mx_matmul_fp8_halves_launch(const void* x, const void* w, const void* scale, void* out, void* ws,
                                           int M, int N, int K, int splits, int walk, void* stream) {
  return launch<mx::kFp8E4M3, kHalves>(x, w, scale, out, ws, M, N, K, splits, walk, stream);
}

// The same over fp4 pairs: w is (K/2, N) bytes, scale (K/32, N), K % 32 ==
// 0; x is (M, Kp) in plane order (Kp = 128 ceil(K / 128): columns [0, K/2)
// x's even elements, [Kp/2, Kp/2 + K/2) its odd ones, zeros elsewhere), as
// K2's plane mode writes it.
extern "C" int mx_matmul_fp4_pair_launch(const void* x, const void* w, const void* scale, void* out, void* ws,
                                         int M, int N, int K, int splits, int walk, void* stream) {
  return launch<mx::kFp4E2M1, kPair>(x, w, scale, out, ws, M, N, K, splits, walk, stream);
}

// out (mn bf16) = the split partials ws (splits x mn fp32) summed in split order.
extern "C" int mx_matmul_fp4_halves_reduce_launch(const void* ws, void* out, long long mn, int splits, void* stream) {
  return reduce_launch(reduce_splits_kernel, ws, out, mn, splits, stream);
}

extern "C" int mx_matmul_fp8_halves_reduce_launch(const void* ws, void* out, long long mn, int splits, void* stream) {
  return reduce_launch(reduce_splits_fp8h_kernel, ws, out, mn, splits, stream);
}

extern "C" int mx_matmul_fp4_pair_reduce_launch(const void* ws, void* out, long long mn, int splits, void* stream) {
  return reduce_launch(reduce_splits_fp4p_kernel, ws, out, mn, splits, stream);
}
