// B12 mx_grouped_matmul: the dropless grouped expert GEMM.  out (R, N) bf16
// from x_sorted (R, K) bf16, rows sorted by expert and each expert's group
// padded to a multiple of tm, and the stacked expert weights (E, K, N):
// bf16, or one-byte codes (fp8 e4m3, fp6 e3m2 / e2m3 flat, int8) with E8M0
// scales (E, K/32, N).  Row tile t (rows [t*tm, (t+1)*tm)) contracts with
// expert tile_expert[t].  Its live rows are the first min(tile_rows[t], ext):
// ext (at most tm) is the caller's bound on any expert's rows, the number of
// tokens (a token's top-k experts are distinct).  Every other row comes out
// as 0: the rows of a dead tile (tile_rows[t] == 0, or the expert out of
// range) and the padding group_tokens adds to a group beyond the bound.
//
// Replaces torchmx_tpu/ops/pallas_moe.py::_grouped_kernel_bf16 (:54),
// _grouped_kernel_tinner (:74) and _grouped_kernel_mx (:136), all launched
// by grouped_matmul (pallas_call at :264): the weight format is a template
// argument (bf16 for _bf16, the one-byte codes for _tinner and _mx, two
// grid orders of one function).
//
// What bounds it on an H100: at decode (a few tokens per expert) the live
// experts' weight bytes; at prefill (hundreds of rows per expert) the
// tensor-core operations, 2 * rows * N * K.  The design is B6's
// (csrc/mx_matmul_1byte.cu) over the expert that each row block names, fed
// by B9's producer warp (csrc/mx_matmul_int8dot.cu):
//  1. W is selected by expert in the TMA coordinate.  W is one 2-D tensor
//     map over (E K, N), its scales one over (E K/32, N); a CTA reads
//     tile_expert[t] and tile_rows[t] on the device and adds expert * K
//     (expert * K/32) to its boxes' row coordinate, with no host
//     synchronisation.  A dead row block issues no load and writes zeros.
//  2. out^T = W^T x^T.  W is decoded once, in registers, into wgmma's A
//     operand (mx_wgmma_decode.cuh, B6's decode; bf16 experts come straight
//     from ldmatrix.trans), 64 columns of W a consumer warpgroup, 128 a CTA;
//     x is B, K-major in shared memory as TMA lands it.  No decoded W tile is
//     stored in shared memory.
//  3. The row extent follows the tokens, not the padding: a CTA takes nb
//     rows of x (one box), nb the smallest of 16 / 32 / 64 / 128 covering
//     the live rows a block can hold (the wrapper picks it from ext), and
//     runs wgmma m64n{nb}k16.  Rows of the box past the live ones (padding,
//     or the next tile's rows at tm = 8) are multiplied but never stored; a
//     zero row of x inside the extent gives +0, as in the plain version.  So
//     no pass marks the rows of x.  The smaller box makes a smaller stage:
//     at nb <= 32 two CTAs share an SM, 7-10 stages each, at nb = 64 one CTA
//     keeps 11 stages in flight.
//  4. Loads overlap the tensor cores: a ring of stages of 64 K (nb x 64 bf16
//     of x, 64 x 128 bytes of codes or 64 x 128 bf16, two scale rows) filled
//     by the producer warp's TMA through full / empty mbarriers; no CTA
//     barrier in the mainloop.
//  5. Each MX block's two k16 products go into a partial fragment p (the
//     first with scale-d = 0), added to the accumulator in block order once
//     retired (p is read only after wait_group 0, so ptxas serializes
//     nothing); while a block's wgmma runs, the CUDA cores decode the next
//     block's fragments from raw operands fetched a phase earlier.  The K
//     splits are ops/cuda_matmul.k_splits(N, K), B6's, summed ((0 + p0) +
//     p1) + ... in split order.  Where the live row blocks fill the card
//     (walk), a CTA walks its splits itself, adding each split's accumulator
//     to a total held in shared memory, and writes out: one launch.
//     Otherwise blockIdx.z takes one split, its nb rows of partials go to a
//     workspace of splits x R/sb x nb x N floats (sb = min(tm, 128), the rows
//     of a row block) and a second kernel sums them in split order and
//     writes every row.  So for the same expert, rows and one-byte weight B12
//     gives B6's bytes, and a row's bytes depend neither on its tile, nor on
//     the other rows, nor on nb (wgmma rounds an element's k16 sum alike at
//     every n).
//  6. Rows of a live row block past its live ones are written as 0 by its
//     consumers while the first stages land.
// The launch takes a planted fault for the model check (never set by the
// package): W's row coordinate one MX block late, or a live tile's extent
// one row short.
#include "mx_common.cuh"
#include "mx_wgmma.cuh"
#include "mx_wgmma_decode.cuh"

namespace {

// Built with -DB12_DATAPATH_ONLY (torchmx_tpu_torch/tools/b8_phase_profile.py
// --datapath-only-b12), the consumers only wait for each stage to land and
// release its slot: no fragment, wgmma or partial.  It times the weight and
// x stream of the mainloop alone.

constexpr int kKT = 64;                    // K elements per stage: two MX blocks
constexpr int kBN = 128;                   // columns of W per CTA: two warpgroups of 64
constexpr int kMaxSB = 128;                // rows of a row block at most
constexpr int kConsumers = 256;            // two warpgroups: decode, wgmma, partials
constexpr int kThreads = kConsumers + 32;  // and one producer warp: TMA
constexpr int kOutStride = kBN + 8;        // fp32 staging row stride, in floats
constexpr int kBf16 = -1;                  // weight format code of bf16 experts
constexpr int kFaultExpertLate = 1;        // planted faults (the model check's)
constexpr int kFaultRowShort = 2;

// Dynamic shared memory of the kernel over WF experts with nb = NB rows: the
// x, W and scale rings, their full and empty mbarriers, the fp32 staging
// tile of NB rows, 1024 bytes of slack to align the swizzled tiles.  At NB
// <= 32 two CTAs share an SM (each within half of its 228 KB, less the 1 KB
// the SM keeps a CTA), else one; the ring takes what is left, at most 16
// stages (nb 16 / 32 / 64 / 128: 10 / 7 / 11 / 6 stages of codes, 5 / 4 / 7
// / 4 of bf16).
template <int WF, int NB>
struct Cfg {
  static constexpr bool kBf = WF == kBf16;
  static constexpr int kX = NB * kKT * 2;               // NB rows of 64 bf16: 128-byte rows
  static constexpr int kW = kKT * kBN * (kBf ? 2 : 1);  // bf16: two 64-column boxes of 8 KB
  static constexpr int kS = kBf ? 0 : 2 * kBN;
  static constexpr int kTotal = NB * kOutStride * 4;
  static constexpr int kBlocks = NB <= 32 ? 2 : 1;
  static constexpr int kBudget = kBlocks == 2 ? 233472 / 2 - 1024 : 232448;
  static constexpr int kFit = (kBudget - 1024 - kTotal) / (kX + kW + kS + 16);
  static constexpr int kStages = kFit < 16 ? kFit : 16;
  static constexpr int x = 0;
  static constexpr int w = kStages * kX;
  static constexpr int s = w + kStages * kW;
  static constexpr int full = s + kStages * kS;       // a ring slot's fill has landed
  static constexpr int empty = full + 8 * kStages;    // a ring slot's readers are done
  static constexpr int total = empty + 8 * kStages;
  static constexpr int bytes = total + kTotal + 1024;
  static_assert(kStages >= 4 && bytes <= kBudget, "the ring does not fit");
};

// The live rows of row block blk (rows [blk sb, blk sb + sb) of tile t):
// those of its tile below min(tile_rows[t], ext), none where the tile's
// expert is out of range; the expert goes to *expert.
__device__ __forceinline__ int block_live(const int* __restrict__ tile_expert, const int* __restrict__ tile_rows,
                                          int blk, int sb, int tm, int ext, int E, int fault, int* expert) {
  const int row0 = blk * sb, t = row0 / tm, e = tile_expert[t];
  *expert = e;
  if (e < 0 || e >= E) return 0;
  const int extent = min(tile_rows[t], ext) - (fault == kFaultRowShort ? 1 : 0);
  return min(max(extent - row0 % tm, 0), sb);
}

// Start the TMA copies of K stage `it` into ring slot `slot` (one thread):
// the x box (NB rows from row0, K it*64 ..), W's box(es) at row wrow + it*64
// of the (E K, N) map and the scale rows at srow + 2 it; past R and N they
// come as zeros.  bf16 W is two boxes of 64 columns (TMA's 128-byte swizzle
// spans 128 bytes), the second skipped where the column tile has only 64.
template <int WF, int NB>
__device__ __forceinline__ void load_stage(uint32_t sbase, int slot, int it, const CUtensorMap* tx,
                                           const CUtensorMap* tw, const CUtensorMap* ts, int row0, int n0, int wrow,
                                           int srow, bool wide) {
  using C = Cfg<WF, NB>;
  const uint32_t bar = sbase + C::full + 8 * slot, wt = sbase + C::w + slot * C::kW;
  mx::mbar_expect_tx(bar, C::kX + (C::kBf && !wide ? C::kW / 2 : C::kW) + C::kS);
  mx::tma_load_2d(sbase + C::x + slot * C::kX, tx, bar, it * kKT, row0);
  mx::tma_load_2d(wt, tw, bar, n0, wrow + it * kKT);
  if constexpr (C::kBf) {
    if (wide) mx::tma_load_2d(wt + C::kW / 2, tw, bar, n0 + 64, wrow + it * kKT);
  } else {
    mx::tma_load_2d(sbase + C::s + slot * C::kS, ts, bar, n0, srow + 2 * it);
  }
}

// A block's raw operands for this thread, fetched one phase before they are
// decoded.  Codes (B6's): r[0] from one ldmatrix.x4.trans of the code tile
// (matrix q: K rows 32 blk + 8q .. + 7, the warp's 16 columns) and s, the
// scale bytes of columns 2g and 2g + 1: warp w's A row 16w + g + 8h stands
// for column 16w + 2g + h of its warpgroup's 64.  bf16: r[kk], the A
// fragments of k16 step kk themselves, from one ldmatrix.x4.trans each
// (matrix q: K rows 16 kk + 8 (q >> 1) .., columns 8 (q & 1) .. of the
// warp's 16): A row 16w + g + 8h stands for column 16w + g + 8h.
struct Raw {
  uint32_t r[2][4];
  uint32_t s;
};

template <int WF, int NB>
__device__ __forceinline__ void fetch(Raw& raw, const uint8_t* smem, uint32_t sbase, int slot, int blk, int wg,
                                      int warp, int lane) {
  using C = Cfg<WF, NB>;
  const uint32_t wt = sbase + C::w + slot * C::kW;
  if constexpr (C::kBf) {
    const int q = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      mx::ldmatrix_x4_trans(raw.r[kk], wt + wg * (C::kW / 2) +
                                           mx::sw128(32 * blk + 16 * kk + 8 * (q >> 1) + (lane & 7),
                                                     2 * warp + (q & 1)));
  } else {
    const int cn = 4 * wg + warp;  // the warp's 16-column chunk of the 128-byte code rows
    mx::ldmatrix_x4_trans(raw.r[0], wt + mx::sw128(32 * blk + lane, cn));
    raw.s = *reinterpret_cast<const uint16_t*>(smem + C::s + slot * C::kS + blk * kBN + cn * 16 + 2 * (lane >> 2));
  }
}

// A block's A fragments f[kk] (k16 step kk) from its raw operands.
template <int WF>
__device__ __forceinline__ void decode(uint32_t (&f)[2][4], const Raw& raw) {
  if constexpr (WF == kBf16) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) f[kk][i] = raw.r[kk][i];
  } else {
    mx::decode_fragments<WF>(f, raw.r[0], raw.s);
  }
}

// wgmma reads its A registers while it runs.  Holding a block's fragments
// until its wgmma has retired keeps the compiler from giving them to the
// next block's raw operands meanwhile: for bf16 the fragments are the raw
// registers themselves, and an ldmatrix into them under a running wgmma
// corrupted every CTA of two K stages or more.
__device__ __forceinline__ void hold_fragments(uint32_t (&f)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[kk][i])::"memory");
}

// Start one MX block: p = its two k16 products over the slot's NB x rows (A
// from f, B the x tile at K offset 32 blk), one commit group.
template <int NB>
__device__ __forceinline__ void start_block(float (&p)[NB / 2], const uint32_t (&f)[2][4], uint32_t xs, int blk) {
  mx::wgmma_fence();
  mx::wgmma_m64nk16_rs<NB>(p, f[0], mx::wgmma_desc(xs + 64 * blk, 16, 1024), 0);
  mx::wgmma_m64nk16_rs<NB>(p, f[1], mx::wgmma_desc(xs + 64 * blk + 32, 16, 1024), 1);
  mx::wgmma_commit();
}

// A split ends: total (this thread's elements of the [row][column] staging
// tile) += acc, acc = 0.  acc[4j + 2h + i] is x row 8j + 2t + i and A row
// 16w + g + 8h: W column nb + 2g + h for codes, nb + g + 8h for bf16.
template <int WF, int NB>
__device__ __forceinline__ void flush_split(float (&acc)[NB / 2], float* total, int nb, int g, int t) {
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = total + (8 * j + 2 * t + i) * kOutStride + nb;
      if constexpr (WF == kBf16) {
        row[g] += acc[4 * j + i];
        row[g + 8] += acc[4 * j + 2 + i];
      } else {
        float2* q = reinterpret_cast<float2*>(row + 2 * g);
        float2 v = *q;
        v.x += acc[4 * j + i];
        v.y += acc[4 * j + 2 + i];
        *q = v;
      }
    }
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
}

// A consumer warpgroup's mainloop over its nt >= 1 stages (B6's order):
// block 0, then block 1 of each stage, each started, waited for and added
// whole, so each row's partials come in block order.  The stage's slot is
// released once its second block has retired and its raw operands were
// read; k counts the stages of the current split.
template <int WF, int NB>
__device__ __forceinline__ void consume(float* total, const uint8_t* smem, uint32_t sbase, int nt, int per, int tid) {
  using C = Cfg<WF, NB>;
  constexpr int S = C::kStages;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, nb = wg * 64 + warp * 16;
  float acc[NB / 2], p[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) {
    acc[i] = 0.f;
    p[i] = 0.f;
  }
  uint32_t f0[2][4], f1[2][4];  // A fragments of a stage's blocks 0 and 1
  Raw r0, r1;                    // their raw operands, fetched a phase ahead
  mx::mbar_wait(sbase + C::full, 0);
  fetch<WF, NB>(r0, smem, sbase, 0, 0, wg, warp, lane);
  fetch<WF, NB>(r1, smem, sbase, 0, 1, wg, warp, lane);
  decode<WF>(f0, r0);
  for (int st = 0, k = 0; st < nt; ++st) {
    const int slot = st % S, nslot = (st + 1) % S;
    const uint32_t xs = sbase + C::x + slot * C::kX;
    const bool next = st + 1 < nt;
    start_block<NB>(p, f0, xs, 0);
    decode<WF>(f1, r1);
    if (next) {
      mx::mbar_wait(sbase + C::full + 8 * nslot, ((st + 1) / S) & 1);  // stage st + 1 has landed
      fetch<WF, NB>(r0, smem, sbase, nslot, 0, wg, warp, lane);
    }
    mx::wgmma_wait<0>();
    mx::fence_fragment(p);
    hold_fragments(f0);
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] += p[i];

    start_block<NB>(p, f1, xs, 1);
    if (next) {
      fetch<WF, NB>(r1, smem, sbase, nslot, 1, wg, warp, lane);
      decode<WF>(f0, r0);
    }
    mx::wgmma_wait<0>();
    mx::fence_fragment(p);
    hold_fragments(f1);
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] += p[i];
    __syncwarp();
    if (lane == 0) mx::mbar_arrive(sbase + C::empty + 8 * slot);
    if (st + 1 == nt || ++k == per) {  // the split ends
      flush_split<WF, NB>(acc, total, nb, g, t);
      k = 0;
    }
  }
}

// blockIdx.x: the row block (sb rows; the blocks of one expert are
// neighbours and share its W stream in L2), blockIdx.y: the column tile,
// blockIdx.z: the split (gridDim.z == 1: the CTA walks every split).
template <int WF, int NB>
__global__ void __launch_bounds__(kThreads, Cfg<WF, NB>::kBlocks)
grouped_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap ts, const int* __restrict__ tile_expert,
                     const int* __restrict__ tile_rows, uint16_t* __restrict__ out, float* __restrict__ ws, int R,
                     int N, int K, int E, int tm, int ext, int splits, int fault) {
  using C = Cfg<WF, NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = mx::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = mx::smem_addr(smem);
  float* total = reinterpret_cast<float*>(smem + C::total);

  const int tid = threadIdx.x;
  const bool walk = gridDim.z == 1;
  const int sb = min(tm, kMaxSB), row0 = blockIdx.x * sb, n0 = blockIdx.y * kBN, cols = min(kBN, N - n0);
  int expert;
  const int live = block_live(tile_expert, tile_rows, blockIdx.x, sb, tm, ext, E, fault, &expert);
  // A row block's rows past its live ones are 0 (in the two-pass form the
  // reduce writes them): all of a dead block's now, a live block's by its
  // consumers while the first stages land.
  auto zero_rows = [&](int from, int i0, int step) {
    for (int i = i0; i < (sb - from) * (kBN / 8); i += step) {
      const int r = from + i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      if (c < cols) *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * N + n0 + c) = make_uint4(0, 0, 0, 0);
    }
  };
  if (live == 0) {
    if (walk) zero_rows(0, tid, kThreads);
    return;
  }
  const int iters = K / kKT, per = (iters + splits - 1) / splits;
  const int it0 = walk ? 0 : blockIdx.z * per;
  const int it1 = walk ? iters : min(iters, it0 + per);
  const int nt = max(it1 - it0, 0);

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mx::mbar_init(sbase + C::full + 8 * s, 1);
      mx::mbar_init(sbase + C::empty + 8 * s, kConsumers / 32);  // one arrival a consumer warp
    }
    mx::mbar_init_fence();
  }
  for (int i = tid; i < C::kTotal / 16; i += kThreads)
    reinterpret_cast<float4*>(total)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer: stage st into slot st % S once the slot's readers of
    // stage st - S are done.  W's row coordinate selects the expert.
    if (tid == kConsumers) {
      const int wrow = expert * K + (fault == kFaultExpertLate ? 32 : 0), srow = expert * (K / 32);
      for (int st = 0; st < nt; ++st) {
        const int slot = st % C::kStages;
        if (st >= C::kStages) mx::mbar_wait(sbase + C::empty + 8 * slot, (st / C::kStages - 1) & 1);
        load_stage<WF, NB>(sbase, slot, it0 + st, &tx, &tw, &ts, row0, n0, wrow, srow, cols == kBN);
      }
    }
  } else {
    if (walk) zero_rows(live, tid, kConsumers);
#ifdef B12_DATAPATH_ONLY
    for (int st = 0; st < nt; ++st) {
      const int slot = st % C::kStages;
      mx::mbar_wait(sbase + C::full + 8 * slot, (st / C::kStages) & 1);
      if ((tid & 31) == 0) mx::mbar_arrive(sbase + C::empty + 8 * slot);
    }
#else
    if (nt > 0) consume<WF, NB>(total, smem, sbase, nt, per, tid);
#endif
  }
  __syncthreads();

  // Epilogue: the live rows, 8 columns a thread, 16-byte stores.
  for (int i = tid; i < live * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    if (c >= cols) continue;
    const float4 a = *reinterpret_cast<const float4*>(total + r * kOutStride + c);
    const float4 b = *reinterpret_cast<const float4*>(total + r * kOutStride + c + 4);
    if (walk) {
      __nv_bfloat162 o[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                             __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * N + n0 + c) = *reinterpret_cast<const uint4*>(o);
    } else {
      float* dst = ws + (((long long)blockIdx.z * gridDim.x + blockIdx.x) * NB + r) * N + n0 + c;
      *reinterpret_cast<float4*>(dst) = a;
      *reinterpret_cast<float4*>(dst + 4) = b;
    }
  }
}

// The two-pass form's second kernel: every row of out, a live row as its
// splits' partials summed in split order (mx::reduce_splits' arithmetic)
// and rounded once, every other row 0.  Block: 256 columns x 8 rows.
__global__ void __launch_bounds__(256)
grouped_reduce_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out, const int* __restrict__ tile_expert,
                      const int* __restrict__ tile_rows, int R, int N, int E, int tm, int ext, int nb, int splits,
                      int fault) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  const int sb = min(tm, kMaxSB);
  const long long plane = (long long)(R / sb) * nb * N;
  const int r0 = blockIdx.y * 8;
  for (int r = r0; r < r0 + 8; ++r) {
    const int blk = r / sb, i = r % sb;
    int expert;
    uint16_t v = 0;
    if (i < block_live(tile_expert, tile_rows, blk, sb, tm, ext, E, fault, &expert)) {
      const float* src = ws + ((long long)blk * nb + i) * N + n;
      float s = 0.f;
      for (int k = 0; k < splits; ++k) s += src[k * plane];
      v = __bfloat16_as_ushort(__float2bfloat16_rn(s));
    }
    out[(long long)r * N + n] = v;
  }
}

template <int WF, int NB>
cudaError_t run(const void* x, const void* w, const void* scale, const int* te, const int* tr, void* out, void* ws,
                int R, int N, int K, int E, int tm, int ext, int splits, int walk, int fault, cudaStream_t stream) {
  using C = Cfg<WF, NB>;
  CUtensorMap tx, tw, ts;
  const uint64_t wrows = (uint64_t)E * K;
  if (!mx::tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT16, x, K, R, (uint64_t)K * 2, kKT, NB,
                      CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if constexpr (C::kBf) {
    if (!mx::tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT16, w, N, wrows, (uint64_t)N * 2, 64, kKT,
                        CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    ts = tw;  // not read
  } else {
    if (!mx::tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, wrows, N, kBN, kKT, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !mx::tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_UINT8, scale, N, wrows / 32, N, kBN, 2,
                        CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
  }
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(grouped_wgmma_kernel<WF, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           C::bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int sb = tm < kMaxSB ? tm : kMaxSB;
  dim3 grid(R / sb, (N + kBN - 1) / kBN, walk ? 1 : splits);
  grouped_wgmma_kernel<WF, NB><<<grid, kThreads, C::bytes, stream>>>(tx, tw, ts, te, tr, (uint16_t*)out, (float*)ws,
                                                                     R, N, K, E, tm, ext, splits, fault);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || walk) return err;
  dim3 rgrid((N + 255) / 256, R / 8);
  grouped_reduce_kernel<<<rgrid, 256, 0, stream>>>((const float*)ws, (uint16_t*)out, te, tr, R, N, E, tm, ext, NB,
                                                   splits, fault);
  return cudaGetLastError();
}

template <int WF>
int dispatch_nb(const void* x, const void* w, const void* scale, const int* te, const int* tr, void* out, void* ws,
                int R, int N, int K, int E, int tm, int ext, int nb, int splits, int walk, int fault, cudaStream_t s) {
  switch (nb) {
    case 16: return (int)run<WF, 16>(x, w, scale, te, tr, out, ws, R, N, K, E, tm, ext, splits, walk, fault, s);
    case 32: return (int)run<WF, 32>(x, w, scale, te, tr, out, ws, R, N, K, E, tm, ext, splits, walk, fault, s);
    case 64: return (int)run<WF, 64>(x, w, scale, te, tr, out, ws, R, N, K, E, tm, ext, splits, walk, fault, s);
    case 128: return (int)run<WF, 128>(x, w, scale, te, tr, out, ws, R, N, K, E, tm, ext, splits, walk, fault, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// elem: -1 for bf16 experts (w holds bf16, scale is unused), else
// mx::kFp8E4M3, kFp6E3M2, kFp6E2M3 or kInt8 (w holds one code per byte).
// tm: a multiple of 8, and of 128 when above 128; R a multiple of tm; N and
// K multiples of 64.  ext: the live rows of a tile at most (1 .. tm); nb:
// 16, 32, 64 or 128, at least min(ext, tm, 128).  walk != 0 (or splits ==
// 1): each CTA walks all splits and writes out; else ws holds splits x
// R/min(tm, 128) x nb x N floats and the same call launches the reduce.
// fault: 0 (1, 2: the planted faults).
extern "C" int mx_grouped_matmul_launch(const void* x, const void* w, const void* scale, const void* tile_expert,
                                        const void* tile_rows, void* out, void* ws, int R, int N, int K, int E,
                                        int tm, int elem, int ext, int nb, int splits, int walk, int fault,
                                        void* stream) {
  if (R == 0) return 0;
  const int sb = tm < kMaxSB ? tm : kMaxSB;
  if (tm <= 0 || tm % 8 || (tm > kMaxSB && tm % kMaxSB) || R % tm || N <= 0 || N % 64 || K <= 0 || K % kKT ||
      E < 1 || splits < 1 || ext < 1 || ext > tm || nb < (ext < sb ? ext : sb) || fault < 0 ||
      fault > kFaultRowShort)
    return (int)cudaErrorInvalidValue;
  walk = walk || splits == 1;
  if (!walk && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* te = (const int*)tile_expert;
  const int* tr = (const int*)tile_rows;
  switch (elem) {
    case kBf16:
      return dispatch_nb<kBf16>(x, w, scale, te, tr, out, ws, R, N, K, E, tm, ext, nb, splits, walk, fault, s);
    case mx::kFp8E4M3:
      return dispatch_nb<mx::kFp8E4M3>(x, w, scale, te, tr, out, ws, R, N, K, E, tm, ext, nb, splits, walk, fault, s);
    case mx::kFp6E3M2:
      return dispatch_nb<mx::kFp6E3M2>(x, w, scale, te, tr, out, ws, R, N, K, E, tm, ext, nb, splits, walk, fault, s);
    case mx::kFp6E2M3:
      return dispatch_nb<mx::kFp6E2M3>(x, w, scale, te, tr, out, ws, R, N, K, E, tm, ext, nb, splits, walk, fault, s);
    case mx::kInt8:
      return dispatch_nb<mx::kInt8>(x, w, scale, te, tr, out, ws, R, N, K, E, tm, ext, nb, splits, walk, fault, s);
  }
  return (int)cudaErrorInvalidValue;
}
