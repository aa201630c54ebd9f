// B8 mx_matmul_fp6q: out (M, N) bf16 = x (M, K) @ W (K, N) with W MXFP6
// (e3m2 or e2m3) in the planar "quarters" layout: three byte planes P0, P1,
// P2 of K/4 rows each (rows [0, K/4), [K/4, K/2), [K/2, 3K/4) of w) hold the
// 6-bit codes q0..q3 of the four K quarters as
//   P0 = q0 << 2 | q3 >> 4,  P1 = q1 << 2 | (q3 >> 2) & 3,  P2 = q2 << 2 | q3 & 3
// (4 codes per 3 bytes); scale (K/32, N), rows [i K/128, (i+1) K/128) for
// quarter i.
//
// Replaces torchmx_tpu/ops/pallas_matmul.py::_linear_kernel_fp6q (:568),
// launched by _pallas_matmul_fp6q (:699).
//
// What bounds it on an H100: at decode (M up to 64) the weight bytes
// (3/4 K N + K N / 32), a quarter less than one byte per code; at prefill
// the tensor-core operations, 2 M N K at 989 TFLOP/s bf16.  The design is
// B6's mainloop (csrc/mx_matmul_1byte.cu) with B8's operands:
//  1. x is read as it is: where the caller asks for an activation format
//     x is fake-quantized once by K2 first, at every M, so no column tile
//     repeats the quantize of its rows (a prologue fused over each stage's
//     live rows was slower at M = 1, 32 and 64: PERF.md); the layers share
//     that K2 among the linears that read one x.
//  2. Loads overlap the tensor cores: a ring of kStages stages filled by TMA
//     from a producer warp (one thread starts a stage's copies once the
//     slot's "empty" mbarrier says every consumer warp is done with it; they
//     complete on its "full" mbarrier; zeros past M and N).  A stage is 128
//     K: one 3-D box of 32 rows of each plane (one MX block of each of the
//     four K quarters; 128-byte swizzled), one of the four scale rows of
//     those blocks, and the four matching 32-column x slices at K offsets
//     q K/4 + 32 it (64-byte swizzled K-major tiles).  At M <= 128 the x box
//     is M rows and the rows past M are zeros set once in shared memory:
//     TMA's zero fill of the missing rows at every stage slowed decode.  No
//     CTA barrier in the mainloop: the two consumer warpgroups run out of
//     phase.
//  3. The quarters are rebuilt in registers, straight into wgmma's A
//     operand (the kernel computes out^T = W^T x^T): one ldmatrix.x4.trans
//     of each plane tile gives each thread the bytes at (K 2t, 2t + 1) x
//     (n, n + 1) of the three planes, and four bytes at a time q0..q2 =
//     (r_p >> 2) & 0x3F, q3 = (r0 & 3) << 4 | (r1 & 3) << 2 | (r2 & 3).  Each
//     quarter is decoded against its own scale row by B6's decode
//     (csrc/mx_wgmma_decode.cuh), mx::decode_bf16_bits bit for bit; no
//     decoded tile is stored or read back.
//  4. One accumulator: wgmma.mma_async m64n128k16 bf16 -> f32, A from
//     registers, x K-major in shared memory as B, two warpgroups (128
//     columns of W) over 128 rows of x at every M, so a row's bytes do not
//     depend on M.  Every k16 product of a split goes straight into the
//     accumulator (the split's first with scale-d = 0): no per-block
//     partials, no fp32 adds a stage.  One commit group for two quarters;
//     while it runs, the CUDA cores decode the next two into the other of
//     two fragment buffers (wait_group 1 before a buffer is written again);
//     the accumulator is read only after wait_group 0.
//  5. K splits: ops/cuda_matmul.k_splits(N, K, sms, 128), a function of N
//     and K alone, summed ((0 + p0) + p1) + ... in split order
//     (mx::reduce_splits).  Where the output tiles fill the card
//     (gridDim.z == 1) a CTA walks its splits in that order itself, adding
//     each split's accumulator to a total held in shared memory: no fp32
//     workspace.  Otherwise blockIdx.z takes one split, its partial goes to
//     the workspace and reduce_splits_fp6q_kernel sums them.
// The epilogue stages the result through shared memory and stores 16 bytes
// a thread.  The element format is a template argument.  Where its time
// goes: PERF.md and torchmx_tpu_torch/tools/b8_phase_profile.py.
#include "mx_common.cuh"
#include "mx_wgmma.cuh"
#include "mx_wgmma_decode.cuh"

namespace {

// Built with -DB8_PHASE_PROFILE (torchmx_tpu_torch/tools/b8_phase_profile.py),
// the kernel adds each mainloop phase's clock cycles, for threads 0 and 200,
// into the workspace: 8 counters each (wgmma start, wgmma wait, rebuild +
// decode, stage wait, fetch, split add + the rest, total, stages).
// Otherwise the hooks are empty.
#ifdef B8_PHASE_PROFILE
#define B8_PHASE(i) (prof_t[i] += clock64() - prof_c, prof_c = clock64())
#else
#define B8_PHASE(i) ((void)0)
#endif

constexpr int kKT = 128;             // K elements per stage: one MX block of each quarter
constexpr int kBN = 128;             // columns of W per CTA: two warpgroups of 64
constexpr int kBM = 128;             // rows of x per CTA: wgmma n128
constexpr int kConsumers = 256;      // two warpgroups: decode and wgmma
constexpr int kThreads = kConsumers + 32;  // and one producer warp: TMA
constexpr int kStages = 3;           // TMA ring depth
constexpr int kOutStride = kBN + 8;  // fp32 staging row stride, in floats
constexpr int kXSlice = kBM * 32 * 2;  // one quarter's 32 columns of x
constexpr int kXBytes = 4 * kXSlice;
constexpr int kPBytes = 32 * kBN;      // 32 rows of one plane
constexpr int kWBytes = 3 * kPBytes;
constexpr int kSBytes = 4 * kBN;

// Dynamic shared memory (cuda_matmul_formats.b8_smem_bytes mirrors it): the
// x, plane and scale rings, their mbarriers and the fp32 staging tile; 1024
// bytes of slack align the swizzled tiles.
struct Smem {
  static constexpr int x = 0;
  static constexpr int w = kStages * kXBytes;
  static constexpr int s = w + kStages * kWBytes;
  static constexpr int full = s + kStages * kSBytes;  // a ring slot's fill has landed
  static constexpr int empty = full + 32;             // a ring slot's readers are done
  static constexpr int out = full + 64;
  static constexpr int bytes = out + kBM * kOutStride * 4 + 1024;
};

// Start the TMA copies of K stage `it` into ring slot `slot` (one thread):
// for each quarter q its x slice (xrows rows from m0, K q K/4 + 32 it ..);
// one 3-D box of the three planes' rows 32 it .. + 31 and one of the four
// quarters' scale rows it; past M and N they come as zeros.
__device__ __forceinline__ void load_stage(uint32_t sbase, int slot, int it, int K, int xrows, const CUtensorMap* tx,
                                           const CUtensorMap* tw, const CUtensorMap* ts, int m0, int n0) {
  const uint32_t bar = sbase + Smem::full + slot * 8;
  const int quarter = K / 4;
  mx::mbar_expect_tx(bar, 4 * xrows * 64 + kWBytes + kSBytes);
  mx::tma_load_3d(sbase + Smem::w + slot * kWBytes, tw, bar, n0, 32 * it, 0);
  mx::tma_load_3d(sbase + Smem::s + slot * kSBytes, ts, bar, n0, it, 0);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    mx::tma_load_2d(sbase + Smem::x + slot * kXBytes + q * kXSlice, tx, bar, q * quarter + 32 * it, m0);
}

// A stage's raw operands for this thread, fetched ahead of their decode: one
// ldmatrix.x4.trans of each plane tile (matrix j: rows 8j .. 8j + 7, the
// warp's 16 columns) and the scale bytes of its columns 2g and 2g + 1 in
// each quarter's row.  Warp w of warpgroup wg takes columns 64 wg + 16 w ..
// + 15 of the CTA's W tile.
struct Raw {
  uint32_t r[3][4];
  uint32_t s[4];
};

__device__ __forceinline__ void fetch(Raw& raw, const uint8_t* smem, uint32_t sbase, int slot, int cn, int lane) {
  const uint32_t row = mx::sw128(lane, cn);  // lane l: row l % 8 of matrix l / 8
#pragma unroll
  for (int p = 0; p < 3; ++p) mx::ldmatrix_x4_trans(raw.r[p], sbase + Smem::w + slot * kWBytes + p * kPBytes + row);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    raw.s[q] = *reinterpret_cast<const uint16_t*>(smem + Smem::s + slot * kSBytes + q * kBN + cn * 16 + 2 * (lane >> 2));
}

// Quarter Q's A fragments from the raw operands: its code words rebuilt from
// the plane words four bytes at a time, then decoded against its scales.
template <int E, int Q>
__device__ __forceinline__ void decode_quarter(uint32_t (&f)[2][4], const Raw& raw) {
  uint32_t c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    c[j] = Q < 3 ? (raw.r[Q < 3 ? Q : 0][j] >> 2) & 0x3F3F3F3Fu
                 : ((raw.r[0][j] & 0x03030303u) << 4) | ((raw.r[1][j] & 0x03030303u) << 2) |
                       (raw.r[2][j] & 0x03030303u);
  mx::decode_fragments<E>(f, c, raw.s[Q]);
}

// Start two quarters: acc (+)= their four k16 products (A from f0 and f1, B
// the x slices at xq and xq + kXSlice), one commit group; scale_d = 0
// starts a split.
__device__ __forceinline__ void start_quarters(float (&acc)[64], const uint32_t (&f0)[2][4],
                                               const uint32_t (&f1)[2][4], uint32_t xq, int scale_d) {
  mx::wgmma_fence();
  mx::wgmma_m64n128k16_rs(acc, f0[0], mx::wgmma_desc_sw64(xq), scale_d);
  mx::wgmma_m64n128k16_rs(acc, f0[1], mx::wgmma_desc_sw64(xq + 32), 1);
  mx::wgmma_m64n128k16_rs(acc, f1[0], mx::wgmma_desc_sw64(xq + kXSlice), 1);
  mx::wgmma_m64n128k16_rs(acc, f1[1], mx::wgmma_desc_sw64(xq + kXSlice + 32), 1);
  mx::wgmma_commit();
}

// A split ends: total (this thread's elements of the [m][n] staging tile)
// += acc.  acc[4j + 2h + i] is column nb + 2g + h, row 8j + 2t + i.
__device__ __forceinline__ void add_split(const float (&acc)[64], float* total, int nb, int g, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2* q = reinterpret_cast<float2*>(total + (8 * j + 2 * t + i) * kOutStride + nb + 2 * g);
      float2 v = *q;
      v.x += acc[4 * j + i];
      v.y += acc[4 * j + 2 + i];
      *q = v;
    }
}

template <int E>
__global__ void __launch_bounds__(kThreads, 1)
matmul_fp6q_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap ts, uint16_t* __restrict__ out, float* __restrict__ ws,
                   int M, int N, int K, int splits, int xrows) {
#ifdef B8_PHASE_PROFILE
  long long prof_t[6] = {0, 0, 0, 0, 0, 0}, prof_0 = clock64(), prof_c = prof_0;
#endif
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = mx::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = mx::smem_addr(smem);
  float* total = reinterpret_cast<float*>(smem + Smem::out);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, nb = wg * 64 + warp * 16, cn = nb / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
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
  if (tid < kConsumers)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(total + (8 * j + 2 * t + i) * kOutStride + nb + 2 * g) = make_float2(0.f, 0.f);
  // x rows past the box (M <= kBM: the box holds the M rows) are zeros
  // that TMA never writes: set them once, for the whole ring.
  for (int i = tid; i < kStages * 4 * (kBM - xrows) * 4; i += kThreads) {
    const int c = i & 3, r = xrows + (i >> 2) % (kBM - xrows), sq = (i >> 2) / (kBM - xrows);
    *reinterpret_cast<uint4*>(smem + Smem::x + sq * kXSlice + r * 64 + c * 16) = make_uint4(0, 0, 0, 0);
  }
  mx::fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer: stage st into slot st % kStages once the slot's readers
    // of stage st - kStages are done.
    if (tid == kConsumers)
      for (int st = 0; st < nt; ++st) {
        const int slot = st % kStages;
        if (st >= kStages) mx::mbar_wait(sbase + Smem::empty + 8 * slot, (st / kStages - 1) & 1);
        load_stage(sbase, slot, it0 + st, K, xrows, &tx, &tw, &ts, m0, n0);
      }
  } else {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t fa[2][2][4], fb[2][2][4];  // A fragments: quarters 0 and 1 in fa, 2 and 3 in fb
    Raw cur, nxt;                        // this stage's raw operands and the next's
    if (nt > 0) {
      mx::mbar_wait(sbase + Smem::full, 0);
      fetch(cur, smem, sbase, 0, cn, lane);
      decode_quarter<E, 0>(fa[0], cur);
      decode_quarter<E, 1>(fa[1], cur);
    }

    // Stage st: quarters 0 and 1 in one commit group, 2 and 3 in the next,
    // into acc.  Before a fragment buffer is decoded into again, wait_group 1
    // retires the group that read it (the one before the newest); the first
    // such wait of a stage retires the previous stage's last group, and the
    // warp then releases that stage's slot.  k counts the stages of the
    // current split.
    for (int st = 0, k = 0; st < nt; ++st) {
      const uint32_t xs = sbase + Smem::x + (st % kStages) * kXBytes;
      const bool next = st + 1 < nt;
      const int nslot = (st + 1) % kStages;
      B8_PHASE(5);
      start_quarters(acc, fa[0], fa[1], xs, k != 0);
      B8_PHASE(0);
      mx::wgmma_wait<1>();
      if (st > 0 && lane == 0) mx::mbar_arrive(sbase + Smem::empty + 8 * ((st - 1) % kStages));
      B8_PHASE(1);
      decode_quarter<E, 2>(fb[0], cur);
      decode_quarter<E, 3>(fb[1], cur);
      B8_PHASE(2);
      if (next) {
        mx::mbar_wait(sbase + Smem::full + 8 * nslot, ((st + 1) / kStages) & 1);  // stage st + 1 has landed
        B8_PHASE(3);
        fetch(nxt, smem, sbase, nslot, cn, lane);
        B8_PHASE(4);
      }
      start_quarters(acc, fb[0], fb[1], xs + 2 * kXSlice, 1);
      B8_PHASE(0);
      if (!next || ++k == per) {  // the split ends
        // acc is read only here, after wait_group 0, and written only by
        // wgmma (scale-d = 0 starts a split): ptxas serializes nothing.
        mx::wgmma_wait<0>();
        add_split(acc, total, nb, g, t);
        k = 0;
      }
      if (next) {
        cur = nxt;
        B8_PHASE(5);
        mx::wgmma_wait<1>();
        B8_PHASE(1);
        decode_quarter<E, 0>(fa[0], cur);
        decode_quarter<E, 1>(fa[1], cur);
        B8_PHASE(2);
      }
    }
    mx::wgmma_wait<0>();  // without it ptxas injects the wait at the loop's exit (info C7517)
#ifdef B8_PHASE_PROFILE
    if (tid == 0 || tid == 200) {
      unsigned long long* c = reinterpret_cast<unsigned long long*>(ws) + (tid == 0 ? 0 : 8);
      for (int i = 0; i < 6; ++i) atomicAdd(c + i, (unsigned long long)prof_t[i]);
      atomicAdd(c + 6, (unsigned long long)(clock64() - prof_0));
      atomicAdd(c + 7, (unsigned long long)nt);
    }
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

__global__ void reduce_splits_fp6q_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out,
                                          long long mn, int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int E>
cudaError_t run(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N, int K,
                int splits, int walk, cudaStream_t stream) {
  CUtensorMap tx, tw, ts;
  const int xrows = min(M, kBM);  // x rows a box: past M, zeros set once in shared memory
  if (!mx::tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT16, x, K, M, (uint64_t)K * 2, 32, xrows,
                      CU_TENSOR_MAP_SWIZZLE_64B) ||
      !mx::tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K / 4, N, kBN, 32, CU_TENSOR_MAP_SWIZZLE_128B, 3,
                      (uint64_t)(K / 4) * N) ||
      !mx::tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_UINT8, scale, N, K / 128, N, kBN, 1, CU_TENSOR_MAP_SWIZZLE_NONE, 4,
                      (uint64_t)(K / 128) * N))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err =
        cudaFuncSetAttribute(matmul_fp6q_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, walk ? 1 : splits);
  matmul_fp6q_kernel<E><<<grid, kThreads, Smem::bytes, stream>>>(tx, tw, ts, (uint16_t*)out, (float*)ws, M, N, K,
                                                                 splits, xrows);
  return cudaGetLastError();
}

}  // namespace

// The main kernel alone.  elem: mx::kFp6E3M2 or kFp6E2M3; w: the (3K/4, N)
// planes; x as it is (the wrapper applies any activation quantize first).
// walk != 0 (or splits == 1): each CTA walks all splits and writes out; else
// split s writes its fp32 partial to ws[s] (splits x M x N) and
// mx_matmul_fp6q_reduce_launch sums.
extern "C" int mx_matmul_fp6q_launch(const void* x, const void* w, const void* scale, void* out, void* ws, int M,
                                     int N, int K, int elem, int splits, int walk, void* stream) {
  if (M == 0) return 0;
  if (splits < 1 || K % kKT || N % 64) return (int)cudaErrorInvalidValue;
  walk = walk || splits == 1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp6E3M2: return (int)run<mx::kFp6E3M2>(x, w, scale, out, ws, M, N, K, splits, walk, s);
    case mx::kFp6E2M3: return (int)run<mx::kFp6E2M3>(x, w, scale, out, ws, M, N, K, splits, walk, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out (mn bf16) = the split partials ws (splits x mn fp32) summed in split order.
extern "C" int mx_matmul_fp6q_reduce_launch(const void* ws, void* out, long long mn, int splits, void* stream) {
  if (mn == 0) return 0;
  reduce_splits_fp6q_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (uint16_t*)out, mn, splits);
  return (int)cudaGetLastError();
}
