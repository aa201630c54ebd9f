// B6 mx_matmul_1byte: out (M, N) bf16 = fq(x) (M, K) @ W (K, N) with W one
// code per byte, K-major: fp8 e4m3, fp6 e3m2 or e2m3 (flat), or int8; scale
// (K/32, N) E8M0 bytes.
//
// Replaces torchmx_tpu/ops/pallas_matmul.py::_linear_kernel_1byte (:419),
// launched by _pallas_matmul_1byte (:1000).
//
// What bounds it on an H100: at decode (M up to 64) the weight bytes (K*N +
// K*N/32); at prefill (M in the thousands) the tensor-core operations,
// 2*M*N*K at 989 TFLOP/s bf16.  The design, against what held the first
// version (mma.sync fed by scalar shared loads, 4 % of the bf16 peak):
//  1. The activation quantize: fused here only at M <= 64 (one warp per
//     (row, 32-block) of a stage's x tile, in place, mx::fq_magic); above
//     that the wrapper runs K2 once and this kernel reads x as it is, so no
//     column tile repeats it.
//  2. Loads overlap the tensor cores: a ring of kStages shared-memory stages
//     (a 128 x 64 bf16 x tile, 64 x 128 code bytes, 2 x 128 scale bytes)
//     filled by TMA kStages - 1 stages ahead (one thread starts a stage's
//     three box copies, completing on the slot's mbarrier; zeros past M and
//     N), in dynamic shared memory; one CTA barrier a stage.  (TMA, not
//     16-byte cp.async from every thread: those fill the load/store unit
//     ahead of the decode's ldmatrix.)
//  3. W is decoded once, in registers, straight into wgmma's A operand: the
//     kernel computes out^T = W^T x^T, so the codes are A (64 columns of W a
//     warpgroup) and x is B, K-major in shared memory as TMA lands it.
//     One ldmatrix.x4.trans of the (swizzled, conflict-free) code tile gives
//     each thread 2 x 2 byte blocks, (K 2t, 2t+1) x (n, n+1): exactly A
//     fragments of rows g and g + 8 when warp w's A row 16w + g + 8h stands
//     for column 16w + 2g + h.  No decoded tile is stored, read back or
//     fenced.  The decode (csrc/mx_wgmma_decode.cuh, shared with B8): where
//     all of a warp's scales of the block are safe (every decoded value
//     bf16-normal), exact integer and fma / bf16-multiply arithmetic with no
//     conversion instruction (decode_fast); elsewhere mx::decode_bf16_bits
//     element by element.  Both are mx::decode_bf16_bits bit for bit.
//  4. wgmma.mma_async m64n128k16 bf16 -> f32, A from registers, two
//     warpgroups (128 columns of W) over 128 rows of x, at every M: a row's
//     bytes do not depend on M.  Each MX block's two k16 products go into
//     the partial fragment p, the first with scale-d = 0, and p is added to
//     the accumulator in block order once its group retires (p is read only
//     after wait_group 0, so ptxas serializes nothing); while a block's
//     wgmma runs the CUDA cores decode the next block's fragments from raw
//     operands fetched a phase earlier (the ldmatrix latency hidden).  With
//     int8 codes on an int8-grid x every partial is exact, so B9
//     (csrc/mx_matmul_int8dot.cu) gives the same bytes; B12
//     (csrc/mx_grouped_matmul.cu) runs this mainloop at n = 16-128, and
//     wgmma rounds an element's k16 sum alike at every n, so it gives them
//     too.
//  5. K splits: ops/cuda_matmul.k_splits, a function of N and K alone, summed
//     ((0 + p0) + p1) + ... in split order (mx::reduce_splits).  Where the
//     output tiles fill the card (gridDim.z == 1) a CTA walks its splits in
//     that order itself, adding each split's accumulator to a total held in
//     shared memory: no fp32 workspace.  Otherwise blockIdx.z takes one
//     split, its partial goes to the workspace and a second kernel sums them.
// The epilogue stages the result through shared memory and stores 16 bytes
// a thread.  The element and activation formats are template arguments.
// What holds it at prefill (PERF.md): the CUDA cores' work a stage (the
// decode and the 128 fp32 partial adds a thread) at 8 warps an SM, not the
// tensor cores.
#include "mx_common.cuh"
#include "mx_wgmma.cuh"
#include "mx_wgmma_decode.cuh"

namespace {

// Built with -DB6_PHASE_PROFILE (torchmx_tpu_torch/tools/b6_phase_profile.py),
// the kernel adds each mainloop phase's clock cycles, for threads 0 and 200,
// into the workspace: 8 counters each (wgmma start, barrier + TMA start +
// stage wait, fetch + decode, wgmma wait, partial adds + flush, -, total,
// stages).  Otherwise the hooks are empty.
#ifdef B6_PHASE_PROFILE
#define B6_PHASE(i) (prof_t[i] += clock64() - prof_c, prof_c = clock64())
#else
#define B6_PHASE(i) ((void)0)
#endif

constexpr int kKT = 64;              // K elements per stage: two MX blocks
constexpr int kBN = 128;             // columns of W per CTA: two warpgroups of 64
constexpr int kBM = 128;             // rows of x per CTA: wgmma n128
constexpr int kThreads = 256;
constexpr int kStages = 6;           // TMA ring depth
constexpr int kOutStride = kBN + 8;  // fp32 staging row stride, in floats
constexpr int kXBytes = kBM * kKT * 2;
constexpr int kWBytes = kKT * kBN;
constexpr int kSBytes = 2 * kBN;

// Dynamic shared memory (cuda_matmul_formats.b6_smem_bytes mirrors it): the
// x, code and scale rings, their mbarriers and the fp32 staging tile; 1024
// bytes of slack align the swizzled tiles.
struct Smem {
  static constexpr int x = 0;
  static constexpr int w = kStages * kXBytes;
  static constexpr int s = w + kStages * kWBytes;
  static constexpr int bar = s + kStages * kSBytes;  // one mbarrier a ring slot
  static constexpr int out = bar + 64;
  static constexpr int bytes = out + kBM * kOutStride * 4 + 1024;
};

// Start the TMA copies of K stage `it` into ring slot `slot` (one thread):
// the x tile (rows m0.., K it*64..), the code tile and the scale rows; past
// M and N they come as zeros.
__device__ __forceinline__ void load_stage(uint32_t sbase, int slot, int it, const CUtensorMap* tx,
                                           const CUtensorMap* tw, const CUtensorMap* ts, int m0, int n0) {
  const uint32_t bar = sbase + Smem::bar + slot * 8;
  mx::mbar_expect_tx(bar, kXBytes + kWBytes + kSBytes);
  mx::tma_load_2d(sbase + Smem::x + slot * kXBytes, tx, bar, it * kKT, m0);
  mx::tma_load_2d(sbase + Smem::w + slot * kWBytes, tw, bar, n0, it * kKT);
  mx::tma_load_2d(sbase + Smem::s + slot * kSBytes, ts, bar, n0, it * 2);
}

// Fake-quantize each 32-element block of the first `rows` rows of a stage's
// x tile in place, one warp a (row, block), one element a lane (the rows
// past M are zeros, which fake-quantize to zeros).
template <int A>
__device__ __forceinline__ void fq_stage(uint8_t* xs, int rows, int warp8, int lane) {
  for (int item = warp8; item < rows * 2; item += kThreads / 32) {
    const int r = item >> 1, h = item & 1;
    uint16_t* e = reinterpret_cast<uint16_t*>(xs + mx::sw128(r, h * 4 + (lane >> 3))) + (lane & 7);
    const int bits = *e;
    const int emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)((bits >> 7) & 0xFF));
    *e = mx::fq_magic<A>(bits, mx::block_scale(emax, mx::Elem<A>::max_pow2));
  }
}

// A block's raw operands for this thread, fetched one phase before they are
// decoded: one ldmatrix.x4.trans of the code tile (matrix q: K rows 32 blk
// + 8q .. + 7, the warp's 16 columns) and the scale bytes of its columns 2g
// and 2g + 1.  Warp w of warpgroup wg takes columns 64 wg + 16 w .. + 15 of
// the CTA's W tile.
struct Raw {
  uint32_t r[4];
  uint32_t s;
};

__device__ __forceinline__ void fetch(Raw& raw, const uint8_t* smem, uint32_t sbase, int slot, int blk, int cn,
                                      int lane) {
  mx::ldmatrix_x4_trans(raw.r, sbase + Smem::w + slot * kWBytes + mx::sw128(blk * 32 + (lane >> 3) * 8 + (lane & 7), cn));
  raw.s = *reinterpret_cast<const uint16_t*>(smem + Smem::s + slot * kSBytes + blk * kBN + cn * 16 + 2 * (lane >> 2));
}

// Start one MX block: p = its two k16 products (A from f, B the x tile at
// K offset 32 blk), one commit group.
__device__ __forceinline__ void start_block(float (&p)[64], const uint32_t (&f)[2][4], uint32_t xs, int blk) {
  mx::wgmma_fence();
  mx::wgmma_m64n128k16_rs(p, f[0], mx::wgmma_desc(xs + 64 * blk, 16, 1024), 0);
  mx::wgmma_m64n128k16_rs(p, f[1], mx::wgmma_desc(xs + 64 * blk + 32, 16, 1024), 1);
  mx::wgmma_commit();
}

// A split ends: total (this thread's elements of the [m][n] staging tile)
// += acc, acc = 0.  acc[4j + 2h + i] is column nb + 2g + h, row 8j + 2t + i.
__device__ __forceinline__ void flush_split(float (&acc)[64], float* total, int nb, int g, int t) {
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
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
}

template <int E, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
matmul_1byte_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap ts, uint16_t* __restrict__ out, float* __restrict__ ws,
                    int M, int N, int K, int splits) {
#ifdef B6_PHASE_PROFILE
  long long prof_t[6] = {0, 0, 0, 0, 0, 0}, prof_0 = clock64(), prof_c = prof_0;
#endif
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = mx::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = mx::smem_addr(smem);
  float* total = reinterpret_cast<float*>(smem + Smem::out);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, nb = wg * 64 + warp * 16, cn = nb / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, rows = min(kBM, M - m0);
  const int iters = K / kKT, per = (iters + splits - 1) / splits;
  // gridDim.z == 1: this CTA walks every split in order; else split blockIdx.z.
  const int it0 = gridDim.z == 1 ? 0 : blockIdx.z * per;
  const int it1 = gridDim.z == 1 ? iters : min(iters, it0 + per);
  const int nt = max(it1 - it0, 0);
  int split_end = it0 + per;  // the K stage after the current split's last

#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(total + (8 * j + 2 * t + i) * kOutStride + nb + 2 * g) = make_float2(0.f, 0.f);
  float acc[64], p[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mx::mbar_init(sbase + Smem::bar + 8 * s, 1);
    mx::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages - 1 && s < nt; ++s) load_stage(sbase, s, it0 + s, &tx, &tw, &ts, m0, n0);
  uint32_t f0[2][4], f1[2][4];  // A fragments of a stage's blocks 0 and 1
  Raw r0, r1;                    // their raw operands, fetched a phase ahead
  if (nt > 0) {
    mx::mbar_wait(sbase + Smem::bar, 0);
    if (ACT >= 0) {
      fq_stage<ACT < 0 ? 0 : ACT>(smem + Smem::x, rows, tid >> 5, lane);
      mx::fence_proxy_async();
      __syncthreads();
    }
    fetch(r0, smem, sbase, 0, 0, cn, lane);
    fetch(r1, smem, sbase, 0, 1, cn, lane);
    mx::decode_fragments<E>(f0, r0.r, r0.s);
  }

  // Stage st: MX block 0 then block 1, each two k16 wgmmas into the partial
  // p (the first with scale-d = 0), added to acc once retired: the partials
  // are added in block order.  While a block's wgmma runs, the CUDA cores
  // decode the next block's fragments and fetch the raw operands of the one
  // after; p is read only after wait_group 0, so ptxas serializes nothing.
  for (int st = 0; st < nt; ++st) {
    const uint32_t xs = sbase + Smem::x + (st % kStages) * kXBytes;
    const bool next = st + 1 < nt;
    const int nslot = (st + 1) % kStages;
    B6_PHASE(5);
    start_block(p, f0, xs, 0);
    B6_PHASE(0);
    mx::decode_fragments<E>(f1, r1.r, r1.s);
    B6_PHASE(2);
    if (next) {
      // After this barrier stage st - 1's ring slot is free: its wgmmas have
      // retired and its codes were read into registers.
      __syncthreads();
      if (tid == 0 && st + kStages - 1 < nt) {
        mx::fence_proxy_async();
        load_stage(sbase, (st + kStages - 1) % kStages, it0 + st + kStages - 1, &tx, &tw, &ts, m0, n0);
      }
      mx::mbar_wait(sbase + Smem::bar + 8 * nslot, ((st + 1) / kStages) & 1);  // stage st + 1 has landed
      B6_PHASE(1);
      fetch(r0, smem, sbase, nslot, 0, cn, lane);
      B6_PHASE(2);
    }
    mx::wgmma_wait<0>();
    mx::fence_fragment(p);
    B6_PHASE(3);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += p[i];
    B6_PHASE(4);

    start_block(p, f1, xs, 1);
    B6_PHASE(0);
    if (next) {
      if (ACT >= 0) {
        fq_stage<ACT < 0 ? 0 : ACT>(smem + Smem::x + nslot * kXBytes, rows, tid >> 5, lane);
        mx::fence_proxy_async();
      }
      fetch(r1, smem, sbase, nslot, 1, cn, lane);
      mx::decode_fragments<E>(f0, r0.r, r0.s);
    }
    B6_PHASE(2);
    mx::wgmma_wait<0>();
    mx::fence_fragment(p);
    B6_PHASE(3);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += p[i];
    if (st == nt - 1 || it0 + st + 1 == split_end) {
      flush_split(acc, total, nb, g, t);
      split_end += per;
    }
    B6_PHASE(4);
    if (ACT >= 0 && next) __syncthreads();  // the next stage's x, fake-quantized by all threads
  }
#ifdef B6_PHASE_PROFILE
  if (tid == 0 || tid == 200) {
    unsigned long long* c = reinterpret_cast<unsigned long long*>(ws) + (tid == 0 ? 0 : 8);
    for (int i = 0; i < 5; ++i) atomicAdd(c + i, (unsigned long long)prof_t[i]);
    atomicAdd(c + 6, (unsigned long long)(clock64() - prof_0));
    atomicAdd(c + 7, (unsigned long long)nt);
  }
#endif
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

__global__ void reduce_splits_1byte_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out,
                                           long long mn, int splits) {
  mx::reduce_splits(ws, out, mn, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x);
}

template <int E, int ACT>
cudaError_t run(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N, int K,
                int splits, int walk, cudaStream_t stream) {
  CUtensorMap tx, tw, ts;
  if (!mx::tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT16, x, K, M, (uint64_t)K * 2, kKT, kBM,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !mx::tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, kBN, kKT, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !mx::tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_UINT8, scale, N, K / 32, N, kBN, 2, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(matmul_1byte_kernel<E, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Smem::bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, walk ? 1 : splits);
  matmul_1byte_kernel<E, ACT><<<grid, kThreads, Smem::bytes, stream>>>(tx, tw, ts, (uint16_t*)out, (float*)ws, M, N,
                                                                         K, splits);
  return cudaGetLastError();
}

template <int E>
int dispatch_act(const void* x, const void* w, const void* scale, void* out, void* ws, int M, int N, int K, int act_fq,
                 int splits, int walk, cudaStream_t s) {
  switch (act_fq) {
    case -1: return (int)run<E, -1>(x, w, scale, out, ws, M, N, K, splits, walk, s);
    case mx::kFp8E4M3: return (int)run<E, mx::kFp8E4M3>(x, w, scale, out, ws, M, N, K, splits, walk, s);
    case mx::kInt8: return (int)run<E, mx::kInt8>(x, w, scale, out, ws, M, N, K, splits, walk, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The main kernel alone.  elem: mx::kFp8E4M3, kFp6E3M2, kFp6E2M3 or kInt8
// (w then holds int8 codes).  act_fq: -1 for none, mx::kFp8E4M3 or
// mx::kInt8 (the wrapper fuses it at M <= 64).  walk != 0 (or splits == 1):
// each CTA walks all splits and writes out; else split s writes its fp32
// partial to ws[s] (splits x M x N) and mx_matmul_1byte_reduce_launch sums.
extern "C" int mx_matmul_1byte_launch(const void* x, const void* w, const void* scale, void* out, void* ws,
                                      int M, int N, int K, int elem, int act_fq, int splits, int walk,
                                      void* stream) {
  if (M == 0) return 0;
  if (splits < 1 || K % kKT || N % 64) return (int)cudaErrorInvalidValue;
  walk = walk || splits == 1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3: return dispatch_act<mx::kFp8E4M3>(x, w, scale, out, ws, M, N, K, act_fq, splits, walk, s);
    case mx::kFp6E3M2: return dispatch_act<mx::kFp6E3M2>(x, w, scale, out, ws, M, N, K, act_fq, splits, walk, s);
    case mx::kFp6E2M3: return dispatch_act<mx::kFp6E2M3>(x, w, scale, out, ws, M, N, K, act_fq, splits, walk, s);
    case mx::kInt8: return dispatch_act<mx::kInt8>(x, w, scale, out, ws, M, N, K, act_fq, splits, walk, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out (mn bf16) = the split partials ws (splits x mn fp32) summed in split order.
extern "C" int mx_matmul_1byte_reduce_launch(const void* ws, void* out, long long mn, int splits, void* stream) {
  if (mn == 0) return 0;
  reduce_splits_1byte_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (uint16_t*)out, mn, splits);
  return (int)cudaGetLastError();
}
