// B12 mx_grouped_matmul: the dropless grouped expert GEMM.  out (R, N) bf16
// from x_sorted (R, K) bf16, rows sorted by expert and each expert's group
// padded to a multiple of tm, and the stacked expert weights (E, K, N):
// bf16, or one-byte codes (fp8 e4m3, fp6 e3m2 / e2m3 flat, int8) with E8M0
// scales (E, K/32, N).  Row tile t (rows [t*tm, (t+1)*tm)) contracts with
// expert tile_expert[t]; tile_rows[t] counts its live rows.  Rows at or past
// tile_rows[t] come out as 0 (a dead tile has tile_rows[t] == 0), and so do
// rows of x that are all zero: the padding rows group_tokens adds to each
// expert's group.
//
// Replaces torchmx_tpu/ops/pallas_moe.py::_grouped_kernel_bf16 (:54),
// _grouped_kernel_tinner (:74) and _grouped_kernel_mx (:136), all launched
// by grouped_matmul (pallas_call at :264): the weight format is a template
// argument (bf16 for _bf16, the one-byte codes for _tinner and _mx, two
// grid orders of one function).
//
// What bounds it on an H100: at decode (a few tokens per expert) the live
// experts' weight bytes; at prefill (hundreds of rows per expert) the
// tensor-core operations, 2 * rows * N * K.  Design: one CTA takes 64
// columns of one tile of up to 128 rows (a tile of more rows is cut into
// sub-tiles of 128) and its K split (the splits of ops/cuda_matmul._plan, a
// function of N and K alone).  It reads tile_expert and tile_rows itself; a
// dead tile reads no weight at all, so a decode step reads only the routed
// experts' bytes, each once per column block and split.  group_tokens
// counts an expert's padding rows as live, so a decode step's tile of 128
// holds a few tokens and many zero rows: a first pass marks the rows of x
// that hold a nonzero bit (one warp per row, x read once), and the main
// kernel neither loads an unmarked row nor multiplies a 16-row chunk
// without a marked row (its products would be +0: exact for finite weights,
// and every weight the quantizers write decodes finite unless its block's
// scale is the NaN code 255).  Each iteration takes 64 K (two MX blocks):
// the expert's W tile is decoded to bf16 into shared memory in [k][n]
// order, 16 codes per thread per 16-byte load (mx::decode_bf16_bits, the
// dot-operand decode B6 uses), the marked x rows are copied beside it, and
// the next iteration's loads are issued into registers before the tile's
// mma.sync m16n8k16 bf16 -> fp32 (fragments by ldmatrix).  An m16 chunk of a
// tile of 8 rows has its other 8 rows zeroed, never another tile's.  Each MX
// block's product is formed in a zeroed fragment and added to the
// accumulator in block order, and the split partials are summed in split
// order, as B6 (csrc/mx_matmul_1byte.cu) does: for the same expert, rows
// and one-byte weight, B12 and B6 give the same bytes, and a row's bytes
// depend neither on its tile nor on the other rows.  No TMA, no wgmma: a
// later change.
#include "mx_common.cuh"

namespace {

constexpr int kKTile = 64;       // K elements per iteration: two MX blocks
constexpr int kPad = kKTile + 8; // smem row stride in bf16: 144 bytes, conflict-free ldmatrix
constexpr int kBN = 64;          // columns per CTA
constexpr int kThreads = 128;    // 4 warps, 16 columns each
constexpr int kMaxRows = 128;    // rows per CTA at most
constexpr int kBf16 = -1;        // weight format code of bf16 experts

// ldmatrix x4 of a 16 x 16 bf16 block at rows r0..r0+15, columns c0..c0+15
// of a row-major tile: lanes 0-15 pass rows r0..r0+15 at c0, lanes 16-31
// the same rows at c0 + 8.  Without .trans the registers are the A fragment
// of mma m16n8k16 (a[0..3]); with .trans over a [k][n] tile, b[0], b[1] are
// the B fragments (k16 x n8) of columns c0..c0+7 and b[2], b[3] of c0+8..15.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem_row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem_row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// marked[r] = 1 when row r of x lies in a live tile and holds a nonzero bit
// (a -0.0 counts as zero).  One warp per row.
__global__ void __launch_bounds__(256)
grouped_mark_kernel(const uint16_t* __restrict__ x, const int* __restrict__ tile_expert,
                    const int* __restrict__ tile_rows, int* __restrict__ marked, int R, int K, int E, int tm) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  if (r >= R) return;
  const int t = r / tm, e = tile_expert[t];
  uint32_t bits = 0;
  if (r % tm < tile_rows[t] && e >= 0 && e < E) {
    const uint16_t* xr = x + (long long)r * K;
    for (int c = lane * 8; c < K; c += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
      bits |= (v.x | v.y | v.z | v.w) & 0x7FFF7FFFu;
    }
  }
  const bool any = __any_sync(0xffffffffu, bits != 0);
  if (lane == 0) marked[r] = any ? 1 : 0;
}

// WF: kBf16 or an mx::ElemCode of a one-byte format.  MT: 16-row chunks per
// CTA (1 for tiles of up to 16 rows, else 8).
template <int WF, int MT>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const uint16_t* __restrict__ x, const uint8_t* __restrict__ w, const uint8_t* __restrict__ scale,
               const int* __restrict__ tile_expert, const int* __restrict__ tile_rows,
               const int* __restrict__ marked, uint16_t* __restrict__ out, float* __restrict__ ws, int R, int N,
               int K, int E, int tm, int sb, int splits) {
  constexpr int kWLoads = WF == kBf16 ? 4 : 2;  // 16-byte weight loads per thread per iteration
  __shared__ __align__(16) uint16_t Xs[MT * 16][kPad];
  __shared__ __align__(16) uint16_t Ws[kKTile][kPad];
  __shared__ int row_mark[MT * 16];
  __shared__ int chunk_mark[MT];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_base = blockIdx.x * kBN;
  const int row0 = blockIdx.y * sb;
  const int tile = row0 / tm;
  const int expert = tile_expert[tile];
  int live = min(max(tile_rows[tile] - row0 % tm, 0), sb);
  if (expert < 0 || expert >= E) live = 0;

  if (splits == 1) {  // rows [live, sb) are 0 (with splits, the reduce writes them)
    for (int i = tid; i < (sb - live) * (kBN / 8); i += kThreads) {
      const int r = live + i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * N + n_base + c) = make_uint4(0, 0, 0, 0);
    }
  }
  if (live == 0) return;
  const int chunks = (live + 15) / 16;

  const int iters = K / kKTile;
  const int per = (iters + splits - 1) / splits;
  const int it0 = blockIdx.z * per, it1 = min(iters, it0 + per);

  // Unmarked rows of x stay zero in shared memory; a chunk without a marked
  // row is not multiplied.
  for (int i = tid; i < MT * 16 * kPad; i += kThreads) Xs[i / kPad][i % kPad] = 0;
  if (tid < MT) chunk_mark[tid] = 0;
  __syncthreads();
  if (tid < MT * 16) {
    row_mark[tid] = tid < live ? marked[row0 + tid] : 0;
    if (row_mark[tid]) chunk_mark[tid / 16] = 1;
  }
  __syncthreads();

  const uint16_t* xrow = x + (long long)row0 * K;
  const long long w_off = (long long)expert * K * N + n_base;
  const long long s_off = (long long)expert * (K / 32) * N + n_base;

  uint4 xr[MT], wr[kWLoads], sr[2];
  auto fetch = [&](int it) {
    const int k0 = it * kKTile;
#pragma unroll
    for (int i = 0; i < MT; ++i) {  // thread tid holds row tid / 8 of chunk i
      const int r = i * 16 + tid / 8, c = (tid % 8) * 8;
      if (row_mark[r]) xr[i] = *reinterpret_cast<const uint4*>(xrow + (long long)r * K + k0 + c);
    }
    if constexpr (WF == kBf16) {
      const uint16_t* wb = reinterpret_cast<const uint16_t*>(w);
#pragma unroll
      for (int i = 0; i < kWLoads; ++i) {
        const int idx = tid + i * kThreads, r = idx / 8, c = (idx % 8) * 8;
        wr[i] = *reinterpret_cast<const uint4*>(wb + w_off + (long long)(k0 + r) * N + c);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWLoads; ++i) {  // row r = tid / 4 + 32 i lies in MX block i of the tile
        const int r = tid / 4 + 32 * i, c = (tid % 4) * 16;
        wr[i] = *reinterpret_cast<const uint4*>(w + w_off + (long long)(k0 + r) * N + c);
        sr[i] = *reinterpret_cast<const uint4*>(scale + s_off + (long long)(k0 / 32 + i) * N + c);
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = i * 16 + tid / 8, c = (tid % 8) * 8;
      if (row_mark[r]) *reinterpret_cast<uint4*>(&Xs[r][c]) = xr[i];
    }
    if constexpr (WF == kBf16) {
#pragma unroll
      for (int i = 0; i < kWLoads; ++i) {
        const int idx = tid + i * kThreads, r = idx / 8, c = (idx % 8) * 8;
        *reinterpret_cast<uint4*>(&Ws[r][c]) = wr[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWLoads; ++i) {
        const int r = tid / 4 + 32 * i, c = (tid % 4) * 16;
        const uint8_t* cb = reinterpret_cast<const uint8_t*>(&wr[i]);
        const uint8_t* sb8 = reinterpret_cast<const uint8_t*>(&sr[i]);
        uint32_t p[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          p[j] = (uint32_t)mx::decode_bf16_bits<WF>(cb[2 * j], sb8[2 * j]) |
                 ((uint32_t)mx::decode_bf16_bits<WF>(cb[2 * j + 1], sb8[2 * j + 1]) << 16);
        *reinterpret_cast<uint4*>(&Ws[r][c]) = make_uint4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<uint4*>(&Ws[r][c + 8]) = make_uint4(p[4], p[5], p[6], p[7]);
      }
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  if (it0 < it1) fetch(it0);
  for (int it = it0; it < it1; ++it) {
    stage();
    __syncthreads();
    if (it + 1 < it1) fetch(it + 1);  // in flight during this tile's products
#pragma unroll
    for (int blk = 0; blk < kKTile / 32; ++blk) {
      uint32_t b[2][4];  // B fragments of this warp's 16 columns, k16 steps 0 and 1 of the block
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldmatrix_x4_trans(b[kk], &Ws[blk * 32 + kk * 16 + (lane & 15)][warp * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= chunks) break;
        if (!chunk_mark[i]) continue;
        float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, &Xs[i * 16 + (lane & 15)][blk * 32 + kk * 16 + (lane >> 4) * 8]);
          mx::mma_bf16_16816(part[0], a, b[kk]);
          mx::mma_bf16_16816(part[1], a, b[kk] + 2);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += part[j][r];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= chunks) break;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i * 16 + g + h * 8;
        if (r >= live) continue;
        const int n = n_base + warp * 16 + j * 8 + 2 * t4;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (splits == 1) {
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row0 + r) * N + n) = __floats2bfloat162_rn(v0, v1);
        } else if (row_mark[r]) {  // the reduce writes 0 for unmarked rows
          *reinterpret_cast<float2*>(ws + ((long long)blockIdx.z * R + row0 + r) * N + n) = make_float2(v0, v1);
        }
      }
  }
}

// Sum the marked rows' split partials in split order (mx::reduce_splits'
// arithmetic) and write 0 to every other row.  Block: 256 columns x 8 rows.
__global__ void __launch_bounds__(256)
grouped_reduce_kernel(const float* __restrict__ ws, uint16_t* __restrict__ out, const int* __restrict__ marked,
                      int R, int N, int splits) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  for (int r = blockIdx.y * 8; r < blockIdx.y * 8 + 8; ++r) {
    const long long i = (long long)r * N + n;
    if (marked[r]) {
      mx::reduce_splits(ws, out, (long long)R * N, splits, i);
    } else {
      out[i] = 0;
    }
  }
}

template <int WF, int MT>
cudaError_t run(const void* x, const void* w, const void* scale, const int* te, const int* tr, int* marked, void* out,
                void* ws, int R, int N, int K, int E, int tm, int sb, int splits, cudaStream_t stream) {
  grouped_mark_kernel<<<(R + 7) / 8, 256, 0, stream>>>((const uint16_t*)x, te, tr, marked, R, K, E, tm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid(N / kBN, R / sb, splits);
  grouped_kernel<WF, MT><<<grid, kThreads, 0, stream>>>((const uint16_t*)x, (const uint8_t*)w,
                                                        (const uint8_t*)scale, te, tr, marked, (uint16_t*)out,
                                                        (float*)ws, R, N, K, E, tm, sb, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  dim3 rgrid((N + 255) / 256, R / 8);
  grouped_reduce_kernel<<<rgrid, 256, 0, stream>>>((const float*)ws, (uint16_t*)out, marked, R, N, splits);
  return cudaGetLastError();
}

template <int WF>
cudaError_t dispatch_rows(const void* x, const void* w, const void* scale, const int* te, const int* tr, int* marked,
                          void* out, void* ws, int R, int N, int K, int E, int tm, int splits, cudaStream_t s) {
  const int sb = tm < kMaxRows ? tm : kMaxRows;  // rows per CTA: the tile, or 128 of its rows
  if (sb <= 16) return run<WF, 1>(x, w, scale, te, tr, marked, out, ws, R, N, K, E, tm, sb, splits, s);
  return run<WF, kMaxRows / 16>(x, w, scale, te, tr, marked, out, ws, R, N, K, E, tm, sb, splits, s);
}

}  // namespace

// elem: -1 for bf16 experts (w holds bf16, scale is unused), else
// mx::kFp8E4M3, kFp6E3M2, kFp6E2M3 or kInt8 (w holds one code per byte).
// tm: a multiple of 8, and of 128 when above 128; R a multiple of tm; N and
// K multiples of 64.  marked: R ints of scratch; ws: splits x R x N floats
// when splits > 1.
extern "C" int mx_grouped_matmul_launch(const void* x, const void* w, const void* scale, const void* tile_expert,
                                        const void* tile_rows, void* marked, void* out, void* ws, int R, int N,
                                        int K, int E, int tm, int elem, int splits, void* stream) {
  if (R == 0) return 0;
  if (tm <= 0 || tm % 8 || (tm > kMaxRows && tm % kMaxRows) || R % tm || N % kBN || K % kKTile || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* te = (const int*)tile_expert;
  const int* tr = (const int*)tile_rows;
  int* mk = (int*)marked;
  switch (elem) {
    case kBf16: return dispatch_rows<kBf16>(x, w, scale, te, tr, mk, out, ws, R, N, K, E, tm, splits, s);
    case mx::kFp8E4M3: return dispatch_rows<mx::kFp8E4M3>(x, w, scale, te, tr, mk, out, ws, R, N, K, E, tm, splits, s);
    case mx::kFp6E3M2: return dispatch_rows<mx::kFp6E3M2>(x, w, scale, te, tr, mk, out, ws, R, N, K, E, tm, splits, s);
    case mx::kFp6E2M3: return dispatch_rows<mx::kFp6E2M3>(x, w, scale, te, tr, mk, out, ws, R, N, K, E, tm, splits, s);
    case mx::kInt8: return dispatch_rows<mx::kInt8>(x, w, scale, te, tr, mk, out, ws, R, N, K, E, tm, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}
