// K7 mx_cached_attention_int8dot: decode attention (one query position per
// batch row) over an int8 MX KV cache in the d-major layout, with both dots
// taken in int8: q is MXINT8-quantized here, p is requantized to 8 bits.
//
// Replaces torchmx_tpu/ops/pallas_attention.py::_attn_kernel_int8dot (:638),
// launched by _mx_cached_attention_int8dot (:754), together with its
// wrapper's quantization of q (_int8dot_attention, :796-818): each CTA
// quantizes its G query rows in its prologue with K1's arithmetic
// (mx::block_scale, mx::cast_int8), the same codes and scales bit for bit.
//
// Inputs: q (b, hq, 1, d) bf16; K/V codes (b, hkv, d, L) int8 and scales
// (b, hkv, d/32, L) uint8, the sequence on the last axis; q_off, kv_len (b,)
// int32.  Output (b, hq, 1, d) bf16.  For the G = hq / hkv query rows r of a
// KV head, the d/32 chunks c and position j, a scale being the float whose
// bits are e << 23 (0 gives +0.0, 255 gives +inf):
//   q_c[r], eq[c,r]  = K1's MXINT8 codes and scale of q's block c
//   dots[c,r,j] = q_c[r] . k_c[j]                       exact int32
//   s[r,j]      = sm_scale * sum_c dots * 2^(eq[c,r]-127) * 2^(ek[c,j]-127)
//   j is visible when j <= q_off and j < kv_len; masked scores are -1e30
// and, per KV tile of lt = _pick_lt(L) positions (JAX's tile: 512 at L =
// 1024, 2048 at L = 8192; ops/cuda_attention._pick_lt):
//   m_t = max_j s, p = exp(s - m_t), l_t = sum_j p
//   p3[c,r,j]   = p[r,j] * 2^(ev[c,j]-127);  mx[c,r] = max_j p3 (1 where 0)
//   pq = round_half_even(p3 * (127 / mx)) as int8
//   acc_t[c,r,:] = (pq . v_c, exact int32) * (mx * (1/127))
// and the tiles are combined in tile order: M = max_t m_t, out = (sum_t
// acc_t e^(m_t - M)) / (sum_t l_t e^(m_t - M)) (a sum of 0 taken as 1: a row
// with no visible key gives 0).  pq does not depend on the maximum p was
// taken against (p3 and mx scale together), so against JAX's online form
// (and the plain version, which is that form) the result differs only in
// fp32 rounding and in rare ties of pq.  A hidden position is skipped, never
// multiplied by its scale: a stale scale of 255 past the prefix cannot turn
// into 0 * inf.
//
// What bounds it on an H100: the cache bytes of the visible prefix (264 bytes
// per position and KV head); the integer work is small.  Design:
//  1. One CTA a JAX tile: the grid is (tile, KV head, batch row); a CTA whose
//     tile starts past its row's visible prefix exits at once (where kv_len
//     is a number the wrapper launches only the tiles below it).  Inside a
//     tile the P.V sums are exact int32 (|pq|, |v| <= 127, 2048 positions),
//     so the warps split the work in any way and add integers in any order.
//  2. The combine runs in the same launch: each live tile of a row with two
//     or more writes (acc_t, m_t, l_t) in fp32 to a workspace (ops/split_kv,
//     shared with B13 and B14), and the last CTA of the (batch row, KV head)
//     (an atomic ticket, which it resets) combines them in tile order.  A row
//     with one live tile writes acc_t / l_t.  So a row's bytes depend on its
//     own q_off, kv_len and L only.
//  3. Asynchronous copies: a producer warp issues TMA boxes of 128 positions
//     x 128 code rows (128-byte swizzled: the scores' word loads and P.V's
//     ldmatrix run without bank conflicts), first the tile's K boxes, then
//     its V boxes, through a ring on full / empty mbarriers (8 slots for
//     tiles of 1024 positions and more, else 4: ring_stages), so that V's
//     boxes are in flight while the scores run; the tile's K and V scale rows
//     (four each) land once, on their own barrier.  Only the boxes of the
//     visible prefix are loaded; q and the tensor maps are fetched while the
//     row's positions are read.
//  4. Scores: the consumer warp that owns a ring slot takes the K boxes that
//     land there (128 positions, a lane four of them; a waiter must see
//     every phase of its barrier), reads each code row as one conflict-free
//     128-byte word load, turns four rows of four positions by a 4x4 byte
//     transpose (mx::transpose_4x4_bytes) into words of four consecutive d,
//     and takes dp4a against q's words; the chunk's two scales, then the
//     chunks added in chunk order.  s goes to shared memory in fp32.
//  5. Softmax and requantization in shared memory, every consumer thread (a
//     query row's share of them its positions): m_t; then p, l_t and the
//     four chunks' mx in one pass; then pq as int8 ([chunk][row][position],
//     rows padded by 16 bytes).
//  6. P.V on the int8 tensor cores: warp w takes d rows 16 w .. 16 w + 15 (in
//     chunk w / 2); the d-major V box is mma.sync m16n8k32's A operand as it
//     lies (ldmatrix.x4 of 16 d rows x 32 positions), pq^T its B (32
//     positions x 8 query rows); the int32 accumulators run over the whole
//     tile.
//  7. q is quantized in the prologue (a warp a 32-block of a row); no
//     separate K1 launch.
//  8. Any GQA group from 1 to 8: the kernel is built for GP = 1, 2, 4 and 8
//     rows (the row reductions split the 8 consumer warps among GP rows), and
//     a group G of 3, 5, 6 or 7 runs in the next of them.  Only the G live
//     rows' blocks of q are read and quantized; the GP - G dead rows take no
//     dot, no position in the softmax and no column of pq (B is zero there),
//     and are never written; shared memory and the workspace are laid out
//     for the G live rows.  The query heads are read and written at stride G
//     (the planted fault kFaultPadStride reads them at stride GP).
#include "mx_common.cuh"
#include "mx_wgmma.cuh"

namespace {

constexpr int kD = 128;                   // head_dim
constexpr int kNc = kD / 32;              // chunks
constexpr int kBox = 128;                 // positions of a TMA box and of a ring slot
constexpr int kSlot = kD * kBox;          // bytes of a ring slot: 128 code rows of 128 positions
constexpr int kMaxStages = 8;             // ring slots at most (ring_stages)
constexpr int kWarps = 8;                 // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxTiles = 64;             // tiles of a cache at most
constexpr int kSmemMax = 232448;          // dynamic shared memory a CTA may take on an H100
static_assert(kMaxStages <= kWarps, "a scoring warp owns a ring slot");
constexpr float kNegInf = -1e30f;
constexpr int kFaultDropLast = 1;  // planted fault: the combine drops the last live tile
constexpr int kFaultQScale = 2;    // planted fault: q's scale of chunk c taken from chunk c + 1
constexpr int kFaultPadStride = 4;  // planted fault: query heads read at the padded instance's stride GP
constexpr int kFaultPDown = 8;      // planted fault: p's int8 codes rounded down, not to nearest

// Byte offsets of the dynamic shared memory for G query rows, tiles of lt
// positions and a ring of `stages` slots (from a 1024-byte aligned base: the
// swizzled slots need it).
struct Smem {
  int ks, vs, s, pq, qc, qse, stat, bar, last, total;
  __host__ __device__ Smem(int G, int lt, int stages) {
    ks = stages * kSlot;           // K scale rows: [box][chunk][128 positions]
    vs = ks + kNc * lt;            // V scale rows, the same
    s = vs + kNc * lt;             // s, then p: fp32 [row][lt]; at the end the combine's factors
    pq = s + 4 * G * lt;           // pq: int8 [chunk][row][lt + 16]
    qc = pq + kNc * G * (lt + 16);  // q codes: int8 [row][d]
    qse = qc + G * kD;             // q scales: E8M0 [row][chunk]
    stat = (qse + 4 * G + 15) & ~15;  // m_t[G], l_t[G], mx[chunk][row], then a row's partials [warp]
    bar = (stat + (6 * G + kWarps) * 4 + 7) & ~7;  // full[stages], empty[stages], scales
    last = bar + (2 * stages + 1) * 8;
    total = last + 16;
  }
};

// D += A (16x32 s8, row) * B (32x8 s8, col), exact int32 (mx::mma_s8_16832's
// fragments, accumulating).
__device__ __forceinline__ void mma_s8_acc(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// `n` arrivals on an mbarrier at once (a warp releasing a slot that counts
// every consumer warp).
__device__ __forceinline__ void mbar_arrive_n(uint32_t bar, int n) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(n) : "memory");
}

__device__ __forceinline__ float byte_scale(uint32_t w, int k) { return mx::pow2_scale((w >> (8 * k)) & 0xFF); }

// The sum (kSum) or maximum of v over the kConsumers / GP threads of a query
// row (a warp, or several through shared memory red[kWarps]); every consumer
// thread calls it.
template <int GP, bool kSum>
__device__ __forceinline__ float row_reduce(float v, float* red, int warp, int lane) {
  v = kSum ? mx::warp_sum(v) : mx::warp_max(v);
  constexpr int kRowWarps = kWarps / GP;
  if constexpr (kRowWarps > 1) {
    if (lane == 0) red[warp] = v;
    mx::named_barrier(1, kConsumers);
    const int w0 = warp / kRowWarps * kRowWarps;
    v = red[w0];
#pragma unroll
    for (int i = 1; i < kRowWarps; ++i) v = kSum ? v + red[w0 + i] : fmaxf(v, red[w0 + i]);
    mx::named_barrier(1, kConsumers);
  }
  return v;
}

// Grid (tiles, hkv, b); kThreads threads: warps 0 .. 7 compute, warp 8
// issues the copies.  G: the group (live rows, G <= GP).  ws: (b hkv, tiles,
// G, d + 2) floats (acc_t, m_t, l_t); tickets: b hkv ints, zero between
// launches.  q_codes / q_scales: null, or where tile 0's CTAs write q's codes
// (b, hkv, G, d) and scales (b, hkv, G, d/32).  stages: the ring's slots
// (ring_stages).
template <int GP>
__global__ void __launch_bounds__(kThreads, GP <= 4 ? 2 : 1)
attention_int8dot_kernel(const __grid_constant__ CUtensorMap tkd, const __grid_constant__ CUtensorMap tks,
                         const __grid_constant__ CUtensorMap tvd, const __grid_constant__ CUtensorMap tvs,
                         const uint16_t* __restrict__ q, const int* __restrict__ q_off_p,
                         const int* __restrict__ kv_len_p, uint16_t* __restrict__ out, float* __restrict__ ws,
                         int* __restrict__ tickets, int8_t* __restrict__ q_codes, uint8_t* __restrict__ q_scales,
                         int G, int hkv, int L, int lt, int stages, float sm_scale, int fault) {
  const int tile = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z, n_tiles = gridDim.x;
  const int kvh = ib * hkv + ih, hq = hkv * G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // q's elements and the tensor maps are fetched while the row's positions
  // are read: a warp a 32-block of q, a lane an element (the live rows'
  // blocks only; the planted fault reads head ih GP + r within the batch row).
  constexpr int kQBlocks = (GP * kNc + kWarps - 1) / kWarps;
  const int head0 = (fault & kFaultPadStride) ? ih * GP : ih * G;
  int qbits[kQBlocks];
#pragma unroll
  for (int i = 0; i < kQBlocks; ++i) {
    const int blk = warp + i * kWarps;
    qbits[i] = warp < kWarps && blk < G * kNc ? q[((long long)ib * hq + (head0 + blk / kNc) % hq) * kD + (blk % kNc) * 32 + lane] : 0;
  }
  if (tid == kConsumers)
    for (const CUtensorMap* m : {&tkd, &tvd, &tks, &tvs})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
  const int kv_end = max(min(min(kv_len_p[ib], q_off_p[ib] + 1), L), 0);
  const int n_live = kv_end > 0 ? (kv_end + lt - 1) / lt : 1;
  if (tile >= n_live) return;  // the tile starts past the row's visible prefix
  const int t0 = tile * lt;
  const int nvis = max(min(kv_end - t0, lt), 0);  // visible positions of the tile
  const int n_box = (nvis + kBox - 1) / kBox;      // boxes of K (and of V) to load

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = mx::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = mx::smem_addr(smem);
  const Smem lay(G, lt, stages);
  const uint32_t full = sbase + lay.bar, empty = full + 8 * stages, scales = full + 16 * stages;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mx::mbar_init(full + 8 * s, 1);
      mx::mbar_init(empty + 8 * s, kWarps);
    }
    mx::mbar_init(scales, 1);
    mx::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer: fill f is K box f (f < n_box), then V box f - n_box
    if (lane == 0) {
      const int crow = kvh * kD, srow = kvh * kNc;
      for (int f = 0; f < 2 * n_box; ++f) {
        const int slot = f % stages, box = f % n_box;
        if (f >= stages) mx::mbar_wait(empty + 8 * slot, (f / stages - 1) & 1);
        mx::mbar_expect_tx(full + 8 * slot, kSlot);
        mx::tma_load_2d(sbase + slot * kSlot, f < n_box ? &tkd : &tvd, full + 8 * slot, t0 + box * kBox, crow);
        if (f == 0) {  // the scale rows, after K's first box
          mx::mbar_expect_tx(scales, 2 * n_box * kNc * kBox);
          for (int bx = 0; bx < n_box; ++bx) {
            mx::tma_load_2d(sbase + lay.ks + bx * kNc * kBox, &tks, scales, t0 + bx * kBox, srow);
            mx::tma_load_2d(sbase + lay.vs + bx * kNc * kBox, &tvs, scales, t0 + bx * kBox, srow);
          }
        }
      }
    }
    return;
  }

  int8_t* qc = reinterpret_cast<int8_t*>(smem + lay.qc);
  uint8_t* qse = smem + lay.qse;
  float* sb = reinterpret_cast<float*>(smem + lay.s);
  uint8_t* pqb = smem + lay.pq;
  float* stat = reinterpret_cast<float*>(smem + lay.stat);  // m_t[G], l_t[G], mx[chunk][row]
  float* red = stat + 6 * G;                                // [kWarps]: a row's partials across warps
  const int pq_row = lt + 16;

  // 1. q to MXINT8, K1's arithmetic.
#pragma unroll
  for (int i = 0; i < kQBlocks; ++i) {
    const int blk = warp + i * kWarps;
    if (blk >= G * kNc) break;
    const int r = blk / kNc, c = blk % kNc, bits = qbits[i];
    const int emax = (int)__reduce_max_sync(0xffffffffu, (unsigned)((bits >> 7) & 0xFF));
    const int se = mx::block_scale(emax, mx::Elem<mx::kInt8>::max_pow2);
    const int code = mx::cast_int8(bits, se);
    qc[r * kD + c * 32 + lane] = (int8_t)code;
    if (lane == 0) qse[r * kNc + c] = (uint8_t)se;
    if (q_codes != nullptr && tile == 0) {
      q_codes[((long long)kvh * G + r) * kD + c * 32 + lane] = (int8_t)code;
      if (lane == 0) q_scales[((long long)kvh * G + r) * kNc + c] = (uint8_t)se;
    }
  }
  mx::named_barrier(1, kConsumers);
  const int qshift = (fault & kFaultQScale) ? 1 : 0;
  if (n_box > 0) mx::mbar_wait(scales, 0);

  // 2. Scores: warp w < stages takes the K boxes of ring slot w (w, w +
  // stages, ...), so it waits on every phase of its slot's full barrier in
  // turn; lane l takes positions 4 l .. 4 l + 3 of the box.
  const int* qw = reinterpret_cast<const int*>(qc);  // [row][d / 4]
  for (int f = warp < stages ? warp : n_box; f < n_box; f += stages) {
    const int slot = f % stages;
    mx::mbar_wait(full + 8 * slot, (f / stages) & 1);
    const uint8_t* kt = smem + slot * kSlot;
    float s[4][GP];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < GP; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      int dot[4][GP];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < GP; ++r) dot[j][r] = 0;
#pragma unroll
      for (int gq = 0; gq < 8; ++gq) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // code row c*32 + gq*4 + i, the lane's word (128-byte swizzle)
          const int row = c * 32 + gq * 4 + i;
          w[i] = *reinterpret_cast<const uint32_t*>(kt + row * 128 + (((lane >> 2) ^ (row & 7)) << 4) + (lane & 3) * 4);
        }
        mx::transpose_4x4_bytes(w);  // w[j]: position 4 lane + j, d = c*32 + gq*4 .. + 3
#pragma unroll
        for (int r = 0; r < GP; ++r) {
          if (r >= G) break;  // a dead row takes no dot
          const int qv = qw[r * (kD / 4) + c * 8 + gq];
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[j][r] = __dp4a((int)w[j], qv, dot[j][r]);
        }
      }
      const uint32_t ksw = *reinterpret_cast<const uint32_t*>(smem + lay.ks + f * kNc * kBox + c * kBox + 4 * lane);
#pragma unroll
      for (int r = 0; r < GP; ++r) {
        if (r >= G) break;
        const float qsc = mx::pow2_scale(qse[r * kNc + ((c + qshift) & (kNc - 1))]);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j][r] += (float)dot[j][r] * qsc * byte_scale(ksw, j);
      }
    }
    const int p0 = f * kBox + 4 * lane;  // the lane's first position in the tile
#pragma unroll
    for (int r = 0; r < GP; ++r) {
      if (r >= G) break;
      float4 v;
      v.x = p0 < nvis ? s[0][r] * sm_scale : kNegInf;
      v.y = p0 + 1 < nvis ? s[1][r] * sm_scale : kNegInf;
      v.z = p0 + 2 < nvis ? s[2][r] * sm_scale : kNegInf;
      v.w = p0 + 3 < nvis ? s[3][r] * sm_scale : kNegInf;
      *reinterpret_cast<float4*>(sb + r * lt + p0) = v;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive_n(empty + 8 * slot, kWarps);  // the slot counts every consumer warp
  }
  mx::named_barrier(1, kConsumers);

  // 3. Softmax and requantization over the tile, every consumer thread: the
  // kRowThreads threads of row r take its positions four at a time (a dead
  // row, r >= G, none).  m_t; then p (replacing s), l_t and mx of the four
  // chunks in one pass; then pq.
  {
    constexpr int kRowThreads = kConsumers / GP;
    const int r = tid / kRowThreads, k = tid % kRowThreads;
    const int npos = r < G ? n_box * kBox : 0;
    float* row = sb + r * lt;
    float m = kNegInf;
    for (int j = 4 * k; j < npos; j += 4 * kRowThreads) {
      const float4 v = *reinterpret_cast<const float4*>(row + j);
      m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    }
    m = row_reduce<GP, false>(m, red, warp, lane);
    float l = 0.f, mxc[kNc] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 4 * k; j < npos; j += 4 * kRowThreads) {
      float4 v = *reinterpret_cast<const float4*>(row + j);
      float pv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = pv[e] == kNegInf ? 0.f : expf(pv[e] - m);
        l += pv[e];
      }
      const uint8_t* vsj = smem + lay.vs + (j / kBox) * kNc * kBox + j % kBox;
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        const uint32_t vw = *reinterpret_cast<const uint32_t*>(vsj + c * kBox);
#pragma unroll
        for (int e = 0; e < 4; ++e) mxc[c] = fmaxf(mxc[c], j + e < nvis ? pv[e] * byte_scale(vw, e) : 0.f);
      }
      *reinterpret_cast<float4*>(row + j) = make_float4(pv[0], pv[1], pv[2], pv[3]);
    }
    l = row_reduce<GP, true>(l, red, warp, lane);
    // p >= 0: less a hair under one half, rounding to nearest rounds down (the planted fault).
    const float down = (fault & kFaultPDown) ? 0.49999997f : 0.f;
    float inv[kNc];
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      mxc[c] = row_reduce<GP, false>(mxc[c], red, warp, lane);
      mxc[c] = mxc[c] == 0.f ? 1.f : mxc[c];
      inv[c] = 127.f / mxc[c];
    }
    for (int j = 4 * k; j < npos; j += 4 * kRowThreads) {
      const float4 v = *reinterpret_cast<const float4*>(row + j);
      const float pv[4] = {v.x, v.y, v.z, v.w};
      const uint8_t* vsj = smem + lay.vs + (j / kBox) * kNc * kBox + j % kBox;
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        const uint32_t vw = *reinterpret_cast<const uint32_t*>(vsj + c * kBox);
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p3 = j + e < nvis ? pv[e] * byte_scale(vw, e) : 0.f;
          word |= (uint32_t)(__float2int_rn(p3 * inv[c] - down) & 0xFF) << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(pqb + (c * G + r) * pq_row + j) = word;
      }
    }
    if (k == 0 && r < G) {
      stat[r] = m;
      stat[G + r] = l;
#pragma unroll
      for (int c = 0; c < kNc; ++c) stat[2 * G + c * G + r] = mxc[c];
    }
  }
  mx::named_barrier(1, kConsumers);

  // 4. P.V: warp w, d rows 16 w .. 16 w + 15 of chunk w / 2, over V boxes 0 .. n_box - 1.
  const int g = lane / 4, t = lane % 4, c = warp / 2;
  int acc[4] = {0, 0, 0, 0};
  const uint8_t* pqg = pqb + (c * G + g) * pq_row;  // B's column g: query row g (g < G)
  const int mi = lane >> 3, dl = 16 * warp + (lane & 7) + 8 * (mi & 1);  // the row this lane addresses for ldmatrix
  for (int bx = 0; bx < n_box; ++bx) {
    const int f = n_box + bx, slot = f % stages;
    mx::mbar_wait(full + 8 * slot, (f / stages) & 1);
    const uint32_t vt = sbase + slot * kSlot;
#pragma unroll
    for (int ks = 0; ks < kBox / 32; ++ks) {
      uint32_t a[4];
      mx::ldmatrix_x4(a, vt + dl * 128 + (((2 * ks + (mi >> 1)) ^ (dl & 7)) << 4));
      uint32_t bq[2] = {0u, 0u};
      if (g < G) {
        const int k0 = bx * kBox + ks * 32 + 4 * t;
        bq[0] = *reinterpret_cast<const uint32_t*>(pqg + k0);
        bq[1] = *reinterpret_cast<const uint32_t*>(pqg + k0 + 16);
      }
      mma_s8_acc(acc, a, bq);
    }
    __syncwarp();
    if (lane == 0) mx::mbar_arrive(empty + 8 * slot);
  }

  // 5. Epilogue.  acc[2h + e]: d row 16 w + g + 8 h, query row 2 t + e.
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 2 * t + (k & 1);
    o[k] = r < G ? (float)acc[k] * (stat[2 * G + c * G + r] * (1.f / 127.f)) : 0.f;
  }
  if (n_live == 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = 2 * t + (k & 1);
      if (r >= G) continue;
      const float l = stat[G + r];
      out[((long long)ib * hq + ih * G + r) * kD + 16 * warp + g + 8 * (k >> 1)] =
          __bfloat16_as_ushort(__float2bfloat16_rn(o[k] / (l == 0.f ? 1.f : l)));
    }
    return;
  }

  constexpr int kRec = kD + 2;  // a record: acc_t[d], m_t, l_t
  float* base = ws + (long long)kvh * n_tiles * G * kRec;
  float* rec = base + (long long)tile * G * kRec;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 2 * t + (k & 1);
    if (r < G) rec[r * kRec + 16 * warp + g + 8 * (k >> 1)] = o[k];
  }
  if (tid < G) {
    rec[tid * kRec + kD] = stat[tid];
    rec[tid * kRec + kD + 1] = stat[G + tid];
  }
  __threadfence();
  mx::named_barrier(1, kConsumers);
  int* last = reinterpret_cast<int*>(smem + lay.last);
  if (tid == 0) *last = atomicAdd(tickets + kvh, 1) == n_live - 1;
  mx::named_barrier(1, kConsumers);
  if (!*last) return;
  __threadfence();

  // The last CTA: a thread an element (r, e) of the output; M = the tiles'
  // largest m_t, then l_t and acc_t weighted by e^(m_t - M), added in tile
  // order.
  const int n_use = (fault & kFaultDropLast) ? n_live - 1 : n_live;
  for (int i = tid; i < G * kD; i += kConsumers) {
    const int r = i / kD, e = i % kD;
    const float* rr = base + r * kRec;
    float M = kNegInf;
#pragma unroll 4
    for (int u = 0; u < n_use; ++u) M = fmaxf(M, __ldcg(rr + u * G * kRec + kD));
    float l = 0.f, a = 0.f;
#pragma unroll 4
    for (int u = 0; u < n_use; ++u) {
      const float* ru = rr + u * G * kRec;
      const float f = expf(__ldcg(ru + kD) - M);
      l = __fadd_rn(l, __fmul_rn(__ldcg(ru + kD + 1), f));
      a = __fadd_rn(a, __fmul_rn(__ldcg(ru + e), f));
    }
    out[((long long)ib * hq + ih * G + r) * kD + e] =
        __bfloat16_as_ushort(__float2bfloat16_rn(a / (l == 0.f ? 1.f : l)));
  }
  if (tid == 0) tickets[kvh] = 0;
}

// The ring's slots for G query rows and tiles of lt positions: 8 for tiles
// of 1024 positions and more where they fit (few CTAs, each streaming a long
// tile: more bytes in flight), else 4 (two CTAs an SM at lt <= 512).
int ring_stages(int G, int lt) {
  return lt >= 1024 && Smem(G, lt, 8).total + 1024 <= kSmemMax ? 8 : 4;
}

template <int GP>
cudaError_t run(const void* q, const void* kd, const void* ks, const void* vd, const void* vs, const void* q_off,
                const void* kv_len, void* out, void* ws, void* tickets, void* q_codes, void* q_scales, int b, int G,
                int hkv, int L, int lt, int tiles, float sm_scale, int fault, cudaStream_t stream) {
  const uint64_t heads = (uint64_t)b * hkv;
  CUtensorMap tkd, tks, tvd, tvs;
  // Codes: boxes of 128 positions x 128 rows, 128-byte swizzled; scales: 128 x 4, plain.
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B, none = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!mx::cached_byte_map(&tkd, kd, heads * kD, L, kBox, kD, sw) ||
      !mx::cached_byte_map(&tvd, vd, heads * kD, L, kBox, kD, sw) ||
      !mx::cached_byte_map(&tks, ks, heads * kNc, L, kBox, kNc, none) ||
      !mx::cached_byte_map(&tvs, vs, heads * kNc, L, kBox, kNc, none))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(attention_int8dot_kernel<GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemMax);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int stages = ring_stages(G, lt);
  const int smem = Smem(G, lt, stages).total + 1024;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  attention_int8dot_kernel<GP><<<dim3(tiles, hkv, b), kThreads, smem, stream>>>(
      tkd, tks, tvd, tvs, (const uint16_t*)q, (const int*)q_off, (const int*)kv_len, (uint16_t*)out, (float*)ws,
      (int*)tickets, (int8_t*)q_codes, (uint8_t*)q_scales, G, hkv, L, lt, stages, sm_scale, fault);
  return cudaGetLastError();
}

}  // namespace

// q (b, hq, 1, d) bf16; codes (b, hkv, d, L) int8, scales (b, hkv, d/32, L),
// every cache pointer 16-byte aligned; hq / hkv from 1 to 8; lt (JAX's
// tile) 128, 256, 512, 1024 or 2048 and L % lt == 0.  tiles: the grid's
// tiles, L / lt or, where the caller knows every kv_len, ceil(min(max kv_len,
// L) / lt) (at least 1, at most 64).  ws: b * hkv * tiles * (hq / hkv) * (d +
// 2) floats where tiles > 1 (else unread); tickets: b * hkv ints, zero (the
// kernel leaves them zero).  q_codes, q_scales: null, or (b, hkv, hq / hkv,
// d) int8 and (b, hkv, hq / hkv, d / 32) uint8 for q's codes and scales.
// fault: 0 (bit 1: the combine drops the last live tile; bit 2: q's scale of
// chunk c taken from chunk c + 1; bit 4: query heads read at the padded
// instance's stride; bit 8: p's codes rounded down).
extern "C" int mx_cached_attention_int8dot_launch(const void* q, const void* kd, const void* ks, const void* vd,
                                                  const void* vs, const void* q_off, const void* kv_len, void* out,
                                                  void* ws, void* tickets, void* q_codes, void* q_scales, int b,
                                                  int hq, int hkv, int L, int d, int lt, int tiles, float sm_scale,
                                                  int fault, void* stream) {
  if (d != kD || hkv <= 0 || hq % hkv || L <= 0 || (lt != 128 && lt != 256 && lt != 512 && lt != 1024 && lt != 2048) ||
      L % lt || tiles < 1 || tiles > L / lt || tiles > kMaxTiles || hkv > 65535 || b > 65535 || fault < 0 || fault > 15 ||
      (q_codes == nullptr) != (q_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)kd | (uintptr_t)ks | (uintptr_t)vd | (uintptr_t)vs) % 16) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  if (tiles > 1 && (ws == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = hq / hkv;  // run in the instance of GP = 1, 2, 4 or 8 rows that holds it
  switch (G <= 2 ? G : G <= 4 ? 4 : G <= 8 ? 8 : 0) {
    case 1: return run<1>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, tickets, q_codes, q_scales, b, G, hkv, L, lt, tiles, sm_scale, fault, s);
    case 2: return run<2>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, tickets, q_codes, q_scales, b, G, hkv, L, lt, tiles, sm_scale, fault, s);
    case 4: return run<4>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, tickets, q_codes, q_scales, b, G, hkv, L, lt, tiles, sm_scale, fault, s);
    case 8: return run<8>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, tickets, q_codes, q_scales, b, G, hkv, L, lt, tiles, sm_scale, fault, s);
  }
  return (int)cudaErrorInvalidValue;
}
