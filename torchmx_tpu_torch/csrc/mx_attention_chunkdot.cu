// K5 mx_cached_attention_chunkdot: decode attention (one query position per
// batch row) of bf16 queries over an int8 MX KV cache in the seq layout, with
// the per-32-block scales factored out of the dots.
//
// Replaces torchmx_tpu/ops/pallas_attention.py::_attn_kernel_chunkdot (:307),
// launched by _mx_cached_attention_chunkdot (:401).
//
// Inputs: q (b, hq, 1, d) bf16; K/V codes (b, hkv, L, d) int8 and scales
// (b, hkv, L, d/32) uint8; q_off, kv_len (b,) int32 or one number each.
// Output (b, hq, 1, d) bf16.  For the G = hq / hkv query rows r of a KV head
// (query heads ih G .. ih G + G - 1 of KV head ih),
// the d/32 chunks c and position j, a scale being the float whose bits are
// e << 23 (0 gives +0.0, 255 +inf):
//   s[r,j]   = sm_scale * sum_c (q_c[r] . k_c[j]) * 2^(ek[j,c]-127)
//   j is visible when j <= q_off and j < kv_len; masked scores are -1e30
// with the codes bare in the dots (int8 -> bf16 is exact), each chunk's
// partial sum in fp32 and K's scale applied to it once.  JAX walks KV tiles
// of lt = _pick_lt(L) positions (256 at L = 256, 512 at 1024, 2048 at 8192;
// ops/cuda_attention.attention_tile) in order, so tile t's p is rounded against the
// running maximum through tile t:
//   m_t = max(m_{t-1}, max_j s), m_{-1} = -1e30;  p = exp(s - m_t), l_t = sum_j p
//   acc_t[r, c*32 + e] = sum_j bf16(p[r,j] * 2^(ev[j,c]-127)) * v[j, c*32 + e]
// and the tiles are combined in tile order: M = max_t m_t, out = (sum_t
// acc_t e^(m_t - M)) / (sum_t l_t e^(m_t - M)) (a sum of 0 taken as 1: a row
// with no visible key gives 0; a tile split into shares adds its shares'
// acc and l, each weighted so, in share order).  Every p is rounded against
// JAX's m_t, so the result differs from JAX's online form (and from the
// plain version, which is that form) in fp32 rounding only.  A hidden position is skipped, never
// multiplied by its scale: a stale scale of 255 past the prefix cannot turn
// into 0 * inf.
//
// What bounds it on an H100: the cache bytes of the visible prefix (264 per
// position and KV head), read once.  p of tile t needs the maxima of every
// earlier tile before its P.V product.  Design:
//  1. A thread-block cluster a (KV head, batch row), its C CTAs splitting the
//     cache into shares of P positions (ops/cuda_attention.k5_share, a
//     function of L alone, C = ceil(L / P) <= 8): a JAX tile is lt / P
//     shares, or, where the cache holds more than 8 tiles, a share is P / lt
//     whole consecutive tiles.  The grid is (C, hkv, b), cluster (C, 1, 1).
//     Each CTA computes its share's scores into shared memory and publishes
//     its maximum; after a cluster barrier it reads the maxima of the shares
//     of its tile and of every earlier tile over distributed shared memory
//     (m_t; a share of several tiles then walks its own tiles' maxima in
//     order, and rescales its acc and l by e^(m_{t-1} - m_t) from one tile to
//     the next, as JAX's online form does), then takes p, l and P.V.  A CTA
//     whose share starts past its row's visible prefix loads nothing and
//     publishes -1e30 and zeros; it stays for the cluster's barriers.
//     Where the prefix lies in the first share, rank 0 computes the row
//     alone (no barrier, no exchange: the same arithmetic) and the others
//     leave at once.  Where kv_len is a number the wrapper launches only the
//     shares below it.
//  2. The combine runs in the same launch: after a second cluster barrier
//     CTA k writes the elements k, k + C, ... of the (batch row, KV head)'s G
//     x d outputs from every share's (acc, m_t, l), in rank (tile) order; a
//     third barrier keeps every CTA's shared memory alive until the others
//     have read it.  No workspace, no atomics: a row's bytes depend on its
//     own q_off, kv_len and L only.
//  3. Copies: a producer warp issues TMA boxes of 128 positions x 128 code
//     bytes (one position a row, 128-byte swizzled), first the tile's K
//     boxes, then its V boxes, through a ring of two slots on full / empty
//     mbarriers (kStages: CTAs an SM count for more than slots); the
//     share's K and V scale rows (4 bytes a position) come
//     as one bulk copy each, on their own barrier.  Only the boxes of the
//     visible prefix are loaded.
//  4. Scores on the bf16 tensor cores (mma.sync m16n8k16, fp32 sums): warp w
//     takes positions 16 w .. 16 w + 15 of each K box as A (8-byte loads of
//     a position's codes, conflict-free under the swizzle), q's G rows as B,
//     held in registers; one accumulator a 32-element chunk (two k16 steps),
//     then K's scale, the chunks added in chunk order.  The codes become
//     bf16 by integer ops and one subtraction (int8_pairs_to_bf16), not by
//     I2F, which runs 16 a clock an SM.  A lane's four consecutive codes
//     enter the k16 step in the order d, d + 2, d + 1, d + 3; q's registers
//     hold its elements in that order.
//  5. Softmax over all 256 consumer threads in shared memory: p (replacing
//     s) and the share's l.
//  6. P.V on the bf16 tensor cores: warp w takes chunk w % 4 and every other
//     16 positions (w / 4 the parity) of each V box; A is bf16(p *
//     2^(ev[j,c]-127)) of the G rows (rows G .. 15 zero), B the V codes of 16
//     positions x 8 d from ldmatrix.x4.trans, four products a 16 positions
//     (d = 32c + 2n, + 1, + 16, + 17), fp32 sums over the tile; the two
//     warps of a chunk are added in that order.
//  7. Any GQA group G from 1 to 8: the row reductions split the 8 consumer
//     warps among GP rows, GP = G at 1, 2, 4 and 8, else the next of those
//     (4 for 3, 8 for 5, 6 and 7).  The GP - G dead rows are zero in q, never
//     enter a maximum, a sum or the cluster's exchange (their positions loop
//     is empty), and are never written; the shared memory and the exchange
//     are laid out for the G live rows.  The query heads are read and written
//     at stride G (the planted fault kFaultPadStride reads them at stride
//     GP).  The kernel is built for GP = 1, 2, 4 and 8 rows and takes the
//     live G at run time, as K7 does (csrc/mx_attention_int8dot.cu).
#include <type_traits>

#include "mx_common.cuh"
#include "mx_wgmma.cuh"

namespace {

constexpr int kD = 128;                    // head_dim
constexpr int kNc = kD / 32;               // chunks
constexpr int kBox = 128;                  // positions of a TMA box and of a ring slot
constexpr int kSlot = kBox * kD;           // bytes of a ring slot
// The ring's slots.  The per-box work is bound by latency (mma.sync, shared
// memory loads, the integer conversions), so CTAs an SM count for more than
// bytes in flight: two slots (and 56 registers a thread) let four CTAs share
// an SM at shares of 512 positions, three at 1024 (tools/phase_profile.py
// --kernel k5, b=4 L=8192: 0.050 ms at two slots, 0.066 at four).
constexpr int kStages = 2;
constexpr int kWarps = 8;                  // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxCluster = 8;             // shares of a cache at most (CTAs a cluster)
constexpr int kMaxShare = 4096;            // positions of a share at most (its scores fit shared memory)
constexpr int kSmemMax = 232448;           // dynamic shared memory a CTA may take on an H100
constexpr float kNegInf = -1e30f;
constexpr int kFaultOwnMax = 1;    // planted fault: p rounded against its tile's own maximum
constexpr int kFaultDropLast = 2;  // planted fault: a row's last live tile left out
constexpr int kFaultPadStride = 4;  // planted fault: query heads read at the padded instance's stride GP

// Byte offsets of the dynamic shared memory for G query rows, shares of P
// positions padded to whole boxes (lp) holding kt tiles (1 where a share is
// a part of a tile) and the ring's kStages slots, from a 1024-byte aligned
// base (the swizzled slots need it).
struct Smem {
  int ks, vs, s, rec, stat, bar, total;
  __host__ __device__ Smem(int G, int lp, int kt) {
    ks = kStages * kSlot;             // K scale rows: [position][chunk]
    vs = ks + 4 * lp;                 // V scale rows, the same
    s = vs + 4 * lp;                  // s, then p: fp32 [row][lp + 4]
    rec = s + 4 * G * (lp + 4);       // acc: fp32 [row][d] (read by the cluster)
    // share max[G], m[G], l[G] (read by the cluster); m_t[kt][G],
    // alpha[kt][G], w[kt][G] of the share's own tiles; red[kWarps][G]
    stat = rec + 4 * G * kD;
    bar = (stat + 4 * (3 + 3 * kt + kWarps) * G + 7) & ~7;  // full[kStages], empty[kStages], scales
    total = bar + (2 * kStages + 1) * 8;
  }
};

// D += A (16x16 bf16, row) * B (16x8 bf16, col), fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (a & b) | c in one instruction (the compiler splits it in two where b and c
// are both constants).
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Bytes 0 and 2 of w (int8 codes) as a bf16 pair, byte 0 in the low half,
// exactly: (128 + (c & 127)) - (128 or 256 as c's sign bit says), both
// operands built by one integer op each, the difference exact in bf16.
__device__ __forceinline__ uint32_t int8_pairs_to_bf16(uint32_t w) {
  const uint32_t lo = and_or(w, 0x007F007Fu, 0x43004300u), sg = and_or(w, 0x00800080u, 0x43004300u);
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo), *reinterpret_cast<const __nv_bfloat162*>(&sg));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float byte_scale(uint32_t w, int k) { return mx::pow2_scale((w >> (8 * k)) & 0xFF); }

// The sum of v over the kConsumers / GP threads of a query row (a warp, or
// several through shared memory red[kWarps]); every consumer thread calls it.
template <int GP>
__device__ __forceinline__ float row_sum(float v, float* red, int warp, int lane) {
  v = mx::warp_sum(v);
  constexpr int kRowWarps = kWarps / GP;
  if constexpr (kRowWarps > 1) {
    if (lane == 0) red[warp] = v;
    mx::named_barrier(1, kConsumers);
    const int w0 = warp / kRowWarps * kRowWarps;
    v = red[w0];
#pragma unroll
    for (int i = 1; i < kRowWarps; ++i) v += red[w0 + i];
    mx::named_barrier(1, kConsumers);
  }
  return v;
}

// Grid (C shares, hkv, b), cluster (C, 1, 1), kThreads threads: warps 0 .. 7
// compute, warp 8 issues the copies.  q_off / kv_len: (b,) or null and the
// numbers q_off_n / kv_len_n for every row.  lt: the tile, P: the share (lt
// % P == 0, or P % lt == 0: P / lt tiles), lp: P padded to whole boxes.
// G: the group (live rows, G <= GP).
template <int GP>
__global__ void __launch_bounds__(kThreads, 4)  // four CTAs an SM: the loops are bound by latency
chunkdot_kernel(const __grid_constant__ CUtensorMap tkd, const __grid_constant__ CUtensorMap tvd,
                const uint16_t* __restrict__ q, const uint8_t* __restrict__ ks, const uint8_t* __restrict__ vs,
                const int* __restrict__ q_off_p, const int* __restrict__ kv_len_p, int q_off_n, int kv_len_n,
                uint16_t* __restrict__ out, int G, int hkv, int L, int lt, int P, int lp, float sm_scale,
                int fault) {
  const int rank = blockIdx.x, C = gridDim.x, ih = blockIdx.y, ib = blockIdx.z;
  const int kvh = ib * hkv + ih, hq = hkv * G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int ldS = lp + 4;  // floats of a row of s (rows 2t and 2t + 1 on other banks)

  // q as the scores' B fragments, fetched while the row's positions are
  // read: lane (g, t) holds row g's elements 32c + 8t .. 8t + 7, in k order
  // {0, 2}, {1, 3} of each k16 step (rows past G zero).  The planted fault
  // reads head ih GP + g (within the batch row).
  const int qhead = (fault & kFaultPadStride) ? (ih * GP + g) % hq : ih * G + g;
  uint32_t qb[kNc][2][2];
#pragma unroll
  for (int c = 0; c < kNc; ++c) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (warp < kWarps && g < G) v = *reinterpret_cast<const uint4*>(q + ((long long)ib * hq + qhead) * kD + 32 * c + 8 * t);
    qb[c][0][0] = __byte_perm(v.x, v.y, 0x5410);
    qb[c][0][1] = __byte_perm(v.x, v.y, 0x7632);
    qb[c][1][0] = __byte_perm(v.z, v.w, 0x5410);
    qb[c][1][1] = __byte_perm(v.z, v.w, 0x7632);
  }
  if (tid == kConsumers)
    for (const CUtensorMap* m : {&tkd, &tvd})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
  const int kv_end = max(min(min(kv_len_p ? kv_len_p[ib] : kv_len_n, (q_off_p ? q_off_p[ib] : q_off_n) + 1), L), 0);
  const int n_live = kv_end > 0 ? (kv_end + lt - 1) / lt : 1;  // the row's tiles with a visible position
  // S shares a tile, kt tiles a share (one of them 1); tile: this share's
  // tile, or this share where it holds several.
  const int S = lt > P ? lt / P : 1, kt = P > lt ? P / lt : 1, tile = rank / S;
  const int t0 = rank * P;
  const int nvis = min(max(kv_end - t0, 0), P);   // visible positions of the share
  // A row whose visible prefix lies in its first share needs no exchange:
  // rank 0 computes it alone (the same arithmetic, bit for bit), the others
  // leave at once and no CTA of the cluster waits on a cluster barrier.
  const int live = max((kv_end + P - 1) / P, 1);  // shares with a visible position (rank 0 at least)
  if (live == 1 && rank > 0) return;
  const bool alone = live == 1;
  const int n_box = (nvis + kBox - 1) / kBox;     // boxes of K (and of V) to load

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = mx::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = mx::smem_addr(smem);
  const Smem lay(G, lp, kt);
  const uint32_t full = sbase + lay.bar, empty = full + 8 * kStages, scales = full + 16 * kStages;
  float* smax = reinterpret_cast<float*>(smem + lay.stat);  // [G]: the share's maximum
  float* msh = smax + G;                                    // [G]: m_t of the share's last live tile
  float* lsh = msh + G;                                     // [G]: the share's l, against msh
  float* mt = lsh + G;                                      // [kt][G]: the share's tiles' maxima, then m_t
  float* alpha = mt + kt * G;                               // [kt][G]: e^(m_{t-1} - m_t)
  float* wl = alpha + kt * G;                               // [kt][G]: e^(m_t - msh)
  float* red = wl + kt * G;                                 // [kWarps][G]
  float* rec = reinterpret_cast<float*>(smem + lay.rec);    // [G][d]: acc_t
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mx::mbar_init(full + 8 * s, 1);
      mx::mbar_init(empty + 8 * s, kWarps);
    }
    mx::mbar_init(scales, 1);
    mx::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer: fill f is K box f (f < n_box), then V box f - n_box
    if (!alone) mx::cluster_arrive();  // 1: it publishes nothing, and must not hold the maxima back
    if (lane == 0 && n_box > 0) {
      const long long row0 = (long long)kvh * L + t0;
      const uint32_t sbytes = (4 * nvis + 15) & ~15;
      mx::mbar_expect_tx(scales, 2 * sbytes);
      mx::bulk_load(sbase + lay.ks, ks + 4 * row0, sbytes, scales);
      mx::bulk_load(sbase + lay.vs, vs + 4 * row0, sbytes, scales);
      for (int f = 0; f < 2 * n_box; ++f) {
        const int slot = f % kStages;
        if (f >= kStages) mx::mbar_wait(empty + 8 * slot, (f / kStages - 1) & 1);
        mx::mbar_expect_tx(full + 8 * slot, kSlot);
        mx::tma_load_2d(sbase + slot * kSlot, f < n_box ? &tkd : &tvd, full + 8 * slot, 0,
                        (int)(row0 + (f % n_box) * kBox));
      }
    }
    __syncwarp();
    if (!alone) {
      mx::cluster_wait();
      mx::cluster_sync();  // 2
      mx::cluster_sync();  // 3
    }
    return;
  }

  float* sb = reinterpret_cast<float*>(smem + lay.s);
  const uint8_t* ksc = smem + lay.ks;
  const uint8_t* vsc = smem + lay.vs;

  // 1. Scores: warp w, positions 16 w .. 16 w + 15 of each K box; lane (g, t)
  // loads codes 32c + 8t .. 8t + 7 of positions g and g + 8 and keeps the
  // running maximum of rows 2t, 2t + 1.
  if (n_box > 0) mx::mbar_wait(scales, 0);
  float tm[2] = {kNegInf, kNegInf};
  for (int f = 0; f < n_box; ++f) {
    const int slot = f % kStages;
    mx::mbar_wait(full + 8 * slot, (f / kStages) & 1);
    const int p0 = f * kBox + 16 * warp;  // the warp's first position in the tile
    if (p0 < nvis) {
      const uint8_t* kt = smem + slot * kSlot;
      const int r0 = 16 * warp + g, r1 = r0 + 8;  // rows of the box
      float dc[kNc][4] = {};
#pragma unroll
      for (int c = 0; c < kNc; ++c) {
        const int u = 2 * c + (t >> 1), o = 8 * (t & 1);
        const uint2 w0 = *reinterpret_cast<const uint2*>(kt + r0 * 128 + ((u ^ (r0 & 7)) << 4) + o);
        const uint2 w1 = *reinterpret_cast<const uint2*>(kt + r1 * 128 + ((u ^ (r1 & 7)) << 4) + o);
        const uint32_t a0[4] = {int8_pairs_to_bf16(w0.x), int8_pairs_to_bf16(w1.x), int8_pairs_to_bf16(w0.x >> 8),
                                int8_pairs_to_bf16(w1.x >> 8)};
        mma_bf16(dc[c], a0, qb[c][0]);
        const uint32_t a1[4] = {int8_pairs_to_bf16(w0.y), int8_pairs_to_bf16(w1.y), int8_pairs_to_bf16(w0.y >> 8),
                                int8_pairs_to_bf16(w1.y >> 8)};
        mma_bf16(dc[c], a1, qb[c][1]);
      }
      // dc[c][e]: position p0 + g (e < 2) or p0 + g + 8, query row 2t + (e & 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = p0 + g + 8 * (e >> 1), r = 2 * t + (e & 1);
        const uint32_t sw = *reinterpret_cast<const uint32_t*>(ksc + 4 * pos);
        float s = __fmul_rn(dc[0][e], byte_scale(sw, 0));
#pragma unroll
        for (int c = 1; c < kNc; ++c) s = __fadd_rn(s, __fmul_rn(dc[c][e], byte_scale(sw, c)));
        s = pos < nvis ? __fmul_rn(s, sm_scale) : kNegInf;
        if (r < G) {
          sb[r * ldS + pos] = s;
          tm[e & 1] = fmaxf(tm[e & 1], s);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mx::mbar_arrive(empty + 8 * slot);
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], o));
  if (g == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (2 * t + i < G) red[warp * G + 2 * t + i] = tm[i];
  mx::named_barrier(1, kConsumers);
  if (tid < G) {
    float m = red[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w * G + tid]);
    smax[tid] = m;
  }
  if (kt > 1) {  // each of the share's tiles' maxima, a warp a (tile, row)
    const int end = (nvis + 15) & ~15;  // the scores written (-1e30 past nvis)
    for (int i = warp; i < kt * G; i += kWarps) {
      const float* row = sb + (i % G) * ldS;
      const int lo = i / G * lt, hi = min(lo + lt, end);
      float m = kNegInf;
      for (int j = lo + 4 * lane; j < hi; j += 128) {
        const float4 v = *reinterpret_cast<const float4*>(row + j);
        m = fmaxf(fmaxf(m, fmaxf(v.x, v.y)), fmaxf(v.z, v.w));
      }
      m = mx::warp_max(m);
      if (lane == 0) mt[i] = m;
    }
  }
  if (alone)
    mx::named_barrier(1, kConsumers);
  else
    mx::cluster_sync();  // 1: the shares' maxima

  // 2. m_t: the running maximum through this share's tile, the maxima of the
  // other shares of this tile and of every earlier one read from their
  // shared memory (the planted fault: this tile's own).  A share of several
  // tiles walks its own tiles' maxima in order from there: m_t of each,
  // alpha (acc and l rescaled from one tile to the next) and w (tile t's l
  // against the last live tile's m_t, which the share publishes).
  if (tid < G) {
    const bool own = fault & kFaultOwnMax;
    float base = kNegInf;
    for (int u = 0; u < live; ++u)  // the shares past the prefix are left out
      if (u != rank && (own ? u / S == tile : u / S <= tile))
        base = fmaxf(base, mx::ld_cluster_f32(mx::cluster_addr(sbase + lay.stat + 4 * tid, u)));
    if (kt == 1) {
      msh[tid] = fmaxf(base, smax[tid]);
    } else {
      float m = base;
      for (int i = 0; i < kt; ++i) {
        const float x = fmaxf(own ? base : m, mt[i * G + tid]);
        alpha[i * G + tid] = expf(m - x);
        mt[i * G + tid] = m = x;
      }
      m = mt[(nvis > 0 ? (nvis - 1) / lt : 0) * G + tid];
      msh[tid] = m;
      for (int i = 0; i < kt; ++i) wl[i * G + tid] = expf(mt[i * G + tid] - m);
    }
  }
  mx::named_barrier(1, kConsumers);

  // 3. p and l: the kConsumers / GP threads of row r take its positions
  // four at a time (in one tile); a dead row (r >= G) takes none.  The
  // planted fault leaves out a row's last live tile: p is 0 from its first
  // position on.
  {
    constexpr int kRowThreads = kConsumers / GP;
    const int r = tid / kRowThreads, k = tid % kRowThreads;
    const int row_end = r < G ? n_box * kBox : 0;
    const int e = (fault & kFaultDropLast) && n_live > 1 ? min(nvis, max((n_live - 1) * lt - t0, 0)) : nvis;
    float m = msh[r], w = 1.f;
    float* row = sb + r * ldS;
    float l = 0.f;
    for (int j = 4 * k; j < row_end; j += 4 * kRowThreads) {
      if (kt > 1) {
        const int i = j / lt;
        m = mt[i * G + r];
        w = wl[i * G + r];
      }
      const float4 v = *reinterpret_cast<const float4*>(row + j);
      const float pv[4] = {j < e ? expf(v.x - m) : 0.f, j + 1 < e ? expf(v.y - m) : 0.f,
                           j + 2 < e ? expf(v.z - m) : 0.f, j + 3 < e ? expf(v.w - m) : 0.f};
      l += ((pv[0] + pv[1]) + (pv[2] + pv[3])) * w;
      *reinterpret_cast<float4*>(row + j) = make_float4(pv[0], pv[1], pv[2], pv[3]);
    }
    l = row_sum<GP>(l, red, warp, lane);
    if (k == 0 && r < G) lsh[r] = l;
  }
  mx::named_barrier(1, kConsumers);

  // 4. P.V: warp w, chunk c = w % 4, the 16-position blocks h, h + 2, ... (h
  // = w / 4) of each V box.  acc[k]: lane (g, t)'s d0, d1 (row g; rows g + 8
  // of A are zero) of the product whose column n is d = 32c + 2n (k = 0),
  // 2n + 1 (1), 16 + 2n (2), 17 + 2n (3).
  const int c = warp % 4, h = warp / 4;
  float acc[4][4] = {};
  // Block i of the box at vt (its first position pos0 in the share); with
  // kCheck the positions from nvis on are zero in A.
  auto pv_block = [&](uint32_t vt, int pos0, int blk, auto check) {
    constexpr bool kCheck = decltype(check)::value;
    uint32_t a[4] = {0u, 0u, 0u, 0u};
    if (g < G) {
      const int j0 = pos0 + 2 * t;  // A's k = 2t, 2t + 1, 2t + 8, 2t + 9: positions j0, j0 + 1, j0 + 8, j0 + 9
      const float2 plo = *reinterpret_cast<const float2*>(sb + g * ldS + j0);
      const float2 phi = *reinterpret_cast<const float2*>(sb + g * ldS + j0 + 8);
      const uint2 slo = *reinterpret_cast<const uint2*>(vsc + 4 * j0);
      const uint2 shi = *reinterpret_cast<const uint2*>(vsc + 4 * (j0 + 8));
      float p3[4] = {__fmul_rn(plo.x, byte_scale(slo.x, c)), __fmul_rn(plo.y, byte_scale(slo.y, c)),
                     __fmul_rn(phi.x, byte_scale(shi.x, c)), __fmul_rn(phi.y, byte_scale(shi.y, c))};
      if constexpr (kCheck) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + (e & 1) + 8 * (e >> 1) >= nvis) p3[e] = 0.f;  // hidden: never its scale
      }
      a[0] = pack_bf16(p3[0], p3[1]);
      a[2] = pack_bf16(p3[2], p3[3]);
    }
    const int mat = lane >> 3, prow = 16 * blk + (lane & 7) + 8 * (mat & 1);
    uint32_t v[4];
    mx::ldmatrix_x4_trans(v, vt + mx::sw128(prow, 2 * c + (mat >> 1)));
    const uint32_t b0[2] = {int8_pairs_to_bf16(v[0]), int8_pairs_to_bf16(v[1])};
    const uint32_t b1[2] = {int8_pairs_to_bf16(v[0] >> 8), int8_pairs_to_bf16(v[1] >> 8)};
    const uint32_t b2[2] = {int8_pairs_to_bf16(v[2]), int8_pairs_to_bf16(v[3])};
    const uint32_t b3[2] = {int8_pairs_to_bf16(v[2] >> 8), int8_pairs_to_bf16(v[3] >> 8)};
    mma_bf16(acc[0], a, b0);
    mma_bf16(acc[1], a, b1);
    mma_bf16(acc[2], a, b2);
    mma_bf16(acc[3], a, b3);
  };
  for (int bx = 0; bx < n_box; ++bx) {
    const int f = n_box + bx, slot = f % kStages;
    if (kt > 1 && bx > 0 && bx * kBox % lt == 0) {  // the next of the share's tiles: acc against its m_t
      const float a = g < G ? alpha[bx * kBox / lt * G + g] : 1.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][e] = __fmul_rn(acc[k][e], a);
    }
    mx::mbar_wait(full + 8 * slot, (f / kStages) & 1);
    const uint32_t vt = sbase + slot * kSlot;
    if (bx * kBox + kBox <= nvis) {  // a whole box: no position hidden
#pragma unroll
      for (int i = 0; i < kBox / 32; ++i) pv_block(vt, bx * kBox + 16 * (2 * i + h), 2 * i + h, std::false_type());
    } else {
      for (int i = 0; i < kBox / 32; ++i) {
        const int pos0 = bx * kBox + 16 * (2 * i + h);
        if (pos0 >= nvis) break;
        pv_block(vt, pos0, 2 * i + h, std::true_type());
      }
    }
    __syncwarp();
    if (lane == 0) mx::mbar_arrive(empty + 8 * slot);
  }
  // Row g, d = 32c + 4t .. + 3 and 32c + 16 + 4t .. + 3: the warps of parity
  // 1 leave theirs in rec, those of parity 0 add them to their own.
  float4* r0 = reinterpret_cast<float4*>(rec + g * kD + 32 * c + 4 * t);
  const float4 lo = make_float4(acc[0][0], acc[1][0], acc[0][1], acc[1][1]);
  const float4 hi = make_float4(acc[2][0], acc[3][0], acc[2][1], acc[3][1]);
  if (h == 1 && g < G) {
    r0[0] = lo;
    r0[4] = hi;
  }
  mx::named_barrier(1, kConsumers);
  if (h == 0 && g < G) {
    const float4 x = r0[0], y = r0[4];
    r0[0] = make_float4(__fadd_rn(lo.x, x.x), __fadd_rn(lo.y, x.y), __fadd_rn(lo.z, x.z), __fadd_rn(lo.w, x.w));
    r0[4] = make_float4(__fadd_rn(hi.x, y.x), __fadd_rn(hi.y, y.y), __fadd_rn(hi.z, y.z), __fadd_rn(hi.w, y.w));
  }
  if (alone)
    mx::named_barrier(1, kConsumers);
  else
    mx::cluster_sync();  // 2: every share's (acc, m_t, l)

  // 5. The combine: each live share's m_t and l of the G rows read once into
  // this CTA's own memory (red, and sb's first floats: p is spent), a row's
  // M = the largest m_t, the weights e^(m_t - M) and l = sum of l e^(m_t -
  // M) in rank order; then this CTA's elements rank, rank + C, ... of the G
  // x d outputs (all of them where it is alone), acc weighted and added in
  // rank order.  The shares past the prefix hold zeros and are left out.
  float* wgt = red;  // [share][row]: m_t, then the weight
  float* ls = sb;    // [share][row]: l; then [kMaxCluster * G + row]: the row's divisor
  if (tid < live * G) {
    const int u = tid / G, r = tid % G;
    wgt[tid] = mx::ld_cluster_f32(mx::cluster_addr(sbase + lay.stat + 4 * (G + r), u));
    ls[tid] = mx::ld_cluster_f32(mx::cluster_addr(sbase + lay.stat + 4 * (2 * G + r), u));
  }
  mx::named_barrier(1, kConsumers);
  if (tid < G) {
    float M = kNegInf, l = 0.f;
    for (int u = 0; u < live; ++u) M = fmaxf(M, wgt[u * G + tid]);
    for (int u = 0; u < live; ++u) {
      const float w = expf(wgt[u * G + tid] - M);
      wgt[u * G + tid] = w;
      l = __fadd_rn(l, __fmul_rn(ls[u * G + tid], w));
    }
    ls[kMaxCluster * G + tid] = l == 0.f ? 1.f : l;
  }
  mx::named_barrier(1, kConsumers);
  const int writers = alone ? 1 : C;
  for (int i = rank + writers * tid; i < G * kD; i += writers * kConsumers) {
    const int r = i / kD, e = i % kD;
    float a = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxCluster; ++u)
      if (u < live)
        a = __fadd_rn(a, __fmul_rn(mx::ld_cluster_f32(mx::cluster_addr(sbase + lay.rec + 4 * i, u)), wgt[u * G + r]));
    out[((long long)ib * hq + ih * G + r) * kD + e] = __bfloat16_as_ushort(__float2bfloat16_rn(__fdiv_rn(a, ls[kMaxCluster * G + r])));
  }
  if (!alone) mx::cluster_sync();  // 3: no CTA leaves while another reads its shared memory
}


template <int GP>
cudaError_t run(const void* q, const void* kd, const void* ks, const void* vd, const void* vs, const void* q_off,
                const void* kv_len, int q_off_n, int kv_len_n, void* out, int b, int G, int hkv, int L, int lt,
                int P, int ctas, float sm_scale, int fault, cudaStream_t stream) {
  const uint64_t rows = (uint64_t)b * hkv * L;
  CUtensorMap tkd, tvd;
  // Boxes of 128 positions x 128 code bytes, 128-byte swizzled; rows past
  // the buffer come as zeros (a box may pass a head's last position only
  // where L % 128 != 0, and those positions are hidden).
  if (!mx::cached_byte_map(&tkd, kd, rows, kD, kD, kBox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !mx::cached_byte_map(&tvd, vd, rows, kD, kD, kBox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(chunkdot_kernel<GP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int lp = (P + kBox - 1) / kBox * kBox;
  const int smem = Smem(G, lp, P > lt ? P / lt : 1).total + 1024;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, hkv, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, chunkdot_kernel<GP>, tkd, tvd, (const uint16_t*)q, (const uint8_t*)ks,
                                       (const uint8_t*)vs, (const int*)q_off, (const int*)kv_len, q_off_n, kv_len_n,
                                       (uint16_t*)out, G, hkv, L, lt, P, lp, sm_scale, fault);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// q (b, hq, 1, d) bf16; codes (b, hkv, L, d) int8, scales (b, hkv, L, d/32),
// every cache pointer 16-byte aligned, L % 4 == 0, b hkv L < 2^31; q_off,
// kv_len: (b,) int32, or null and the number q_off_n / kv_len_n for every
// row; hq / hkv from 1 to 8; lt (the tile) with L % lt == 0, P (the
// share) at most 4096 with lt % P == 0 or P % lt == 0 and ceil(L / P) <= 8.
// ctas: the grid's shares, ceil(L / P) or, where the caller knows every
// kv_len, ceil(min(max kv_len, L) / P) (at least 1).  fault: 0 (bit 1: p
// rounded against its tile's own maximum; bit 2: a row's last live tile left
// out; bit 4: query heads read at the padded instance's stride).
extern "C" int mx_cached_attention_chunkdot_launch(const void* q, const void* kd, const void* ks, const void* vd,
                                                   const void* vs, const void* q_off, const void* kv_len,
                                                   int q_off_n, int kv_len_n, void* out, int b, int hq, int hkv,
                                                   int L, int d, int lt, int P, int ctas, float sm_scale, int fault,
                                                   void* stream) {
  if (d != kD || hkv <= 0 || hq % hkv || L <= 0 || L % 4 || lt <= 0 || L % lt || P <= 0 || P % 4 ||
      (lt % P && (P % lt || lt % kBox)) || P > kMaxShare || (L + P - 1) / P > kMaxCluster || ctas < 1 ||
      ctas > (L + P - 1) / P || hkv > 65535 || b > 65535 ||
      (long long)b * hkv * L >= (1ll << 31) || fault < 0 || fault > 7 || (q_off == nullptr) != (kv_len == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)kd | (uintptr_t)ks | (uintptr_t)vd | (uintptr_t)vs | (uintptr_t)q) % 16) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = hq / hkv;  // run in the instance of GP = 1, 2, 4 or 8 rows that holds it
  switch (G <= 2 ? G : G <= 4 ? 4 : G <= 8 ? 8 : 0) {
    case 1: return run<1>(q, kd, ks, vd, vs, q_off, kv_len, q_off_n, kv_len_n, out, b, G, hkv, L, lt, P, ctas, sm_scale, fault, s);
    case 2: return run<2>(q, kd, ks, vd, vs, q_off, kv_len, q_off_n, kv_len_n, out, b, G, hkv, L, lt, P, ctas, sm_scale, fault, s);
    case 4: return run<4>(q, kd, ks, vd, vs, q_off, kv_len, q_off_n, kv_len_n, out, b, G, hkv, L, lt, P, ctas, sm_scale, fault, s);
    case 8: return run<8>(q, kd, ks, vd, vs, q_off, kv_len, q_off_n, kv_len_n, out, b, G, hkv, L, lt, P, ctas, sm_scale, fault, s);
  }
  return (int)cudaErrorInvalidValue;
}
