// B14 mx_mla_attention_int8dot: absorbed MLA decode (one query position per
// batch row) over an int8 latent cache in the d-major layout, both dots in
// int8: q quantized to int8 with one scale a row, p requantized to 8 bits.
//
// Replaces torchmx_tpu/ops/pallas_mla.py::_mla_kernel_int8dot (:343),
// launched by _mla_cached_attention_int8dot (:460), together with its
// wrapper's quantization of q (_mla_int8dot_attention, :513-540): each CTA
// quantizes its rows of q in its prologue with mx_quantize_rows' device
// functions (mx::quantize_row), the same codes and scales bit for bit.
//
// Inputs: q_lat (b, n, 512) and q_rot (b, n, 64) bf16; the latent (b, 512,
// L) and rope key (b, 64, L) int8 codes, the sequence on the last axis, with
// per-position E8M0 scales (b, 1, L) uint8 (one exponent over a position's
// whole latent, and one over its rope key); q_off, kv_len (b,) int32.
// Output (b, n, 512) bf16.  With ql, qr the int8 rows of q, qlsc, qrsc their
// f32 scales times sm_scale, pk(e) the float whose bits are e << 23 (0 gives
// +0.0, 255 +inf), for head r and position j:
//   s[r,j] = (dot(ql[r], lat[:,j]) * qlsc[r]) * pk(el[j])
//          + (dot(qr[r], rot[:,j]) * qrsc[r]) * pk(er[j])      exact int32 dots
//   j is visible when j <= q_off and j < kv_len;
// and per KV tile of lt = _pick_lt(L) positions (JAX's tile: 256 at L =
// 256, 512 at L = 1024, 2048 at L = 8192; ops/cuda_attention._pick_lt), over
// the visible j of the tile:
//   m_t = max_j s, p = exp(s - m_t), l_t = sum_j p
//   p3 = p * pk(el[j]),  mx_t = max_j p3 (1 where 0)
//   pq = round_half_even(p3 * (127 / mx_t)) as int8
//   acc_t = (pq . lat^T, exact int32) * (mx_t * (1/127))
// and the tiles are combined in tile order: M = max_t m_t, out = (sum_t
// acc_t e^(m_t - M)) / (sum_t l_t e^(m_t - M)) (a sum of 0 taken as 1: a row
// with no visible key gives 0).  pq does not depend on the maximum p was
// taken against (p3 and mx_t scale together), so against JAX's online form
// (and the plain version, which is that form) the result differs only in
// fp32 rounding and in rare ties of pq.  A hidden position is skipped, never
// multiplied by its scale: a stale scale of 255 past the prefix cannot turn
// into 0 * inf (JAX's kernel multiplies, :439).
//
// What bounds it on an H100: the cache bytes of the visible prefix (578 per
// position: 576 codes and two scales), read once.  The integer work is 2 x
// 576 x n multiply-adds a position, on the int8 tensor cores.  K and V are
// the same latent, and a JAX tile of it (lt x 578 bytes: 296 KB at lt = 512,
// 1.18 MB at 2048) does not fit one SM, while pq needs the whole tile's mx_t
// before any P.V product.  Design:
//  1. A thread-block cluster a (JAX tile, head group, batch row): the grid
//     is (C x tiles, head groups, b), cluster (C, 1, 1).  The tile's
//     positions are split across the C CTAs, P = 128 a CTA at lt <= 512 and
//     256 above (C = lt / P: 2 at L = 256, 4 at 1024, 8 at 8192; a function of
//     L alone).  Each CTA loads its share (latent, rope key, the two scale
//     rows) once and keeps it in shared memory for both products.  A head
//     group is all n heads where n <= 32 (the latent read once), else 32.  A
//     cluster whose tile starts past its row's visible prefix exits at once
//     (where kv_len is a number the wrapper launches only the tiles below
//     it); a CTA whose share starts past it loads nothing and contributes
//     -inf and zeros.
//  2. Copies: thread 0 issues TMA boxes of 128 positions x 256 (latent) or 64
//     (rope) code rows, 128-byte swizzled, and two 128-byte bulk copies of
//     the scales, a barrier for each 128 positions, only for the visible
//     prefix; q is quantized while they land.
//  3. Scores on the int8 tensor cores (mma.sync m16n8k32, s = q . lat):
//     warp w takes 32 positions of the share, all 576 dims.  The latent's d
//     is strided, so B comes from word loads of four code rows turned by a 4x4
//     byte transpose (mx::transpose_4x4_bytes); the dims enter a k-block of
//     32 in the order 8i + 2t (+1), so that the word loads hit 32 banks; q's
//     codes are stored in that order.  Exact int32 sums, then the scales.
//  4. Softmax and requantization in shared memory, 256 / n_group threads a
//     row, with the cluster's statistics exchanged over distributed shared
//     memory: the per-row maximum of s; then l_t (summed in CTA-rank order)
//     and mx_t.
//  5. P.V on the int8 tensor cores as out^T = lat . pq^T: the latent share as
//     it lies is A (ldmatrix.x4 of 16 dims x 32 positions), pq^T is B; warp w
//     owns dims 64 w .. 64 w + 63, exact int32 over the share.  The cluster
//     reduces the int32 partials (exact in any order) so that CTA k owns
//     dims k 512 / C .. (k + 1) 512 / C - 1.
//  6. The combine runs in the same launch: a row with one live tile writes
//     acc_t / l_t; else each CTA writes its slice of (acc_t, m_t, l_t) to a
//     workspace (ops/split_kv, shared with B13 and K7) and the last CTA of
//     the (batch row, head group, slice) (an atomic ticket, which it resets)
//     combines the tiles in tile order.  So a row's bytes depend on its own
//     q_off, kv_len and L only.
#include "mx_common.cuh"
#include "mx_wgmma.cuh"

namespace {

constexpr int kR = 512;                // latent rank
constexpr int kDr = 64;                // rope key width
constexpr int kBox = 128;              // positions of a TMA box and of a load group
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQRow = kR + kDr + 16;   // bytes of a row of q's codes in shared memory (conflict-free A loads)
constexpr int kMaxTiles = 64;          // tiles of a cache at most
constexpr int kMaxCluster = 8;         // CTAs a cluster at most (lt / P)
constexpr int kSmemMax = 232448;       // dynamic shared memory a CTA may take on an H100
constexpr float kNegInf = -1e30f;
constexpr int kFaultDropLast = 1;      // planted fault: the combine drops the last live tile
constexpr int kGroupBytes = 2 * 32768 + 8192 + 2 * kBox;  // a load group: latent, rope key, two scale rows

// Byte offsets of the dynamic shared memory for NR rows (heads) and P
// positions a CTA, from a 1024-byte aligned base (the swizzled boxes need it).
template <int NR, int P>
struct Smem {
  static constexpr int kGroups = P / kBox;
  static constexpr int kSRow = P + kThreads / NR;  // floats of a row of s (a row's threads on 32 banks)
  static constexpr int kPqRow = P + 16;            // bytes of a row of pq
  static constexpr int lat = 0;                             // [group][512 rows][128 B], swizzled
  static constexpr int rot = lat + kGroups * kR * kBox;     // [group][64 rows][128 B], swizzled
  static constexpr int scl = rot + kGroups * kDr * kBox;    // [group][latent 128 B, rope 128 B]
  static constexpr int q = scl + kGroups * 2 * kBox;        // q's codes [row][kQRow], dims permuted
  static constexpr int qsc = q + NR * kQRow;                // q's f32 scales: latent [NR], rope [NR]
  static constexpr int s = qsc + 8 * NR;                    // s, then p3: f32 [row][kSRow]
  static constexpr int pq = s + 4 * NR * kSRow;             // pq: int8 [row][kPqRow]
  static constexpr int stat = pq + NR * kPqRow;             // f32 [6][NR]: m_c, l_c, mx_c (read by the
                                                            // cluster); M_t, l_t, mx_t / 127 (own)
  static constexpr int bar = stat + 6 * 4 * NR;             // kGroups mbarriers
  static constexpr int last = bar + 8 * kGroups;
  static constexpr int total = last + 16;
  // The int32 P.V partials [512 dims][NR + 4] overlay the latent and rope key once P.V is done.
  static constexpr int kPvRow = NR + 4;
  static_assert(kR * kPvRow * 4 <= rot + kGroups * kDr * kBox, "P.V partials fit over the share");
  static_assert(q % 16 == 0 && s % 16 == 0 && pq % 16 == 0 && stat % 16 == 0, "aligned regions");
};

// D += A (16x32 s8, row) * B (32x8 s8, col), exact int32.
__device__ __forceinline__ void mma_s8_acc(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four int32 from another CTA's shared memory (an address from mx::cluster_addr).
__device__ __forceinline__ int4 ld_cluster_v4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The word of four positions p .. p + 3 (p % 4 == 0) of code row d in a
// 128-byte swizzled box (16-byte chunk c of row d at chunk c ^ (d % 8)).
__device__ __forceinline__ uint32_t box_word(const uint8_t* box, int d, int p) {
  return *reinterpret_cast<const uint32_t*>(box + d * kBox + ((((p >> 4) ^ (d & 7))) << 4) + (p & 15));
}

// Where dim e (0..31) of a k-block enters the mma's k: the k-block's even dims
// 8i + 2t at k = 4t + i (b0), its odd dims at 16 + 4t + i (b1).
__device__ __forceinline__ int k_of_dim(int e) { return 16 * (e & 1) + 4 * ((e >> 1) & 3) + (e >> 3); }

// One k-block of 32 dims of the scores into acc (m16n8k32, exact int32):
// lane (g, t) loads dims d0 + 8i and d0 + 8i + 1 (d0 = 32 kb + 2t, i = 0..3)
// of positions p .. p + 3 (p = pos0 + 4g) and turns them by a 4x4 byte
// transpose into its B words of the four n-tiles j (column g of n-tile j is
// position p + j); q's codes (at qk, the k-block's first byte of row 0) are
// stored in that dim order, so A is four plain word loads a row tile.
template <int NR>
__device__ __forceinline__ void score_block(const uint8_t* box, int d0, int p, const int8_t* qk, int g, int t,
                                            int (&acc)[NR / 16][4][4]) {
  uint32_t wa[4], wb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wa[i] = box_word(box, d0 + 8 * i, p);
    wb[i] = box_word(box, d0 + 8 * i + 1, p);
  }
  mx::transpose_4x4_bytes(wa);  // wa[j]: position p + j, dims d0 + 8i
  mx::transpose_4x4_bytes(wb);
#pragma unroll
  for (int mt = 0; mt < NR / 16; ++mt) {
    const int8_t* qa = qk + (16 * mt + g) * kQRow + 4 * t;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(qa);
    a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * kQRow);
    a[2] = *reinterpret_cast<const uint32_t*>(qa + 16);
    a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * kQRow + 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b[2] = {wa[j], wb[j]};
      mma_s8_acc(acc[mt][j], a, b);
    }
  }
}

// Max or sum over the TPR consecutive lanes of a row (a tree, fixed order).
template <int TPR, bool kSum>
__device__ __forceinline__ float row_reduce(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kSum ? v + u : fmaxf(v, u);
  }
  return v;
}

// Grid (C tiles, head groups, b), cluster (C, 1, 1), kThreads threads.  ws:
// (b, groups, tiles, C, NR, 512 / C + 4) floats (acc_t's slice, m_t, l_t, pads)
// where tiles > 1; tickets: b groups C ints, zero between launches.  q_out:
// null, or where the CTA of tile 0, rank 0 writes q's codes (b, n, 512) /
// (b, n, 64) int8 and scales (b, n) f32.
template <int NR, int P>
__global__ void __launch_bounds__(kThreads, P == 128 ? 2 : 1)
mla_int8dot_kernel(const __grid_constant__ CUtensorMap tlat, const __grid_constant__ CUtensorMap trot,
                   const uint16_t* __restrict__ ql, const uint16_t* __restrict__ qr,
                   const uint8_t* __restrict__ ls, const uint8_t* __restrict__ rs,
                   const int* __restrict__ q_off_p, const int* __restrict__ kv_len_p, int q_off_n, int kv_len_n,
                   uint16_t* __restrict__ out, float* __restrict__ ws, int* __restrict__ tickets,
                   int8_t* __restrict__ qlc_out,
                   float* __restrict__ qls_out, int8_t* __restrict__ qrc_out, float* __restrict__ qrs_out, int n,
                   int L, int lt, float sm_scale, int fault) {
  using Lay = Smem<NR, P>;
  constexpr int TPR = kThreads / NR;  // threads of a row in the softmax passes
  constexpr int kNt = NR / 8;         // n-tiles of P.V (8 heads each)
  const int C = lt / P, rank = blockIdx.x % C, tile = blockIdx.x / C, n_tiles = gridDim.x / C;
  const int hg = blockIdx.y, ib = blockIdx.z, groups = gridDim.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  // q's elements and the tensor maps are fetched while the row's positions
  // are read: warp w's rows w, w + 8, ..., a lane elements lane, lane + 32, ...
  constexpr int kQRows = NR / kWarps;
  int lbits[kQRows][mx::kMaxRowLanes], rbits[kQRows][mx::kMaxRowLanes];
#pragma unroll
  for (int i = 0; i < kQRows; ++i) {
    const long long hrow = (long long)ib * n + min(hg * NR + warp + kWarps * i, n - 1);
#pragma unroll
    for (int e = 0; e < kR / 32; ++e) lbits[i][e] = ql[hrow * kR + 32 * e + lane];
#pragma unroll
    for (int e = 0; e < kDr / 32; ++e) rbits[i][e] = qr[hrow * kDr + 32 * e + lane];
  }
  if (tid == 0)
    for (const CUtensorMap* m : {&tlat, &trot})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
  const int kv_end = max(min(min(kv_len_p ? kv_len_p[ib] : kv_len_n, (q_off_p ? q_off_p[ib] : q_off_n) + 1), L), 0);
  const int n_live = kv_end > 0 ? (kv_end + lt - 1) / lt : 1;
  if (tile >= n_live) return;  // the whole cluster: its tile starts past the row's visible prefix
  const int c0 = tile * lt + rank * P;              // the share's first position
  const int nvis = min(max(kv_end - c0, 0), P);     // its visible positions
  const int n_grp = (nvis + kBox - 1) / kBox;       // its load groups

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = mx::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = mx::smem_addr(smem);
  if (tid == 0) {
    for (int i = 0; i < Lay::kGroups; ++i) mx::mbar_init(sbase + Lay::bar + 8 * i, 1);
    mx::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int gi = 0; gi < n_grp; ++gi) {
      const uint32_t bar = sbase + Lay::bar + 8 * gi;
      const int pos = c0 + gi * kBox;
      mx::mbar_expect_tx(bar, kGroupBytes);
      mx::tma_load_2d(sbase + Lay::lat + gi * kR * kBox, &tlat, bar, pos, ib * kR);
      mx::tma_load_2d(sbase + Lay::lat + gi * kR * kBox + 256 * kBox, &tlat, bar, pos, ib * kR + 256);
      mx::tma_load_2d(sbase + Lay::rot + gi * kDr * kBox, &trot, bar, pos, ib * kDr);
      mx::bulk_load(sbase + Lay::scl + gi * 2 * kBox, ls + (long long)ib * L + pos, kBox, bar);
      mx::bulk_load(sbase + Lay::scl + gi * 2 * kBox + kBox, rs + (long long)ib * L + pos, kBox, bar);
    }
  }

  int8_t* qc = reinterpret_cast<int8_t*>(smem + Lay::q);
  float* qsc = reinterpret_cast<float*>(smem + Lay::qsc);
  float* sb = reinterpret_cast<float*>(smem + Lay::s);
  uint8_t* pqb = smem + Lay::pq;
  float* stat = reinterpret_cast<float*>(smem + Lay::stat);  // [6][NR]

  // 1. q to int8, one exponent a row (mx_quantize_rows' arithmetic) from the
  // elements fetched above; the codes go to shared memory in the scores' dim
  // order, and from tile 0, rank 0 to q_out as they are.
  const bool q_out = qlc_out != nullptr && tile == 0 && rank == 0;
#pragma unroll
  for (int i = 0; i < kQRows; ++i) {
    const int r = warp + kWarps * i, head = hg * NR + r;
    int8_t* row = qc + r * kQRow;
    if (head >= n) {
      for (int e = lane; e < kR + kDr; e += 32) row[e] = 0;
      if (lane == 0) qsc[r] = qsc[NR + r] = 0.f;
      continue;
    }
    const long long hrow = (long long)ib * n + head;
    const int sel = mx::quantize_row_bits<mx::kInt8>(lbits[i], kR, lane, [&](int e, int c) {
      row[(e & ~31) + k_of_dim(e & 31)] = (int8_t)c;
      if (q_out) qlc_out[hrow * kR + e] = (int8_t)c;
    });
    const int ser = mx::quantize_row_bits<mx::kInt8>(rbits[i], kDr, lane, [&](int e, int c) {
      row[kR + (e & ~31) + k_of_dim(e & 31)] = (int8_t)c;
      if (q_out) qrc_out[hrow * kDr + e] = (int8_t)c;
    });
    if (lane == 0) {
      qsc[r] = __fmul_rn(mx::pow2_scale(sel), sm_scale);
      qsc[NR + r] = __fmul_rn(mx::pow2_scale(ser), sm_scale);
      if (q_out) {
        qls_out[hrow] = qsc[r];
        qrs_out[hrow] = qsc[NR + r];
      }
    }
  }
  __syncthreads();

  // 2. Scores: warp w takes positions 32 (w % 4) .. + 31 of load group w / 4;
  // lane (g, t) feeds the mma's column g with positions 4 g .. 4 g + 3, one a
  // column of each of the four n-tiles j (column g of n-tile j is position
  // 4 g + j), and its k with dims 8i + 2t (+1).
  {
    const int grp = warp / 4, pos0 = 32 * (warp % 4);
    if (grp < n_grp) {
      mx::mbar_wait(sbase + Lay::bar + 8 * grp, 0);
      const uint8_t* lat = smem + Lay::lat + grp * kR * kBox;
      const uint8_t* rot = smem + Lay::rot + grp * kDr * kBox;
      int sl[NR / 16][4][4], sr[NR / 16][4][4];
#pragma unroll
      for (int mt = 0; mt < NR / 16; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sl[mt][j][e] = sr[mt][j][e] = 0;
#pragma unroll 4
      for (int kb = 0; kb < kR / 32; ++kb) score_block<NR>(lat, kb * 32 + 2 * t, pos0 + 4 * g, qc + kb * 32, g, t, sl);
#pragma unroll
      for (int kb = 0; kb < kDr / 32; ++kb)
        score_block<NR>(rot, kb * 32 + 2 * t, pos0 + 4 * g, qc + kR + kb * 32, g, t, sr);
      // c[2h + e] of n-tile j: head 16 mt + g + 8 h, column 2t + e, position pos0 + 8t + 4e + j.
      const uint8_t* scl = smem + Lay::scl + grp * 2 * kBox;
      const int pbase = grp * kBox + pos0 + 8 * t;  // in the share
#pragma unroll
      for (int mt = 0; mt < NR / 16; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mt + g + 8 * h;
          const float qls = qsc[r], qrs = qsc[NR + r];
          float v[8];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int p = pos0 + 8 * t + 4 * e + j;
              v[4 * e + j] = __fadd_rn(
                  __fmul_rn(__fmul_rn(__int2float_rn(sl[mt][j][2 * h + e]), qls), mx::pow2_scale(scl[p])),
                  __fmul_rn(__fmul_rn(__int2float_rn(sr[mt][j][2 * h + e]), qrs), mx::pow2_scale(scl[kBox + p])));
            }
          float* dst = sb + r * Lay::kSRow + pbase;
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
        }
    }
  }
  __syncthreads();
  for (int gi = 0; gi < n_grp; ++gi) mx::mbar_wait(sbase + Lay::bar + 8 * gi, 0);  // the copies, seen by every thread

  // 3. Softmax and requantization, TPR threads a row, its visible positions
  // only (the others hold nothing: p3 = pq = 0 there).
  const int row_r = tid / TPR, k = tid % TPR;
  float* srow = sb + row_r * Lay::kSRow;
  {
    float m = kNegInf;
    for (int j = k; j < nvis; j += TPR) m = fmaxf(m, srow[j]);
    m = row_reduce<TPR, false>(m);
    if (k == 0) stat[row_r] = m;
  }
  mx::cluster_sync();  // 1: the shares' maxima
  float M = kNegInf;
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c)
    if (c < C) M = fmaxf(M, mx::ld_cluster_f32(mx::cluster_addr(sbase + Lay::stat + 4 * row_r, c)));
  {
    const uint8_t* scl = smem + Lay::scl;
    float l = 0.f, mxv = 0.f;
    for (int j = k; j < nvis; j += TPR) {
      const float p = expf(srow[j] - M);
      const float p3 = __fmul_rn(p, mx::pow2_scale(scl[(j / kBox) * 2 * kBox + j % kBox]));
      l += p;
      mxv = fmaxf(mxv, p3);
      srow[j] = p3;
    }
    l = row_reduce<TPR, true>(l);
    mxv = row_reduce<TPR, false>(mxv);
    if (k == 0) {
      stat[NR + row_r] = l;
      stat[2 * NR + row_r] = mxv;
    }
  }
  mx::cluster_sync();  // 2: l_c and mx_c
  {
    float l = 0.f, mxv = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {  // in rank order
      if (c < C) {
        l = __fadd_rn(l, mx::ld_cluster_f32(mx::cluster_addr(sbase + Lay::stat + 4 * (NR + row_r), c)));
        mxv = fmaxf(mxv, mx::ld_cluster_f32(mx::cluster_addr(sbase + Lay::stat + 4 * (2 * NR + row_r), c)));
      }
    }
    mxv = mxv == 0.f ? 1.f : mxv;
    const float inv = __fdiv_rn(127.f, mxv);
    uint8_t* pqrow = pqb + row_r * Lay::kPqRow;
    for (int j = 4 * k; j < n_grp * kBox; j += 4 * TPR) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < nvis) word |= (uint32_t)(__float2int_rn(__fmul_rn(srow[j + e], inv)) & 0xFF) << (8 * e);
      *reinterpret_cast<uint32_t*>(pqrow + j) = word;
    }
    if (k == 0) {
      stat[3 * NR + row_r] = M;
      stat[4 * NR + row_r] = l;
      stat[5 * NR + row_r] = __fmul_rn(mxv, 1.f / 127.f);
    }
  }
  __syncthreads();

  // 4. P.V: warp w, dims 64 w .. 64 w + 63 (four m-tiles), all heads, over the
  // share's positions that hold a nonzero pq.
  int acc[4][kNt][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
  const int mi = lane >> 3;
  for (int grp = 0; grp < n_grp; ++grp) {
    const uint32_t box = sbase + Lay::lat + grp * kR * kBox;
    const int n_ks = min((nvis - grp * kBox + 31) / 32, kBox / 32);
    for (int ks = 0; ks < n_ks; ++ks) {
      uint32_t b[kNt][2];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const uint8_t* pr = pqb + (8 * nt + g) * Lay::kPqRow + grp * kBox + 32 * ks + 4 * t;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(pr);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(pr + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int dl = 64 * warp + 16 * mt + (lane & 7) + 8 * (mi & 1);
        uint32_t a[4];
        mx::ldmatrix_x4(a, box + dl * kBox + (((2 * ks + (mi >> 1)) ^ (dl & 7)) << 4));
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) mma_s8_acc(acc[mt][nt], a, b[nt]);
      }
    }
  }
  __syncthreads();  // the share is read: its partials go over it
  int* pv = reinterpret_cast<int*>(smem + Lay::lat);  // [512][kPvRow]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 64 * warp + 16 * mt + g + 8 * h;
        *reinterpret_cast<int2*>(pv + d * Lay::kPvRow + 8 * nt + 2 * t) =
            make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  mx::cluster_sync();  // 3: the partials

  // 5. CTA `rank` sums its slice of dims over the cluster (exact integers),
  // a thread four heads of a dim at a time; acc_t = sum * (mx_t / 127): the
  // output where the row has one live tile, else the slice's record (acc_t,
  // m_t, l_t) in the workspace.
  const int S = kR / C, d_lo = rank * S, rec = S + 4;  // a record row: acc_t's slice, m_t, l_t, two pads
  const long long unit = (long long)ib * groups + hg;
  float* base = ws + (unit * n_tiles * C + rank) * NR * rec;  // tile u's record at base + u * C * NR * rec
  float* mine = base + (long long)tile * C * NR * rec;
  constexpr int kQuads = NR / 4;
  for (int it = tid; it < S * kQuads; it += kThreads) {
    const int d = it / kQuads, q4 = it % kQuads;
    const uint32_t local = sbase + Lay::lat + 4 * ((d_lo + d) * Lay::kPvRow + 4 * q4);
    int4 v[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) v[c] = c < C ? ld_cluster_v4(mx::cluster_addr(local, c)) : make_int4(0, 0, 0, 0);
    int4 s4 = v[0];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c) {
      s4.x += v[c].x;
      s4.y += v[c].y;
      s4.z += v[c].z;
      s4.w += v[c].w;
    }
    const int sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * q4 + e, head = hg * NR + r;
      const float o = __fmul_rn(__int2float_rn(sv[e]), stat[5 * NR + r]);
      if (n_live > 1) {
        mine[r * rec + d] = o;
      } else if (head < n) {
        const float l = stat[4 * NR + r];
        out[((long long)ib * n + head) * kR + d_lo + d] =
            __bfloat16_as_ushort(__float2bfloat16_rn(__fdiv_rn(o, l == 0.f ? 1.f : l)));
      }
    }
  }
  mx::cluster_arrive();  // 4: done reading the cluster's shared memory (waited for before exit)
  if (n_live == 1) {
    mx::cluster_wait();
    return;
  }
  if (tid < NR) {
    mine[tid * rec + S] = stat[3 * NR + tid];
    mine[tid * rec + S + 1] = stat[4 * NR + tid];
  }
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(smem + Lay::last);
  int* ticket = tickets + unit * C + rank;
  if (tid == 0) *last = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (*last) {
    __threadfence();
    // The last CTA of the slice.  Each live tile's m_t and l_t into shared
    // memory (one round trip); a row's M = max m_t, weights e^(m_t - M) and
    // l = sum l_t e^(m_t - M) in tile order; then acc_t weighted and added in
    // tile order, four dims a thread.
    const int n_use = (fault & kFaultDropLast) ? n_live - 1 : n_live;
    const long long step = (long long)C * NR * rec;
    float* wm = sb;                   // [tile][NR]: m_t, then its weight
    float* wl = sb + kMaxTiles * NR;  // [tile][NR]: l_t; then [NR]: the row's l
    for (int i = tid; i < n_use * NR; i += kThreads) {
      const float* ri = base + (i / NR) * step + (i % NR) * rec + S;
      wm[i] = __ldcg(ri);
      wl[i] = __ldcg(ri + 1);
    }
    __syncthreads();
    if (tid < NR) {
      float Mx = kNegInf, l = 0.f;
      for (int u = 0; u < n_use; ++u) Mx = fmaxf(Mx, wm[u * NR + tid]);
      for (int u = 0; u < n_use; ++u) {
        const float f = expf(wm[u * NR + tid] - Mx);
        wm[u * NR + tid] = f;
        l = __fadd_rn(l, __fmul_rn(wl[u * NR + tid], f));
      }
      wl[kMaxTiles * NR + tid] = l == 0.f ? 1.f : l;
    }
    __syncthreads();
    for (int i = tid; i < NR * S / 4; i += kThreads) {
      const int r = i / (S / 4), e = 4 * (i % (S / 4)), head = hg * NR + r;
      if (head >= n) continue;
      const float* rr = base + r * rec + e;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int u = 0; u < n_use; ++u) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(rr + u * step));
        const float f = wm[u * NR + r];
        a[0] = __fadd_rn(a[0], __fmul_rn(v.x, f));
        a[1] = __fadd_rn(a[1], __fmul_rn(v.y, f));
        a[2] = __fadd_rn(a[2], __fmul_rn(v.z, f));
        a[3] = __fadd_rn(a[3], __fmul_rn(v.w, f));
      }
      const float l = wl[kMaxTiles * NR + r];
      uint16_t* o = out + ((long long)ib * n + head) * kR + d_lo + e;
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) o[k4] = __bfloat16_as_ushort(__float2bfloat16_rn(__fdiv_rn(a[k4], l)));
    }
    if (tid == 0) *ticket = 0;
  }
  mx::cluster_wait();
}

template <int NR, int P>
cudaError_t run(const void* ql, const void* qr, const void* ld, const void* ls, const void* rd, const void* rs,
                const void* q_off, const void* kv_len, int q_off_n, int kv_len_n, void* out, void* ws, void* tickets,
                void* qlc, void* qls, void* qrc, void* qrs, int b, int n, int L, int lt, int tiles, float sm_scale,
                int fault, cudaStream_t stream) {
  CUtensorMap tlat, trot;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;  // boxes of 128 positions x 256 / 64 rows
  if (!mx::cached_byte_map(&tlat, ld, (uint64_t)b * kR, L, kBox, 256, sw) ||
      !mx::cached_byte_map(&trot, rd, (uint64_t)b * kDr, L, kBox, kDr, sw))
    return cudaErrorInvalidValue;
  constexpr int smem = Smem<NR, P>::total + 1024;
  static_assert(smem <= kSmemMax, "shared memory");
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(mla_int8dot_kernel<NR, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int C = lt / P;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * tiles, (n + NR - 1) / NR, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, mla_int8dot_kernel<NR, P>, tlat, trot, (const uint16_t*)ql, (const uint16_t*)qr, (const uint8_t*)ls,
      (const uint8_t*)rs, (const int*)q_off, (const int*)kv_len, q_off_n, kv_len_n, (uint16_t*)out, (float*)ws,
      (int*)tickets,
      (int8_t*)qlc, (float*)qls, (int8_t*)qrc, (float*)qrs, n, L, lt, sm_scale, fault);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// q_lat (b, n, 512), q_rot (b, n, 64) bf16; latent codes (b, 512, L) and rope
// codes (b, 64, L) int8, scales (b, 1, L) uint8, every cache pointer 16-byte
// aligned; q_off, kv_len: (b,) int32, or null and the number q_off_n /
// kv_len_n for every row; lt (JAX's tile) 128 .. 2048 and L % lt == 0; P
// (positions a CTA) 128 or 256, lt % P == 0 and lt / P <= 8.  tiles: the
// grid's tiles, L / lt or, where the caller knows every kv_len, ceil(min(max
// kv_len, L) / lt) (at least 1, at most 64).  ws: b * ceil(n / NR) * tiles *
// NR * (512 + 4 lt / P) floats where tiles > 1 (NR = 16 where n <= 16, else
// 32); tickets: b * ceil(n / NR) * lt / P ints, zero (the kernel leaves them
// zero).  q codes / scales out: all null, or (b, n, 512) / (b, n, 64) int8
// and (b, n) f32 each.  fault: 0 (bit 1: the combine drops the last live
// tile).
extern "C" int mx_mla_attention_int8dot_launch(const void* ql, const void* qr, const void* ld, const void* ls,
                                               const void* rd, const void* rs, const void* q_off, const void* kv_len,
                                               int q_off_n, int kv_len_n, void* out, void* ws, void* tickets,
                                               void* qlc, void* qls, void* qrc, void* qrs, int b, int n, int L, int r,
                                               int dr, int lt, int P, int tiles, float sm_scale, int fault,
                                               void* stream) {
  if (r != kR || dr != kDr || n <= 0 || L <= 0 || lt < kBox || lt > 2048 || (lt & (lt - 1)) || L % lt ||
      (P != 128 && P != 256) || lt % P || lt / P > kMaxCluster || tiles < 1 || tiles > L / lt || tiles > kMaxTiles ||
      b > 65535 || fault < 0 || fault > 1)
    return (int)cudaErrorInvalidValue;
  const bool q_none = qlc == nullptr;
  if (q_none != (qls == nullptr) || q_none != (qrc == nullptr) || q_none != (qrs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)ld | (uintptr_t)ls | (uintptr_t)rd | (uintptr_t)rs) % 16) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  if (tiles > 1 && (ws == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define B14_RUN(NR, P_) run<NR, P_>(ql, qr, ld, ls, rd, rs, q_off, kv_len, q_off_n, kv_len_n, out, ws, tickets, qlc, \
                                    qls, qrc, qrs, b, n, L, lt, tiles, sm_scale, fault, s)
  if (n <= 16) return P == 128 ? B14_RUN(16, 128) : B14_RUN(16, 256);
  return P == 128 ? B14_RUN(32, 128) : B14_RUN(32, 256);
#undef B14_RUN
}
