// K6 mx_cached_attention_dmajor: causal attention of bf16 queries over an MX
// KV cache in the d-major layout, prefill, chunks and decode alike.
//
// Replaces torchmx_tpu/ops/pallas_attention.py::_attn_kernel_dmajor (:490),
// launched by _mx_cached_attention_dmajor (:610).
//
// Inputs: q (b, hq, sq, d) bf16; K/V codes (b, hkv, dp, L), the sequence on
// the last axis: one byte per element and dp = d for fp8, fp6 and int8; for
// fp4 dp = d/2 and byte row p holds element p in its high nibble and element
// p + d/2 in its low nibble; scales (b, hkv, d/32, L) uint8 (for fp4, rows
// [0, d/64) scale the high plane); q_off, kv_len (b,) int32.  Output
// (b, hq, sq, d) bf16.  GQA folded: row r of a KV head is query position
// r / G, head r % G, and sees positions <= q_off + r / G and < kv_len; fp32
// online softmax over tiles of 64 positions, p rounded to bf16 before P.V,
// masked scores -1e30, a row with no visible key gives 0; positions at or
// past kv_len decode to 0 (a stale scale of 255 never reaches the dots).
//
// The algorithm: the positions are cut into chunks of S (ops/cuda_attention.
// k6_chunk(L), a function of L alone) at fixed absolute positions; within a
// chunk the online softmax of K4 (csrc/mx_attention.cu) over its tiles in
// position order; the chunks' (m, l, acc) then combined in chunk order:
// M = max m_s, out = (sum_s acc_s e^(m_s - M)) * (1 / sum_s l_s e^(m_s - M)).
// A chunk or tile a row sees nothing of adds exact zeros, and a row's lone
// live chunk is scaled by exactly 1, so a row's bytes depend on its own
// query position, q_off, kv_len and L only: not on b, sq, the other rows of
// its tile, or whether kv_len is a number.
//
// Invariant against K4: the decoded values, the tile order inside a chunk
// and every element's dot and softmax arithmetic are K4's (in both layouts
// of point 5 below), so K6 equals K4 bit for bit on the same cache content
// for every row whose visible prefix min(kv_len, q_off + r / G + 1) lies in
// one chunk (<= S positions).  A row whose prefix spans chunks sums in
// another fp32 order: against K4 and against the plain version it holds abs
// <= 2e-2 and the worst row's relative L2 error <= chip_smoke.K6_ROW_REL.
//
// What bounds it on an H100: at decode the cache bytes of the visible prefix,
// at prefill the two dots; at decode, in practice, the latency of a CTA's
// walk and its fixed cost (tools/phase_profile.py --kernel k6).  Design:
//  1. The KV is split across the card.  The grid is (chunk, 64-row tile,
//     b * hkv); a CTA whose chunk starts past its tile's last visible
//     position exits at once (where kv_len is a number the wrapper launches
//     only the chunks below it).
//  2. The combine runs in the same launch: each live chunk of a tile with two
//     or more writes its rows' (m, l, acc) in fp32 to a workspace
//     (ops/split_kv, shared with B13), and the last CTA of the tile (an
//     atomic ticket, which it resets) combines them in chunk order, its
//     loads batched.  A tile with one live chunk writes acc * (1 / l).
//  3. Asynchronous copies on full / empty mbarriers: four TMA boxes a tile
//     (K and V codes, dp rows x 64 positions, and their four scale rows, from
//     2-D tensor maps over (b hkv dp, L) and (b hkv 4, L), encoded once per
//     buffer and kept, keyed by pointer and shape), into a ring of one stage
//     (fp4: two).  Thread 0 issues the first fills before the CTA's set-up
//     ends and fill t + stages as soon as tile t's slot is released, so the
//     next tile's copy runs under this tile's dots.  No producer warp and no
//     deeper ring: on an H100 the fourth CTA an SM gained more (tools/
//     phase_profile.py readings in PERF.md).
//  4. The four warps decode each landed tile once into a bf16 [d][position]
//     tile pair (a thread: 16 positions of one code row, by integer ops and
//     one bf16 multiply a pair where the scales are safe, else the exact
//     decode, the same bits), then run its dots.  Four CTAs an SM (three
//     with 64-row tiles) overlap one CTA's decode with another's dots and
//     copies.
//  5. Dots on mma.sync m16n8k16 with K4's arithmetic, in two layouts of the
//     same per-element sums.  Decode (G * sq <= 16, one 16-row warp tile):
//     no warp runs dots or softmax for rows past rows_total; the four warps
//     split the tile, warp w the scores of positions 16 w .. 16 w + 15 and
//     the output columns 32 w .. 32 w + 31, the maxima, p (fp32, summed in
//     each row's K4 order) and the P fragments passed through shared memory.
//     Prefill and chunks: 64-row tiles, warp w rows 16 w .. 16 w + 15, all
//     positions and columns, as K4; a warp skips a tile that lies past its
//     rows' last position (exact zeros).  The K tile's B fragments come
//     through ldmatrix.trans from the [d][position] tile, the V tile's are
//     read as K4 reads its transposed V tile.
#include "mx_common.cuh"
#include "mx_wgmma.cuh"
#include "mx_wgmma_decode.cuh"

namespace {

constexpr int kD = 128;          // head_dim
constexpr int kRows = 64;        // query rows per CTA (4 warps x 16)
constexpr int kL = 64;           // KV positions per tile (K6_TILE in ops/cuda_attention.py)
constexpr int kSeg = 16;         // positions a thread decodes at once
constexpr int kTPad = kL + 8;    // decoded tile row stride (bf16): 144 bytes, conflict-free for ldmatrix
constexpr int kThreads = 128;    // four warps; thread 0 also issues the copies
constexpr int kMaxChunks = 64;   // chunks of a cache at most (cuda_attention.k6_chunk)
constexpr float kNegInf = -1e30f;
constexpr int kFaultDropLast = 1;  // planted fault: the combine drops the last live chunk

// Shared memory of a format: the decoded K / V tiles, then the ring (a stage:
// K codes, V codes, K scales, V scales of one tile; one stage for one-byte
// codes, two for fp4), the decode layout's maxima, the full and empty
// barriers and the combine's "last" flag: small enough for four CTAs an SM
// (the decode layout; 64-row tiles' registers allow three).
template <int E> struct Geo {
  static constexpr int ctas = 4;
  static constexpr int rows = E == mx::kFp4E2M1 ? kD / 2 : kD;  // code rows of a head
  static constexpr int codes = rows * kL, scales = (kD / 32) * kL;
  static constexpr int o_vd = codes, o_ks = 2 * codes, o_vs = 2 * codes + scales;
  static constexpr int stage = 2 * codes + 2 * scales;
  static constexpr int stages = E == mx::kFp4E2M1 ? 2 : 1;
  static constexpr int tile = kD * kTPad * 2;  // bytes of one decoded bf16 tile
  static constexpr int o_ring = 2 * tile;
  static constexpr int o_red = o_ring + stages * stage;  // the decode layout's [warp][row] maxima
  static constexpr int o_bar = o_red + 4 * 16 * 4;
  static constexpr int bytes = o_bar + 2 * stages * 8 + 16;
  static_assert(stage % 128 == 0 && codes % 128 == 0 && scales % 128 == 0 && o_ring % 128 == 0, "TMA boxes");
  static_assert(ctas * (bytes + 128 + 1024) <= 233472, "CTAs an SM");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Whether all four scale bytes of w are safe for the fast decode.
template <int E>
__device__ __forceinline__ bool all_safe(uint32_t w) {
  return __vcmpleu4(__vsub4(w, 0x10101010u), (mx::safe_hi<E>() - mx::kSafeLo) * 0x01010101u) == 0xFFFFFFFFu;
}

// Codes hi and 2 + hi of word r (positions hi and 2 + hi), each at its own
// scale byte of sw, as bf16x2: mx::decode_fast's arithmetic with a scale
// per lane (int8: one exact fma a code; fp: one bf16 multiply a pair).
template <int E>
__device__ __forceinline__ uint32_t decode_pair(uint32_t r, uint32_t sw, int hi) {
  if constexpr (E == mx::kInt8) {
    const uint32_t u = r ^ 0x80808080u;
    const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + hi));
    const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442 + hi));
    const float sa = __uint_as_float(((sw >> (8 * hi)) & 0xFF) << 23);
    const float sb = __uint_as_float(((sw >> (16 + 8 * hi)) & 0xFF) << 23);
    return __byte_perm(__float_as_uint(fmaf(a, sa, -8388736.0f * sa)), __float_as_uint(fmaf(b, sb, -8388736.0f * sb)),
                       0x7632);
  } else {
    const uint32_t s16 = __byte_perm(sw, 0u, 0x4240 + 0x101 * hi);
    const uint32_t scale2 = (s16 + (uint32_t)(127 - mx::Elem<E>::bias) * 0x00010001u) << 7;  // 2^(se - bias) a lane
    return mx::decode_fast<E>(r, hi, 0.f, 0.f, scale2);
  }
}

// 16 positions of one code row (codes cw, fp4: the high nibbles with `high`,
// else the low ones; their scales sw) -> 16 bf16 at dst.  Positions from
// `live` on decode to 0.
template <int E>
__device__ __forceinline__ void decode_segment(uint16_t* dst, uint4 cw, uint4 sw, int live, bool high) {
  const uint32_t c[4] = {cw.x, cw.y, cw.z, cw.w}, s[4] = {sw.x, sw.y, sw.z, sw.w};
  uint32_t o[8];
  const bool fast = live >= kSeg && all_safe<E>(s[0]) && all_safe<E>(s[1]) && all_safe<E>(s[2]) && all_safe<E>(s[3]);
  if (fast) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t r = (E == mx::kFp4E2M1 && high) ? c[w] >> 4 : c[w];
      const uint32_t x02 = decode_pair<E>(r, s[w], 0), x13 = decode_pair<E>(r, s[w], 1);
      o[2 * w] = __byte_perm(x02, x13, 0x5410);
      o[2 * w + 1] = __byte_perm(x02, x13, 0x7632);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSeg; j += 2) {
      uint32_t v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int code = (c[(j + i) / 4] >> (8 * ((j + i) % 4))) & 0xFF;
        if (E == mx::kFp4E2M1) code = high ? code >> 4 : code & 0xF;
        const int se = (s[(j + i) / 4] >> (8 * ((j + i) % 4))) & 0xFF;
        v[i] = j + i < live ? mx::decode_bf16_bits<E>(code, se) : 0u;
      }
      o[j / 2] = v[0] | (v[1] << 16);
    }
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// Decode ring fill f (positions pos0 .. pos0 + 63) into the bf16 tiles Kt,
// Vt ([d][position]); positions at or past kv_len as 0.  Then release the
// slot.
template <int E>
__device__ __forceinline__ void decode_tile(const uint8_t* smem, uint32_t sbase, uint16_t (*Kt)[kTPad],
                                            uint16_t (*Vt)[kTPad], int f, int pos0, int kv_len, int tid) {
  using G = Geo<E>;
  const int slot = f % G::stages;
  mx::mbar_wait(sbase + G::o_bar + 8 * slot, (f / G::stages) & 1);
  const uint8_t* st = smem + G::o_ring + slot * G::stage;
  constexpr int kItems = G::rows * (kL / kSeg);  // (code row, segment) pairs of one tensor
#pragma unroll 2
  for (int i = tid; i < 2 * kItems; i += kThreads) {
    const int v = i / kItems, crow = (i % kItems) / (kL / kSeg), seg = i % (kL / kSeg);
    uint16_t(*T)[kTPad] = v ? Vt : Kt;
    const uint4 cw = *reinterpret_cast<const uint4*>(st + v * G::o_vd + crow * kL + seg * kSeg);
    const uint8_t* sc = st + G::o_ks + v * G::scales + seg * kSeg;
    const int live = min(max(kv_len - (pos0 + seg * kSeg), 0), kSeg);
    if constexpr (E == mx::kFp4E2M1) {
      const uint4 sh = *reinterpret_cast<const uint4*>(sc + (crow / 32) * kL);
      const uint4 sl = *reinterpret_cast<const uint4*>(sc + (crow / 32 + kD / 64) * kL);
      decode_segment<E>(&T[crow][seg * kSeg], cw, sh, live, true);
      decode_segment<E>(&T[crow + kD / 2][seg * kSeg], cw, sl, live, false);
    } else {
      const uint4 sw = *reinterpret_cast<const uint4*>(sc + (crow / 32) * kL);
      decode_segment<E>(&T[crow][seg * kSeg], cw, sw, live, false);
    }
  }
  mx::mbar_arrive(sbase + G::o_bar + 8 * (G::stages + slot));
}

// The scores of one tile for a thread's rows (g, g + 8 of a 16-row warp
// tile) and n8 blocks, K4's arithmetic: s = q . k over d in k16 steps,
// scaled, masked to -1e30.
template <int NJ>
__device__ __forceinline__ void tile_scores(float (&s)[NJ][4], const uint32_t (&qa)[kD / 16][4],
                                            uint16_t (*Kt)[kTPad], int j0, int lane, int kt0, const int (&qpos)[2],
                                            int kv_len, float sm_scale) {
  const int t = lane % 4;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
    for (int r = 0; r < 4; ++r) s[jj][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t b[2];
      mx::ldmatrix_x2_trans(b, &Kt[kk * 16 + (lane & 15)][(j0 + jj) * 8]);
      mx::mma_bf16_16816(s[jj], qa[kk], b);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kv_pos = kt0 + (j0 + jj) * 8 + 2 * t + e;
        const float v = s[jj][2 * h + e] * sm_scale;
        s[jj][2 * h + e] = kv_pos <= qpos[h] && kv_pos < kv_len ? v : kNegInf;
      }
  }
}

// Grid (n_chunks, row tiles, b * hkv); kThreads threads.  q and out are
// (b, hq, sq_stride, d), this launch's positions the first sq of each head;
// ws: (b hkv, n_chunks, rows_total, d) floats of acc, then (b hkv, n_chunks,
// rows_total, 2) of (m, l); tickets: (b hkv, row tiles) ints, zero between
// launches.  kCols (rows_total <= 16, decode): the tile's 16 rows are one
// warp tile, and warp w computes the scores of positions 16 w .. 16 w + 15
// of each KV tile and the output columns 32 w .. 32 w + 31, the running max,
// p and the P fragments shared through shared memory; else (prefill) warp w
// computes rows 16 w .. 16 w + 15, all positions and columns.  Either way
// every element's arithmetic, the sum of p in each row's order included, is
// K4's.
template <int E, bool kCols>
__global__ void __launch_bounds__(kThreads, kCols ? Geo<E>::ctas : 3)
attention_dmajor_kernel(const __grid_constant__ CUtensorMap tkd, const __grid_constant__ CUtensorMap tks,
                        const __grid_constant__ CUtensorMap tvd, const __grid_constant__ CUtensorMap tvs,
                        const uint16_t* __restrict__ q, const int* __restrict__ q_off_p,
                        const int* __restrict__ kv_len_p, uint16_t* __restrict__ out, float* __restrict__ ws,
                        int* __restrict__ tickets, int hq, int hkv, int sq, int sq_stride, int L, int S,
                        float sm_scale, int fault) {
  using Geom = Geo<E>;
  constexpr int kJ = kCols ? kD / 8 / 4 : kD / 8;  // n8 output column blocks of a warp
  const int c = blockIdx.x, rt = blockIdx.y, kvh = blockIdx.z, n_chunks = gridDim.x;
  const int ib = kvh / hkv, ih = kvh % hkv, G = hq / hkv;
  const int rows_total = sq * G, row_base = rt * kRows;
  const int q_off = q_off_p[ib], kv_len = kv_len_p[ib];
  // Highest query position of the tile: positions above it, or at/after kv_len, are dead.
  const int q_hi = q_off + (min(rows_total, row_base + kRows) - 1) / G;
  const int kv_end = min(min(kv_len, q_hi + 1), L);
  const int n_live = kv_end > 0 ? (kv_end + S - 1) / S : 1;
  if (c >= n_live) return;  // the chunk starts past the tile's last visible position
  const int c0 = c * S;
  const int t_end = min(c0 + S, kv_end);
  const int nt = t_end > c0 ? (t_end - c0 + kL - 1) / kL : 0;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = mx::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 127) & ~127u) - raw_addr);
  const uint32_t sbase = mx::smem_addr(smem);
  const int tid = threadIdx.x;
  // Thread 0 issues every copy: fill f of the ring is tile f of the chunk,
  // four TMA boxes on the slot's full barrier.
  const int crow0 = kvh * Geom::rows, srow0 = kvh * (kD / 32);
  auto fill = [&](int f) {
    const int slot = f % Geom::stages;
    const uint32_t full = sbase + Geom::o_bar + 8 * slot, st = sbase + Geom::o_ring + slot * Geom::stage;
    const int pos = c0 + f * kL;
    mx::mbar_expect_tx(full, Geom::stage);
    mx::tma_load_2d(st, &tkd, full, pos, crow0);
    mx::tma_load_2d(st + Geom::o_vd, &tvd, full, pos, crow0);
    mx::tma_load_2d(st + Geom::o_ks, &tks, full, pos, srow0);
    mx::tma_load_2d(st + Geom::o_vs, &tvs, full, pos, srow0);
  };
  if (tid == 0) {
    for (const CUtensorMap* m : {&tkd, &tvd, &tks, &tvs})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
    for (int s = 0; s < Geom::stages; ++s) {
      mx::mbar_init(sbase + Geom::o_bar + 8 * s, 1);
      mx::mbar_init(sbase + Geom::o_bar + 8 * (Geom::stages + s), kThreads);
    }
    mx::mbar_init_fence();
    for (int f = 0; f < min(nt, Geom::stages); ++f) fill(f);
  }
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  uint16_t(*Kt)[kTPad] = reinterpret_cast<uint16_t(*)[kTPad]>(smem);  // the decoded tile pair
  uint16_t(*Vt)[kTPad] = reinterpret_cast<uint16_t(*)[kTPad]>(smem + Geom::tile);
  float* red = reinterpret_cast<float*>(smem + Geom::o_red);  // kCols: [warp][row] tile maxima
  const int warp_base = kCols ? row_base : row_base + warp * 16;  // the thread's 16-row tile
  const int j0 = kCols ? warp * kJ : 0;                            // its first output column block
  const bool live_warp = warp_base < rows_total;
  const int warp_qhi = q_off + (min(rows_total, warp_base + 16) - 1) / G;  // the rows' last query position

  // This thread's two rows (g and g + 8 of the 16), clamped to a real row.
  int row[2], qpos[2];
  long long qidx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = warp_base + g + h * 8;
    const int r = min(row[h], rows_total - 1), si = r / G, gi = r % G;
    qpos[h] = q_off + si;
    qidx[h] = (((long long)ib * hq + ih * G + gi) * sq_stride + si) * kD;
  }
  // Q fragments for the 8 k-steps over d, kept in registers (dead warps: none).
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int col = kk * 16 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = live_warp && row[h] < rows_total;
      qa[kk][h] = ok ? *reinterpret_cast<const uint32_t*>(q + qidx[h] + col) : 0u;
      qa[kk][2 + h] = ok ? *reinterpret_cast<const uint32_t*>(q + qidx[h] + col + 8) : 0u;
    }
  }

  float o[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int ti = 0; ti < nt; ++ti) {
    decode_tile<E>(smem, sbase, Kt, Vt, ti, c0 + ti * kL, kv_len, tid);
    mx::named_barrier(1, kThreads);  // tile ti decoded, its ring slot released
    if (tid == 0 && ti + Geom::stages < nt) {
      mx::mbar_wait(sbase + Geom::o_bar + 8 * (Geom::stages + ti % Geom::stages), (ti / Geom::stages) & 1);
      fill(ti + Geom::stages);  // in flight while tile ti's dots run
    }
    const int kt0 = c0 + ti * kL;
    if constexpr (kCols) {
      // Every warp, or none, computes: the tile's rows are one warp tile.
      if (kt0 <= warp_qhi) {
        float s[2][4];  // positions 16 warp .. + 15: n8 blocks 2 warp, 2 warp + 1
        tile_scores<2>(s, qa, Kt, 2 * warp, lane, kt0, qpos, kv_len, sm_scale);
        float mx_new[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mloc = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1]));
          mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
          mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
          if (t == 0) red[warp * 16 + g + 8 * h] = mloc;
        }
        mx::named_barrier(1, kThreads);  // every warp's maxima; every warp done with Kt
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          mx_new[h] = fmaxf(m_run[h], fmaxf(fmaxf(red[r], red[16 + r]), fmaxf(red[32 + r], red[48 + r])));
        }
        // p, and the tile's P shared: p in fp32 ([row][position], for each
        // row's sum in K4's order) and as bf16 A fragments ([k16 step][lane]),
        // both over the scores' tile, free now.
        float* pbuf = reinterpret_cast<float*>(Kt);
        uint4* pfrag = reinterpret_cast<uint4*>(pbuf + 16 * kL);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = s[jj][2 * h + e];
              s[jj][2 * h + e] = v == kNegInf ? 0.f : expf(v - mx_new[h]);
            }
            *reinterpret_cast<float2*>(pbuf + (g + 8 * h) * kL + (2 * warp + jj) * 8 + 2 * t) =
                make_float2(s[jj][2 * h], s[jj][2 * h + 1]);
          }
        pfrag[warp * 32 + lane] = make_uint4(pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                             pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3]));
        mx::named_barrier(1, kThreads);
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          alpha[h] = expf(m_run[h] - mx_new[h]);
          float psum = 0.f;
#pragma unroll
          for (int j = 0; j < kL / 8; ++j) {
            const float2 v = *reinterpret_cast<const float2*>(pbuf + (g + 8 * h) * kL + j * 8 + 2 * t);
            psum += v.x;
            psum += v.y;
          }
          psum += __shfl_xor_sync(0xffffffffu, psum, 1);
          psum += __shfl_xor_sync(0xffffffffu, psum, 2);
          l_run[h] = l_run[h] * alpha[h] + psum;
          m_run[h] = mx_new[h];
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          o[j][0] *= alpha[0];
          o[j][1] *= alpha[0];
          o[j][2] *= alpha[1];
          o[j][3] *= alpha[1];
        }
        // O += bf16(P) V over this warp's columns, the k16 steps in order.
#pragma unroll
        for (int kk = 0; kk < kL / 16; ++kk) {
          const uint4 pv = pfrag[kk * 32 + lane];
          const uint32_t pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            uint32_t b[2];
            b[0] = *reinterpret_cast<const uint32_t*>(&Vt[(j0 + j) * 8 + g][kk * 16 + 2 * t]);
            b[1] = *reinterpret_cast<const uint32_t*>(&Vt[(j0 + j) * 8 + g][kk * 16 + 2 * t + 8]);
            mx::mma_bf16_16816(o[j], pa, b);
          }
        }
      }
    } else if (live_warp && kt0 <= warp_qhi) {  // else every position of the tile is masked for the warp: exact zeros
      // S = Q K^T for this warp's 16 rows x 64 positions, then K4's online softmax.
      float s[kL / 8][4];
      tile_scores<kL / 8>(s, qa, Kt, 0, lane, kt0, qpos, kv_len, sm_scale);
      float mx_new[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mloc = kNegInf;
#pragma unroll
        for (int j = 0; j < kL / 8; ++j) mloc = fmaxf(mloc, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
        mx_new[h] = fmaxf(m_run[h], mloc);
      }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        alpha[h] = expf(m_run[h] - mx_new[h]);
#pragma unroll
        for (int j = 0; j < kL / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // A masked score adds 0, also where the row has seen no key yet in this chunk.
            const float v = s[j][2 * h + e];
            const float p = v == kNegInf ? 0.f : expf(v - mx_new[h]);
            s[j][2 * h + e] = p;
            psum[h] += p;
          }
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
        l_run[h] = l_run[h] * alpha[h] + psum[h];
        m_run[h] = mx_new[h];
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // O += bf16(P) V: the S accumulator layout is the A fragment layout.
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          uint32_t b[2];
          b[0] = *reinterpret_cast<const uint32_t*>(&Vt[j * 8 + g][kk * 16 + 2 * t]);
          b[1] = *reinterpret_cast<const uint32_t*>(&Vt[j * 8 + g][kk * 16 + 2 * t + 8]);
          mx::mma_bf16_16816(o[j], pa, b);
        }
      }
    }
    mx::named_barrier(1, kThreads);  // tile ti's dots done: the tile pair is free
  }

  // Epilogue.  Thread (warp, g, t) holds rows warp_base + g + 8 h, columns
  // 8 (j0 + j) + 2 t + {0, 1} in o[j][2 h + {0, 1}].
  if (n_live == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live_warp || row[h] >= rows_total) continue;
      const float inv = 1.f / (l_run[h] == 0.f ? 1.f : l_run[h]);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        *reinterpret_cast<uint32_t*>(out + qidx[h] + (j0 + j) * 8 + 2 * t) =
            pack_bf16(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    }
    return;
  }

  const long long acc_elems = (long long)gridDim.z * n_chunks * rows_total * kD;
  float* ml = ws + acc_elems;
  const long long part = ((long long)kvh * n_chunks + c) * rows_total;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live_warp || row[h] >= rows_total) continue;
    float* arow = ws + (part + row[h]) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      *reinterpret_cast<float2*>(arow + 8 * (j0 + j)) = make_float2(o[j][2 * h], o[j][2 * h + 1]);
    if (t == 0 && j0 == 0) *reinterpret_cast<float2*>(ml + 2 * (part + row[h])) = make_float2(m_run[h], l_run[h]);
  }
  __threadfence();
  mx::named_barrier(1, kThreads);
  int* last = reinterpret_cast<int*>(smem + Geom::o_bar + 2 * Geom::stages * 8);
  int* ticket = tickets + (long long)kvh * gridDim.y + rt;
  if (tid == 0) *last = atomicAdd(ticket, 1) == n_live - 1;
  mx::named_barrier(1, kThreads);
  if (!*last) return;
  __threadfence();

  // The last CTA of the tile: combine the live chunks in chunk order.  Each
  // row's factors f_s = e^(m_s - M) and 1 / sum_s l_s f_s first, into shared
  // memory (the decoded tiles, free now), then every column of the row, its
  // chunks' partials added in chunk order.
  const int n_use = (fault & kFaultDropLast) ? n_live - 1 : n_live;
  const int rows_here = min(kRows, rows_total - row_base);
  const long long base = (long long)kvh * n_chunks * rows_total + row_base;
  constexpr int kFr = 2 * kMaxChunks + 1;       // a row's factors: m_s then f_s, l_s, 1 / l
  float* fac = reinterpret_cast<float*>(smem);  // [kRows][kFr]
  for (int e = tid; e < rows_here * n_use; e += kThreads) {
    const int r = e / n_use, sc = e % n_use;
    const float2 msl = __ldcg(reinterpret_cast<const float2*>(ml + 2 * (base + (long long)sc * rows_total + r)));
    fac[r * kFr + sc] = msl.x;
    fac[r * kFr + kMaxChunks + sc] = msl.y;
  }
  mx::named_barrier(1, kThreads);
  if (tid < rows_here) {
    float* fr = fac + tid * kFr;
    float m_all = kNegInf;
    for (int sc = 0; sc < n_use; ++sc) m_all = fmaxf(m_all, fr[sc]);
    float l = 0.f;
    for (int sc = 0; sc < n_use; ++sc) {
      const float f = expf(fr[sc] - m_all);
      l = __fadd_rn(l, __fmul_rn(fr[kMaxChunks + sc], f));
      fr[sc] = f;
    }
    fr[2 * kMaxChunks] = 1.f / (l == 0.f ? 1.f : l);
  }
  mx::named_barrier(1, kThreads);
  // A thread takes four columns of rows r0, r0 + 4, ...: its (row, chunk)
  // partials row by row, each row's in chunk order, kBatch loads in flight.
  constexpr int kBatch = 16, kRowStep = kThreads / (kD / 4);
  const int col = 4 * (tid % (kD / 4)), r0 = tid / (kD / 4);
  const int items = r0 < rows_here ? (rows_here - r0 + kRowStep - 1) / kRowStep * n_use : 0;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < items; i0 += kBatch) {
    float4 p[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u, r = r0 + (i / n_use) * kRowStep, sc = i % n_use;
      if (i < items) p[u] = __ldcg(reinterpret_cast<const float4*>(ws + (base + (long long)sc * rows_total + r) * kD + col));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u, r = r0 + (i / n_use) * kRowStep, sc = i % n_use;
      if (i >= items) break;
      const float f = fac[r * kFr + sc];
      if (sc == 0) a = make_float4(0.f, 0.f, 0.f, 0.f);
      a.x = __fadd_rn(a.x, __fmul_rn(p[u].x, f));
      a.y = __fadd_rn(a.y, __fmul_rn(p[u].y, f));
      a.z = __fadd_rn(a.z, __fmul_rn(p[u].z, f));
      a.w = __fadd_rn(a.w, __fmul_rn(p[u].w, f));
      if (sc == n_use - 1) {
        const float inv = fac[r * kFr + 2 * kMaxChunks];
        const int rr = row_base + r, si = rr / G, gi = rr % G;
        uint16_t* orow = out + (((long long)ib * hq + ih * G + gi) * sq_stride + si) * kD + col;
        *reinterpret_cast<uint2*>(orow) = make_uint2(pack_bf16(__fmul_rn(a.x, inv), __fmul_rn(a.y, inv)),
                                                     pack_bf16(__fmul_rn(a.z, inv), __fmul_rn(a.w, inv)));
      }
    }
  }
  if (tid == 0) *ticket = 0;
}

template <int E>
cudaError_t run(const void* q, const void* kd, const void* ks, const void* vd, const void* vs, const void* q_off,
                const void* kv_len, void* out, void* ws, void* tickets, int b, int hq, int hkv, int sq, int sq_stride,
                int L, int S, int chunks, float sm_scale, int fault, cudaStream_t stream) {
  using Geom = Geo<E>;
  const uint64_t heads = (uint64_t)b * hkv;
  CUtensorMap tkd, tks, tvd, tvs;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!mx::cached_byte_map(&tkd, kd, heads * Geom::rows, L, kL, Geom::rows, none) ||
      !mx::cached_byte_map(&tvd, vd, heads * Geom::rows, L, kL, Geom::rows, none) ||
      !mx::cached_byte_map(&tks, ks, heads * (kD / 32), L, kL, kD / 32, none) ||
      !mx::cached_byte_map(&tvs, vs, heads * (kD / 32), L, kL, kD / 32, none))
    return cudaErrorInvalidValue;
  const int rows = sq * (hq / hkv);
  auto kernel = rows <= 16 ? attention_dmajor_kernel<E, true> : attention_dmajor_kernel<E, false>;
  const int smem = Geo<E>::bytes + 128;
  static bool attr_set[2] = {false, false};
  if (!attr_set[rows <= 16]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set[rows <= 16] = true;
  }
  dim3 grid(chunks, (rows + kRows - 1) / kRows, b * hkv);
  kernel<<<grid, kThreads, smem, stream>>>(tkd, tks, tvd, tvs, (const uint16_t*)q, (const int*)q_off,
                                                        (const int*)kv_len, (uint16_t*)out, (float*)ws, (int*)tickets,
                                                        hq, hkv, sq, sq_stride, L, S, sm_scale, fault);
  return cudaGetLastError();
}

}  // namespace

// Codes are (b, hkv, d, L) bytes, (b, hkv, d/2, L) for fp4; L % 64 == 0;
// every cache pointer 16-byte aligned.  q and out are (b, hq, sq_stride, d),
// of which this launch takes the first sq positions (q_off names the first
// one's position).  S (the chunk) a multiple of 64; chunks: the grid's
// chunks, ceil(L / S) or, where the caller knows every kv_len, ceil(min(max
// kv_len, L) / S) (at least 1, at most 64).  ws: b * hkv * chunks * sq * (hq
// / hkv) * (d + 2) floats where chunks > 1 (else unread); tickets: b * hkv *
// ceil(sq * hq / hkv / 64) ints, zero (the kernel leaves them zero).  fault:
// 0 (1: the combine drops the last live chunk).
extern "C" int mx_cached_attention_dmajor_launch(const void* q, const void* kd, const void* ks, const void* vd,
                                                 const void* vs, const void* q_off, const void* kv_len, void* out,
                                                 void* ws, void* tickets, int b, int hq, int hkv, int sq,
                                                 int sq_stride, int L, int d, int S, int chunks, float sm_scale,
                                                 int elem, int fault, void* stream) {
  if (d != kD || hkv <= 0 || hq % hkv || L <= 0 || L % kL || S <= 0 || S % kL || chunks < 1 ||
      chunks > (L + S - 1) / S || chunks > kMaxChunks || sq > sq_stride || (long long)b * hkv > 65535 ||
      fault < 0 || fault > 1)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)kd | (uintptr_t)ks | (uintptr_t)vd | (uintptr_t)vs) % 16) return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  if (chunks > 1 && (ws == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case mx::kFp8E4M3:
      return (int)run<mx::kFp8E4M3>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, tickets, b, hq, hkv, sq, sq_stride, L,
                                    S, chunks, sm_scale, fault, s);
    case mx::kFp4E2M1:
      return (int)run<mx::kFp4E2M1>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, tickets, b, hq, hkv, sq, sq_stride, L,
                                    S, chunks, sm_scale, fault, s);
    case mx::kFp6E3M2:
      return (int)run<mx::kFp6E3M2>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, tickets, b, hq, hkv, sq, sq_stride, L,
                                    S, chunks, sm_scale, fault, s);
    case mx::kFp6E2M3:
      return (int)run<mx::kFp6E2M3>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, tickets, b, hq, hkv, sq, sq_stride, L,
                                    S, chunks, sm_scale, fault, s);
    case mx::kInt8:
      return (int)run<mx::kInt8>(q, kd, ks, vd, vs, q_off, kv_len, out, ws, tickets, b, hq, hkv, sq, sq_stride, L, S,
                                 chunks, sm_scale, fault, s);
  }
  return (int)cudaErrorInvalidValue;
}
