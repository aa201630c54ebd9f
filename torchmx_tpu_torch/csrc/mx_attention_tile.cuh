// The cluster kernel of K4 (csrc/mx_attention.cu, seq layout) and K6
// (csrc/mx_attention_dmajor.cu, d-major layout): causal attention of bf16
// queries over an MX KV cache, prefill, chunks and decode alike, with JAX's
// arithmetic at JAX's KV tile.
//
// Replaces torchmx_tpu/ops/pallas_attention.py::_attn_kernel (:115) and
// ::_attn_kernel_dmajor (:490).
//
// Semantics (ops/cuda_attention._online_attention states them in PyTorch):
// q (b, hq, sq, d) bf16, d = 128; row r of a KV head is query position
// r / G, head r % G (G = hq / hkv) and sees positions <= q_off + r / G and
// < kv_len; scores s = (q . k) * sm_scale in fp32 over the decoded cache
// (a position at or past kv_len decodes to 0, so a stale scale of 255 never
// reaches a dot); masked scores -1e30.  JAX walks KV tiles of lt =
// _pick_lt(L) positions (ops/cuda_attention.attention_tile: 256 at L = 256,
// 512 at 1024, 2048 at 8192; the whole cache where no JAX tile divides L),
// and rounds tile t's p = exp(s - m_t) to bf16 against the running maximum
// m_t through the whole of tile t; a row with no visible key gives 0.
//
// What bounds it on an H100: at decode the cache bytes of the visible prefix
// (each code and scale read once per KV head) and, in practice, the latency
// of a CTA's walk; at prefill the two dots.  p of tile t needs the maxima of
// all of tile t and of every earlier tile before its P.V product.  Design,
// from K5's (csrc/mx_attention_chunkdot.cu):
//  1. A thread-block cluster a (row tile, KV head, batch row), its C CTAs
//     splitting the cache into shares of P positions (ops/cuda_attention.
//     attention_share, a function of L alone: a divisor of the tile, or whole
//     consecutive tiles; C = ceil(L / P) <= 8).  Grid (C, row tiles, b hkv),
//     cluster (C, 1, 1).  Each CTA computes its share's scores into shared
//     memory (fp32 [row][position]) and publishes its rows' maxima of each of
//     its tiles; after one cluster barrier it reads the maxima of its tile's
//     other shares and of every earlier tile over distributed shared memory
//     (m_t), then takes p, l and P.V.  A share of several tiles walks them in
//     order, rescaling acc and l by e^(m_{t-1} - m_t) from one to the next.
//     A share longer than kMaxChunk = 2048 positions (L > 16384: 4096 at
//     32768) does not fit shared memory as fp32 scores: the CTA keeps its
//     first chunk of 2048 positions' scores from the maxima's pass and,
//     after the exchange, takes p and P.V chunk by chunk, each later chunk's
//     scores recomputed from K's fills by the same mma chain (the same bits;
//     K's bytes of those chunks read twice).  A row keeps one maximum per
//     JAX tile of its share and, for the chunk in hand, one reference
//     maximum and factor per 64-position sub-tile, so the share grows to
//     kMaxShare = 2^19 positions (L <= 2^22) with the cluster at 8 CTAs.
//     A CTA whose share starts past the tile's visible prefix leaves at
//     once (a cluster barrier waits only for threads that have not exited;
//     staying held the CTA's SM slot through the live CTAs' work, and the
//     64-row tiles' prefill ran 2-4x slower); where the prefix lies in rank
//     0's share, rank 0 computes alone (no barrier, no exchange, the output
//     written from its registers: the same arithmetic, bit for bit).  Where
//     kv_len is a number the wrapper launches only the shares below it.
//  2. The combine runs in the same launch: after a second cluster barrier
//     each live CTA writes its part of the tile's outputs (16-column runs of
//     a row in turn, every share's four floats loaded before any is added)
//     from every live share's (acc, m, l), in rank order: M = max_u m_u,
//     out = (sum_u acc_u e^(m_u - M)) / (sum_u l_u e^(m_u - M)) (a sum of 0
//     taken as 1); a third barrier keeps every CTA's shared memory alive
//     until the others have read it.  No workspace, no atomics.
//  3. Copies: thread 0 issues each 64-position sub-tile of K (then of V) into
//     a ring on full mbarriers (four slots for 16-row tiles, two for 64-row
//     tiles): seq, one 1-D bulk copy of the
//     codes (64 positions x 128 bytes) and one of the scale rows; d-major,
//     2-D TMA boxes of the code rows x 64 positions and of the 4 scale rows
//     (tensor maps over (b hkv dp, L) and (b hkv 4, L)).  Only the sub-tiles
//     of the visible prefix are loaded; V's first fills land during the
//     exchange.
//  4. The eight warps decode each landed sub-tile once into a bf16 tile in the
//     codes' own layout (seq [position][d], d-major [d][position]) by integer
//     ops and one bf16 multiply a pair where the scale is safe (mx::
//     decode_fast), else the exact decode: the same bits either way.
//  5. Dots on mma.sync m16n8k16 (bf16, fp32 sums), eight warps, in two
//     layouts of the same per-element arithmetic: wide (64-row tiles, where
//     the share's scores fit: L <= 2048), warp w rows 16 (w % 4) .. + 15 and
//     half w / 4 of a sub-tile's positions (q.K^T) and of the output columns
//     (P.V); narrow (16-row tiles: decode, and prefill at longer caches),
//     warp w positions 8 w .. 8 w + 7 of a sub-tile and output columns
//     16 w .. 16 w + 15.  Eight warps, not four: on an H100 the 64-row tiles
//     fit two CTAs an SM and the decode of a d-major fill is the 16-row
//     tiles' longest phase (tools/phase_profile.py --kernel k4 / k6).  q.K^T's B fragments come as 32-bit
//     loads (seq) or ldmatrix.trans (d-major), P.V's the other way round, so
//     both layouts feed the same values to the same mma sequence: s chains
//     its 8 k16 steps over d in order, acc its k16 steps over positions in
//     order, and l sums each 16 positions as one tree and the groups in
//     order.  A row's bytes therefore depend on its own query position,
//     q_off, kv_len and L only: not on b, sq, the other rows of its tile,
//     the layout of the cache or whether kv_len is a number, and K6 equals K4
//     bit for bit on the same cache content.
#pragma once

#include <type_traits>

#include "mx_common.cuh"
#include "mx_wgmma.cuh"
#include "mx_wgmma_decode.cuh"

// Internal linkage: each layout's source, and each diagnostic build of one
// (tools/phase_profile.py), holds its own copy.
namespace mx_tile {
namespace {

using namespace mx;

constexpr int kD = 128;           // head_dim
constexpr int kSub = 64;          // positions of a sub-tile: a ring fill and a decoded tile
constexpr int kThreads = 256;     // eight warps; thread 0 also issues the copies
// Ring slots: four for 16-row tiles, two for 64-row tiles (whose scores
// take the room).  The per-fill work at decode is short beside a copy's
// latency, so fills must be in flight well ahead.
template <bool kWide> __host__ __device__ constexpr int stages() { return kWide ? 2 : 4; }
// The warps' parts of a row's positions at q.K^T (and of its columns at
// P.V): two in 64-row tiles (four row groups of 16), eight in 16-row tiles.
template <bool kWide> __host__ __device__ constexpr int parts() { return kWide ? 2 : 8; }
constexpr int kMaxCluster = 8;    // shares of a cache at most (CTAs a cluster)
constexpr int kMaxChunk = 2048;   // positions whose scores a 16-row tile holds in shared memory at once
constexpr int kMaxShare = 1 << 19;  // positions of a share at most (its tiles' maxima fit shared memory)
constexpr int kWideShare = 256;   // positions of a share at most for 64-row tiles (their scores all held)
constexpr int kLdR = kD + 8;      // floats of a row of the published acc
constexpr int kSmemMax = 232448;  // dynamic shared memory a CTA may take on an H100
constexpr float kNegInf = -1e30f;
constexpr int kFaultSubTileMax = 1;  // planted fault: p rounded against the 64-position running maximum
constexpr int kFaultDropLast = 2;    // planted fault: the combine leaves out the last live share
enum { kSeq = 0, kDmajor = 1 };

// A layout's and format's fill: the codes of one 64-position sub-tile and
// their scales; the decoded bf16 tile.
template <int Lay, int E> struct Fmt {
  static constexpr int code_rows = (Lay == kDmajor && E == kFp4E2M1) ? kD / 2 : kD;  // d-major rows a head
  static constexpr int codes = kSub * code_rows;                                     // bytes
  static constexpr int scales = kSub * (kD / 32);
  static constexpr int stage = codes + scales;
  static constexpr int ld = Lay == kSeq ? kD + 8 : kSub + 8;  // bf16 row stride of the decoded tile
  static constexpr int tile = (Lay == kSeq ? kSub : kD) * ld * 2;
  static_assert(stage % 128 == 0 && codes % 128 == 0 && tile % 128 == 0, "TMA destinations");
};

// Byte offsets of the dynamic shared memory (from a 128-byte aligned base)
// for R rows (whose positions the warps split in `parts`), shares of P
// positions holding kt tiles whose scores are held Pc at a time, a ring of
// n_stages slots: the ring, the decoded tile, the scores (then p, then the
// published acc), the 16-position sums of p, the per-row statistics and the
// barriers.  A row keeps one maximum per JAX tile of the share and, for the
// chunk of Pc positions in hand, one reference maximum and factor per
// sub-tile: nothing grows with the share but the tiles' maxima (4 bytes a
// row and tile), so a share of kMaxShare positions fits.
struct Smem {
  int tile, s, g, pub, msh, lsh, mref, alf, pm, pmax, wgt, div, bar, total;
  __host__ __device__ Smem(int stage, int n_stages, int tile_bytes, int R, int parts, int P, int Pc, int kt) {
    const int nsc = Pc / kSub;
    tile = n_stages * stage;  // the ring's slots from 0
    s = tile + tile_bytes;
    g = s + 4 * R * (Pc + 8 > kLdR ? Pc + 8 : kLdR);
    pub = g + 4 * R * (Pc / 16);   // [R][kt] the share's tiles' maxima (read by the cluster)
    msh = pub + 4 * R * kt;        // [R] the running maximum; at the end the one acc and l are taken
                                   // against (read by the cluster)
    lsh = msh + 4 * R;             // [R] l (read by the cluster)
    mref = lsh + 4 * R;            // [R][nsc] the maximum each sub-tile of the chunk takes its p against
    alf = mref + 4 * R * nsc;      // [R][nsc] e^(mref[j-1] - mref[j])
    pm = alf + 4 * R * nsc;        // [2][parts][R] the warps' maxima of the last two sub-tiles
    pmax = pm + 8 * parts * R;     // [R][nsc] the rows' maxima of the chunk's sub-tiles (the planted fault's)
    wgt = pmax + 4 * R * nsc;      // [kMaxCluster][R] the combine's weights
    div = wgt + 4 * kMaxCluster * R;  // [R] the combine's divisor
    bar = (div + 4 * R + 7) & ~7;  // full[n_stages]
    total = bar + 8 * n_stages;
  }
};

// Positions whose scores a CTA holds at once: the whole share, or chunks of
// kMaxChunk positions of a longer one (16-row tiles only: a 64-row tile's
// share is at most kWideShare).  A kernel that takes shares in chunks is
// built apart (kChunked): the recompute's registers, live beside acc, made
// the 16-row tiles spill where it shared their build.
__host__ __device__ constexpr int chunk_of(int P) { return P <= kMaxChunk ? P : kMaxChunk; }

// Four floats from another CTA's shared memory (16-byte aligned).
__device__ __forceinline__ float4 ld_cluster_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 codes of one scale (a seq run: consecutive d of one position) -> 16 bf16
// at dst; all 0 where the position is hidden.
template <int E>
__device__ __forceinline__ void decode_run(uint16_t* dst, uint4 cw, int se, bool live) {
  const uint32_t c[4] = {cw.x, cw.y, cw.z, cw.w};
  uint32_t o[8];
  if (live && scale_safe<E>(se)) {
    const float sf = __uint_as_float((uint32_t)se << 23), sneg = -8388736.0f * sf;  // -(2^23 + 128) 2^(se-127)
    const uint32_t sc2 = (uint32_t)(se + 127 - Elem<E>::bias) * 0x00800080u;      // bf16x2 2^(se - bias)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t x02 = decode_fast<E>(c[w], 0, sf, sneg, sc2), x13 = decode_fast<E>(c[w], 1, sf, sneg, sc2);
      o[2 * w] = __byte_perm(x02, x13, 0x5410);
      o[2 * w + 1] = __byte_perm(x02, x13, 0x7632);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      const uint32_t lo = live ? decode_bf16_bits<E>((c[j / 4] >> (8 * (j % 4))) & 0xFF, se) : 0u;
      const uint32_t hi = live ? decode_bf16_bits<E>((c[j / 4] >> (8 * (j % 4 + 1))) & 0xFF, se) : 0u;
      o[j / 2] = lo | (hi << 16);
    }
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// Whether all four scale bytes of w are safe for the fast decode.
template <int E>
__device__ __forceinline__ bool all_safe(uint32_t w) {
  return __vcmpleu4(__vsub4(w, 0x10101010u), (safe_hi<E>() - kSafeLo) * 0x01010101u) == 0xFFFFFFFFu;
}

// Codes hi and 2 + hi of word r (positions hi and 2 + hi), each at its own
// scale byte of sw, as bf16x2: decode_fast's arithmetic with a scale a lane.
template <int E>
__device__ __forceinline__ uint32_t decode_pair(uint32_t r, uint32_t sw, int hi) {
  if constexpr (E == kInt8) {
    const uint32_t u = r ^ 0x80808080u;
    const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + hi));
    const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442 + hi));
    const float sa = __uint_as_float(((sw >> (8 * hi)) & 0xFF) << 23);
    const float sb = __uint_as_float(((sw >> (16 + 8 * hi)) & 0xFF) << 23);
    return __byte_perm(__float_as_uint(fmaf(a, sa, -8388736.0f * sa)), __float_as_uint(fmaf(b, sb, -8388736.0f * sb)),
                       0x7632);
  } else {
    const uint32_t s16 = __byte_perm(sw, 0u, 0x4240 + 0x101 * hi);
    const uint32_t scale2 = (s16 + (uint32_t)(127 - Elem<E>::bias) * 0x00010001u) << 7;  // 2^(se - bias) a lane
    return decode_fast<E>(r, hi, 0.f, 0.f, scale2);
  }
}

// 16 positions of one d-major code row (codes cw, fp4: the high nibbles with
// `high`, else the low ones; their scales sw) -> 16 bf16 at dst; positions
// from `live` on decode to 0: their codes are taken as 0 at the scale 2^0,
// which the fast decode turns into +0 as the exact one does, so a segment
// that the prefix ends in still takes the fast decode.
template <int E>
__device__ __forceinline__ void decode_segment(uint16_t* dst, uint4 cw, uint4 sw, int live, bool high) {
  uint32_t c[4] = {cw.x, cw.y, cw.z, cw.w}, s[4] = {sw.x, sw.y, sw.z, sw.w};
  if (live < 16) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int n = min(max(live - 4 * w, 0), 4);  // live bytes of word w
      const uint32_t keep = n == 4 ? 0xFFFFFFFFu : (1u << (8 * n)) - 1u;
      c[w] &= keep;
      s[w] = (s[w] & keep) | (0x7F7F7F7Fu & ~keep);
    }
  }
  uint32_t o[8];
  if (all_safe<E>(s[0]) && all_safe<E>(s[1]) && all_safe<E>(s[2]) && all_safe<E>(s[3])) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t r = (E == kFp4E2M1 && high) ? c[w] >> 4 : c[w];
      const uint32_t x02 = decode_pair<E>(r, s[w], 0), x13 = decode_pair<E>(r, s[w], 1);
      o[2 * w] = __byte_perm(x02, x13, 0x5410);
      o[2 * w + 1] = __byte_perm(x02, x13, 0x7632);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      uint32_t v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int code = (c[(j + i) / 4] >> (8 * ((j + i) % 4))) & 0xFF;
        if (E == kFp4E2M1) code = high ? code >> 4 : code & 0xF;
        const int se = (s[(j + i) / 4] >> (8 * ((j + i) % 4))) & 0xFF;
        v[i] = j + i < live ? decode_one<E>(code, se) : 0u;
      }
      o[j / 2] = v[0] | (v[1] << 16);
    }
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// A landed fill (the sub-tile at positions pos0 ..) into the bf16 tile T;
// positions at or past kv_len as 0.
template <int Lay, int E>
__device__ __forceinline__ void decode_fill(const uint8_t* st, uint16_t* T, int pos0, int kv_len, int tid) {
  using F = Fmt<Lay, E>;
  if constexpr (Lay == kSeq) {  // st: [position][d] codes, then [position][d/32] scales; T [position][d]
#pragma unroll 2
    for (int i = tid; i < kSub * (kD / 16); i += kThreads) {
      const int p = i / (kD / 16), seg = i % (kD / 16);
      const uint4 cw = *reinterpret_cast<const uint4*>(st + p * kD + seg * 16);
      decode_run<E>(T + p * F::ld + seg * 16, cw, st[F::codes + p * (kD / 32) + seg / 2], pos0 + p < kv_len);
    }
  } else {  // st: [code row][position], then [d/32][position]; T [d][position]
    const int live0 = kv_len - pos0;
#pragma unroll 2
    for (int i = tid; i < F::code_rows * (kSub / 16); i += kThreads) {
      const int crow = i / (kSub / 16), seg = i % (kSub / 16);
      const uint4 cw = *reinterpret_cast<const uint4*>(st + crow * kSub + seg * 16);
      const uint8_t* sc = st + F::codes + seg * 16;
      const int live = min(max(live0 - seg * 16, 0), 16);
      if constexpr (E == kFp4E2M1) {
        const uint4 sh = *reinterpret_cast<const uint4*>(sc + (crow / 32) * kSub);
        const uint4 sl = *reinterpret_cast<const uint4*>(sc + (crow / 32 + kD / 64) * kSub);
        decode_segment<E>(T + crow * F::ld + seg * 16, cw, sh, live, true);
        decode_segment<E>(T + (crow + kD / 2) * F::ld + seg * 16, cw, sl, live, false);
      } else {
        const uint4 sw = *reinterpret_cast<const uint4*>(sc + (crow / 32) * kSub);
        decode_segment<E>(T + crow * F::ld + seg * 16, cw, sw, live, false);
      }
    }
  }
}

// q.K^T's B fragments (k16 step kk over d, n8 block jj of positions) from
// the decoded K tile: b0 = K[8 jj + g][16 kk + 2t ..], b1 = .. + 8.
template <int Lay>
__device__ __forceinline__ void k_frag(uint32_t (&b)[2], const uint16_t* T, int jj, int kk, int lane) {
  if constexpr (Lay == kSeq) {
    const uint16_t* p = T + (8 * jj + lane / 4) * (kD + 8) + 16 * kk + 2 * (lane % 4);
    b[0] = *reinterpret_cast<const uint32_t*>(p);
    b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
  } else {
    ldmatrix_x2_trans(b, T + (16 * kk + (lane & 15)) * (kSub + 8) + 8 * jj);
  }
}

// P.V's B fragments (k16 step kk over positions, n8 block jn of d) from the
// decoded V tile: b0 = V[16 kk + 2t ..][8 jn + g], b1 = V[16 kk + 2t + 8 ..][..].
template <int Lay>
__device__ __forceinline__ void v_frag(uint32_t (&b)[2], const uint16_t* T, int jn, int kk, int lane) {
  if constexpr (Lay == kSeq) {
    ldmatrix_x2_trans(b, T + (16 * kk + (lane & 15)) * (kD + 8) + 8 * jn);
  } else {
    const uint16_t* p = T + (8 * jn + lane / 4) * (kSub + 8) + 16 * kk + 2 * (lane % 4);
    b[0] = *reinterpret_cast<const uint32_t*>(p);
    b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
  }
}

// Fill f of a CTA's sequence into ring slot f % kStages: K's sub-tiles 0 ..
// nt - 1 (the scores' pass), then chunk by chunk (nsc sub-tiles) V's
// sub-tiles, each chunk past the first preceded by K's sub-tiles again (its
// scores recomputed).  The share starts at position t0 of (batch row, KV
// head) kvh; full / sbase: the ring's barriers and slots.
template <int Lay, int E, int kStages>
__device__ __forceinline__ void issue_fill(int f, int nt, int nsc, int t0, int kvh, int L, uint32_t full,
                                           uint32_t sbase, const CUtensorMap* tkd, const CUtensorMap* tks,
                                           const CUtensorMap* tvd, const CUtensorMap* tvs, const uint8_t* kd,
                                           const uint8_t* ks, const uint8_t* vd, const uint8_t* vs) {
  using F = Fmt<Lay, E>;
  const int n0 = min(nt, nsc);
  bool v = f >= nt;
  int sub = v ? f - nt : f;
  if (f >= nt + n0) {
    const int i = f - nt - n0, base = (1 + i / (2 * nsc)) * nsc, k = i % (2 * nsc), cnt = min(nsc, nt - base);
    v = k >= cnt;
    sub = base + (v ? k - cnt : k);
  }
  const int slot = f % kStages, pos = t0 + sub * kSub;
  const uint32_t bar = full + 8 * slot, dst = sbase + slot * F::stage;
  mbar_expect_tx(bar, F::stage);
  if constexpr (Lay == kSeq) {
    const long long row = (long long)kvh * L + pos;
    bulk_load(dst, (v ? vd : kd) + row * kD, F::codes, bar);
    bulk_load(dst + F::codes, (v ? vs : ks) + row * (kD / 32), F::scales, bar);
  } else {
    tma_load_2d(dst, v ? tvd : tkd, bar, pos, kvh * F::code_rows);
    tma_load_2d(dst + F::codes, v ? tvs : tks, bar, pos, kvh * (kD / 32));
  }
}

// Fill f (the sub-tile at positions pos0 ..) waited for and decoded into T;
// its slot is free after the barrier.
template <int Lay, int E, int kStages>
__device__ __forceinline__ void take_fill(uint32_t full, const uint8_t* smem, uint16_t* T, int f, int pos0, int kv_len,
                                          int tid) {
  const int slot = f % kStages;
  mbar_wait(full + 8 * slot, (f / kStages) & 1);
  decode_fill<Lay, E>(smem + slot * Fmt<Lay, E>::stage, T, pos0, kv_len, tid);
  named_barrier(1, kThreads);  // the tile decoded, its slot free
}

// q's A fragment of k16 step kk for the thread's rows (row and row + 8 of
// the call, 0 past rows_total; qidx: their q offsets).
__device__ __forceinline__ void load_q_step(uint32_t (&a)[4], const uint16_t* __restrict__ q,
                                            const long long (&qidx)[2], int row, int rows_total, int t, int kk) {
  const int col = kk * 16 + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < rows_total;
    a[h] = ok ? *reinterpret_cast<const uint32_t*>(q + qidx[h] + col) : 0u;
    a[2 + h] = ok ? *reinterpret_cast<const uint32_t*>(q + qidx[h] + col + 8) : 0u;
  }
}

// s = (q . k) * sm_scale of the decoded K sub-tile at positions pos0 .. for
// the warp's part hf of them and the thread's rows (S rows srow and srow +
// 8, query positions qpos), masked to -1e30, into S at column col + its
// position where `keep`; the rows' maxima over the part into mloc.  q's
// fragments held in qa (kHeldQ), or loaded for each k16 step (a recomputed
// chunk: fewer registers live beside acc).  The same mma chain each time it
// runs on a sub-tile: a recomputed score has the same bits.
template <int Lay, bool kWide, bool kHeldQ>
__device__ __forceinline__ void sub_tile_scores(const uint32_t (*qa)[4], const uint16_t* __restrict__ q,
                                                const long long (&qidx)[2], int qrow, int rows_total,
                                                const uint16_t* T, float* S, int ldS, int srow, int col, int pos0,
                                                bool keep, const int (&qpos)[2], int kv_len, float sm_scale, int hf,
                                                int lane, float (&mloc)[2]) {
  constexpr int kNJ = kSub / 8 / parts<kWide>();  // n8 blocks of positions a warp
  const int jj0 = kNJ * hf, t = lane % 4;
  mloc[0] = mloc[1] = kNegInf;
#pragma unroll
  for (int jj = 0; jj < kNJ; ++jj) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4], b[2];
      if constexpr (kHeldQ) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qa[kk][i];
      } else {
        load_q_step(a, q, qidx, qrow, rows_total, t, kk);
      }
      k_frag<Lay>(b, T, jj0 + jj, kk, lane);
      mma_bf16_16816(s, a, b);
    }
    const int c = 8 * (jj0 + jj) + 2 * t;  // the sub-tile position of s[0]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = pos0 + c + e;
        v[e] = pos <= qpos[h] && pos < kv_len ? s[2 * h + e] * sm_scale : kNegInf;
        mloc[h] = fmaxf(mloc[h], v[e]);
      }
      if (keep) *reinterpret_cast<float2*>(S + (srow + 8 * h) * ldS + col + c) = make_float2(v[0], v[1]);
    }
  }
}

// Row r's mref and alf for the sub-tiles c0 .. c0 + cnt - 1 of its share (a
// chunk), the running maximum carried from chunk to chunk in msh[r]: m steps
// up to its JAX tile's maximum (pub) where a sub-tile starts a tile, or, under
// the planted fault, to each sub-tile's own maximum (pmax, the chunk's).
__device__ __forceinline__ void chunk_refs(float* mref, float* alf, float* msh, const float* pmax, const float* pub,
                                           int r, int c0, int cnt, int nsc, int kt, int lt, bool sub_max) {
  float m = msh[r], prev = m;
  for (int jl = 0; jl < cnt; ++jl) {
    const int j = c0 + jl;
    if (sub_max)
      m = fmaxf(m, pmax[r * nsc + jl]);
    else if (j * kSub % lt == 0 || j == 0)
      m = fmaxf(m, pub[r * kt + j * kSub / lt % kt]);
    mref[r * nsc + jl] = m;
    alf[r * nsc + jl] = j == 0 ? 1.f : expf(prev - m);
    prev = m;
  }
  msh[r] = m;
}

// One CTA of the cluster kernel.  Grid (C shares, row tiles, b hkv), cluster
// (C, 1, 1), kThreads threads.  q / out (b, hq, sq, d); codes and scales
// through kd .. vs (seq) or the tensor maps (d-major); q_off / kv_len: (b,)
// or null and the numbers q_off_n / kv_len_n for every row.  lt: the tile;
// P: the share (lt % P == 0 or P % lt == 0, P % 64 == 0).
template <int Lay, int E, bool kWide, bool kChunked>
__device__ __forceinline__ void tile_attention(const CUtensorMap* tkd, const CUtensorMap* tks, const CUtensorMap* tvd,
                                               const CUtensorMap* tvs, const uint8_t* __restrict__ kd,
                                               const uint8_t* __restrict__ ks, const uint8_t* __restrict__ vd,
                                               const uint8_t* __restrict__ vs, const uint16_t* __restrict__ q,
                                               const int* __restrict__ q_off_p, const int* __restrict__ kv_len_p,
                                               int q_off_n, int kv_len_n, uint16_t* __restrict__ out, int hq,
                                               int hkv, int sq, int L, int lt, int P, float sm_scale, int fault) {
  using F = Fmt<Lay, E>;
  constexpr int R = kWide ? 64 : 16;  // rows of the CTA
  const int rank = blockIdx.x, rt = blockIdx.y, kvh = blockIdx.z;
  const int ib = kvh / hkv, ih = kvh % hkv, G = hq / hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  const int rows_total = sq * G, row_base = rt * R, rows_here = min(R, rows_total - row_base);
  const int q_off = q_off_p ? q_off_p[ib] : q_off_n, kv_len = kv_len_p ? kv_len_p[ib] : kv_len_n;
  // The tile's visible prefix: positions past its last query or at/after kv_len are dead.
  const int kv_end = max(min(min(kv_len, q_off + (row_base + rows_here - 1) / G + 1), L), 0);
  const int live = max((kv_end + P - 1) / P, 1);  // shares with a visible position (rank 0 at least)
  // A CTA past the visible prefix leaves at once (a cluster barrier waits
  // for the threads that have not exited; no CTA reads its shared memory),
  // so that a cluster holds no idle CTA.  Where the prefix lies in rank 0's
  // share, rank 0 computes alone: no barrier, no exchange.
  if (rank >= live) return;
  const bool alone = live == 1;
  constexpr int kStages = stages<kWide>();
  const int Pc = kChunked ? kMaxChunk : P, nsc = Pc / kSub;  // positions (sub-tiles) whose scores S holds at once
  const int kt = P > lt ? P / lt : 1, ldS = Pc + 8;
  const int t0 = rank * P;
  const int nvis = min(max(kv_end - t0, 0), P);  // visible positions of the share
  const int nt = (nvis + kSub - 1) / kSub;       // its sub-tiles, of K and then of V
  const int n0 = min(nt, nsc);                   // those of its first chunk
  const int n_fills = nt + n0 + 2 * (nt - n0);   // K's, V's, and K's again for each chunk past the first

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 127) & ~127u) - raw_addr);
  const uint32_t sbase = smem_addr(smem);
  constexpr int kParts = parts<kWide>();
  const Smem lay(F::stage, kStages, F::tile, R, kParts, P, Pc, kt);
  const uint32_t full = sbase + lay.bar;
  uint16_t* T = reinterpret_cast<uint16_t*>(smem + lay.tile);
  float* S = reinterpret_cast<float*>(smem + lay.s);
  float* gsum = reinterpret_cast<float*>(smem + lay.g);
  float* pub = reinterpret_cast<float*>(smem + lay.pub);
  float* msh = reinterpret_cast<float*>(smem + lay.msh);
  float* lsh = reinterpret_cast<float*>(smem + lay.lsh);
  float* mref = reinterpret_cast<float*>(smem + lay.mref);
  float* alf = reinterpret_cast<float*>(smem + lay.alf);
  float* pm = reinterpret_cast<float*>(smem + lay.pm);
  float* pmax = reinterpret_cast<float*>(smem + lay.pmax);
  float* wgt = reinterpret_cast<float*>(smem + lay.wgt);
  float* dv = reinterpret_cast<float*>(smem + lay.div);

#define MX_TILE_ISSUE(f) \
  issue_fill<Lay, E, kStages>(f, nt, nsc, t0, kvh, L, full, sbase, tkd, tks, tvd, tvs, kd, ks, vd, vs)
  if (tid == 0) {
    if constexpr (Lay == kDmajor)
      for (const CUtensorMap* m : {tkd, tks, tvd, tvs})
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    mbar_init_fence();
    for (int f = 0; f < min(n_fills, kStages); ++f) MX_TILE_ISSUE(f);
  }
  __syncthreads();
  int next = 0;  // the next fill of the sequence the CTA takes

  // The thread's rows: g and g + 8 of its warp's 16-row group (wide: rows
  // 16 (w % 4) ..; narrow: the CTA's 16), clamped to a real row; its part hf
  // of the group's positions and columns (wide: w / 4 of two; narrow: w).
  const int wrow = kWide ? 16 * (warp % 4) : 0, hf = kWide ? warp / 4 : warp;
  int qpos[2];
  long long qidx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = min(row_base + wrow + g + 8 * h, rows_total - 1), si = r / G, gi = r % G;
    qpos[h] = q_off + si;
    qidx[h] = (((long long)ib * hq + ih * G + gi) * sq + si) * kD;
  }

  // 1. Scores into S [row][position] (the first chunk's; a longer share's
  // other chunks are recomputed in step 3); each row's maximum over each
  // sub-tile (the warps' parts through a ring of two in pm) into the maximum
  // of its JAX tile, pub, and for the first chunk into pmax.
  if (tid < rows_here)
    for (int ti = 0; ti < kt; ++ti) pub[tid * kt + ti] = kNegInf;
  {
    uint32_t qa[kD / 16][4];
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) load_q_step(qa[kk], q, qidx, row_base + wrow + g, rows_total, t, kk);
    for (int j = 0; j < nt; ++j, ++next) {
      take_fill<Lay, E, kStages>(full, smem, T, next, t0 + j * kSub, kv_len, tid);
      if (tid == 0 && next + kStages < n_fills) MX_TILE_ISSUE(next + kStages);
      float mloc[2];
      sub_tile_scores<Lay, kWide, true>(qa, q, qidx, row_base + wrow + g, rows_total, T, S, ldS, wrow + g, j * kSub,
                                        t0 + j * kSub, j < nsc, qpos, kv_len, sm_scale, hf, lane, mloc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mloc[h] = fmaxf(mloc[h], __shfl_xor_sync(0xffffffffu, mloc[h], 1));
        mloc[h] = fmaxf(mloc[h], __shfl_xor_sync(0xffffffffu, mloc[h], 2));
        if (t == 0) pm[((j & 1) * kParts + hf) * R + wrow + g + 8 * h] = mloc[h];
      }
      named_barrier(1, kThreads);  // the tile read, the warps' maxima written
      if (tid < rows_here) {
        float x = pm[(j & 1) * kParts * R + tid];
#pragma unroll
        for (int w = 1; w < kParts; ++w) x = fmaxf(x, pm[((j & 1) * kParts + w) * R + tid]);
        if (j < nsc) pmax[tid * nsc + j] = x;
        float& mt = pub[tid * kt + (kt > 1 ? j * kSub / lt : 0)];
        mt = fmaxf(mt, x);
      }
    }
  }

  // 2. The share's tiles' maxima are published in pub; one cluster barrier;
  // then the running maximum before the share (base: the maxima of the
  // tile's other shares and of every earlier tile, read from their CTAs'
  // shared memory) and, a chunk at a time (chunk_refs), for each sub-tile j
  // the maximum its p is taken against (mref: m_t of its JAX tile; the
  // planted fault: the running maximum through the sub-tile) and alf, acc's
  // and l's factor from j - 1.  The running maximum is carried in msh.
  if (!alone) cluster_sync();  // 1: the shares' maxima
  const bool sub_max = fault & kFaultSubTileMax;
#define MX_TILE_CHUNK_REFS(r, c0, cnt) chunk_refs(mref, alf, msh, pmax, pub, r, c0, cnt, nsc, kt, lt, sub_max)
  if (tid < rows_here) {
    const int r = tid;
    const int my_tile = t0 / lt;
    float base = kNegInf;
    for (int u = 0; u < live; ++u) {  // the shares past the prefix are left out
      if (u == rank || (sub_max ? u > rank : u * P / lt > my_tile)) continue;
      const int n = u * P / lt < my_tile || sub_max ? kt : 1;  // a share of an earlier tile: all its tiles
      for (int ti = 0; ti < n; ++ti)
        base = fmaxf(base, ld_cluster_f32(cluster_addr(sbase + lay.pub + 4 * (r * kt + ti), u)));
    }
    msh[r] = nt > 0 ? base : kNegInf;
    MX_TILE_CHUNK_REFS(r, 0, n0);
  }
  named_barrier(1, kThreads);

  // 3-4, chunk by chunk (one chunk unless the share is longer than
  // kMaxChunk): a chunk past the first gets its scores again from K's fills
  // (and, under the planted fault, its sub-tiles' maxima), then its mref and alf;
  // p = exp(s - mref) in place (0 where masked), each 16 positions' sum as
  // one tree; then l, the groups in order, against msh; then P.V: A = bf16(p)
  // of the warp's 16 rows from S, B the decoded V tile, acc rescaled by alf
  // where a sub-tile starts another JAX tile (or, under the planted fault,
  // another running maximum).  The rows past the call's are left as they are
  // (their outputs are never written).
  constexpr int kNJ = kD / 8 / kParts;  // n8 blocks of columns a warp
  const int jn0 = kNJ * hf;
  float acc[kNJ][4];
#pragma unroll
  for (int jn = 0; jn < kNJ; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
  const bool rescale = kt > 1 || (fault & kFaultSubTileMax);
  for (int c0 = 0; c0 < nt; c0 += nsc) {
    const int cnt = min(nsc, nt - c0);
    if constexpr (kChunked) {
      for (int jl = 0; c0 > 0 && jl < cnt; ++jl, ++next) {
        const int pos0 = t0 + (c0 + jl) * kSub;
        take_fill<Lay, E, kStages>(full, smem, T, next, pos0, kv_len, tid);
        if (tid == 0 && next + kStages < n_fills) MX_TILE_ISSUE(next + kStages);
        float mloc[2];
        sub_tile_scores<Lay, kWide, false>(nullptr, q, qidx, row_base + wrow + g, rows_total, T, S, ldS, wrow + g,
                                           jl * kSub, pos0, true, qpos, kv_len, sm_scale, hf, lane, mloc);
        if (sub_max) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mloc[h] = fmaxf(mloc[h], __shfl_xor_sync(0xffffffffu, mloc[h], 1));
            mloc[h] = fmaxf(mloc[h], __shfl_xor_sync(0xffffffffu, mloc[h], 2));
            if (t == 0) pm[((jl & 1) * kParts + hf) * R + wrow + g + 8 * h] = mloc[h];
          }
        }
        named_barrier(1, kThreads);  // the tile read (and the warps' maxima written)
        if (sub_max && tid < rows_here) {
          float x = pm[(jl & 1) * kParts * R + tid];
          for (int w = 1; w < kParts; ++w) x = fmaxf(x, pm[((jl & 1) * kParts + w) * R + tid]);
          pmax[tid * nsc + jl] = x;
        }
      }
      if (c0 > 0) {
        if (tid < rows_here) MX_TILE_CHUNK_REFS(tid, c0, cnt);
        named_barrier(1, kThreads);  // the chunk's mref and alf
      }
    }
    for (int i = tid; i < rows_here * cnt * 4; i += kThreads) {
      const int r = i / (cnt * 4), grp = i % (cnt * 4);
      const float m = mref[r * nsc + grp / 4];
      float4* row = reinterpret_cast<float4*>(S + r * ldS + grp * 16);
      float part[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = row[k];
        const float4 p = make_float4(v.x == kNegInf ? 0.f : expf(v.x - m), v.y == kNegInf ? 0.f : expf(v.y - m),
                                     v.z == kNegInf ? 0.f : expf(v.z - m), v.w == kNegInf ? 0.f : expf(v.w - m));
        row[k] = p;
        part[k] = (p.x + p.y) + (p.z + p.w);
      }
      gsum[r * (Pc / 16) + grp] = (part[0] + part[1]) + (part[2] + part[3]);
    }
    named_barrier(1, kThreads);
    if (tid < rows_here) {  // l carried from chunk to chunk in lsh
      float l = c0 == 0 ? 0.f : lsh[tid];
      for (int jl = 0; jl < cnt; ++jl) {
        const float* gs = gsum + tid * (Pc / 16) + 4 * jl;
        l = __fadd_rn(__fmul_rn(l, alf[tid * nsc + jl]), (gs[0] + gs[1]) + (gs[2] + gs[3]));
      }
      lsh[tid] = l;
    }
    for (int jl = 0; jl < cnt; ++jl, ++next) {
      const int j = c0 + jl;
      take_fill<Lay, E, kStages>(full, smem, T, next, t0 + j * kSub, kv_len, tid);  // (at jl = 0 also: p and l done)
      if (tid == 0 && next + kStages < n_fills) MX_TILE_ISSUE(next + kStages);
      if (rescale && j > 0) {
        const float a0 = alf[(wrow + g) * nsc + jl], a1 = alf[(wrow + g + 8) * nsc + jl];
#pragma unroll
        for (int jn = 0; jn < kNJ; ++jn) {
          acc[jn][0] = __fmul_rn(acc[jn][0], a0);
          acc[jn][1] = __fmul_rn(acc[jn][1], a0);
          acc[jn][2] = __fmul_rn(acc[jn][2], a1);
          acc[jn][3] = __fmul_rn(acc[jn][3], a1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        const float* p0 = S + (wrow + g) * ldS + jl * kSub + 16 * kk + 2 * t;
        const float* p1 = p0 + 8 * ldS;
        const float2 x0 = *reinterpret_cast<const float2*>(p0), x1 = *reinterpret_cast<const float2*>(p1);
        const float2 y0 = *reinterpret_cast<const float2*>(p0 + 8), y1 = *reinterpret_cast<const float2*>(p1 + 8);
        const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y), pack_bf16(y0.x, y0.y),
                               pack_bf16(y1.x, y1.y)};
#pragma unroll
        for (int jn = 0; jn < kNJ; ++jn) {
          uint32_t b[2];
          v_frag<Lay>(b, T, jn0 + jn, kk, lane);
          mma_bf16_16816(acc[jn], a, b);
        }
      }
      named_barrier(1, kThreads);  // the tile and p read
    }
  }
  if (nt == 0 && tid < rows_here) lsh[tid] = 0.f;
#undef MX_TILE_ISSUE
#undef MX_TILE_CHUNK_REFS

  // 5. Alone: out = acc / l from the registers.  Else acc published (over
  // S: p is spent), then the combine in rank order: the rows' weights
  // e^(m_u - M) and divisor sum_u l_u e^(m_u - M), then this CTA's part of
  // the outputs, a 16-column run of a row to each live CTA in turn; with one
  // share the combine's arithmetic is the alone path's, bit for bit.  The
  // planted fault leaves out the last live share.
  if (alone) {
    named_barrier(1, kThreads);  // l of every row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + g + 8 * h, rr = row_base + r;
      if (r >= rows_here) continue;
      const float l = lsh[r] == 0.f ? 1.f : lsh[r];
      uint16_t* orow = out + (((long long)ib * hq + ih * G + rr % G) * sq + rr / G) * kD + 2 * t;
#pragma unroll
      for (int jn = 0; jn < kNJ; ++jn)
        *reinterpret_cast<uint32_t*>(orow + 8 * (jn0 + jn)) =
            pack_bf16(__fdiv_rn(acc[jn][2 * h], l), __fdiv_rn(acc[jn][2 * h + 1], l));
    }
    return;
  }
  float* rec = S;  // [R][kLdR]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int jn = 0; jn < kNJ; ++jn)
      *reinterpret_cast<float2*>(rec + (wrow + g + 8 * h) * kLdR + 8 * (jn0 + jn) + 2 * t) =
          make_float2(acc[jn][2 * h], acc[jn][2 * h + 1]);
  cluster_sync();  // 2: every share's (acc, m, l)
  const int n_use = (fault & kFaultDropLast) ? live - 1 : live;
  if (tid < rows_here) {
    float M = kNegInf, l = 0.f;
    for (int u = 0; u < n_use; ++u) M = fmaxf(M, ld_cluster_f32(cluster_addr(sbase + lay.msh + 4 * tid, u)));
    for (int u = 0; u < n_use; ++u) {
      const float w = expf(ld_cluster_f32(cluster_addr(sbase + lay.msh + 4 * tid, u)) - M);
      wgt[u * R + tid] = w;
      l = __fadd_rn(l, __fmul_rn(ld_cluster_f32(cluster_addr(sbase + lay.lsh + 4 * tid, u)), w));
    }
    dv[tid] = l == 0.f ? 1.f : l;
  }
  named_barrier(1, kThreads);
  // A thread takes four columns of a row, every share's loaded before any is added.
  for (int i = tid; i < rows_here * (kD / 4); i += kThreads) {
    const int r = i / (kD / 4), e = 4 * (i % (kD / 4));
    if ((r * (kD / 16) + e / 16) % live != rank) continue;
    float4 v[kMaxCluster];
#pragma unroll
    for (int u = 0; u < kMaxCluster; ++u)
      if (u < n_use) v[u] = ld_cluster_f32x4(cluster_addr(sbase + lay.s + 4 * (r * kLdR + e), u));
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < kMaxCluster; ++u)
      if (u < n_use) {
        const float w = wgt[u * R + r];
        a[0] = __fadd_rn(a[0], __fmul_rn(v[u].x, w));
        a[1] = __fadd_rn(a[1], __fmul_rn(v[u].y, w));
        a[2] = __fadd_rn(a[2], __fmul_rn(v[u].z, w));
        a[3] = __fadd_rn(a[3], __fmul_rn(v[u].w, w));
      }
    const int rr = row_base + r;
    const float d = dv[r];
    *reinterpret_cast<uint2*>(out + (((long long)ib * hq + ih * G + rr % G) * sq + rr / G) * kD + e) =
        make_uint2(pack_bf16(__fdiv_rn(a[0], d), __fdiv_rn(a[1], d)), pack_bf16(__fdiv_rn(a[2], d), __fdiv_rn(a[3], d)));
  }
  cluster_sync();  // 3: no CTA leaves while another reads its shared memory
}

// The two layouts' kernels, named apart so that a profile tells K4's device
// time from K6's.  Three CTAs an SM of 16-row tiles (80 registers), two of
// 64-row tiles; a chunked share's CTA takes most of an SM's shared memory,
// so its registers are not capped.
#define MX_TILE_KERNEL_ARGS                                                                                         \
  const __grid_constant__ CUtensorMap tkd, const __grid_constant__ CUtensorMap tks,                                 \
      const __grid_constant__ CUtensorMap tvd, const __grid_constant__ CUtensorMap tvs,                             \
      const uint8_t *__restrict__ kd, const uint8_t *__restrict__ ks, const uint8_t *__restrict__ vd,               \
      const uint8_t *__restrict__ vs, const uint16_t *__restrict__ q, const int *__restrict__ q_off_p,              \
      const int *__restrict__ kv_len_p, int q_off_n, int kv_len_n, uint16_t *__restrict__ out, int hq, int hkv,    \
      int sq, int L, int lt, int P, float sm_scale, int fault
#define MX_TILE_KERNEL_CALL                                                                                         \
  &tkd, &tks, &tvd, &tvs, kd, ks, vd, vs, q, q_off_p, kv_len_p, q_off_n, kv_len_n, out, hq, hkv, sq, L, lt, P,      \
      sm_scale, fault

template <int E, bool kWide, bool kChunked>
__global__ void __launch_bounds__(kThreads, kWide ? 2 : kChunked ? 1 : 3) seq_tile_attention_kernel(MX_TILE_KERNEL_ARGS) {
  tile_attention<kSeq, E, kWide, kChunked>(MX_TILE_KERNEL_CALL);
}

template <int E, bool kWide, bool kChunked>
__global__ void __launch_bounds__(kThreads, kWide ? 2 : kChunked ? 1 : 3) dmajor_tile_attention_kernel(MX_TILE_KERNEL_ARGS) {
  tile_attention<kDmajor, E, kWide, kChunked>(MX_TILE_KERNEL_CALL);
}
#undef MX_TILE_KERNEL_ARGS
#undef MX_TILE_KERNEL_CALL

template <int Lay, int E, bool kWide, bool kChunked>
auto kernel_of() {
  if constexpr (Lay == kSeq)
    return seq_tile_attention_kernel<E, kWide, kChunked>;
  else
    return dmajor_tile_attention_kernel<E, kWide, kChunked>;
}

template <int Lay, int E, bool kWide, bool kChunked>
cudaError_t launch(const CUtensorMap (&maps)[4], const void* q, const void* kd, const void* ks, const void* vd,
                   const void* vs, const void* q_off, const void* kv_len, int q_off_n, int kv_len_n, void* out, int b,
                   int hq, int hkv, int sq, int L, int lt, int P, int ctas, float sm_scale, int fault,
                   cudaStream_t stream) {
  using F = Fmt<Lay, E>;
  constexpr int R = kWide ? 64 : 16;
  auto kernel = kernel_of<Lay, E, kWide, kChunked>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int smem =
      Smem(F::stage, stages<kWide>(), F::tile, R, parts<kWide>(), P, chunk_of(P), P > lt ? P / lt : 1).total +
      128;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, (sq * (hq / hkv) + R - 1) / R, b * hkv);
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
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, maps[0], maps[1], maps[2], maps[3], (const uint8_t*)kd, (const uint8_t*)ks, (const uint8_t*)vd,
      (const uint8_t*)vs, (const uint16_t*)q, (const int*)q_off, (const int*)kv_len, q_off_n, kv_len_n,
      (uint16_t*)out, hq, hkv, sq, L, lt, P, sm_scale, fault);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One launch of the layout's kernel for the format: the checks of both
// entry points, the tensor maps (d-major), the row layout.  Codes (b, hkv,
// L, d) (seq) or (b, hkv, dp, L) (d-major; dp = d / 2 for fp4), scales (b,
// hkv, L, d/32) or (b, hkv, d/32, L); every cache pointer 16-byte aligned; L
// % 64 == 0; q and out (b, hq, sq, d); q_off / kv_len (b,) int32, or null and
// the numbers for every row; lt (the tile) with L % lt == 0; P (the share) a
// multiple of 64 with lt % P == 0 or P % lt == 0, ceil(L / P) <= 8, at most
// kMaxShare (256 where wide); ctas: ceil(L / P) or, where the caller knows every
// kv_len, ceil(min(max kv_len, L) / P) (at least 1); wide: 64-row tiles (sq
// hq / hkv > 16 only).  fault: 0 (bit 1: p rounded against the 64-position
// running maximum; bit 2: the combine leaves out the last live share).
template <int Lay>
int run(const void* q, const void* kd, const void* ks, const void* vd, const void* vs, const void* q_off,
        const void* kv_len, int q_off_n, int kv_len_n, void* out, int b, int hq, int hkv, int sq, int L, int d,
        int lt, int P, int ctas, int wide, float sm_scale, int elem, int fault, cudaStream_t stream) {
  if (d != kD || hkv <= 0 || hq % hkv || L <= 0 || L % kSub || lt <= 0 || L % lt || P <= 0 || P % kSub ||
      (lt % P && P % lt) || P > (wide ? kWideShare : kMaxShare) || (L + P - 1) / P > kMaxCluster || ctas < 1 ||
      ctas > (L + P - 1) / P || (long long)b * hkv > 65535 || (wide && sq * (hq / hkv) <= 16) ||
      (long long)b * hkv * L >= (1ll << 31) || fault < 0 || fault > 3 || (q_off == nullptr) != (kv_len == nullptr) ||
      (sq * (hq / hkv) + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)kd | (uintptr_t)ks | (uintptr_t)vd | (uintptr_t)vs) % 16) return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return 0;
  CUtensorMap maps[4] = {};
  if (Lay == kDmajor) {
    const uint64_t heads = (uint64_t)b * hkv;
    const uint32_t rows = elem == kFp4E2M1 ? kD / 2 : kD;
    const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
    if (!cached_byte_map(&maps[0], kd, heads * rows, L, kSub, rows, none) ||
        !cached_byte_map(&maps[1], ks, heads * (kD / 32), L, kSub, kD / 32, none) ||
        !cached_byte_map(&maps[2], vd, heads * rows, L, kSub, rows, none) ||
        !cached_byte_map(&maps[3], vs, heads * (kD / 32), L, kSub, kD / 32, none))
      return (int)cudaErrorInvalidValue;
  }
#define MX_TILE_LAUNCH(E)                                                                                          \
  return (int)(wide ? launch<Lay, E, true, false>(maps, q, kd, ks, vd, vs, q_off, kv_len, q_off_n, kv_len_n, out, b,  \
                                                  hq, hkv, sq, L, lt, P, ctas, sm_scale, fault, stream)            \
               : P > kMaxChunk                                                                                     \
                   ? launch<Lay, E, false, true>(maps, q, kd, ks, vd, vs, q_off, kv_len, q_off_n, kv_len_n, out, b, \
                                                 hq, hkv, sq, L, lt, P, ctas, sm_scale, fault, stream)             \
                   : launch<Lay, E, false, false>(maps, q, kd, ks, vd, vs, q_off, kv_len, q_off_n, kv_len_n, out, b,\
                                                  hq, hkv, sq, L, lt, P, ctas, sm_scale, fault, stream))
  switch (elem) {
    case kFp8E4M3: MX_TILE_LAUNCH(kFp8E4M3);
    case kFp6E3M2: MX_TILE_LAUNCH(kFp6E3M2);
    case kFp6E2M3: MX_TILE_LAUNCH(kFp6E2M3);
    case kInt8: MX_TILE_LAUNCH(kInt8);
    case kFp4E2M1:
      if constexpr (Lay == kDmajor) MX_TILE_LAUNCH(kFp4E2M1);
      break;
  }
#undef MX_TILE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mx_tile
