// B13 mx_mla_attention: absorbed multi-head latent attention (DeepSeek-V3
// MLA) over the seq-layout latent cache, prefill and decode alike.
//
// Replaces torchmx_tpu/ops/pallas_mla.py::_mla_kernel (:75), launched by
// _mla_cached_attention (:197).
//
// Inputs: q_lat (b, rows, 512) and q_rot (b, rows, 64) bf16, rows = sq * n
// ordered (query position, head); the latent cache (b, L, 512) and the rope
// key cache (b, L, 64): bf16 (no scales), one code per byte (fp8 e4m3, fp6
// e3m2 / e2m3, int8) with (b, L, w/32) uint8 scales, or fp4 halves-packed
// (b, L, w/2) bytes, byte j holding element j (high nibble) and element
// j + w/2 (low nibble); q_off, kv_len (b,) int32.  Output (b, rows, 512)
// bf16:  out = softmax(sm_scale * (q_lat . lat^T + q_rot . rot^T)) . lat,
// row (i, h) seeing positions <= q_off + i and < kv_len; masked scores are
// -1e30; a row with no visible key outputs 0.
//
// The algorithm (ops/cuda_mla.mx_mla_attention_plain computes the same,
// differing in fp32 summation order and the exponential's last bits only:
// the softmax takes __expf): the positions are cut into
// chunks of S (a function of L alone, cuda_mla.mla_chunk), each chunk into
// tiles of kT = 32; within a chunk an online softmax over its tiles in
// position order (fp32 running max and sum, p rounded to bf16 before the
// P.lat product); the chunks' (m, l, acc) then combined in chunk order:
// M = max m_s, out = (sum_s acc_s e^(m_s - M)) * (1 / sum_s l_s e^(m_s - M)).
// A row's arithmetic depends on its own positions only: chunks and tiles
// sit at fixed absolute positions, a chunk or tile the row sees nothing of
// adds exact zeros (factor e^(-1e30 - M) = 0, or alpha = 1 and p = 0), and a
// tile with one live chunk writes acc * (1 / l), what the combine gives with
// a factor of exactly 1.  So a row's bytes do not depend on b, sq or the
// other rows of its tile.
//
// What bounds it on an H100: at decode the cache bytes of the visible prefix
// (the latent is shared by all heads: 576 codes a position), at prefill the
// dots, 2 * rows * kv * (512 + 64 + 512) operations; at decode the latency
// of a CTA's walk over its tiles bounds it long before either.  Design:
//  1. The KV is split across the card.  The grid is (chunk, 64-row tile,
//     batch row); a CTA whose chunk starts past its tile's last visible
//     position exits at once (where kv_len is a number, the wrapper launches
//     only the chunks below it).  Decode at b=32 over L=1024 runs about 144
//     live CTAs, at b=8 over L=8192 128.
//  2. The combine runs in the same launch: each live chunk of a tile with
//     two or more writes its rows' (m, l, acc) in fp32 to a workspace, and
//     the last CTA of the tile to finish (an atomic ticket, which it resets)
//     combines them in chunk order and writes the output.  No second launch,
//     no host synchronisation; the workspace and tickets are the wrapper's
//     per-device buffers.
//  3. A producer thread keeps a ring of stages of 16 positions in flight, one
//     1-D cp.async.bulk per cache tensor (each a contiguous run of a batch
//     row), completing on the stage's full mbarrier; the consumers release
//     a stage on its empty mbarrier.  No tensor map: no host work a call.
//  4. Two consumer warpgroups decode each landed tile once into a bf16
//     operand tile (128-byte swizzled panels of 64 features: 8 of the latent,
//     1 of the rope key; positions past kv_len as 0, so a stale NaN scale
//     never reaches the dots), double-buffered: tile t + 1 is decoded while
//     tile t's scores run on the tensor cores.  One named barrier a tile.
//  5. Tensor cores for both products, in 64-row tiles.  Scores: wgmma
//     m64n32k16 with Q (the tile's 64 rows, loaded once into the same
//     panels) and the decoded tile both K-major in shared memory, 36 k16
//     steps into one accumulator, so a row's full 576-wide dot and its
//     softmax stay in the four threads that own it (both warpgroups compute
//     the same scores).  P.lat: P as A from registers (the score fragment
//     rounded to bf16), the same decoded tile as B transposed (N-major),
//     wgmma m64n128k16, each warpgroup 256 of the 512 output columns.  The
//     producer warpgroup gives its registers to the consumers (setmaxnreg),
//     whose 64 x 256 fp32 output fragment would otherwise spill.
// On an H100 (tools/b13_phase_profile.py) a tile of 32 positions costs about
// 4 us of a CTA's walk: the copies hide under the consumers' barrier and
// softmax, and the score wgmmas (Q and the tile read from shared memory by
// both warpgroups) and the decode do not overlap; a CTA's launch, Q load,
// partial write and combine cost 15-36 us more.  Decode stays far above its
// byte bound: latency, not bandwidth, holds it.
#include "mx_common.cuh"
#include "mx_wgmma.cuh"
#include "mx_wgmma_decode.cuh"

namespace {

constexpr int kR = 512;           // latent rank (kv_lora_rank)
constexpr int kDr = 64;           // rope key width (qk_rope_head_dim)
constexpr int kRows = 64;         // query rows per CTA (one wgmma m64 tile)
constexpr int kT = 32;            // KV positions per tile (B13_TILE in ops/cuda_mla.py)
constexpr int kSP = 16;           // positions per ring stage (two stages a tile)
constexpr int kPanels = 9;        // 64-feature panels: 8 of the latent, 1 of the rope key
constexpr int kChunks = 72;       // 16-byte chunks (8 features) of a position: 64 + 8
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread issues the copies)
// Registers a thread after setmaxnreg: the consumers hold a 64 x 256 fp32
// output fragment each (128) and the scores; 2 x 128 x 232 + 128 x 40 <= 64K.
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kQPanel = kRows * 128;       // bytes of a Q panel
constexpr int kTPanel = kT * 128;          // bytes of a decoded tile's panel
constexpr int kQBytes = kPanels * kQPanel;
constexpr int kTileBytes = kPanels * kTPanel;
constexpr int kMaxChunks = 64;    // chunks of a cache at most (cuda_mla.mla_chunk)
constexpr float kNegInf = -1e30f;
// Planted faults for the model check (never set by the package).
constexpr int kFaultVFromRot = 1;     // V read from the rope key instead of the latent
constexpr int kFaultDropLast = 2;     // the combine drops the last live chunk

// Geometry of a format's cache (E < 0: bf16): bytes a position of each
// tensor, a ring stage's layout (latent codes, rope codes, latent scales,
// rope scales) and the ring depth.
template <int E> struct Geo {
  static constexpr bool bf = E < 0, fp4 = E == mx::kFp4E2M1;
  static constexpr int lat = bf ? 2 * kR : (fp4 ? kR / 2 : kR);
  static constexpr int rot = bf ? 2 * kDr : (fp4 ? kDr / 2 : kDr);
  static constexpr int lat_sc = bf ? 0 : kR / 32, rot_sc = bf ? 0 : kDr / 32;
  static constexpr int o_rot = kSP * lat, o_lsc = o_rot + kSP * rot, o_rsc = o_lsc + kSP * lat_sc;
  static constexpr int stage = o_rsc + kSP * rot_sc;
  static constexpr int stages = bf ? 4 : 6;
  static constexpr int o_ring = kQBytes + 2 * kTileBytes;
  static constexpr int o_bar = o_ring + stages * stage;
  static constexpr int bytes = o_bar + 2 * stages * 8 + 16;  // + the barriers and the "last" flag
  static_assert(stage % 16 == 0 && o_rot % 16 == 0 && o_lsc % 16 == 0 && o_rsc % 16 == 0, "bulk copies need 16 B");
  static_assert(bytes + 1024 <= 232448, "shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight codes (one per byte of w; fp4: the high nibbles with `high`, else the
// low ones) at scale se -> eight bf16 (mx::decode_fast where the scale is
// safe, else the exact decode: the same bits).
template <int E>
__device__ __forceinline__ uint4 decode8(uint2 w, int se, bool high) {
  if (E == mx::kFp4E2M1 && high) {
    w.x >>= 4;
    w.y >>= 4;
  }
  uint4 o;
  if (mx::scale_safe<E>(se)) {
    const float sf = __uint_as_float((uint32_t)se << 23), sneg = -8388736.0f * sf;
    const uint32_t sc = (uint32_t)(se + 127 - mx::Elem<E>::bias) * 0x00800080u;
    uint32_t x02 = mx::decode_fast<E>(w.x, 0, sf, sneg, sc), x13 = mx::decode_fast<E>(w.x, 1, sf, sneg, sc);
    o.x = __byte_perm(x02, x13, 0x5410);
    o.y = __byte_perm(x02, x13, 0x7632);
    x02 = mx::decode_fast<E>(w.y, 0, sf, sneg, sc);
    x13 = mx::decode_fast<E>(w.y, 1, sf, sneg, sc);
    o.z = __byte_perm(x02, x13, 0x5410);
    o.w = __byte_perm(x02, x13, 0x7632);
  } else {
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t word = j < 2 ? w.x : w.y;
      const int sh = 16 * (j & 1);
      r[j] = mx::decode_one<E>((int)((word >> sh) & 0xFF), se) |
             (mx::decode_one<E>((int)((word >> (sh + 8)) & 0xFF), se) << 16);
    }
    o = make_uint4(r[0], r[1], r[2], r[3]);
  }
  return o;
}

// Decode tile t of the chunk (ring fills 2t and 2t + 1) into the bf16 panels
// at dst: 16-byte chunk k of position p (features 8k .. 8k + 7; k >= 64 the
// rope key's) to panel k / 8, row p, chunk k % 8 swizzled.  Positions at or
// past kv_len come as 0.  Then release both ring stages.
template <int E>
__device__ __forceinline__ void decode_tile(uint8_t* smem, uint32_t sbase, uint8_t* dst, int t, int pos0, int kv_len,
                                            int tid) {
  using G = Geo<E>;
  const int f0 = 2 * t;
  mx::mbar_wait(sbase + G::o_bar + 8 * (f0 % G::stages), (f0 / G::stages) & 1);
  mx::mbar_wait(sbase + G::o_bar + 8 * ((f0 + 1) % G::stages), ((f0 + 1) / G::stages) & 1);
#pragma unroll 3
  for (int i = tid; i < kT * kChunks; i += kConsumers) {
    const int p = i / kChunks, k = i % kChunks;
    const uint8_t* st = smem + G::o_ring + ((f0 + p / kSP) % G::stages) * G::stage;
    const int pp = p % kSP;
    const bool rope = k >= 64;
    const int kk = rope ? k - 64 : k;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (pos0 + p < kv_len) {
      if constexpr (G::bf) {
        v = *reinterpret_cast<const uint4*>(st + (rope ? G::o_rot + pp * G::rot : pp * G::lat) + 16 * kk);
      } else {
        const int w = rope ? kDr : kR;  // the row's width in features
        const int f = 8 * kk;           // its first feature
        const int se = st[rope ? G::o_rsc + pp * G::rot_sc + f / 32 : G::o_lsc + pp * G::lat_sc + f / 32];
        const uint8_t* row = st + (rope ? G::o_rot + pp * G::rot : pp * G::lat);
        int byte = f;
        bool high = true;
        if constexpr (G::fp4) {
          high = f < w / 2;
          byte = high ? f : f - w / 2;
        }
        v = decode8<E>(*reinterpret_cast<const uint2*>(row + byte), se, high);
      }
    }
    *reinterpret_cast<uint4*>(dst + (rope ? 8 : kk / 8) * kTPanel + mx::sw128(p, kk % 8)) = v;
  }
  mx::fence_proxy_async();
  mx::mbar_arrive(sbase + G::o_bar + 8 * (G::stages + f0 % G::stages));
  mx::mbar_arrive(sbase + G::o_bar + 8 * (G::stages + (f0 + 1) % G::stages));
}

// Keep the P fragments live until the wgmma that reads them has retired.
__device__ __forceinline__ void hold_fragments(uint32_t (&f)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[kk][i])::"memory");
}

// Grid (n_chunks, row tiles, b); kThreads threads.  ws: (b, n_chunks, rows,
// 512) floats of acc, then (b, n_chunks, rows, 2) of (m, l); tickets: (b,
// row tiles) ints, zero between launches.
template <int E>
__global__ void __launch_bounds__(kThreads, 1)
mla_kernel(const uint16_t* __restrict__ ql, const uint16_t* __restrict__ qr,
           const uint8_t* __restrict__ ld, const uint8_t* __restrict__ ls,
           const uint8_t* __restrict__ rd, const uint8_t* __restrict__ rs,
           const int* __restrict__ q_off_p, const int* __restrict__ kv_len_p,
           uint16_t* __restrict__ out, float* __restrict__ ws, int* __restrict__ tickets,
           int rows_total, int n_heads, int L, int S, float sm_scale, int fault) {
  using G = Geo<E>;
  const int c = blockIdx.x, rt = blockIdx.y, ib = blockIdx.z, n_chunks = gridDim.x;
  const int row_base = rt * kRows;
  const int q_off = q_off_p[ib], kv_len = kv_len_p[ib];
  const int q_hi = q_off + (min(rows_total, row_base + kRows) - 1) / n_heads;
  const int kv_end = min(min(kv_len, q_hi + 1), L);
  const int n_live = kv_end > 0 ? (kv_end + S - 1) / S : 1;
  if (c >= n_live) return;  // the chunk starts past the tile's last visible position
  const int c0 = c * S;
  const int t_end = min(c0 + S, kv_end);
  const int nt = t_end > c0 ? (t_end - c0 + kT - 1) / kT : 0;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = mx::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = mx::smem_addr(smem);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < G::stages; ++s) {
      mx::mbar_init(sbase + G::o_bar + 8 * s, 1);
      mx::mbar_init(sbase + G::o_bar + 8 * (G::stages + s), kConsumers);
    }
    mx::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid != kConsumers) return;
    const uint8_t* ld_b = ld + (long long)ib * L * G::lat;
    const uint8_t* rd_b = rd + (long long)ib * L * G::rot;
    const uint8_t* ls_b = ls + (long long)ib * L * G::lat_sc;
    const uint8_t* rs_b = rs + (long long)ib * L * G::rot_sc;
    for (int f = 0; f < 2 * nt; ++f) {
      const int slot = f % G::stages;
      if (f >= G::stages) mx::mbar_wait(sbase + G::o_bar + 8 * (G::stages + slot), ((f / G::stages) + 1) & 1);
      const uint32_t full = sbase + G::o_bar + 8 * slot, st = sbase + G::o_ring + slot * G::stage;
      const long long pos = c0 + f * kSP;
      mx::mbar_expect_tx(full, G::stage);
      mx::bulk_load(st, ld_b + pos * G::lat, kSP * G::lat, full);
      mx::bulk_load(st + G::o_rot, rd_b + pos * G::rot, kSP * G::rot, full);
      if constexpr (!G::bf) {
        mx::bulk_load(st + G::o_lsc, ls_b + pos * G::lat_sc, kSP * G::lat_sc, full);
        mx::bulk_load(st + G::o_rsc, rs_b + pos * G::rot_sc, kSP * G::rot_sc, full);
      }
    }
    return;
  }

  // Consumers: warpgroup wg, warp w of it, lane (g, q4).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32, g = lane / 4, q4 = lane % 4;
  uint8_t* qs = smem;
  uint8_t* dec[2] = {smem + kQBytes, smem + kQBytes + kTileBytes};

  // The tile's 64 query rows into the Q panels (rows past rows_total as 0):
  // every load in flight before the first store.
  {
    constexpr int kPer = kRows * kChunks / kConsumers;
    uint4 v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kConsumers, r = i / kChunks, k = i % kChunks, row = row_base + r;
      const long long qrow = (long long)ib * rows_total + row;
      v[j] = row >= rows_total ? make_uint4(0, 0, 0, 0)
             : k < 64          ? reinterpret_cast<const uint4*>(ql + qrow * kR)[k]
                               : reinterpret_cast<const uint4*>(qr + qrow * kDr)[k - 64];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kConsumers, r = i / kChunks, k = i % kChunks;
      *reinterpret_cast<uint4*>(qs + (k < 64 ? k / 8 : 8) * kQPanel + mx::sw128(r, k % 8)) = v[j];
    }
  }
  if (nt > 0) decode_tile<E>(smem, sbase, dec[0], 0, c0, kv_len, tid);
  else mx::fence_proxy_async();

  float o[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[h][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = q_off + min(row_base + 16 * w + g + 8 * h, rows_total - 1) / n_heads;
  const uint32_t qaddr = mx::smem_addr(qs);
  const bool v_rot = fault & kFaultVFromRot;

  for (int t = 0; t < nt; ++t) {
    mx::named_barrier(1, kConsumers);  // tile t decoded; every wgmma of tile t - 1 retired
    const uint32_t taddr = mx::smem_addr(dec[t & 1]);
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    mx::wgmma_fence();
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mx::wgmma_m64n32k16_ss(s, mx::wgmma_desc(qaddr + p * kQPanel + 32 * kk, 16, 1024),
                               mx::wgmma_desc(taddr + p * kTPanel + 32 * kk, 16, 1024), p | kk);
    mx::wgmma_commit();
    if (t + 1 < nt) decode_tile<E>(smem, sbase, dec[(t + 1) & 1], t + 1, c0 + (t + 1) * kT, kv_len, tid);
    mx::wgmma_wait<0>();
    mx::fence_fragment(s);

    // Online softmax of rows 16 w + g + 8 h: s[4 j + 2 h + i] is position 8 j + 2 q4 + i of the tile.
    const int pos0 = c0 + t * kT;
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx_t = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int pos = pos0 + 8 * j + 2 * q4 + i;
          const bool valid = pos <= qpos[h] && pos < kv_len;
          const float v = valid ? __fmul_rn(s[4 * j + 2 * h + i], sm_scale) : kNegInf;
          s[4 * j + 2 * h + i] = v;
          mx_t = fmaxf(mx_t, v);
        }
      mx_t = fmaxf(mx_t, __shfl_xor_sync(0xffffffffu, mx_t, 1));
      mx_t = fmaxf(mx_t, __shfl_xor_sync(0xffffffffu, mx_t, 2));
      const float m_new = fmaxf(m_run[h], mx_t);
      alpha[h] = __expf(m_run[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int pos = pos0 + 8 * j + 2 * q4 + i;
          const bool valid = pos <= qpos[h] && pos < kv_len;
          const float p = valid ? __expf(s[4 * j + 2 * h + i] - m_new) : 0.f;
          s[4 * j + 2 * h + i] = p;
          sum = __fadd_rn(sum, p);
        }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      l_run[h] = __fadd_rn(__fmul_rn(l_run[h], alpha[h]), sum);
      m_run[h] = m_new;
    }
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))  // a factor of 1 changes nothing
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int i = 0; i < 64; ++i) o[hh][i] = __fmul_rn(o[hh][i], alpha[(i >> 1) & 1]);

    // O += bf16(P) . lat over this warpgroup's 256 columns (V: the same tile, N-major).
    mx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int panel = v_rot ? 8 : 4 * wg + 2 * hh;
        mx::wgmma_m64n128k16_rs_tb(o[hh], pa[kk],
                                   mx::wgmma_desc(taddr + panel * kTPanel + 2048 * kk, v_rot ? 0 : kTPanel, 1024), 1);
      }
    mx::wgmma_commit();
    mx::wgmma_wait<0>();
    mx::fence_fragment(o[0]);
    mx::fence_fragment(o[1]);
    hold_fragments(pa);
  }

  // Epilogue.  Thread (w, g, q4) holds rows 16 w + g + 8 h, columns 256 wg +
  // 128 hh + 8 j + 2 q4 + {0, 1} in o[hh][4 j + 2 h + {0, 1}].
  if (n_live == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_base + 16 * w + g + 8 * h;
      if (row >= rows_total) continue;
      const float inv = 1.f / (l_run[h] == 0.f ? 1.f : l_run[h]);
      uint16_t* orow = out + ((long long)ib * rows_total + row) * kR + 256 * wg + 2 * q4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(orow + 128 * hh + 8 * j) =
              pack_bf16(__fmul_rn(o[hh][4 * j + 2 * h], inv), __fmul_rn(o[hh][4 * j + 2 * h + 1], inv));
    }
    return;
  }

  const long long acc_elems = (long long)gridDim.z * n_chunks * rows_total * kR;
  float* ml = ws + acc_elems;
  const long long part = ((long long)ib * n_chunks + c) * rows_total;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + 16 * w + g + 8 * h;
    if (row >= rows_total) continue;
    float* arow = ws + (part + row) * kR + 256 * wg + 2 * q4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(arow + 128 * hh + 8 * j) =
            make_float2(o[hh][4 * j + 2 * h], o[hh][4 * j + 2 * h + 1]);
    if (wg == 0 && q4 == 0) *reinterpret_cast<float2*>(ml + 2 * (part + row)) = make_float2(m_run[h], l_run[h]);
  }
  __threadfence();
  mx::named_barrier(1, kConsumers);
  int* last = reinterpret_cast<int*>(smem + G::o_bar + 2 * G::stages * 8);
  int* ticket = tickets + (long long)ib * gridDim.y + rt;
  if (tid == 0) *last = atomicAdd(ticket, 1) == n_live - 1;
  mx::named_barrier(1, kConsumers);
  if (!*last) return;
  __threadfence();

  // The last CTA of the tile: combine the live chunks in chunk order.  Each
  // row's factors f_s = e^(m_s - M) and 1 / sum_s l_s f_s first, into shared
  // memory (the Q panels, free now), then every column of the row, its
  // chunks' partials added in chunk order.
  const int n_use = (fault & kFaultDropLast) ? n_live - 1 : n_live;
  const int rows_here = min(kRows, rows_total - row_base);
  const long long base = (long long)ib * n_chunks * rows_total + row_base;
  constexpr int kFr = 2 * kMaxChunks + 1;       // a row's factors: m_s then f_s, l_s, 1 / l
  float* fac = reinterpret_cast<float*>(smem);  // [kRows][kFr]
  for (int e = tid; e < rows_here * n_use; e += kConsumers) {
    const int r = e / n_use, sc = e % n_use;
    const float2 msl = __ldcg(reinterpret_cast<const float2*>(ml + 2 * (base + (long long)sc * rows_total + r)));
    fac[r * kFr + sc] = msl.x;
    fac[r * kFr + kMaxChunks + sc] = msl.y;
  }
  mx::named_barrier(1, kConsumers);
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
  mx::named_barrier(1, kConsumers);
  // Two rows a pass (kR / 4 threads a row, four columns each), each row's
  // chunks kBatch at a time: 2 kBatch loads in flight.
  constexpr int kBatch = 8, kRowsPass = kConsumers / (kR / 4);
  const int col = 4 * (tid % (kR / 4));
  for (int r0 = 0; r0 < rows_here; r0 += 2 * kRowsPass) {
    const int r[2] = {r0 + tid / (kR / 4), r0 + kRowsPass + tid / (kR / 4)};
    float4 a[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int s0 = 0; s0 < n_use; s0 += kBatch) {
      float4 part[2][kBatch];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (r[u] < rows_here && s0 + k < n_use)
            part[u][k] = __ldcg(reinterpret_cast<const float4*>(
                ws + (base + (long long)(s0 + k) * rows_total + r[u]) * kR + col));
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (r[u] < rows_here && s0 + k < n_use) {
            const float f = fac[r[u] * kFr + s0 + k];
            a[u].x = __fadd_rn(a[u].x, __fmul_rn(part[u][k].x, f));
            a[u].y = __fadd_rn(a[u].y, __fmul_rn(part[u][k].y, f));
            a[u].z = __fadd_rn(a[u].z, __fmul_rn(part[u][k].z, f));
            a[u].w = __fadd_rn(a[u].w, __fmul_rn(part[u][k].w, f));
          }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (r[u] >= rows_here) continue;
      const float inv = fac[r[u] * kFr + 2 * kMaxChunks];
      *reinterpret_cast<uint2*>(out + ((long long)ib * rows_total + row_base + r[u]) * kR + col) =
          make_uint2(pack_bf16(__fmul_rn(a[u].x, inv), __fmul_rn(a[u].y, inv)),
                     pack_bf16(__fmul_rn(a[u].z, inv), __fmul_rn(a[u].w, inv)));
    }
  }
  if (tid == 0) *ticket = 0;
}

template <int E>
cudaError_t run(const void* ql, const void* qr, const void* ld, const void* ls, const void* rd, const void* rs,
                const void* q_off, const void* kv_len, void* out, void* ws, void* tickets, int b, int rows, int n,
                int L, int S, int chunks, float sm_scale, int fault, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(mla_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Geo<E>::bytes + 1024);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid(chunks, (rows + kRows - 1) / kRows, b);
  mla_kernel<E><<<grid, kThreads, Geo<E>::bytes + 1024, stream>>>(
      (const uint16_t*)ql, (const uint16_t*)qr, (const uint8_t*)ld, (const uint8_t*)ls, (const uint8_t*)rd,
      (const uint8_t*)rs, (const int*)q_off, (const int*)kv_len, (uint16_t*)out, (float*)ws, (int*)tickets, rows, n,
      L, S, sm_scale, fault);
  return cudaGetLastError();
}

}  // namespace

// elem: -1 for a bf16 cache (ls / rs unused), else an mx::ElemCode.  r must
// be 512 and dr 64; L a multiple of 32; rows = sq * n; S (the chunk) a
// multiple of 32.  chunks: the grid's chunks, ceil(L / S) or, where the
// caller knows every kv_len, ceil(min(max kv_len, L) / S) (at least 1; at
// most 64).  ws: b * chunks * rows * 514 floats; tickets: b * ceil(rows /
// 64) ints, zero (the kernel leaves them zero).  Every cache pointer 16-byte
// aligned.  fault: 0 (1: V from the rope key, 2: the combine drops the last
// live chunk).
extern "C" int mx_mla_attention_launch(const void* ql, const void* qr, const void* ld, const void* ls,
                                       const void* rd, const void* rs, const void* q_off, const void* kv_len,
                                       void* out, void* ws, void* tickets, int b, int rows, int n, int L, int r,
                                       int dr, int S, int chunks, float sm_scale, int elem, int fault, void* stream) {
  if (r != kR || dr != kDr || L <= 0 || L % kT || S <= 0 || S % kT || chunks < 1 || chunks > (L + S - 1) / S ||
      chunks > kMaxChunks || n <= 0 || rows % n || fault < 0 || fault > 3)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)ld | (uintptr_t)rd | (elem < 0 ? 0 : (uintptr_t)ls | (uintptr_t)rs)) % 16)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem) {
    case -1:
      return (int)run<-1>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, ws, tickets, b, rows, n, L, S, chunks,
                          sm_scale, fault, s);
    case mx::kFp8E4M3:
      return (int)run<mx::kFp8E4M3>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, ws, tickets, b, rows, n, L, S,
                                    chunks, sm_scale, fault, s);
    case mx::kFp4E2M1:
      return (int)run<mx::kFp4E2M1>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, ws, tickets, b, rows, n, L, S,
                                    chunks, sm_scale, fault, s);
    case mx::kFp6E3M2:
      return (int)run<mx::kFp6E3M2>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, ws, tickets, b, rows, n, L, S,
                                    chunks, sm_scale, fault, s);
    case mx::kFp6E2M3:
      return (int)run<mx::kFp6E2M3>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, ws, tickets, b, rows, n, L, S,
                                    chunks, sm_scale, fault, s);
    case mx::kInt8:
      return (int)run<mx::kInt8>(ql, qr, ld, ls, rd, rs, q_off, kv_len, out, ws, tickets, b, rows, n, L, S, chunks,
                                 sm_scale, fault, s);
  }
  return (int)cudaErrorInvalidValue;
}
