// Hopper building blocks of the wgmma kernels: TMA and 1-D bulk copies
// completing on mbarriers, the 128-byte swizzled shared-memory tiles TMA
// writes and wgmma and ldmatrix read, wgmma's shared-memory matrix
// descriptor, and wgmma.mma_async m64n{16,32,64,128}k16 bf16 -> f32 (and
// m64n64k32 on int8 codes) with A from registers and B K-major in shared
// memory; for B13 also A from shared memory and B N-major; the cluster
// barrier and loads from a neighbour's shared memory.  sm_90a only.
//
// Tiles.  An operand tile is made of 1024-byte atoms of eight 128-byte rows
// (row r of a K-major B tile holds 64 bf16 K values); the 16-byte chunk c
// of row r lies at chunk c ^ (r % 8): TMA's 128-byte swizzle (atoms
// 1024-byte aligned, 8 rows = 1024 bytes apart).  A 64-byte swizzled tile
// (rows of 32 bf16 K values) has 512-byte atoms of eight rows; chunk c
// (0..3) of row r lies at chunk c ^ ((r / 2) % 4).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace mx {

// Byte offset of 16-byte chunk c (0..7) of row r in a swizzled run of
// 128-byte rows (r counts rows from a 1024-byte aligned start).
__device__ __forceinline__ uint32_t sw128(int r, int c) { return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// mbarriers and TMA: a ring slot's barrier counts one arrival (the thread
// that starts the slot's copies, announcing their bytes) and completes when
// the copies have landed; waiters pass the parity of the fill they wait for.
// A slot's "empty" barrier counts the arrivals of the slot's readers.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A 2-D box of the tensor map (its element coordinates c0 innermost, c1)
// into shared memory, completing on mbarrier bar; elements outside the
// tensor come as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(tmap), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A 3-D box (c0 innermost, c1, c2) of the tensor map, the same way.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* tmap, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(tmap), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A 1-D bulk copy of `bytes` contiguous bytes (a multiple of 16; both
// addresses 16-byte aligned) from global memory into shared memory,
// completing on mbarrier bar: no tensor map.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Named barrier `id` (1..15) among `count` threads (a multiple of 32).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Order this thread's generic-proxy accesses to shared memory before the
// async proxy's (wgmma's operand reads, TMA's writes).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Shared-memory matrix descriptor of a 128-byte swizzled K-major tile:
// start address, leading byte offset (unused for this layout) and stride
// byte offset (1024, between 8-row atoms).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// The same for a 64-byte swizzled K-major tile (layout type 2): 8-row atoms
// 512 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// d (64 x 128 f32, the warpgroup's fragment) = A (64 x 16 bf16, from
// registers) * B (16 x 128 bf16, K-major in shared memory) + (scale_d ? d :
// 0).  For thread t of the warpgroup (w = t / 32, l = t % 32, g = l / 4,
// q = l % 4): a[0..3] is mma.sync m16n8k16's A fragment of rows 16w + g and
// 16w + g + 8 (a0: row g, K 2q, 2q+1; a1: row g+8; a2: row g, K 2q+8, 2q+9;
// a3: row g+8, K 2q+8, 2q+9); d[4j + 2h + i] is row 16w + g + 8h, column
// 8j + 2q + i.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The 32 accumulator registers of an m64n64 fragment, as asm operands %0 .. %31.
#define MX_WGMMA_D32 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MX_WGMMA_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define MX_WGMMA_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"

// The same product as wgmma_m64n128k16_rs over 16, 32 or 64 columns of B:
// d (64 x N f32) = A (64 x 16 bf16, registers) * B (16 x N, K-major in
// shared memory) + (scale_d ? d : 0), with m64n128k16's fragment layout cut
// to j < N / 8.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " MX_WGMMA_D8 ", {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " MX_WGMMA_D16 ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MX_WGMMA_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 32 f32) = A (64 x 16 bf16, K-major in shared memory) * B (16 x
// 32 bf16, K-major in shared memory) + (scale_d ? d : 0); the fragment
// layout of wgmma_m64n32k16_rs.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " MX_WGMMA_D16 ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// wgmma_m64n128k16_rs with B transposed (N-major in shared memory: each of
// B's 16 K rows holds its N values contiguous, in 128-byte swizzled atoms
// of 8 K rows by 64 N values; the descriptor's leading byte offset steps
// between 64-column atoms, its stride byte offset between 8-row atoms).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// wgmma_m64n{N}k16_rs for N = 16, 32, 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_m64nk16_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                                 int scale_d) {
  if constexpr (N == 16) wgmma_m64n16k16_rs(d, a, desc_b, scale_d);
  else if constexpr (N == 32) wgmma_m64n32k16_rs(d, a, desc_b, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16_rs(d, a, desc_b, scale_d);
  else wgmma_m64n128k16_rs(d, a, desc_b, scale_d);
}

// One MX block's dot on raw int8 codes: d (64 x 64, the warpgroup's
// fragment) = A (64 x 32 codes, from registers) * B (32 x 64 codes, K-major
// in shared memory), s8 x s8 -> s32, the exact integer sum, with scale-d = 0
// (d's old value is not read).  (Its e4m3 form, e4m3 x e4m3 -> f32, keeps
// fewer bits than f32 in the sum, where mma.sync m16n8k32 keeps them: B9
// takes mma.sync for e4m3, csrc/mx_matmul_int8dot.cu.)  For thread t of the
// warpgroup (w = t / 32, l = t % 32, g = l / 4, q = l % 4): a[0] holds the
// codes at K 4q .. 4q + 3 of row 16w + g (byte i: K 4q + i), a[1] the same of
// row 16w + g + 8, a[2] / a[3] those at K 16 + 4q ..; d[4j + 2h + i] is row
// 16w + g + 8h, column 8j + 2q + i (the k16 layout's).
__device__ __forceinline__ void wgmma_m64n64k32_s8_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " MX_WGMMA_D32 ", {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
}

// Tell the compiler the fragment changed here (after a wgmma wait), so that
// no read of it moves above the wait.
template <int N>
__device__ __forceinline__ void fence_fragment(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_fragment(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ldmatrix x4 with .trans of four 8 x 8 b16 matrices; lane l passes the row
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned).  Lane
// (g = l/4, t = l%4) receives, in r[q], elements [row 2t][col g] (low half)
// and [row 2t + 1][col g] (high half) of matrix q.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same without .trans: lane (g = l/4, t = l%4) receives, in r[q],
// elements [row g][col 2t] (low half) and [row g][col 2t + 1] (high half)
// of matrix q: bytes 4t .. 4t + 3 of row g of an 8 x 16-byte matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A thread-block cluster: a barrier split into its arrive and wait (release
// / acquire: shared-memory writes before the arrive are seen by reads after
// the wait, in every CTA; every thread of the cluster takes part), and loads
// from another CTA's shared memory.  B14 and K5 exchange their tiles'
// statistics so.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Host side: cuTensorMapEncodeTiled, looked up through the runtime's entry
// points (no link against libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2-D tensor map: inner x outer elements of `type` at base, rows
// row_bytes apart, boxes of box_inner x box_outer; with depth > 1 a 3-D
// map of `depth` such matrices, matrix_bytes apart, boxes `depth` deep.
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner, uint64_t outer,
                       uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer, CUtensorMapSwizzle swizzle,
                       uint32_t depth = 1, uint64_t matrix_bytes = 0) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {inner, outer, depth}, strides[2] = {row_bytes, matrix_bytes};
  cuuint32_t box[3] = {box_inner, box_outer, depth}, elem_strides[3] = {1, 1, 1};
  return encode(map, type, depth > 1 ? 3 : 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


// A 2-D uint8 tensor map over rows of L bytes (a d-major cache buffer: code
// or scale rows, the positions innermost; or a seq-layout code buffer: a
// position's d codes a row), boxes of box_inner bytes x box_rows rows,
// encoded once for each (pointer, rows, L, box, swizzle) and kept, so that a
// call does no encode on the host.  A pointer that a later buffer of the
// same shape reuses gives the same map; the box is part of the key (a code
// buffer may reuse a scale buffer's address with the same number of rows).
// K5, K6, K7 and B14 read their caches through it.
struct ByteMapKey {
  uintptr_t p;
  uint64_t rows, L;
  uint32_t box_inner, box_rows;
  int swizzle;
  bool operator==(const ByteMapKey& o) const {
    return p == o.p && rows == o.rows && L == o.L && box_inner == o.box_inner && box_rows == o.box_rows &&
           swizzle == o.swizzle;
  }
};
struct ByteMapKeyHash {
  size_t operator()(const ByteMapKey& k) const {
    return std::hash<uintptr_t>()(k.p) ^ (k.rows * 0x9E3779B97F4A7C15ull) ^ (k.L << 8) ^ k.box_rows ^
           ((size_t)k.box_inner << 20) ^ ((size_t)k.swizzle << 40);
  }
};

inline bool cached_byte_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t L, uint32_t box_inner,
                              uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  static std::mutex mu;
  static std::unordered_map<ByteMapKey, CUtensorMap, ByteMapKeyHash> maps;
  const ByteMapKey key{(uintptr_t)base, rows, L, box_inner, box_rows, (int)swizzle};
  std::lock_guard<std::mutex> lock(mu);
  auto it = maps.find(key);
  if (it == maps.end()) {
    CUtensorMap m;
    if (!tensor_map(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, L, rows, L, box_inner, box_rows, swizzle)) return false;
    if (maps.size() >= 4096) maps.clear();
    it = maps.emplace(key, m).first;
  }
  *map = it->second;
  return true;
}

}  // namespace mx
