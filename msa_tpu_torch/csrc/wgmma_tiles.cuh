// Warpgroup tensor-core tiles (Hopper's wgmma) for a head dim kD of 16,
// 32, 64, 128 or 256: what the flash kernels of flash_kernels.cuh (the
// forward of rows 10 and 13 and the split pair of rows 12 and 13 at every
// kD, row 11's fused backward from 64) and the tiled short-attention
// backward (short_bwd_tiled.cuh, every kD) build their bf16 products from.
//
// A warpgroup (4 warps, 128 threads) issues one asynchronous product of a
// 64-row tile, m64nNk16 (bf16 in, f32 accumulate), A read from shared
// memory through a descriptor or from registers, B always from shared
// memory through a descriptor: no ldmatrix, so no fragment traffic through
// the register file.  Offered here:
//
//   * swizzled row tiles: a tile holds rows of kD bf16 values in swizzle
//     atoms of 8 rows, an atom row min(kD, 64) values wide, its 16-byte
//     chunk c stored at chunk c ^ f(r): the 128-byte swizzle at d = 64 and
//     128 (f(r) = r % 8, an atom of 1024 bytes), the 64-byte swizzle at d =
//     32 (f(r) = (r / 2) % 4, 512 bytes) and the 32-byte swizzle at d = 16
//     (f(r) = (r / 4) % 2, 256 bytes).  At d = 128 a row spans two atoms
//     and at 256 four: 8-row group j holds atom a of its rows at
//     kGroupBytes j + 1024 a (swz), so one descriptor layout serves tiles
//     of any height.
//     The hardware applies the pattern to absolute shared addresses, so
//     every tile starts on a 1024-byte boundary (align_smem).  stage_rows
//     copies rows into it with cp.async, zero-filling rows past the
//     sequence;
//   * descriptors of such a tile as either operand layout:
//       desc_k(tile, kk)  K-major: the tile's rows are the M (A) or N (B)
//                         index, kD the contracted one; k-step kk starts
//                         32 kk bytes into each row's atoms (the next atom
//                         from 64 values on).  SBO = an 8-row group, LBO
//                         unused (1);
//       desc_mn(tile, kk, col0)
//                         MN-major (transposed): the tile's rows are the
//                         contracted index, its columns from col0 (a
//                         multiple of 8) the N (or M) index; k-step kk
//                         starts at row 16 kk, and a col0 inside an atom
//                         moves the start 2 col0 bytes into its rows, as a
//                         K-major k-step moves it.  SBO = an 8-row group;
//                         LBO, the stride between atoms along N (1024
//                         bytes at d = 128 and 256; unused elsewhere, one
//                         atom);
//     fields (PTX ISA, "matrix descriptor"): start address >> 4 in bits
//     0-13, LBO >> 4 in 16-29, SBO >> 4 in 32-45, base offset 0 (the
//     tiles are atom-aligned), swizzle mode in 62-63 (1: 128 B, 2: 64 B,
//     3: 32 B);
//   * mma_ss<N, kTransB, kTransA>(d, desc_a, desc_b, scale_d) and
//     mma_rs<N, kTransB>(d, a, desc_b, scale_d): d = A B (+ d when
//     scale_d), N = 16 ... 128 from shared memory (kTransA: A MN-major, its
//     descriptor a desc_mn of a tile whose rows are the K index), N = 16
//     ... 128 with A from registers (a product 256 wide is two of 128:
//     cols);
//   * fence, commit and wait, and fence_operand, which pins registers that
//     an asynchronous product reads or writes across the fence / wait pair
//     so that the compiler neither moves nor reuses them in between (a
//     register touched there makes ptxas serialise the products);
//   * the accumulator as A: the m64nN accumulator's per-warp layout is
//     mma.sync's m16n8 C layout repeated along N (Frag of mma_tiles.cuh:
//     warp w of the group holds rows 16 w + g and 16 w + g + 8, columns 8 n
//     + 2 c + {0, 1}), so column tiles 2 kk and 2 kk + 1, packed to bf16,
//     are the m64k16 A fragment of k-step kk (to_a).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace msa_wgmma {

using msa_mma::cp_async16;
using msa_mma::pack_bf16;
using msa_mma::smem_addr;

constexpr int kGroupThreads = 128;  // a warpgroup
constexpr int kAlign = 1024;        // a 128-byte swizzle atom

template <int kD>
inline constexpr int kRowBytes = kD * 2;
template <int kD>
inline constexpr int kChunks = kD / 8;  // 16-byte chunks of a row
template <int kD>
inline constexpr int kAtomCols = kD < 64 ? kD : 64;  // bf16 values of an atom row
template <int kD>
inline constexpr int kAtomChunks = kAtomCols<kD> / 8;
template <int kD>
inline constexpr int kAtomBytes = 8 * 2 * kAtomCols<kD>;  // 8 atom rows
template <int kD>
inline constexpr int kGroupBytes = 8 * kRowBytes<kD>;  // 8 whole rows: 1, 2 or 4 atoms
template <int kD>
inline constexpr uint64_t kSwizzleMode = kD >= 64 ? 1 : kD == 32 ? 2 : 3;

// The first kAlign-aligned address at or after p (the caller asks for
// kAlign bytes more dynamic shared memory than its tiles take).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((kAlign - (smem_addr(p) & (kAlign - 1))) & (kAlign - 1));
}

// Byte offset of chunk ch of row r in a swizzled tile.
template <int kD>
__device__ __forceinline__ int swz(int r, int ch) {
  static_assert(kD == 16 || kD == 32 || kD == 64 || kD == 128 || kD == 256,
                "the tiles take head dim 16, 32, 64, 128 or 256");
  const int f = kD >= 64 ? (r & 7) : kD == 32 ? ((r >> 1) & 3) : ((r >> 2) & 1);
  if constexpr (kD <= 64) {  // one atom a row
    return r * kRowBytes<kD> + ((ch ^ f) << 4);
  } else {  // kD / 64 atoms a row
    return (r >> 3) * kGroupBytes<kD> + (ch / kAtomChunks<kD>) * kAtomBytes<kD> +
           (r & 7) * 2 * kAtomCols<kD> + (((ch % kAtomChunks<kD>) ^ f) << 4);
  }
}

// Rows [r0, r0 + n) of one head (row 0 at src + base, row stride ld) into
// the swizzled tile dst by threads [0, threads) of the block (the caller's
// tid); rows >= seq are zero-filled.  Asynchronous: the caller commits and
// waits.
template <int kD>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const __nv_bfloat16* src,
                                           size_t base, int ld, int r0, int n, int seq,
                                           int tid, int threads) {
  for (int idx = tid; idx < n * kChunks<kD>; idx += threads) {
    const int r = idx / kChunks<kD>, ch = idx % kChunks<kD>;
    const bool ok = r0 + r < seq;
    cp_async16(dst + swz<kD>(r, ch), src + base + (size_t)(ok ? r0 + r : 0) * ld + ch * 8, ok);
  }
}

// The chunks of dst that stage_rows(..., tid, threads) had this thread
// copy, each value times mult rounded to bf16.  Called after the thread's
// cp.async groups landed (its own writes are visible to it then).
template <int kD>
__device__ __forceinline__ void scale_own_rows(unsigned char* dst, int n, float mult, int tid,
                                               int threads) {
  for (int idx = tid; idx < n * kChunks<kD>; idx += threads) {
    uint4* chunk = reinterpret_cast<uint4*>(dst + swz<kD>(idx / kChunks<kD>, idx % kChunks<kD>));
    uint4 raw = *chunk;
    __nv_bfloat16* vals = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16_rn(__bfloat162float(vals[e]) * mult);
    *chunk = raw;
  }
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// K-major: rows of the tile from `row` (a multiple of 8) on are the M or N
// index, k-step kk covers columns [16 kk, 16 kk + 16).
template <int kD>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int row, int kk) {
  constexpr int kSteps = kAtomCols<kD> / 16;  // k-steps an atom row holds
  if constexpr (kD <= 64) {  // one atom a row: rows kRowBytes apart
    return make_desc(smem_addr(tile) + row * kRowBytes<kD> + kk * 32, 16, kGroupBytes<kD>,
                     kSwizzleMode<kD>);
  } else {
    return make_desc(smem_addr(tile) + (row >> 3) * kGroupBytes<kD> +
                         (kk / kSteps) * kAtomBytes<kD> + (kk % kSteps) * 32,
                     16, kGroupBytes<kD>, kSwizzleMode<kD>);
  }
}

// MN-major: rows [16 kk, 16 kk + 16) of the tile are k-step kk's K index,
// its columns from col0 (a multiple of 8) the N index.
template <int kD>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int kk, int col0 = 0) {
  return make_desc(smem_addr(tile) + kk * 2 * kGroupBytes<kD> +
                       (col0 / kAtomCols<kD>) * kAtomBytes<kD> + (col0 % kAtomCols<kD>) * 2,
                   kAtomBytes<kD>, kGroupBytes<kD>, kSwizzleMode<kD>);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to the async proxy that wgmma reads through; before the barrier
// that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void fence_operand(float (&d)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
  }
}
template <int kK>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[kK][4]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
  }
}

// Column tiles of an accumulator (Frag layout) as A fragments, rounded to
// bf16: a[kk] is k-step kk over the accumulator's N index.
template <int kN>
__device__ __forceinline__ void to_a(const float (&f)[kN][4], uint32_t (&a)[kN / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
    a[kk][0] = pack_bf16(f[2 * kk][0], f[2 * kk][1]);
    a[kk][1] = pack_bf16(f[2 * kk][2], f[2 * kk][3]);
    a[kk][2] = pack_bf16(f[2 * kk + 1][0], f[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(f[2 * kk + 1][2], f[2 * kk + 1][3]);
  }
}

// d[64 x kN] = A B (+ d if scale_d), A and B from shared memory; kTransB:
// B MN-major, kTransA: A MN-major.  Issued by the whole warpgroup.
template <int kN, int kTransB, int kTransA = 0>
__device__ __forceinline__ void mma_ss(float (&d)[kN / 8][4], uint64_t desc_a, uint64_t desc_b,
                                       int scale_d) {
  static_assert(kN == 16 || kN == 32 || kN == 64 || kN == 128,
                "shared-memory A products are 16, 32, 64 or 128 wide");
  if constexpr (kN == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %12, %11;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB), "n"(kTransA));
  }
  if constexpr (kN == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %20, %19;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB), "n"(kTransA));
  }
  if constexpr (kN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %36, %35;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB), "n"(kTransA));
  }
  if constexpr (kN == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %68, %67;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB), "n"(kTransA));
  }
}

// Column tiles [kN h, kN (h + 1)) of an accumulator of kW column tiles, as
// an accumulator of kN tiles (the operand of a product 8 kN wide).
template <int kN, int kW>
__device__ __forceinline__ float (&cols(float (&d)[kW][4], int h))[kN][4] {
  static_assert(kW % kN == 0, "whole column blocks");
  return *reinterpret_cast<float(*)[kN][4]>(&d[h * kN]);
}

// d[64 x kN] = A B (+ d if scale_d), A from registers (m64k16 fragment).
template <int kN, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[kN / 8][4], const uint32_t (&a)[4],
                                       uint64_t desc_b, int scale_d) {
  static_assert(kN == 16 || kN == 32 || kN == 64 || kN == 128,
                "register A products are kD wide");
  if constexpr (kN == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
  if constexpr (kN == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
  if constexpr (kN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
  if constexpr (kN == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(kTransB));
  }
}

}  // namespace msa_wgmma
