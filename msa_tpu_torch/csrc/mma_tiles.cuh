// Warp-level tensor-core tiles for head dim 64: the mma.sync primitives that
// the attention kernels of the port share (flash_kernels.cuh for rows 10-13,
// short_attention.cu and short_attention_v1.cu for the bf16 short-attention
// forwards, short_bwd_tc.cuh for the bf16 v1 and v3 backwards).
//
// A warp owns 16 query rows.  Operands in shared memory are row-major bf16
// rows of kStride elements (64 values and 8 of padding: 144-byte rows, so
// the eight row addresses of an ldmatrix fall in distinct banks).  Products
// are m16n8k16 (bf16 in, f32 accumulate); their outputs stay in registers
// in mma.sync's accumulator layout, and that layout, packed to bf16, is the
// A operand of the next product (the probabilities are rounded there).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"

namespace msa_mma {

constexpr int kD = 64;                 // head dim: depth of nt, width of nn
constexpr int kNT = kD / 8;            // 8-column tiles of a [16 x 64] fragment
constexpr int kStride = kD + 8;        // 144-byte rows: ldmatrix conflict-free
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// A [16 x 64] f32 tile held by one warp in mma.sync's accumulator layout:
// lane (g = lane / 4, c = lane % 4) holds x[n][0..1] at row g, columns
// 8n + 2c + {0, 1}, and x[n][2..3] at row g + 8, the same columns.
struct Frag {
  float x[kNT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < kNT; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (the
// source address is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// Tile products of one warp, bf16 operands of row stride kStride.
//   mma_nt<kN>(a, m0, b, c): c  = a[m0 .. m0+16) . b[0 .. 8kN)^T  (over 64 columns)
//   mma_nn<kN>(f, b, c):     c += f . b[0 .. 8kN)                  (f [16 x 8kN])
//   mma_tn<kK>(at, lda, m0, b, c): below load_b_kn
// kN (8-column tiles of the [16 x 8kN] side) is even: 16 keys a k-step.
// ---------------------------------------------------------------------------

template <int kN>
__device__ __forceinline__ void mma_nt(const __nv_bfloat16* a, int m0,
                                       const __nv_bfloat16* b, float (&c)[kN][4]) {
  static_assert(kN % 2 == 0, "column tiles come in pairs");
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int n = 0; n < kN; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (m0 + r + 8 * (i & 1)) * kStride + kk * 16 + 8 * (i >> 1));
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (n * 8 + r + 8 * (i >> 1)) * kStride + kk * 16 + 8 * (i & 1));
      mma_bf16(c[n], af, bf[0], bf[1]);
      mma_bf16(c[n + 1], af, bf[2], bf[3]);
    }
  }
}

// B operand of k-step kk for column tiles n, n + 1 from a row-major [k][n]
// tile (ldmatrix.trans gives each lane b[k = 2c + e][n = g]).
__device__ __forceinline__ void load_b_kn(const __nv_bfloat16* b, int kk, int n,
                                          uint32_t* bf) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  ldsm_x4_trans(bf, b + (kk * 16 + r + 8 * (i & 1)) * kStride + n * 8 + 8 * (i >> 1));
}

template <int kN>
__device__ __forceinline__ void mma_nn(const float (&f)[kN][4], const __nv_bfloat16* b,
                                       float (&c)[kNT][4]) {
  static_assert(kN % 2 == 0, "column tiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
    // the accumulator layout of column tiles 2kk, 2kk+1 is the A layout
    const uint32_t af[4] = {pack_bf16(f[2 * kk][0], f[2 * kk][1]),
                            pack_bf16(f[2 * kk][2], f[2 * kk][3]),
                            pack_bf16(f[2 * kk + 1][0], f[2 * kk + 1][1]),
                            pack_bf16(f[2 * kk + 1][2], f[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < kNT; n += 2) {
      uint32_t bf[4];
      load_b_kn(b, kk, n, bf);
      mma_bf16(c[n], af, bf[0], bf[1]);
      mma_bf16(c[n + 1], af, bf[2], bf[3]);
    }
  }
}

// c = at[0 .. 16kK)[:, m0 .. m0+16)^T . b[0 .. 16kK): at a row-major [k][m]
// tile of row stride lda (16-byte rows, an odd multiple of 16 bytes apart
// for conflict-free ldmatrix), b a [k][64] tile of row stride kStride.
template <int kK>
__device__ __forceinline__ void mma_tn(const __nv_bfloat16* at, int lda, int m0,
                                       const __nv_bfloat16* b, float (&c)[kNT][4]) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int n = 0; n < kNT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    uint32_t af[4];
    ldsm_x4_trans(af, at + (kk * 16 + r + 8 * (i >> 1)) * lda + m0 + 8 * (i & 1));
#pragma unroll
    for (int n = 0; n < kNT; n += 2) {
      uint32_t bf[4];
      load_b_kn(b, kk, n, bf);
      mma_bf16(c[n], af, bf[0], bf[1]);
      mma_bf16(c[n + 1], af, bf[2], bf[3]);
    }
  }
}

// The products on [16 x 64] fragments and [64][kStride] tiles, as the
// flash kernels' policy P takes them (the f32 policy, SimtF32 in
// flash_kernels.cuh, stages through its float* scratch; this one has none).
//   nt(a, m0, b, c):  c  = a[m0 .. m0+16) . b^T         (over the 64 columns)
//   nn(f, b, c):      c += f . b                         (f's columns are k)
//   tn(at, m0, b, c): c  = at[:, m0 .. m0+16)^T . b      (over the 64 rows)
struct MmaBf16 {
  using T = __nv_bfloat16;
  static constexpr int kStride = msa_mma::kStride;
  static constexpr int kStageFloats = 0;

  __device__ static void nt(const T* a, int m0, const T* b, Frag& c, float*) {
    mma_nt<kNT>(a, m0, b, c.x);
  }

  __device__ static void nn(const Frag& f, const T* b, Frag& c, float*) {
    mma_nn<kNT>(f.x, b, c.x);
  }

  __device__ static void tn(const T* at, int m0, const T* b, Frag& c, float*) {
    mma_tn<kD / 16>(at, kStride, m0, b, c.x);
  }
};

// ---------------------------------------------------------------------------
// Moving bf16 rows between device memory and shared memory
// ---------------------------------------------------------------------------

// Rows [r0, r0 + n) of one head (row 0 at src + base, row stride ld) into
// dst (row stride kStride) by every thread of the block; rows >= seq are
// zero-filled.  Asynchronous: the caller commits and waits.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           size_t base, int ld, int r0, int n, int seq) {
  for (int idx = threadIdx.x; idx < n * (kD / 8); idx += blockDim.x) {
    const int r = idx >> 3, ch = idx & 7;
    const bool ok = r0 + r < seq;
    cp_async16(dst + r * kStride + ch * 8,
               src + base + (size_t)(ok ? r0 + r : 0) * ld + ch * 8, ok);
  }
}

// Column tiles [0, kN) of a warp's [16 x 8kN] f32 tile (accumulator layout)
// times mult, as bf16 into columns 8n of the warp's [16][kStride] stage
// (kN <= 8).
template <int kN>
__device__ __forceinline__ void frag_to_stage(const float (&f)[kN][4], __nv_bfloat16* stage,
                                              float mult) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * kStride + n * 8 + 2 * c) =
        pack_bf16(f[n][0] * mult, f[n][1] * mult);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kStride + n * 8 + 2 * c) =
        pack_bf16(f[n][2] * mult, f[n][3] * mult);
  }
}

// One head's rows for the short-attention forwards that hold every key:
// Q and K (one cp.async group), then V (the next), rows [0, rows) of
// [rows][kStride] tiles, zero-filled past seq, and the key bias times
// log2e into bias_s (-inf past seq: no keys, where a masked key has the
// -10000 fill).  The caller waits (cp_async_wait<1> for Q and K, <0> for
// V), each wait followed by __syncthreads.
__device__ __forceinline__ void stage_head(__nv_bfloat16* q_s, __nv_bfloat16* k_s,
                                           __nv_bfloat16* v_s, float* bias_s,
                                           const __nv_bfloat16* q, const __nv_bfloat16* k,
                                           const __nv_bfloat16* v, const float* bias_row,
                                           size_t base, int ld, int rows, int seq) {
  stage_rows(q_s, q, base, ld, 0, rows, seq);
  stage_rows(k_s, k, base, ld, 0, rows, seq);
  cp_async_commit();
  stage_rows(v_s, v, base, ld, 0, rows, seq);
  cp_async_commit();
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    bias_s[j] = j < seq ? bias_row[j] * kLog2e : -INFINITY;
  }
}

// A warp's staged rows out to device memory in 16-byte vectors: chunk ch
// (8 values) of stage row r to dst + r * ld + 8 * ch, for rows r < rows and
// chunks ch < chunks.  The caller has written the stage and __syncwarp'd.
__device__ __forceinline__ void stage_to_rows(const __nv_bfloat16* stage, __nv_bfloat16* dst,
                                              size_t ld, int rows, int chunks) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * kNT; idx += 32) {
    const int r = idx >> 3, ch = idx & 7;
    if (r < rows && ch < chunks) {
      *reinterpret_cast<uint4*>(dst + r * ld + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kStride + ch * 8);
    }
  }
}

// A warp's [16 x 64] f32 tile (accumulator layout) times mult as bf16
// through its stage into rows [0, rows) of dst (row stride ld), 16-byte
// vectors.
__device__ __forceinline__ void store_tile(const float (&f)[kNT][4], __nv_bfloat16* stage,
                                           __nv_bfloat16* dst, size_t ld, int rows,
                                           float mult = 1.f) {
  frag_to_stage<kNT>(f, stage, mult);
  __syncwarp();
  stage_to_rows(stage, dst, ld, rows, kNT);
}

// ---------------------------------------------------------------------------
// Softmax pieces on score tiles (a quad of lanes holds one row)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Scores of column tiles [0, kN) in the log2 domain: s * score_mult plus
// the key bias (bias: the tile's first key, already times log2e).
template <int kN>
__device__ __forceinline__ void scores_log2(float (&s)[kN][4], const float* bias,
                                            float score_mult) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float bb = bias[n * 8 + 2 * c + e];
      s[n][e] = fmaf(s[n][e], score_mult, bb);
      s[n][2 + e] = fmaf(s[n][2 + e], score_mult, bb);
    }
  }
}

// The row max of column tiles [0, kN), rows g and g + 8, over the quad.
template <int kN>
__device__ __forceinline__ void row_max(const float (&s)[kN][4], float* mx) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) mx[x >> 1] = fmaxf(mx[x >> 1], s[n][x]);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
}

// Keep words for a query-major fragment (rows = queries q_row, q_row + 8 of
// probability rows row_base + ..., columns = keys [k0, k0 + 64)): word gi
// holds, for keys k0 + 16 gi + jj, bit jj (row g) and bit 16 + jj (row g+8).
__device__ __forceinline__ void keep_words_qmajor(const msa_dropout::Dropout& drop,
                                                  uint32_t prob_row, int k0, uint32_t* w) {
  const int lane = threadIdx.x & 31;
  const uint32_t grp = (uint32_t)k0 / 16u + (uint32_t)(lane & 3);
  const uint32_t mine = msa_dropout::keep_bits16(drop, grp, prob_row) |
                        (msa_dropout::keep_bits16(drop, grp, prob_row + 8u) << 16);
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) w[gi] = __shfl_sync(kFull, mine, (lane & ~3) | gi);
}

// Is column e of column tile n (keys 8n + 2c + e) kept in row half r (0: g,
// 1: g + 8), given the words of keep_words_qmajor from the same k0?
__device__ __forceinline__ bool kept_at(const uint32_t* w, int n, int e, int r) {
  const int jj = (n & 1) * 8 + 2 * (threadIdx.x & 3) + e;
  return (w[n >> 1] >> (16 * r + jj)) & 1u;
}

}  // namespace msa_mma
