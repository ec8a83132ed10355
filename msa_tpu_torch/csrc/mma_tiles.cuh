// Warp-level tensor-core tiles for a head dim kD of 16, 32, 64, 128 or 256 (a
// template parameter of every tile function): the mma.sync primitives that the
// attention kernels of the port share (flash_kernels.cuh for row 11's bf16
// fused backward, and the copies and dropout words of rows 10-13;
// short_attention.cu and short_attention_v1.cu for the bf16 short-attention
// forwards, short_bwd_tc.cuh for the bf16 short-attention backwards).
//
// A warp owns 16 query rows.  Operands in shared memory are row-major bf16
// rows of kStride<kD> elements (kD values and 8 of padding: 528-, 272-,
// 144-, 80- and 48-byte rows at 256, 128, 64, 32 and 16; an odd multiple of
// 16 bytes, so the eight row addresses of an ldmatrix fall in distinct
// banks).  Q K^T takes kD / 16
// k-steps, and P V, dQ, dK and dV fill kD / 8 column tiles.  Products
// are m16n8k16 (bf16 in, f32 accumulate); their outputs stay in registers
// in mma.sync's accumulator layout, and that layout, packed to bf16, is the
// A operand of the next product (the probabilities are rounded there).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dropout.cuh"

namespace msa_mma {

template <int kD>
inline constexpr int kNT = kD / 8;      // 8-column tiles of a [16 x kD] fragment
template <int kD>
inline constexpr int kStride = kD + 8;  // bf16 row stride of a staged head row
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// The head dims the tiles take: 16-wide k-steps, column tiles in pairs,
// staged rows an odd multiple of 16 bytes apart.
template <int kD>
constexpr bool head_dim_ok() {
  return kD % 16 == 0 && (kStride<kD> * 2 / 16) % 2 == 1;
}
static_assert(head_dim_ok<16>() && head_dim_ok<32>() && head_dim_ok<64>() &&
                  head_dim_ok<128>() && head_dim_ok<256>(),
              "staged rows conflict-free");

// The host side's switch to the head dims the kernels are instantiated
// for: f(std::integral_constant<int, d>{}) for d = 16, 32, 64, 128 or 256, else
// cudaErrorInvalidValue.  A source built with -DMSA_HEAD_DIM=k (the build
// compiles each attention source once a head dim, in parallel) holds the
// kernels of head dim k alone; the Python wrappers pick its library by the
// head dim they hand it, any other head dim zero-padded up to k.
template <class F>
int by_head_dim(int d, F&& f) {
#ifdef MSA_HEAD_DIM
  static_assert(head_dim_ok<MSA_HEAD_DIM>(), "an instantiated head dim");
  if (d == MSA_HEAD_DIM) return f(std::integral_constant<int, MSA_HEAD_DIM>{});
#else
  if (d == 16) return f(std::integral_constant<int, 16>{});
  if (d == 32) return f(std::integral_constant<int, 32>{});
  if (d == 64) return f(std::integral_constant<int, 64>{});
  if (d == 128) return f(std::integral_constant<int, 128>{});
  if (d == 256) return f(std::integral_constant<int, 256>{});
#endif
  return (int)cudaErrorInvalidValue;
}

// The head dim hidden / num_heads if by_head_dim takes it, else 0.
inline int head_dim_of(int hidden, int num_heads) {
  if (num_heads <= 0 || hidden % num_heads) return 0;
  const int d = hidden / num_heads;
  return by_head_dim(d, [](auto) { return 0; }) == 0 ? d : 0;
}

// A [16 x 8kN] f32 tile held by one warp in mma.sync's accumulator layout:
// lane (g = lane / 4, c = lane % 4) holds x[n][0..1] at row g, columns
// 8n + 2c + {0, 1}, and x[n][2..3] at row g + 8, the same columns.
template <int kN>
struct Frag {
  float x[kN][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < kN; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
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
// 4 bytes global -> shared, asynchronously (through L1: .cg takes only 16);
// zero-filled when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
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
// Tile products of one warp, bf16 operands of row stride kStride<kD>.
//   mma_nt<kD, kN>(a, m0, b, c): c  = a[m0 .. m0+16) . b[0 .. 8kN)^T  (over kD columns)
//   mma_nn<kD, kN>(f, b, c):     c += f . b[0 .. 8kN)                  (f [16 x 8kN])
//   mma_tn<kD, kK>(at, lda, m0, b, c): below load_b_kn
// kN (8-column tiles of the [16 x 8kN] side) is even: 16 keys a k-step.
// ---------------------------------------------------------------------------

template <int kD, int kN>
__device__ __forceinline__ void mma_nt(const __nv_bfloat16* a, int m0,
                                       const __nv_bfloat16* b, float (&c)[kN][4]) {
  static_assert(kN % 2 == 0, "column tiles come in pairs");
  constexpr int ld = kStride<kD>;
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int n = 0; n < kN; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (m0 + r + 8 * (i & 1)) * ld + kk * 16 + 8 * (i >> 1));
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (n * 8 + r + 8 * (i >> 1)) * ld + kk * 16 + 8 * (i & 1));
      mma_bf16(c[n], af, bf[0], bf[1]);
      mma_bf16(c[n + 1], af, bf[2], bf[3]);
    }
  }
}

// B operand of k-step kk for column tiles n, n + 1 from a row-major [k][n]
// tile of row stride kStride<kD> (ldmatrix.trans gives each lane b[k = 2c +
// e][n = g]).
template <int kD>
__device__ __forceinline__ void load_b_kn(const __nv_bfloat16* b, int kk, int n,
                                          uint32_t* bf) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  ldsm_x4_trans(bf, b + (kk * 16 + r + 8 * (i & 1)) * kStride<kD> + n * 8 + 8 * (i >> 1));
}

template <int kD, int kN>
__device__ __forceinline__ void mma_nn(const float (&f)[kN][4], const __nv_bfloat16* b,
                                       float (&c)[kNT<kD>][4]) {
  static_assert(kN % 2 == 0, "column tiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
    // the accumulator layout of column tiles 2kk, 2kk+1 is the A layout
    const uint32_t af[4] = {pack_bf16(f[2 * kk][0], f[2 * kk][1]),
                            pack_bf16(f[2 * kk][2], f[2 * kk][3]),
                            pack_bf16(f[2 * kk + 1][0], f[2 * kk + 1][1]),
                            pack_bf16(f[2 * kk + 1][2], f[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < kNT<kD>; n += 2) {
      uint32_t bf[4];
      load_b_kn<kD>(b, kk, n, bf);
      mma_bf16(c[n], af, bf[0], bf[1]);
      mma_bf16(c[n + 1], af, bf[2], bf[3]);
    }
  }
}

// c = at[0 .. 16kK)[:, m0 .. m0+16)^T . b[0 .. 16kK): at a row-major [k][m]
// tile of row stride lda (16-byte rows, an odd multiple of 16 bytes apart
// for conflict-free ldmatrix), b a [k][kD] tile of row stride kStride<kD>.
template <int kD, int kK>
__device__ __forceinline__ void mma_tn(const __nv_bfloat16* at, int lda, int m0,
                                       const __nv_bfloat16* b, float (&c)[kNT<kD>][4]) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int n = 0; n < kNT<kD>; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    uint32_t af[4];
    ldsm_x4_trans(af, at + (kk * 16 + r + 8 * (i >> 1)) * lda + m0 + 8 * (i & 1));
#pragma unroll
    for (int n = 0; n < kNT<kD>; n += 2) {
      uint32_t bf[4];
      load_b_kn<kD>(b, kk, n, bf);
      mma_bf16(c[n], af, bf[0], bf[1]);
      mma_bf16(c[n + 1], af, bf[2], bf[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Moving bf16 rows between device memory and shared memory
// ---------------------------------------------------------------------------

// Rows [r0, r0 + n) of one head (row 0 at src + base, row stride ld) into
// dst (row stride kStride<kD>) by every thread of the block; rows >= seq
// are zero-filled.  Asynchronous: the caller commits and waits.
template <int kD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           size_t base, int ld, int r0, int n, int seq) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks of a head row
  for (int idx = threadIdx.x; idx < n * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const bool ok = r0 + r < seq;
    cp_async16(dst + r * kStride<kD> + ch * 8,
               src + base + (size_t)(ok ? r0 + r : 0) * ld + ch * 8, ok);
  }
}

// Column tiles [0, kN) of a warp's [16 x 8kN] f32 tile (accumulator layout)
// times mult, as bf16 into columns 8n of the warp's [16][kStride<kD>] stage
// (kN <= kD / 8).
template <int kD, int kN>
__device__ __forceinline__ void frag_to_stage(const float (&f)[kN][4], __nv_bfloat16* stage,
                                              float mult) {
  static_assert(kN <= kNT<kD>, "a stage row holds kD columns");
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * kStride<kD> + n * 8 + 2 * c) =
        pack_bf16(f[n][0] * mult, f[n][1] * mult);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kStride<kD> + n * 8 + 2 * c) =
        pack_bf16(f[n][2] * mult, f[n][3] * mult);
  }
}

// One head's rows for the short-attention forwards that hold every key:
// Q and K (one cp.async group), then V (the next), rows [0, rows) of
// [rows][kStride<kD>] tiles, zero-filled past seq, and the key bias times
// log2e into bias_s (-inf past seq: no keys, where a masked key has the
// -10000 fill).  The caller waits (cp_async_wait<1> for Q and K, <0> for
// V), each wait followed by __syncthreads.
template <int kD>
__device__ __forceinline__ void stage_head(__nv_bfloat16* q_s, __nv_bfloat16* k_s,
                                           __nv_bfloat16* v_s, float* bias_s,
                                           const __nv_bfloat16* q, const __nv_bfloat16* k,
                                           const __nv_bfloat16* v, const float* bias_row,
                                           size_t base, int ld, int rows, int seq) {
  stage_rows<kD>(q_s, q, base, ld, 0, rows, seq);
  stage_rows<kD>(k_s, k, base, ld, 0, rows, seq);
  cp_async_commit();
  stage_rows<kD>(v_s, v, base, ld, 0, rows, seq);
  cp_async_commit();
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    bias_s[j] = j < seq ? bias_row[j] * kLog2e : -INFINITY;
  }
}

// A warp's staged rows out to device memory in 16-byte vectors: chunk ch
// (8 values) of stage row r to dst + r * ld + 8 * ch, for rows r < rows and
// chunks ch < chunks (<= kD / 8).  The caller has written the stage and
// __syncwarp'd.
template <int kD>
__device__ __forceinline__ void stage_to_rows(const __nv_bfloat16* stage, __nv_bfloat16* dst,
                                              size_t ld, int rows, int chunks) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * kNT<kD>; idx += 32) {
    const int r = idx / kNT<kD>, ch = idx % kNT<kD>;
    if (r < rows && ch < chunks) {
      *reinterpret_cast<uint4*>(dst + r * ld + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kStride<kD> + ch * 8);
    }
  }
}

// A warp's [16 x kD] f32 tile (accumulator layout) times mult as bf16
// through its stage into rows [0, rows) of dst (row stride ld), 16-byte
// vectors.
template <int kD>
__device__ __forceinline__ void store_tile(const float (&f)[kNT<kD>][4], __nv_bfloat16* stage,
                                           __nv_bfloat16* dst, size_t ld, int rows,
                                           float mult = 1.f) {
  frag_to_stage<kD, kNT<kD>>(f, stage, mult);
  __syncwarp();
  stage_to_rows<kD>(stage, dst, ld, rows, kNT<kD>);
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
