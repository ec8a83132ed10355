// The blockwise attention kernels of two sources, head dim 16, 32, 64, 128
// or 256:
// flash2.cu (the natural-layout flash2, kernel rows 10-12) and
// flash_attention.cu (the head-split flash attention, row 13).  The two
// contracts differ only in where a head's rows lie and in what the backward
// reads, so one set of kernels serves both, picked by the template flag
// kHeadSplit:
//
//                     kHeadSplit = false (flash2)   kHeadSplit = true (row 13)
//   q, k, v, o, grads [B, S, H], row stride H        [B, heads, S, d], stride d
//   row lse           log2 units                     natural-log units
//   o for delta       the f32 output (out32)         the output in its dtype
//   dropout in dV, dP dO * (1 / (1 - rate)), factor  the kept p rounded, dV
//                     and product rounded to the      and dP times 1 / (1 -
//                     storage type, then the kept p   rate) in f32
//                     rounded (flash2.py:248, :313,   (attention.py:242-244)
//                     :407)
//
// Inside, all run the softmax in base 2 (scores carry scale * log2e, exp2
// replaces exp); the head-split kernels convert their lse at the store
// and the load.  The families, by dtype and route:
//
//   * bf16 forward (rows 10, 13) and split backward (rows 12, 13) at every
//     head dim, and fused backward (row 11) from head dim 64: warpgroup
//     kernels on Hopper's wgmma (wgmma_tiles.cuh), flash_fwd_wg_kernel,
//     flash_bwd_dq_wg_kernel, flash_bwd_dkv_wg_kernel and, behind a delta
//     pre-pass, flash2_bwd_fused_wg_kernel below: 64-row warpgroup tiles
//     whose operands wgmma reads from swizzled shared memory, probabilities
//     and dS kept in the accumulator registers as the next product's A
//     operand.  At head dim 256 under dropout the forward is
//     flash_fwd_wg_overlap_kernel (kFwdOverlap), which issues the next key
//     tile's scores before this tile's P V product; the dq launch there is
//     one warpgroup holding dQ [64 x 256] f32 over 32-key tiles at two CTAs
//     an SM, the dk/dv launch flash_bwd_dkv_role_wg_kernel, two warpgroups
//     split by role (S^T, p and dV; dP^T, dS and dK), and the fused sweep's
//     two warpgroups share a CTA's 64 keys, each holding half the columns
//     of dK and dV;
//   * bf16 fused backward (row 11) at head dims 16 and 32:
//     flash2_bwd_fused_kernel, mma.sync warp tiles of 32 keys
//     (mma_tiles.cuh) behind the same pre-pass;
//   * f32 (the tests and the f32 checks): flash_fwd_kernel,
//     flash_bwd_dq_kernel and flash_bwd_dkv_kernel (split and fused) with
//     the tile products on the CUDA cores (SimtF32), 64-row blocks of 4
//     warps, up to kMaxF32HeadDim.
//
// Every family lays a score tile out as mma.sync's m16n8 accumulator (a
// warp holds rows g and g + 8 of its 16, columns 8n + 2c + {0, 1}), so the
// per-element code (softmax, key bias, dropout words, the folds of 1 / (1
// - rate)) reads alike in each.  flash2.cu's header says what bounds them.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dropout.cuh"
#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

namespace tc = msa_mma;
using msa_dropout::Dropout;
using msa_dropout::keep_bits16;
using msa_dropout::make_dropout;
using msa_mma::cp_async16;
using msa_mma::cp_async_commit;
using msa_mma::cp_async_wait;
using msa_mma::Frag;
using msa_mma::keep_words_qmajor;
using msa_mma::kFull;

// The f32 kernels' blocks (the bf16 kernels' tiles are their own, below).
constexpr int kBlock = 64;             // rows of a block and of a loop tile
constexpr int kWarps = kBlock / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kSN = kBlock / 8;        // 8-column tiles of a [16 x 64] score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using SFrag = Frag<kSN>;               // scores, probabilities, dS: [16 x 64]

static_assert(msa_dropout::kGroup == 16, "one Philox draw per 16 keys");
static_assert(kThreads == 2 * kBlock, "row_delta takes two threads per row");

// The tile products of the f32 policy on [kBlock][kStride] row tiles (q,
// k, v, dO; kD values a row) and one [kBlock][kTStride] tile of dS^T (the
// fused backward only):
//   nt(a, m0, b, c):       c  = a[m0 .. m0+16) . b^T  [16 x 64], over kD columns
//   nn(f, b, c):           c += f . b                 [16 x kD], f [16 x 64]
//   tn(at, m0, b, c):      c  = at[:, m0 .. m0+16)^T . b  [16 x kD], over 64 rows
//                          of at (row stride kTStride)

// f32 on the CUDA cores, each lane computing the elements its Frag holds
// (on the tensor cores f32 would be TF32).  nn stages f in the warp's
// shared scratch ([16][kSStride]).  Rows of kD + 4 floats (an odd multiple
// of 16 bytes).
template <int kDim>
struct SimtF32 {
  using T = float;
  static constexpr int kD = kDim;
  static constexpr int kON = kD / 8;
  static constexpr int kStride = kD + 4;
  static constexpr int kTStride = kBlock + 4;
  static constexpr int kSStride = kBlock + 4;    // the stage holds a score tile
  static constexpr int kStageFloats = kWarps * 16 * kSStride;
  using OFrag = Frag<kON>;

  __device__ static void nt(const float* a, int m0, const float* b, SFrag& c, float*) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    c.zero();
    const float* a0 = a + (m0 + g) * kStride;
    const float* a1 = a0 + 8 * kStride;
#pragma unroll 2
    for (int d = 0; d < kD; d += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + d);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + d);
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 y =
              *reinterpret_cast<const float4*>(b + (n * 8 + 2 * q + e) * kStride + d);
          float s0 = c.x[n][e], s1 = c.x[n][2 + e];
          s0 = fmaf(x0.x, y.x, s0); s0 = fmaf(x0.y, y.y, s0);
          s0 = fmaf(x0.z, y.z, s0); s0 = fmaf(x0.w, y.w, s0);
          s1 = fmaf(x1.x, y.x, s1); s1 = fmaf(x1.y, y.y, s1);
          s1 = fmaf(x1.z, y.z, s1); s1 = fmaf(x1.w, y.w, s1);
          c.x[n][e] = s0;
          c.x[n][2 + e] = s1;
        }
      }
    }
  }

  // c[g][:] += a_g * b[k][:], c[g + 8][:] += a_g8 * b[k][:] for one k
  __device__ static void axpy_row(float a_g, float a_g8, const float* brow, OFrag& c) {
    const int q = threadIdx.x & 3;
#pragma unroll
    for (int n = 0; n < kON; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(brow + n * 8 + 2 * q);
      c.x[n][0] = fmaf(a_g, y.x, c.x[n][0]);
      c.x[n][1] = fmaf(a_g, y.y, c.x[n][1]);
      c.x[n][2] = fmaf(a_g8, y.x, c.x[n][2]);
      c.x[n][3] = fmaf(a_g8, y.y, c.x[n][3]);
    }
  }

  __device__ static void nn(const SFrag& f, const float* b, OFrag& c, float* stage) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
      *reinterpret_cast<float2*>(stage + g * kSStride + n * 8 + 2 * q) =
          make_float2(f.x[n][0], f.x[n][1]);
      *reinterpret_cast<float2*>(stage + (g + 8) * kSStride + n * 8 + 2 * q) =
          make_float2(f.x[n][2], f.x[n][3]);
    }
    __syncwarp();
#pragma unroll 4
    for (int k = 0; k < kBlock; ++k) {
      axpy_row(stage[g * kSStride + k], stage[(g + 8) * kSStride + k], b + k * kStride, c);
    }
    __syncwarp();  // the stage is rewritten by the next product
  }

  __device__ static void tn(const float* at, int m0, const float* b, OFrag& c, float*) {
    const int g = (threadIdx.x & 31) >> 2;
    c.zero();
#pragma unroll 4
    for (int k = 0; k < kBlock; ++k) {
      axpy_row(at[k * kTStride + m0 + g], at[k * kTStride + m0 + g + 8], b + k * kStride, c);
    }
  }
};

// The widest head dim at which one warpgroup holds whole rows of both dK
// and dV (2 x [64 x kD] f32: kD registers a thread).  Above it (head dim
// 256) the backwards split that work over two warpgroups, and the dq
// launch's dQ [64 x 256] f32 (128 registers) leaves one warpgroup a CTA:
// the tile choices of the fused sweep (kFusedColGroups) and of the split
// pair (kDqGroups, kDkvCols, kDkvByRole) change above it.
constexpr int kMaxWholeDkvHeadDim = 128;
// f32's staged tiles fit in shared memory up to this head dim; above it f32
// is refused here (the Python wrappers run it on the short-attention
// CUDA-core kernels, which take any S).
constexpr int kMaxF32HeadDim = 128;

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------

// Element offset of row 0 of (batch row b, head) and the row stride:
// natural layout [B, S, hidden] or head-split [B, heads, S, kD].
template <int kD, bool kHeadSplit>
__device__ __forceinline__ size_t head_offset(int b, int head, int seq, int hidden) {
  return kHeadSplit ? ((size_t)b * gridDim.y + head) * seq * kD
                    : (size_t)b * seq * hidden + (size_t)head * kD;
}
template <int kD, bool kHeadSplit>
__device__ __forceinline__ int row_stride(int hidden) {
  return kHeadSplit ? kD : hidden;
}

// The output type delta = rowsum(dO o) reads: flash2 the f32 output, the
// head-split kernels the output in its own dtype (JAX's _flash_dq_kernel
// reads o_ref).
template <class P, bool kHeadSplit>
using OutT = std::conditional_t<kHeadSplit, typename P::T, float>;

// Rows [r0, r0 + 64) of one head of x into a shared tile; rows >= seq are
// zero-filled.  Asynchronous: the caller commits and waits.
template <class P>
__device__ __forceinline__ void load_tile(typename P::T* dst, const typename P::T* src,
                                          size_t head_base, int ld, int r0, int seq) {
  using T = typename P::T;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = P::kD / kVec;
  for (int idx = threadIdx.x; idx < kBlock * kChunks; idx += kThreads) {
    const int r = idx / kChunks, ch = idx - r * kChunks;
    const bool ok = r0 + r < seq;
    const T* g = src + head_base + (size_t)(ok ? r0 + r : 0) * ld + ch * kVec;
    cp_async16(dst + r * P::kStride + ch * kVec, g, ok);
  }
}

// x times m, rounded to x's type.
__device__ __forceinline__ void scale_in_place(float& x, float m) { x *= m; }
__device__ __forceinline__ void scale_in_place(__nv_bfloat16& x, float m) {
  x = __float2bfloat16_rn(__bfloat162float(x) * m);
}

// flash2's dropout factor 1 / (1 - rate) as JAX folds it into dO: the
// weakly typed Python float takes dO's dtype before the product
// (flash2.py:248, :313, :407), 1.109375 in bf16 at rate 26/256.
template <typename T>
__device__ __forceinline__ float fold_factor(float scale) {
  if constexpr (std::is_same_v<T, float>) {
    return scale;
  } else {
    return __bfloat162float(__float2bfloat16_rn(scale));
  }
}

// The chunks of a tile that this thread copied by load_tile, times mult,
// each value rounded to the tile's type (flash2's fold of the dropout
// factor into dO).  Called after cp_async_wait: a thread's own cp.async
// writes are visible to it then, so the block's next barrier publishes the
// scaled tile and no barrier is added.
template <class P>
__device__ __forceinline__ void scale_own_chunks(typename P::T* tile, float mult) {
  using T = typename P::T;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = P::kD / kVec;
  for (int idx = threadIdx.x; idx < kBlock * kChunks; idx += kThreads) {
    const int r = idx / kChunks, ch = idx - r * kChunks;
    uint4* chunk = reinterpret_cast<uint4*>(tile + r * P::kStride + ch * kVec);
    uint4 raw = *chunk;
    T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) scale_in_place(vals[e], mult);
    *chunk = raw;
  }
}

// The key bias of keys [k0, k0 + kN) in the log2 domain, -inf past seq.
template <int kN>
__device__ __forceinline__ void bias_tile(float* dst, const float* bias_row, int k0, int seq) {
  for (int j = threadIdx.x; j < kN; j += blockDim.x) {
    dst[j] = k0 + j < seq ? bias_row[k0 + j] * kLog2e : -INFINITY;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Rows g and g + 8 of a warp's Frag, times mult, into rows row0 and row0 + 8
// of one head of out; rows >= seq are skipped.
template <typename T, int kN>
__device__ __forceinline__ void store_frag(T* out, size_t head_base, int ld,
                                           int row0, int seq, const Frag<kN>& f,
                                           float mult0, float mult1) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= seq) continue;
    const float m = half ? mult1 : mult0;
    T* p = out + head_base + (size_t)row * ld + 2 * q;
#pragma unroll
    for (int n = 0; n < kN; ++n) store2(p + n * 8, f.x[n][2 * half] * m, f.x[n][2 * half + 1] * m);
  }
}

// Four consecutive values as f32 (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// delta_i = dO_i . o_i for the 64 rows [i0, i0 + 64) of a staged dO tile,
// o read from global memory (f32 or the storage type); rows >= seq give 0.
// Two threads per row.  kFold: each thread then writes the values of dO it
// read back times mult, rounded to the tile's type (flash2's fold of 1 /
// (1 - rate) into dO, after delta took the unscaled dO); the caller
// synchronises before the tile is read again.
template <class P, bool kFold, typename OT>
__device__ __forceinline__ float row_delta(typename P::T* do_s, const OT* out,
                                           size_t head_base, int ld, int i0, int seq,
                                           int* row_out, float mult) {
  constexpr int kHalf = P::kD / 2;
  const int j = threadIdx.x >> 1, half = threadIdx.x & 1;
  float sum = 0.f;
  if (i0 + j < seq) {
    const OT* o = out + head_base + (size_t)(i0 + j) * ld + half * kHalf;
    typename P::T* d = do_s + j * P::kStride + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; e += 4) {
      const float4 ov = load4(o + e);
      sum = fmaf(to_float(d[e]), ov.x, sum);
      sum = fmaf(to_float(d[e + 1]), ov.y, sum);
      sum = fmaf(to_float(d[e + 2]), ov.z, sum);
      sum = fmaf(to_float(d[e + 3]), ov.w, sum);
      if constexpr (kFold) {
#pragma unroll
        for (int x = 0; x < 4; ++x) scale_in_place(d[e + x], mult);
      }
    }
  }
  sum += __shfl_xor_sync(kFull, sum, 1);
  *row_out = half == 0 ? j : -1;
  return sum;
}

// ---------------------------------------------------------------------------
// Forward (rows 10 and 13)
// ---------------------------------------------------------------------------

template <class P>
constexpr int fwd_smem_bytes() {
  return 5 * kBlock * P::kStride * (int)sizeof(typename P::T) + 2 * kBlock * 4 +
         P::kStageFloats * 4;
}

template <class P, bool kHeadSplit, bool kDropout, bool kTrain>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const typename P::T* __restrict__ q, const typename P::T* __restrict__ k,
                  const typename P::T* __restrict__ v, const float* __restrict__ key_bias,
                  typename P::T* __restrict__ out, float* __restrict__ lse,
                  float* __restrict__ out32, int seq, int hidden, float score_mult,
                  Dropout drop) {
  using T = typename P::T;
  constexpr int kTileElems = kBlock * P::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kTileElems;       // two buffers
  T* v_s = k_s + 2 * kTileElems;   // two buffers
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * kTileElems);  // [2][64]
  float* stage = bias_s + 2 * kBlock;

  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t head_base = head_offset<P::kD, kHeadSplit>(b, head, seq, hidden);
  const int ld = row_stride<P::kD, kHeadSplit>(hidden);
  const float* bias_row = key_bias + (size_t)b * seq;
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  float* my_stage = stage + warp * 16 * P::kSStride;

  load_tile<P>(q_s, q, head_base, ld, q0, seq);
  load_tile<P>(k_s, k, head_base, ld, 0, seq);
  load_tile<P>(v_s, v, head_base, ld, 0, seq);
  cp_async_commit();
  bias_tile<kBlock>(bias_s, bias_row, 0, seq);

  typename P::OFrag acc;
  acc.zero();
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy overlaps this tile's math
      const int nb = buf ^ 1;
      load_tile<P>(k_s + nb * kTileElems, k, head_base, ld, (t + 1) * kBlock, seq);
      load_tile<P>(v_s + nb * kTileElems, v, head_base, ld, (t + 1) * kBlock, seq);
      cp_async_commit();
      bias_tile<kBlock>(bias_s + nb * kBlock, bias_row, (t + 1) * kBlock, seq);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    SFrag s;
    P::nt(q_s, warp * 16, k_s + buf * kTileElems, s, my_stage);
    const float* bias_t = bias_s + buf * kBlock;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bb = bias_t[n * 8 + 2 * c + e];
        s.x[n][e] = fmaf(s.x[n][e], score_mult, bb);
        s.x[n][2 + e] = fmaf(s.x[n][2 + e], score_mult, bb);
        mx[0] = fmaxf(mx[0], s.x[n][e]);
        mx[1] = fmaxf(mx[1], s.x[n][2 + e]);
      }
    }
    // Online softmax.  Every tile holds >= 1 key < seq, so the row max is
    // finite and exp2(-inf - max) = 0 on the first tile.  The normaliser
    // sums every probability; dropout only zeroes what reaches the PV
    // product (its 1/(1 - rate) is applied at the end).
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
    uint32_t keep[4] = {kFull, kFull, kFull, kFull};
    if constexpr (kDropout) keep_words_qmajor(drop, row_base + row0, t * kBlock, keep);
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2f(s.x[n][e] - m_run[0]);
        const float p1 = exp2f(s.x[n][2 + e] - m_run[1]);
        l_run[0] += p0;
        l_run[1] += p1;
        const int jj = (n & 1) * 8 + 2 * c + e;
        const uint32_t w = keep[n >> 1];
        s.x[n][e] = ((w >> jj) & 1u) ? p0 : 0.f;
        s.x[n][2 + e] = ((w >> (16 + jj)) & 1u) ? p1 : 0.f;
      }
    }
#pragma unroll
    for (int n = 0; n < P::kON; ++n) {
      acc.x[n][0] *= corr[0];
      acc.x[n][1] *= corr[0];
      acc.x[n][2] *= corr[1];
      acc.x[n][3] *= corr[1];
    }
    P::nn(s, v_s + buf * kTileElems, acc, my_stage);
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
  }
  if constexpr (kHeadSplit) {  // JAX's guard (_flash_kernel: max(l, 1e-30))
    l_run[0] = fmaxf(l_run[0], 1e-30f);
    l_run[1] = fmaxf(l_run[1], 1e-30f);
  }
  const float inv0 = drop.scale / l_run[0], inv1 = drop.scale / l_run[1];
  store_frag(out, head_base, ld, row0, seq, acc, inv0, inv1);
  if constexpr (kTrain) {
    // the row lse in log2 units; the head-split contract stores it in
    // natural-log units (m + log l of the natural scores)
    const float unit = kHeadSplit ? kLn2 : 1.f;
    if (c == 0) {
      if (row0 < seq) lse[row_base + row0] = (m_run[0] + log2f(l_run[0])) * unit;
      if (row0 + 8 < seq) lse[row_base + row0 + 8] = (m_run[1] + log2f(l_run[1])) * unit;
    }
    if (out32 != nullptr) store_frag(out32, head_base, ld, row0, seq, acc, inv0, inv1);
  }
}

// ---------------------------------------------------------------------------
// Split backward 1/2: dq, and delta = rowsum(dO o) for the dk/dv launch
// (rows 12 and 13)
// ---------------------------------------------------------------------------

template <class P>
constexpr int dq_smem_bytes() {
  return 6 * kBlock * P::kStride * (int)sizeof(typename P::T) + 4 * kBlock * 4 +
         P::kStageFloats * 4;
}

// Under dropout flash2 folds 1 / (1 - rate) into its staged dO tile, the
// factor and the product rounded to the storage type (fold_factor; JAX's
// flash2.py:248, :313, :407), after delta is taken from the unscaled dO; the head-split kernels scale dP and dV in f32
// (attention.py:203, :242-245).
template <bool kHeadSplit, bool kDropout>
constexpr bool kFoldDo = kDropout && !kHeadSplit;

template <class P, bool kHeadSplit, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const typename P::T* __restrict__ q, const typename P::T* __restrict__ k,
                    const typename P::T* __restrict__ v, const float* __restrict__ key_bias,
                    const OutT<P, kHeadSplit>* __restrict__ o, const typename P::T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta_out,
                    typename P::T* __restrict__ dq, int seq, int hidden, float score_mult,
                    float scale, Dropout drop) {
  using T = typename P::T;
  constexpr int kTileElems = kBlock * P::kStride;
  constexpr bool kFold = kFoldDo<kHeadSplit, kDropout>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kTileElems;
  T* k_s = do_s + kTileElems;      // two buffers
  T* v_s = k_s + 2 * kTileElems;   // two buffers
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * kTileElems);  // [2][64]
  float* lse_s = bias_s + 2 * kBlock;
  float* delta_s = lse_s + kBlock;
  float* stage = delta_s + kBlock;

  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t head_base = head_offset<P::kD, kHeadSplit>(b, head, seq, hidden);
  const int ld = row_stride<P::kD, kHeadSplit>(hidden);
  const float* bias_row = key_bias + (size_t)b * seq;
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int row0 = q0 + warp * 16 + g;
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  float* my_stage = stage + warp * 16 * P::kSStride;

  load_tile<P>(q_s, q, head_base, ld, q0, seq);
  load_tile<P>(do_s, dout, head_base, ld, q0, seq);
  cp_async_commit();
  load_tile<P>(k_s, k, head_base, ld, 0, seq);
  load_tile<P>(v_s, v, head_base, ld, 0, seq);
  cp_async_commit();
  bias_tile<kBlock>(bias_s, bias_row, 0, seq);
  for (int j = threadIdx.x; j < kBlock; j += kThreads) {
    // p = 0 past seq; the head-split lse arrives in natural-log units
    lse_s[j] = q0 + j < seq ? lse[row_base + q0 + j] * (kHeadSplit ? kLog2e : 1.f) : INFINITY;
  }
  cp_async_wait<1>();  // q and dO have landed
  __syncthreads();
  {
    int j;
    const float d = row_delta<P, kFold>(do_s, o, head_base, ld, q0, seq, &j,
                                        fold_factor<T>(drop.scale));
    if (j >= 0) {
      delta_s[j] = d;
      if (q0 + j < seq) delta_out[row_base + q0 + j] = d;
    }
  }
  __syncthreads();
  const float lse_r[2] = {lse_s[warp * 16 + g], lse_s[warp * 16 + g + 8]};
  const float delta_r[2] = {delta_s[warp * 16 + g], delta_s[warp * 16 + g + 8]};

  typename P::OFrag dqa;
  dqa.zero();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      const int nb = buf ^ 1;
      load_tile<P>(k_s + nb * kTileElems, k, head_base, ld, (t + 1) * kBlock, seq);
      load_tile<P>(v_s + nb * kTileElems, v, head_base, ld, (t + 1) * kBlock, seq);
      cp_async_commit();
      bias_tile<kBlock>(bias_s + nb * kBlock, bias_row, (t + 1) * kBlock, seq);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    SFrag s, dp;
    P::nt(q_s, warp * 16, k_s + buf * kTileElems, s, my_stage);
    P::nt(do_s, warp * 16, v_s + buf * kTileElems, dp, my_stage);
    const float* bias_t = bias_s + buf * kBlock;
    uint32_t keep[4] = {kFull, kFull, kFull, kFull};
    if constexpr (kDropout) keep_words_qmajor(drop, row_base + row0, t * kBlock, keep);
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bb = bias_t[n * 8 + 2 * c + e];
        const int jj = (n & 1) * 8 + 2 * c + e;
        const uint32_t w = keep[n >> 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p = exp2f(fmaf(s.x[n][2 * r + e], score_mult, bb) - lse_r[r]);
          float dpm = dp.x[n][2 * r + e];
          if constexpr (kDropout) {
            const bool kept = (w >> (16 * r + jj)) & 1u;
            dpm = kept ? (kFold ? dpm : dpm * drop.scale) : 0.f;
          }
          s.x[n][2 * r + e] = p * (dpm - delta_r[r]);
        }
      }
    }
    P::nn(s, k_s + buf * kTileElems, dqa, my_stage);
    __syncthreads();
  }
  store_frag(dq, head_base, ld, row0, seq, dqa, scale, scale);
}

// ---------------------------------------------------------------------------
// dk/dv: the split backward's second launch (rows 12 and 13, kFused =
// false, delta from the dq launch) and flash2's fused single-sweep backward
// in f32 (row 11, kFused = true: delta per query tile, dq by f32 atomics;
// bf16 takes flash2_bwd_fused_kernel or flash2_bwd_fused_wg_kernel below)
// ---------------------------------------------------------------------------

template <class P, bool kFused>
constexpr int dkv_smem_bytes() {
  return 4 * kBlock * P::kStride * (int)sizeof(typename P::T) +
         (kFused ? kBlock * P::kTStride * (int)sizeof(typename P::T) : 0) +
         2 * kBlock * 4 + P::kStageFloats * 4;
}

template <class P, bool kHeadSplit, bool kDropout, bool kFused>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const typename P::T* __restrict__ q, const typename P::T* __restrict__ k,
                     const typename P::T* __restrict__ v, const float* __restrict__ key_bias,
                     const OutT<P, kHeadSplit>* __restrict__ o, const typename P::T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta_in,
                      float* __restrict__ dq32, typename P::T* __restrict__ dk,
                      typename P::T* __restrict__ dv, int seq, int hidden, float score_mult,
                      float scale, Dropout drop) {
  using T = typename P::T;
  constexpr int kTileElems = kBlock * P::kStride;
  constexpr bool kFold = kFoldDo<kHeadSplit, kDropout>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kb_s = reinterpret_cast<T*>(smem);  // this CTA's key block
  T* vb_s = kb_s + kTileElems;
  T* q_s = vb_s + kTileElems;            // the current query tile
  T* do_s = q_s + kTileElems;
  T* dst_s = do_s + kTileElems;          // dS^T [key][query] (fused only)
  float* lse_s = reinterpret_cast<float*>(dst_s + (kFused ? kBlock * P::kTStride : 0));
  float* delta_s = lse_s + kBlock;
  float* stage = delta_s + kBlock;

  const int b = blockIdx.z, head = blockIdx.y, kb0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t head_base = head_offset<P::kD, kHeadSplit>(b, head, seq, hidden);
  const int ld = row_stride<P::kD, kHeadSplit>(hidden);
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int key0 = kb0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  const int n_tiles = (seq + kBlock - 1) / kBlock;
  float* my_stage = stage + warp * 16 * P::kSStride;
  // the warp's 16 keys are one Philox group
  const uint32_t grp = (uint32_t)(kb0 + warp * 16) / 16u;

  float bias2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    bias2[r] = key < seq ? key_bias[(size_t)b * seq + key] * kLog2e : -INFINITY;
  }
  load_tile<P>(kb_s, k, head_base, ld, kb0, seq);
  load_tile<P>(vb_s, v, head_base, ld, kb0, seq);

  typename P::OFrag dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * kBlock;
    load_tile<P>(q_s, q, head_base, ld, i0, seq);
    load_tile<P>(do_s, dout, head_base, ld, i0, seq);
    cp_async_commit();
    for (int j = threadIdx.x; j < kBlock; j += kThreads) {
      const bool ok = i0 + j < seq;
      // p = 0 past seq; the head-split lse arrives in natural-log units
      lse_s[j] = ok ? lse[row_base + i0 + j] * (kHeadSplit ? kLog2e : 1.f) : INFINITY;
      if constexpr (!kFused) delta_s[j] = ok ? delta_in[row_base + i0 + j] : 0.f;
    }
    cp_async_wait<0>();
    // the split route's delta came from the unscaled dO: fold as it lands
    if constexpr (kFold && !kFused) scale_own_chunks<P>(do_s, fold_factor<T>(drop.scale));
    __syncthreads();
    if constexpr (kFused) {  // delta from the unscaled dO, then the fold
      int j;
      const float d = row_delta<P, kFold>(do_s, o, head_base, ld, i0, seq, &j,
                                          fold_factor<T>(drop.scale));
      if (j >= 0) delta_s[j] = d;
      __syncthreads();
    }

    // S^T and dP^T: rows = this warp's keys, columns = the tile's queries
    SFrag st, dpt;
    P::nt(kb_s, warp * 16, q_s, st, my_stage);
    P::nt(vb_s, warp * 16, do_s, dpt, my_stage);
    uint32_t mine = kFull;  // keep bits of queries lane, lane + 32 (16 keys each)
    if constexpr (kDropout) {
      mine = keep_bits16(drop, grp, row_base + i0 + lane) |
             (keep_bits16(drop, grp, row_base + i0 + lane + 32) << 16);
    }
#pragma unroll
    for (int n = 0; n < kSN / 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t w = kFull;
        if constexpr (kDropout) w = __shfl_sync(kFull, mine, n * 8 + 2 * c + e);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {  // query columns n*8 + ... and +32
          const int nn = n + hi * (kSN / 2);
          const int col = nn * 8 + 2 * c + e;
          const uint32_t bits = w >> (16 * hi);
          const float l = lse_s[col], dl = delta_s[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p = exp2f(fmaf(st.x[nn][2 * r + e], score_mult, bias2[r]) - l);
            float pd = p, dpm = dpt.x[nn][2 * r + e];
            if constexpr (kDropout) {
              // the kept p unscaled (flash2: dO carries 1 / (1 - rate); the
              // head-split dV is scaled at its store).  A product with the
              // keep bit, not a select: with selects ptxas fitted the
              // head-split kernel into 176 registers in place of 212 and
              // row 13's backward ran 8-10 % slower on the H100.
              const float kept = ((bits >> (g + 8 * r)) & 1u) ? 1.f : 0.f;
              pd = p * kept;
              dpm *= kFold ? kept : kept * drop.scale;
            }
            st.x[nn][2 * r + e] = p * (dpm - dl);  // dS^T
            dpt.x[nn][2 * r + e] = pd;             // P^T with dropout
          }
        }
      }
    }
    P::nn(dpt, do_s, dv_acc, my_stage);  // dV += P^T dO
    P::nn(st, q_s, dk_acc, my_stage);    // dK += dS^T Q
    if constexpr (kFused) {
      // dQ[i0 .. i0+64) += dS K: dS^T through shared memory, each warp then
      // takes 16 queries over the block's 64 keys
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          T* p = dst_s + (warp * 16 + g + 8 * r) * P::kTStride + n * 8 + 2 * c;
          store2(p, st.x[n][2 * r], st.x[n][2 * r + 1]);
        }
      }
      __syncthreads();
      typename P::OFrag dqp;
      P::tn(dst_s, warp * 16, kb_s, dqp, my_stage);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = i0 + warp * 16 + g + 8 * r;
        if (row >= seq) continue;
        float* p = dq32 + head_base + (size_t)row * ld + 2 * c;
#pragma unroll
        for (int n = 0; n < P::kON; ++n) {  // 8-byte vector atomics (sm_90)
          atomicAdd(reinterpret_cast<float2*>(p + n * 8),
                    make_float2(dqp.x[n][2 * r] * scale, dqp.x[n][2 * r + 1] * scale));
        }
      }
    }
    __syncthreads();  // the tile buffers are reloaded next
  }
  // the head-split kernels' dV carries 1 / (1 - rate) from here (JAX's
  // _flash_dkv_kernel scales each tile's f32 product)
  const float dv_mult = kDropout && kHeadSplit ? drop.scale : 1.f;
  store_frag(dk, head_base, ld, key0, seq, dk_acc, scale, scale);
  store_frag(dv, head_base, ld, key0, seq, dv_acc, dv_mult, dv_mult);
}

// ---------------------------------------------------------------------------
// The fused backward's pre-pass (row 11, both dtypes)
// ---------------------------------------------------------------------------
//
// flash2_bwd_prep_kernel takes delta = rowsum(dO o32) from the unscaled dO
// once per row ([B, heads, S] f32) and zeroes the f32 dq scratch that the
// sweep then sums into (bf16: flash2_bwd_fused_kernel up to
// kFusedMmaMaxDim, flash2_bwd_fused_wg_kernel above; f32:
// flash_bwd_dkv_kernel<SimtF32, ..., kFused = true>, which takes its own
// delta per tile and reads only the zeroed scratch).

constexpr int kPrepThreads = 256;

// Eight consecutive values as f32.
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// delta[b, head, i] = dO_i . o32_i over the head's kD columns (dO unscaled,
// in its type) and dq32 = 0.  A thread takes 8 columns of a row; the kD / 8
// lanes of a head's row sum by shuffles.
template <typename T, int kD>
__global__ void __launch_bounds__(kPrepThreads)
flash2_bwd_prep_kernel(const float* __restrict__ o32, const T* __restrict__ dout,
                       float* __restrict__ delta, float* __restrict__ dq32, int seq,
                       int hidden, int num_heads, long long chunks) {
  constexpr int kTeam = kD / 8;
  const long long idx = (long long)blockIdx.x * kPrepThreads + threadIdx.x;
  const bool ok = idx < chunks;
  float sum = 0.f;
  if (ok) {
    float d[8], o[8];
    load8(dout + idx * 8, d);
    load8(o32 + idx * 8, o);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum = fmaf(d[e], o[e], sum);
    float4* z = reinterpret_cast<float4*>(dq32 + idx * 8);
    z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int m = kTeam / 2; m > 0; m >>= 1) sum += __shfl_xor_sync(kFull, sum, m);
  const int per_row = hidden / 8;
  if (ok && idx % kTeam == 0) {
    const long long row = idx / per_row;  // b * seq + i
    const int head = (int)(idx - row * per_row) / kTeam;
    const long long b = row / seq, i = row - b * seq;
    delta[(b * num_heads + head) * seq + i] = sum;
  }
}

// ---------------------------------------------------------------------------
// The fused sweep in bf16 up to kFusedMmaMaxDim (row 11 at head dims 16 and
// 32, and the head dims padded onto them)
// ---------------------------------------------------------------------------
//
// flash2_bwd_fused_kernel runs one CTA of 4 warps per 128 keys of a (head,
// batch row), each warp 32 keys (two 16-key mma.sync tiles,
// mma_tiles.cuh), over query tiles of 64 that a two-stage cp.async ring
// brings in (q, dO, and the tile's lse and delta) while the tile before is
// computed.  A warp takes each tile in two halves of 32 queries, so its
// score tiles are 2 x [16 x 32]: S^T and dP^T (each q and dO fragment
// loaded once for both key tiles), p and dS in registers, dV += P^T dO and
// dK += dS^T Q, and dS^T (bf16) into a [128 keys][64 queries] shared tile.
// After a barrier each warp takes dQ[16 queries x d] = dS K over the
// block's 128 keys and adds it to the f32 scratch by 16-byte vector
// atomics (lane pairs swap halves so that each lane holds 4 consecutive
// columns of one row).  At these head dims a tile's products are one or two
// k-steps deep, and the warpgroup sweep below, whose warpgroups wait on
// their products and barriers in step, measured slower than these eight
// independent warps an SM (PERF.md §6), so they keep this form.
constexpr int kFusedMmaMaxDim = 32;
constexpr int kFM = 2;                // 16-key mma tiles a warp
constexpr int kFKeys = 64 * kFM;      // keys of a CTA
constexpr int kFThreads = 128;        // 4 warps
constexpr int kFQ = 64;               // queries of a ring tile
constexpr int kFTStride = kFQ + 8;    // dS^T rows: 144 bytes, conflict-free
static_assert(kFThreads == 2 * kFQ, "the dQ step: a warp per 16 queries");
static_assert(kFThreads == 32 * kFKeys / (16 * kFM), "a warp per 16 kFM keys");

template <int kD>
constexpr int fused_tc_smem_bytes() {
  // K and V blocks, two ring stages of q and dO, the dS^T tile, two stages
  // of lse and delta
  return (2 * kFKeys + 4 * kFQ) * tc::kStride<kD> * 2 + kFKeys * kFTStride * 2 + 4 * kFQ * 4;
}

template <int kD, int kM, int kN>
__device__ __forceinline__ void mma_nt_m(const __nv_bfloat16* a, int m0,
                                         const __nv_bfloat16* b, float (&c)[kM][kN][4]) {
  constexpr int ld = tc::kStride<kD>;
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int n = 0; n < kN; ++n) c[m][n][0] = c[m][n][1] = c[m][n][2] = c[m][n][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t af[kM][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      tc::ldsm_x4(af[m], a + (m0 + 16 * m + r + 8 * (i & 1)) * ld + kk * 16 + 8 * (i >> 1));
    }
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      uint32_t bf[4];
      tc::ldsm_x4(bf, b + (n * 8 + r + 8 * (i >> 1)) * ld + kk * 16 + 8 * (i & 1));
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        tc::mma_bf16(c[m][n], af[m], bf[0], bf[1]);
        tc::mma_bf16(c[m][n + 1], af[m], bf[2], bf[3]);
      }
    }
  }
}

// c[m] += f[m] . b[0 .. 8kN) for m < kM (f[m] [16 x 8kN], rounded to bf16
// as the A operand): the b fragments loaded once for the kM row tiles.
template <int kD, int kM, int kN>
__device__ __forceinline__ void mma_nn_m(const float (&f)[kM][kN][4], const __nv_bfloat16* b,
                                         float (&c)[kM][tc::kNT<kD>][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
    uint32_t af[kM][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      af[m][0] = tc::pack_bf16(f[m][2 * kk][0], f[m][2 * kk][1]);
      af[m][1] = tc::pack_bf16(f[m][2 * kk][2], f[m][2 * kk][3]);
      af[m][2] = tc::pack_bf16(f[m][2 * kk + 1][0], f[m][2 * kk + 1][1]);
      af[m][3] = tc::pack_bf16(f[m][2 * kk + 1][2], f[m][2 * kk + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < tc::kNT<kD>; n += 2) {
      uint32_t bf[4];
      tc::load_b_kn<kD>(b, kk, n, bf);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        tc::mma_bf16(c[m][n], af[m], bf[0], bf[1]);
        tc::mma_bf16(c[m][n + 1], af[m], bf[2], bf[3]);
      }
    }
  }
}

template <int kD, bool kDropout>
__global__ void __launch_bounds__(kFThreads, 2)
flash2_bwd_fused_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq32,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                        int seq, int hidden, float score_mult, float scale, Dropout drop) {
  using T = __nv_bfloat16;
  static_assert(kD <= kFusedMmaMaxDim, "the warpgroup sweep takes the wider head dims");
  constexpr int kM = kFM;
  constexpr int kKeys = kFKeys;
  constexpr int ld = tc::kStride<kD>;
  constexpr int kStage = kFQ * ld;         // elements of a ring tile
  constexpr int kChunks = kD / 8;          // 16-byte chunks of a head row
  constexpr int kON = kD / 8;              // 8-column tiles of a head row
  extern __shared__ __align__(16) unsigned char smem[];
  T* kb_s = reinterpret_cast<T*>(smem);    // [kKeys][ld]
  T* vb_s = kb_s + kKeys * ld;
  T* q_s = vb_s + kKeys * ld;              // [2][64][ld]
  T* do_s = q_s + 2 * kStage;              // [2][64][ld]
  T* dst_s = do_s + 2 * kStage;            // dS^T [kKeys][kFTStride]
  float* lse_s = reinterpret_cast<float*>(dst_s + kKeys * kFTStride);  // [2][64]
  float* delta_s = lse_s + 2 * kFQ;                                     // [2][64]

  const int b = blockIdx.z, head = blockIdx.y, kb0 = blockIdx.x * kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const size_t head_base = (size_t)b * seq * hidden + (size_t)head * kD;
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int wk0 = kb0 + warp * 16 * kM;    // the warp's first key
  const int n_tiles = (seq + kFQ - 1) / kFQ;

  // q, dO rows [i0, i0 + 64) and their lse and delta into ring stage st;
  // zero-filled past seq
  auto load_tile = [&](int st, int i0) {
    tc::stage_rows<kD>(q_s + st * kStage, q, head_base, hidden, i0, kFQ, seq);
    tc::stage_rows<kD>(do_s + st * kStage, dout, head_base, hidden, i0, kFQ, seq);
    for (int j = threadIdx.x; j < 2 * kFQ; j += kFThreads) {
      const int jj = j & (kFQ - 1);
      const bool ok = i0 + jj < seq;
      const float* src = (j < kFQ ? lse : delta) + row_base + (ok ? i0 + jj : 0);
      tc::cp_async4((j < kFQ ? lse_s : delta_s) + st * kFQ + jj, src, ok);
    }
  };

  float bias2[kM][2];  // this lane's keys wk0 + 16 m + g + 8 r
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = wk0 + 16 * m + g + 8 * r;
      bias2[m][r] = key < seq ? key_bias[(size_t)b * seq + key] * kLog2e : -INFINITY;
    }
  }
  tc::stage_rows<kD>(kb_s, k, head_base, hidden, kb0, kKeys, seq);
  tc::stage_rows<kD>(vb_s, v, head_base, hidden, kb0, kKeys, seq);
  load_tile(0, 0);
  cp_async_commit();

  float dk_acc[kM][kON][4], dv_acc[kM][kON][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int n = 0; n < kON; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) dk_acc[m][n][x] = dv_acc[m][n][x] = 0.f;
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, i0 = t * kFQ;
    if (t + 1 < n_tiles) {  // tile t + 1 lands while tile t is computed
      load_tile(st ^ 1, i0 + kFQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    T* qt = q_s + st * kStage;
    T* dot = do_s + st * kStage;
    if constexpr (kDropout) {
      // fold 1 / (1 - rate) into the chunks of dO this thread copied (delta
      // took the unscaled dO); the barrier below publishes them
      const float fold = fold_factor<T>(drop.scale);
      for (int idx = threadIdx.x; idx < kFQ * kChunks; idx += kFThreads) {
        const int r = idx / kChunks, ch = idx - r * kChunks;
        uint4* chunk = reinterpret_cast<uint4*>(dot + r * ld + ch * 8);
        uint4 raw = *chunk;
        T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) scale_in_place(vals[e], fold);
        *chunk = raw;
      }
    }
    __syncthreads();
    const float* lt = lse_s + st * kFQ;
    const float* dt = delta_s + st * kFQ;

#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {  // queries [32 hq, 32 hq + 32) of the tile
      const T* qh = qt + hq * 32 * ld;
      const T* doh = dot + hq * 32 * ld;
      float s[kM][4][4], dp[kM][4][4];  // S^T, dP^T: rows = keys, columns = queries
      mma_nt_m<kD, kM, 4>(kb_s, warp * 16 * kM, qh, s);
      mma_nt_m<kD, kM, 4>(vb_s, warp * 16 * kM, doh, dp);
      uint32_t mine[kM];  // keep bits of query 32 hq + lane, key tile m
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        mine[m] = kFull;
        if constexpr (kDropout) {
          mine[m] = keep_bits16(drop, (uint32_t)(wk0 + 16 * m) / 16u,
                                row_base + i0 + hq * 32 + lane);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = hq * 32 + n * 8 + 2 * c + e;
          // p = 0 past seq (the ring's zero fill gives lse = 0 there)
          const float l = i0 + col < seq ? lt[col] : INFINITY, dl = dt[col];
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            uint32_t w = kFull;
            if constexpr (kDropout) w = __shfl_sync(kFull, mine[m], n * 8 + 2 * c + e);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float p = exp2f(fmaf(s[m][n][2 * r + e], score_mult, bias2[m][r]) - l);
              float pd = p, dpm = dp[m][n][2 * r + e];
              if constexpr (kDropout) {
                // the kept p unscaled (dO carries 1 / (1 - rate)); a product
                // with the keep bit, as in flash_bwd_dkv_kernel
                const float kept = ((w >> (g + 8 * r)) & 1u) ? 1.f : 0.f;
                pd = p * kept;
                dpm *= kept;
              }
              s[m][n][2 * r + e] = p * (dpm - dl);  // dS^T
              dp[m][n][2 * r + e] = pd;             // P^T with dropout
            }
          }
        }
      }
      mma_nn_m<kD, kM, 4>(dp, doh, dv_acc);  // dV += P^T dO
      mma_nn_m<kD, kM, 4>(s, qh, dk_acc);    // dK += dS^T Q
#pragma unroll
      for (int m = 0; m < kM; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            store2(dst_s + (warp * 16 * kM + 16 * m + g + 8 * r) * kFTStride + hq * 32 + n * 8 +
                       2 * c,
                   s[m][n][2 * r], s[m][n][2 * r + 1]);
          }
        }
      }
    }
    __syncthreads();  // dS^T is whole; the ring stage st is read

    // dQ[i0 .. i0 + 64) += dS K over the block's keys: 16 queries a warp
    float dqp[kON][4];
    const int m0 = warp * 16;
    tc::mma_tn<kD, kKeys / 16>(dst_s, kFTStride, m0, kb_s, dqp);
    const bool odd = c & 1;  // odd lanes take row g + 8, even lanes row g
    const int row = i0 + m0 + g + (odd ? 8 : 0);
    float* dst = dq32 + head_base + (size_t)row * hidden + 2 * (c & ~1);
#pragma unroll
    for (int n = 0; n < kON; ++n) {
      const float* x = dqp[n];
      const float r0 = __shfl_xor_sync(kFull, odd ? x[0] : x[2], 1);
      const float r1 = __shfl_xor_sync(kFull, odd ? x[1] : x[3], 1);
      const float4 val = odd ? make_float4(r0 * scale, r1 * scale, x[2] * scale, x[3] * scale)
                             : make_float4(x[0] * scale, x[1] * scale, r0 * scale, r1 * scale);
      if (row < seq) atomicAdd(reinterpret_cast<float4*>(dst + n * 8), val);
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    Frag<kON> fk, fv;
#pragma unroll
    for (int n = 0; n < kON; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        fk.x[n][x] = dk_acc[m][n][x];
        fv.x[n][x] = dv_acc[m][n][x];
      }
    }
    store_frag(dk, head_base, hidden, wk0 + 16 * m + g, seq, fk, scale, scale);
    store_frag(dv, head_base, hidden, wk0 + 16 * m + g, seq, fv, 1.f, 1.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the warpgroup tensor cores (wgmma): the forward (rows 10 and 13)
// and the split backward (rows 12 and 13), every head dim
// ---------------------------------------------------------------------------
//
// Every product is a warpgroup's m64nNk16 (wgmma_tiles.cuh): B, and A where
// it is a staged tile, read from swizzled shared-memory tiles through
// descriptors; A from registers where it is a probability or dS tile,
// which never leaves the accumulator registers (the accumulator layout of
// column tiles 2kk and 2kk + 1 is k-step kk's A fragment).  Warp w of a CTA
// holds rows 16 w + g and 16 w + g + 8 of the CTA's tile, as the mma.sync
// kernels above, so the per-element code (base-2 softmax, key bias, lse
// units, dropout words per 16-row warp slice, the folds of 1 / (1 - rate))
// is theirs.  Copies are cp.async into the swizzled layout by every thread
// (no producer warp), a two-stage ring, one barrier a tile.

namespace wg = msa_wgmma;

// The output delta reads: flash2's f32 out32, the head-split output in bf16.
template <bool kHeadSplit>
using WgOutT = std::conditional_t<kHeadSplit, __nv_bfloat16, float>;

// The tile choices, measured on the H100 (PERF.md §6): warpgroups
// a CTA (64 rows each), the width of a loop tile, and the CTAs an SM that
// ptxas fits the registers to (__launch_bounds__).
//   * forward: 128 query rows, 64-key tiles, 2 CTAs an SM (128 registers;
//     the dropout forms took 170 and held 1 CTA, 27 % slower; 128-key
//     tiles took 180 and ran 27 % slower);
//   * dq launch: 128 query rows at rate 0 (2 CTAs an SM); under dropout
//     the head-split form spills at 128 registers, so 64 rows and 3 CTAs
//     (up to 170 registers), which also ran 4-6 % faster there and 3-6 %
//     slower at rate 0;
//   * dk/dv launch: 64 keys (one warpgroup, 3 CTAs an SM at rate 0 by its
//     own 166 registers; 128 keys in two warpgroups held 1 CTA and ran 9 %
//     slower), 64-query tiles.
// At head dim 128 the output accumulators take 64 registers a thread, so
// the forward and dq launches name one CTA an SM (up to 255 registers); at
// 256 the forward's O [64 x 256] f32 takes 128, and its Q tile and two K
// and V stages 193 KB of shared memory: one CTA an SM either way.  The
// split pair at 256 (above kMaxWholeDkvHeadDim; the pair's times at
// [32, 1024, 1024]):
//   * dq launch: one warpgroup of 64 query rows a CTA (dQ [64 x 256] f32
//     is 128 registers a thread beside S and dP's 32; 196-216 registers)
//     over a one-stage ring of 32-key tiles: Q, dO, K and V 97 KB, so two
//     CTAs share an SM and one's copies and softmax run beside the other's
//     products (the pair 1.62 ms).  Measured beside it (kWideDq*): two
//     64-key stages at one CTA an SM, as the tiled short backward's dq
//     launch at 256, 1.69 ms; with two warpgroups sharing the 64 rows,
//     each on its half of every key tile with their partial dQ summed
//     through shared memory, 2.5 % slower than that; two on 128 rows over
//     32-key tiles, 1-3 % faster than it at rate 0, 0.4 % slower under
//     dropout;
//   * dk/dv launch: 64 keys, two warpgroups split by role (kDkvByRole,
//     flash_bwd_dkv_role_wg_kernel: S^T, p and dV in one, dP^T, dS and dK
//     in the other, p handed over in f32 through shared memory: 4 products
//     of [64 x 64 x 256] a query tile; 230-254 registers).  Split by
//     columns instead (kDkvCols = 2, each warpgroup forming S^T and dP^T
//     whole, as flash2_bwd_fused_wg_kernel: 6 products) the pair ran 9-13
//     % slower.
constexpr int kFwdGroups = 2, kFwdKeys = 64;
template <int kD>
constexpr int kFwdMinBlocks = kD >= 128 ? 1 : 2;
// The forwards that run flash_fwd_wg_overlap_kernel (the next key tile's S
// = Q K^T issued before this tile's P V): head dim 256 under dropout.  At
// rate 0 ptxas serialised its products (C7513: "non wgmma instructions
// defining input registers of a wgmma between start and end of the
// pipeline stage") in every arrangement measured, where it kept the
// dropout forms whole, so rate 0 runs flash_fwd_wg_kernel, as every other
// head dim does.
template <int kD, bool kDropout>
constexpr bool kFwdOverlap = kD == 256 && kDropout;
// The split pair's choices above kMaxWholeDkvHeadDim (scripts/
// flash_variants.py measures the others).
constexpr int kWideDqGroups = 1, kWideDqRowGroups = 1, kWideDqKeys = 32;
constexpr int kWideDqStages = 1, kWideDqMinBlocks = 2;
constexpr bool kWideDkvByRole = true;
template <int kD, bool kDropout>
constexpr int kDqGroups = kD > kMaxWholeDkvHeadDim ? kWideDqGroups : kDropout ? 1 : 2;
template <int kD, bool kDropout>
constexpr int kDqRowGroups = kD > kMaxWholeDkvHeadDim ? kWideDqRowGroups : kDqGroups<kD, kDropout>;
template <int kD, bool kDropout>
constexpr int kDqMinBlocks =
    kD > kMaxWholeDkvHeadDim ? kWideDqMinBlocks : kD == 128 ? 1 : kDropout ? 3 : 2;
template <int kD>
constexpr int kDqKeys = kD > kMaxWholeDkvHeadDim ? kWideDqKeys : 64;
template <int kD>
constexpr int kDqStages = kD > kMaxWholeDkvHeadDim ? kWideDqStages : 2;  // of the K / V ring
constexpr int kDkvGroups = 1, kDkvQueries = 64;
template <int kD>
constexpr int kDkvCols = kD > kMaxWholeDkvHeadDim ? 2 : 1;
template <int kD>
constexpr bool kDkvByRole = kD > kMaxWholeDkvHeadDim && kWideDkvByRole;

static_assert(kDkvQueries == 64, "the dk/dv launch's keep bits cover 64 queries");

template <int kD>
constexpr int wg_fwd_smem_bytes() {
  return wg::kAlign + (64 * kFwdGroups + 4 * kFwdKeys) * wg::kRowBytes<kD> + 2 * kFwdKeys * 4;
}
template <int kD, bool kDropout>
constexpr int wg_dq_smem_bytes() {
  return wg::kAlign +
         (2 * 64 * kDqRowGroups<kD, kDropout> + 2 * kDqStages<kD> * kDqKeys<kD>) *
             wg::kRowBytes<kD> +
         kDqStages<kD> * kDqKeys<kD> * 4 + 64 * kDqRowGroups<kD, kDropout> * 4;
}
template <int kD>
constexpr int wg_dkv_smem_bytes() {
  // K and V, two ring stages of q and dO (by role also the p tile, [64 x
  // 64] f32), two stages of lse and delta
  return wg::kAlign + (2 * 64 * kDkvGroups + 4 * kDkvQueries) * wg::kRowBytes<kD> +
         (kDkvByRole<kD> ? 64 * kDkvQueries * 4 : 0) + 4 * kDkvQueries * 4;
}

// delta = dO . o of row `row` (dO unscaled, o in its type) from device
// memory: this thread sums half `half` of the kD columns in order, its
// partner (lane ^ 1) the other; 0 past seq.  row_delta's order.
template <int kD, typename OT>
__device__ __forceinline__ float row_delta_dev(const __nv_bfloat16* dout, const OT* o,
                                               size_t head_base, int ld, int row, int seq,
                                               int half) {
  constexpr int kHalf = kD / 2;
  float sum = 0.f;
  if (row < seq) {
    const OT* op = o + head_base + (size_t)row * ld + half * kHalf;
    const __nv_bfloat16* dp = dout + head_base + (size_t)row * ld + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; e += 4) {
      const float4 ov = load4(op + e), dv = load4(dp + e);
      sum = fmaf(dv.x, ov.x, sum);
      sum = fmaf(dv.y, ov.y, sum);
      sum = fmaf(dv.z, ov.z, sum);
      sum = fmaf(dv.w, ov.w, sum);
    }
  }
  return sum + __shfl_xor_sync(kFull, sum, 1);
}

// S = A B^T over kD (A rows from a_row of tile a, B the kN rows of tile b
// from b_row), both K-major in shared memory; the accumulator is
// overwritten.
template <int kD, int kN>
__device__ __forceinline__ void wg_nt(float (&s)[kN / 8][4], const unsigned char* a, int a_row,
                                      const unsigned char* b, int b_row = 0) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wg::mma_ss<kN, 0>(s, wg::desc_k<kD>(a, a_row, kk), wg::desc_k<kD>(b, b_row, kk), kk);
  }
}

// c += F B for F [64 x 16kK] in A fragments and B rows [16 kk0, 16 (kk0 +
// kK)) of tile b (MN-major: rows the contracted index), its kC columns
// from col0 the output columns; above 128 columns each k-step is products
// of 128 (wgmma_tiles.cuh::cols).
template <int kD, int kK, int kC = kD>
__device__ __forceinline__ void wg_nn(float (&c)[kC / 8][4], const uint32_t (&f)[kK][4],
                                      const unsigned char* b, int kk0 = 0, int col0 = 0) {
  if constexpr (kC <= 128) {
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      wg::mma_rs<kC, 1>(c, f[kk], wg::desc_mn<kD>(b, kk0 + kk, col0), 1);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int h = 0; h < kC / 128; ++h) {
        wg::mma_rs<128, 1>(wg::cols<16>(c, h), f[kk],
                           wg::desc_mn<kD>(b, kk0 + kk, col0 + 128 * h), 1);
      }
    }
  }
}

// Named barrier `id` (not 0, __syncthreads') of `threads` threads: arrive
// without waiting (the producer's side), or wait for the others.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kD, bool kHeadSplit, bool kDropout, bool kTrain>
__global__ void __launch_bounds__(wg::kGroupThreads * kFwdGroups, kFwdMinBlocks<kD>)
flash_fwd_wg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    float* __restrict__ out32, int seq, int hidden, float score_mult,
                    Dropout drop) {
  constexpr int kRows = 64 * kFwdGroups, kThr = wg::kGroupThreads * kFwdGroups;
  constexpr int kN = kFwdKeys / 8, kTile = kFwdKeys * wg::kRowBytes<kD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* q_s = wg::align_smem(smem_raw);
  unsigned char* k_s = q_s + kRows * wg::kRowBytes<kD>;  // two stages
  unsigned char* v_s = k_s + 2 * kTile;                   // two stages
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * kTile);  // [2][kFwdKeys]

  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  const int a_row = 64 * (warp >> 2);  // the warpgroup's rows of the Q tile
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kRows;
  const size_t head_base = head_offset<kD, kHeadSplit>(b, head, seq, hidden);
  const int ld = row_stride<kD, kHeadSplit>(hidden);
  const float* bias_row = key_bias + (size_t)b * seq;
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int n_tiles = (seq + kFwdKeys - 1) / kFwdKeys;

  wg::stage_rows<kD>(q_s, q, head_base, ld, q0, kRows, seq, tid, kThr);
  wg::stage_rows<kD>(k_s, k, head_base, ld, 0, kFwdKeys, seq, tid, kThr);
  wg::stage_rows<kD>(v_s, v, head_base, ld, 0, kFwdKeys, seq, tid, kThr);
  cp_async_commit();
  bias_tile<kFwdKeys>(bias_s, bias_row, 0, seq);

  Frag<kD / 8> acc;
  acc.zero();
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy overlaps this tile's math
      const int nb = buf ^ 1, k1 = (t + 1) * kFwdKeys;
      wg::stage_rows<kD>(k_s + nb * kTile, k, head_base, ld, k1, kFwdKeys, seq, tid, kThr);
      wg::stage_rows<kD>(v_s + nb * kTile, v, head_base, ld, k1, kFwdKeys, seq, tid, kThr);
      cp_async_commit();
      bias_tile<kFwdKeys>(bias_s + nb * kFwdKeys, bias_row, k1, seq);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    wg::fence_proxy_async();
    __syncthreads();
    const unsigned char* kt = k_s + buf * kTile;
    const unsigned char* vt = v_s + buf * kTile;

    float s[kN][4];
    wg::fence();
    wg_nt<kD, kFwdKeys>(s, q_s, a_row, kt);
    wg::commit();
    uint32_t keep[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) keep[i] = kFull;
    if constexpr (kDropout) {
#pragma unroll
      for (int h = 0; h < kFwdKeys / 64; ++h) {
        keep_words_qmajor(drop, row_base + row0, t * kFwdKeys + 64 * h, keep + 4 * h);
      }
    }
    wg::wait<0>();
    wg::fence_operand(s);
    const float* bias_t = bias_s + buf * kFwdKeys;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bb = bias_t[n * 8 + 2 * c + e];
        s[n][e] = fmaf(s[n][e], score_mult, bb);
        s[n][2 + e] = fmaf(s[n][2 + e], score_mult, bb);
        mx[0] = fmaxf(mx[0], s[n][e]);
        mx[1] = fmaxf(mx[1], s[n][2 + e]);
      }
    }
    // Online softmax, as flash_fwd_kernel: every tile holds a key < seq.
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2f(s[n][e] - m_run[0]);
        const float p1 = exp2f(s[n][2 + e] - m_run[1]);
        l_run[0] += p0;
        l_run[1] += p1;
        const int jj = (n & 1) * 8 + 2 * c + e;
        const uint32_t w = keep[n >> 1];
        s[n][e] = ((w >> jj) & 1u) ? p0 : 0.f;
        s[n][2 + e] = ((w >> (16 + jj)) & 1u) ? p1 : 0.f;
      }
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc.x[n][0] *= corr[0];
      acc.x[n][1] *= corr[0];
      acc.x[n][2] *= corr[1];
      acc.x[n][3] *= corr[1];
    }
    uint32_t pa[kN / 2][4];  // p rounded to bf16 before P V, as JAX's
    wg::to_a(s, pa);
    wg::fence_operand(acc.x);
    wg::fence_operand(pa);
    wg::fence();
    wg_nn<kD, kN / 2>(acc.x, pa, vt);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc.x);
    wg::fence_operand(pa);
    __syncthreads();  // every warpgroup is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
  }
  if constexpr (kHeadSplit) {  // JAX's guard (_flash_kernel: max(l, 1e-30))
    l_run[0] = fmaxf(l_run[0], 1e-30f);
    l_run[1] = fmaxf(l_run[1], 1e-30f);
  }
  const float inv0 = drop.scale / l_run[0], inv1 = drop.scale / l_run[1];
  store_frag(out, head_base, ld, row0, seq, acc, inv0, inv1);
  if constexpr (kTrain) {
    const float unit = kHeadSplit ? kLn2 : 1.f;  // the head-split lse in natural-log units
    if (c == 0) {
      if (row0 < seq) lse[row_base + row0] = (m_run[0] + log2f(l_run[0])) * unit;
      if (row0 + 8 < seq) lse[row_base + row0 + 8] = (m_run[1] + log2f(l_run[1])) * unit;
    }
    if (out32 != nullptr) store_frag(out32, head_base, ld, row0, seq, acc, inv0, inv1);
  }
}

// The forward with the warpgroup's products overlapped (kFwdOverlap): the
// scores of key tile t + 1 and this tile's P V are in flight together, and
// tile t + 1's softmax runs while P V does, so a warpgroup's tensor cores
// wait for no softmax but the first.  Per tile t (P_t already in
// registers, the output rescaled to tile t's running max):
//
//   issue S_{t+1} = Q K_{t+1}^T; issue O += P_t V_t;
//   wait for S_{t+1}; softmax(S_{t+1}) -> P_{t+1}, corr;
//   wait for P V; O *= corr.
//
// K runs a tile ahead of V in the two-stage ring: at tile t the copies of
// K_{t+2} (and its key bias) and V_{t+1} go into the stages that K_t and
// V_{t-1} left, after the one barrier of the tile, which also publishes
// V_t and K_{t+1}.  The rounding is flash_fwd_wg_kernel's: p rounded to
// bf16 before P V, the normaliser summing the unrounded p.
template <int kD, bool kHeadSplit, bool kDropout, bool kTrain>
__global__ void __launch_bounds__(wg::kGroupThreads * kFwdGroups, kFwdMinBlocks<kD>)
flash_fwd_wg_overlap_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ key_bias, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, float* __restrict__ out32, int seq,
                            int hidden, float score_mult, Dropout drop) {
  constexpr int kRows = 64 * kFwdGroups, kThr = wg::kGroupThreads * kFwdGroups;
  constexpr int kN = kFwdKeys / 8, kTile = kFwdKeys * wg::kRowBytes<kD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* q_s = wg::align_smem(smem_raw);
  unsigned char* k_s = q_s + kRows * wg::kRowBytes<kD>;  // two stages
  unsigned char* v_s = k_s + 2 * kTile;                   // two stages
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * kTile);  // [2][kFwdKeys], K's stages

  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  const int a_row = 64 * (warp >> 2);  // the warpgroup's rows of the Q tile
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kRows;
  const size_t head_base = head_offset<kD, kHeadSplit>(b, head, seq, hidden);
  const int ld = row_stride<kD, kHeadSplit>(hidden);
  const float* bias_row = key_bias + (size_t)b * seq;
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int n_tiles = (seq + kFwdKeys - 1) / kFwdKeys;

  auto stage_k = [&](int t) {  // K_t and its key bias into stage t % 2
    wg::stage_rows<kD>(k_s + (t & 1) * kTile, k, head_base, ld, t * kFwdKeys, kFwdKeys, seq,
                       tid, kThr);
    bias_tile<kFwdKeys>(bias_s + (t & 1) * kFwdKeys, bias_row, t * kFwdKeys, seq);
  };
  auto stage_v = [&](int t) {
    wg::stage_rows<kD>(v_s + (t & 1) * kTile, v, head_base, ld, t * kFwdKeys, kFwdKeys, seq,
                       tid, kThr);
  };

  // The dropout keep words of this lane's rows for key tile t.  Drawn while
  // no product is in flight: the draw is a call, and a call between a
  // product's issue and its wait made ptxas serialise the products.
  auto keep_of = [&](int t, uint32_t (&keep)[kN / 2]) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) keep[i] = kFull;
    if constexpr (kDropout) {
#pragma unroll
      for (int h = 0; h < kFwdKeys / 64; ++h) {
        keep_words_qmajor(drop, row_base + row0, t * kFwdKeys + 64 * h, keep + 4 * h);
      }
    }
  };
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // The online softmax of tile t's scores (flash_fwd_wg_kernel's), into
  // bf16 A fragments pa; corr: the factor the output takes before P_t V_t.
  auto softmax = [&](float (&s)[kN][4], int t, const uint32_t (&keep)[kN / 2],
                     uint32_t (&pa)[kN / 2][4], float (&corr)[2]) {
    const float* bias_t = bias_s + (t & 1) * kFwdKeys;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bb = bias_t[n * 8 + 2 * c + e];
        s[n][e] = fmaf(s[n][e], score_mult, bb);
        s[n][2 + e] = fmaf(s[n][2 + e], score_mult, bb);
        mx[0] = fmaxf(mx[0], s[n][e]);
        mx[1] = fmaxf(mx[1], s[n][2 + e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // every tile holds a key < seq: finite
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2f(s[n][e] - m_run[0]);
        const float p1 = exp2f(s[n][2 + e] - m_run[1]);
        l_run[0] += p0;
        l_run[1] += p1;
        const int jj = (n & 1) * 8 + 2 * c + e;
        const uint32_t w = keep[n >> 1];
        s[n][e] = ((w >> jj) & 1u) ? p0 : 0.f;
        s[n][2 + e] = ((w >> (16 + jj)) & 1u) ? p1 : 0.f;
      }
    }
    wg::to_a(s, pa);  // p rounded to bf16 before P V, as JAX's
  };

  wg::stage_rows<kD>(q_s, q, head_base, ld, q0, kRows, seq, tid, kThr);
  stage_k(0);
  cp_async_commit();  // Q, K_0
  stage_v(0);
  if (n_tiles > 1) stage_k(1);
  cp_async_commit();  // V_0, K_1
  cp_async_wait<1>();
  wg::fence_proxy_async();
  __syncthreads();

  Frag<kD / 8> acc;
  acc.zero();
  float s[kN][4], corr[2];
  uint32_t pa[kN / 2][4], keep[kN / 2];
  keep_of(0, keep);
  wg::fence();
  wg_nt<kD, kFwdKeys>(s, q_s, a_row, k_s);
  wg::commit();
  wg::wait<0>();
  wg::fence_operand(s);
  softmax(s, 0, keep, pa, corr);  // the output is zero: no rescale

  // Tile t; kNext: a tile t + 1 follows (the last tile is peeled off, so
  // that no product is issued on a divergent path)
  auto step = [&](int t, auto next) {
    constexpr bool kNext = decltype(next)::value;
    cp_async_wait<0>();  // V_t and K_{t+1}
    wg::fence_proxy_async();
    __syncthreads();  // ... published; every warpgroup is done with K_t and V_{t-1}
    if (t + 2 < n_tiles) stage_k(t + 2);
    if (t + 1 < n_tiles) stage_v(t + 1);
    cp_async_commit();
    if constexpr (kNext) keep_of(t + 1, keep);
    wg::fence_operand(acc.x);
    wg::fence_operand(pa);
    wg::fence();
    if constexpr (kNext) {
      wg_nt<kD, kFwdKeys>(s, q_s, a_row, k_s + ((t + 1) & 1) * kTile);
      wg::commit();
    }
    wg_nn<kD, kN / 2>(acc.x, pa, v_s + (t & 1) * kTile);
    wg::commit();
    if constexpr (kNext) {
      wg::wait<1>();  // S_{t+1}; P_t V_t runs on
      wg::fence_operand(s);
      uint32_t pn[kN / 2][4];
      softmax(s, t + 1, keep, pn, corr);
      wg::wait<0>();
      wg::fence_operand(acc.x);
      wg::fence_operand(pa);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        acc.x[n][0] *= corr[0];
        acc.x[n][1] *= corr[0];
        acc.x[n][2] *= corr[1];
        acc.x[n][3] *= corr[1];
      }
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[i][x] = pn[i][x];
      }
    } else {
      wg::wait<0>();
      wg::fence_operand(acc.x);
      wg::fence_operand(pa);
    }
  };
  for (int t = 0; t + 1 < n_tiles; ++t) step(t, std::true_type{});
  step(n_tiles - 1, std::false_type{});

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(kFull, l_run[r], 2);
  }
  if constexpr (kHeadSplit) {  // JAX's guard (_flash_kernel: max(l, 1e-30))
    l_run[0] = fmaxf(l_run[0], 1e-30f);
    l_run[1] = fmaxf(l_run[1], 1e-30f);
  }
  const float inv0 = drop.scale / l_run[0], inv1 = drop.scale / l_run[1];
  store_frag(out, head_base, ld, row0, seq, acc, inv0, inv1);
  if constexpr (kTrain) {
    const float unit = kHeadSplit ? kLn2 : 1.f;  // the head-split lse in natural-log units
    if (c == 0) {
      if (row0 < seq) lse[row_base + row0] = (m_run[0] + log2f(l_run[0])) * unit;
      if (row0 + 8 < seq) lse[row_base + row0 + 8] = (m_run[1] + log2f(l_run[1])) * unit;
    }
    if (out32 != nullptr) store_frag(out32, head_base, ld, row0, seq, acc, inv0, inv1);
  }
}

// The split backward's dq launch: dS = p (dP - delta) per key tile, dQ +=
// dS K; delta = rowsum(dO o) once a row, also written for the dk/dv launch.
// kDqRowGroups warpgroups on their own 64 query rows each; where kDqGroups
// is twice that, two groups share each row slice, each taking its half of
// every key tile, and sum their partial dQ through shared memory at the
// end (kSplit).
template <int kD, bool kHeadSplit, bool kDropout>
__global__ void __launch_bounds__(wg::kGroupThreads * kDqGroups<kD, kDropout>,
                                  kDqMinBlocks<kD, kDropout>)
flash_bwd_dq_wg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
                       const WgOutT<kHeadSplit>* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ delta_out, __nv_bfloat16* __restrict__ dq, int seq,
                       int hidden, float score_mult, float scale, Dropout drop) {
  constexpr int kGroups = kDqGroups<kD, kDropout>, kRowGroups = kDqRowGroups<kD, kDropout>;
  constexpr int kSplit = kGroups / kRowGroups;  // warpgroups sharing a row slice
  constexpr int kKeys = kDqKeys<kD>, kSub = kKeys / kSplit;  // keys of a tile, of a part
  constexpr int kRows = 64 * kRowGroups, kStages = kDqStages<kD>;
  constexpr int kThr = wg::kGroupThreads * kGroups;
  constexpr int kN = kSub / 8, kTile = kKeys * wg::kRowBytes<kD>;
  constexpr bool kFold = kFoldDo<kHeadSplit, kDropout>;
  static_assert(kGroups == kRowGroups * kSplit && kSplit <= 2 && kSub % 32 == 0,
                "one or two whole parts of a key tile");
  static_assert(kThr >= 2 * kRows, "delta takes two threads a row");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* q_s = wg::align_smem(smem_raw);
  unsigned char* do_s = q_s + kRows * wg::kRowBytes<kD>;
  unsigned char* k_s = do_s + kRows * wg::kRowBytes<kD>;  // kStages stages
  unsigned char* v_s = k_s + kStages * kTile;              // kStages stages
  float* bias_s = reinterpret_cast<float*>(v_s + kStages * kTile);  // [kStages][kKeys]
  float* delta_s = bias_s + kStages * kKeys;                        // [kRows]

  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, c = tid & 3;
  // the warpgroup's part of a key tile, its first row in the CTA's slice
  const int part = kSplit == 1 ? 0 : (warp >> 2) / kRowGroups;
  const int a_row = 64 * (kSplit == 1 ? warp >> 2 : (warp >> 2) % kRowGroups);
  const int koff = kSub * part;
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kRows;
  const size_t head_base = head_offset<kD, kHeadSplit>(b, head, seq, hidden);
  const int ld = row_stride<kD, kHeadSplit>(hidden);
  const float* bias_row = key_bias + (size_t)b * seq;
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int row0 = q0 + (kSplit == 1 ? warp * 16 : a_row + (warp & 3) * 16) + g;
  const int n_tiles = (seq + kKeys - 1) / kKeys;

  wg::stage_rows<kD>(q_s, q, head_base, ld, q0, kRows, seq, tid, kThr);
  wg::stage_rows<kD>(do_s, dout, head_base, ld, q0, kRows, seq, tid, kThr);
  cp_async_commit();
  wg::stage_rows<kD>(k_s, k, head_base, ld, 0, kKeys, seq, tid, kThr);
  wg::stage_rows<kD>(v_s, v, head_base, ld, 0, kKeys, seq, tid, kThr);
  cp_async_commit();
  bias_tile<kKeys>(bias_s, bias_row, 0, seq);
  if (kSplit == 1 || tid < 2 * kRows) {  // delta from the unscaled dO, two threads a row
    const int j = tid >> 1;
    const float d = row_delta_dev<kD>(dout, o, head_base, ld, q0 + j, seq, tid & 1);
    if ((tid & 1) == 0) {
      delta_s[j] = d;
      if (q0 + j < seq && part == 0) delta_out[row_base + q0 + j] = d;
    }
  }
  float lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // p = 0 past seq; the head-split lse arrives in natural-log units
    const int row = row0 + 8 * r;
    lse_r[r] = row < seq ? lse[row_base + row] * (kHeadSplit ? kLog2e : 1.f) : INFINITY;
  }
  cp_async_wait<1>();  // q and dO have landed
  // flash2 folds 1 / (1 - rate) into the staged dO (delta took it unscaled)
  if constexpr (kFold) wg::scale_own_rows<kD>(do_s, kRows, fold_factor<__nv_bfloat16>(drop.scale), tid, kThr);
  __syncthreads();
  const float delta_r[2] = {delta_s[row0 - q0], delta_s[row0 - q0 + 8]};

  Frag<kD / 8> dqa;
  dqa.zero();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = kStages == 1 ? 0 : t & 1;
    if (kStages == 1 && t > 0) {
      // one stage: tile t into the buffers the last barrier freed (other
      // CTAs on the SM compute meanwhile)
      const int k1 = t * kKeys;
      wg::stage_rows<kD>(k_s, k, head_base, ld, k1, kKeys, seq, tid, kThr);
      wg::stage_rows<kD>(v_s, v, head_base, ld, k1, kKeys, seq, tid, kThr);
      cp_async_commit();
      bias_tile<kKeys>(bias_s, bias_row, k1, seq);
    }
    if (kStages == 2 && t + 1 < n_tiles) {
      const int nb = buf ^ 1, k1 = (t + 1) * kKeys;
      wg::stage_rows<kD>(k_s + nb * kTile, k, head_base, ld, k1, kKeys, seq, tid, kThr);
      wg::stage_rows<kD>(v_s + nb * kTile, v, head_base, ld, k1, kKeys, seq, tid, kThr);
      cp_async_commit();
      bias_tile<kKeys>(bias_s + nb * kKeys, bias_row, k1, seq);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    wg::fence_proxy_async();
    __syncthreads();
    const unsigned char* kt = k_s + buf * kTile;
    const unsigned char* vt = v_s + buf * kTile;

    float s[kN][4], dp[kN][4];
    wg::fence();
    wg_nt<kD, kSub>(s, q_s, a_row, kt, koff);
    wg_nt<kD, kSub>(dp, do_s, a_row, vt, koff);
    wg::commit();
    uint32_t keep[kN / 2 < 4 ? 4 : kN / 2];  // keep_words_qmajor's 64 keys
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) keep[i] = kFull;
    if constexpr (kDropout) {
#pragma unroll
      for (int h = 0; h < (kSub + 63) / 64; ++h) {
        keep_words_qmajor(drop, row_base + row0, t * kKeys + koff + 64 * h, keep + 4 * h);
      }
    }
    wg::wait<0>();
    wg::fence_operand(s);
    wg::fence_operand(dp);
    const float* bias_t = bias_s + buf * kKeys + koff;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bb = bias_t[n * 8 + 2 * c + e];
        const int jj = (n & 1) * 8 + 2 * c + e;
        const uint32_t w = keep[n >> 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p = exp2f(fmaf(s[n][2 * r + e], score_mult, bb) - lse_r[r]);
          float dpm = dp[n][2 * r + e];
          if constexpr (kDropout) {
            const bool kept = (w >> (16 * r + jj)) & 1u;
            dpm = kept ? (kFold ? dpm : dpm * drop.scale) : 0.f;
          }
          s[n][2 * r + e] = p * (dpm - delta_r[r]);
        }
      }
    }
    uint32_t da[kN / 2][4];  // dS rounded to bf16, as JAX's
    wg::to_a(s, da);
    wg::fence_operand(dqa.x);
    wg::fence_operand(da);
    wg::fence();
    wg_nn<kD, kN / 2>(dqa.x, da, kt, koff / 16);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(dqa.x);
    wg::fence_operand(da);
    __syncthreads();
  }
  if constexpr (kSplit == 2) {
    // part 1's dQ into the K and V stages (free now), each thread's values
    // at float4s 128 apart; part 0 adds them and stores
    float4* sum_s = reinterpret_cast<float4*>(k_s) + (warp >> 2) % kRowGroups * (kD / 8) * 128;
    const int tl = tid % wg::kGroupThreads;
    static_assert(kRowGroups * 64 * kD * 4 <= 2 * kStages * kTile, "the sums fit the stages");
    if (part == 1) {
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        sum_s[n * 128 + tl] = make_float4(dqa.x[n][0], dqa.x[n][1], dqa.x[n][2], dqa.x[n][3]);
      }
    }
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const float4 x = sum_s[n * 128 + tl];
      dqa.x[n][0] += x.x;
      dqa.x[n][1] += x.y;
      dqa.x[n][2] += x.z;
      dqa.x[n][3] += x.w;
    }
  }
  store_frag(dq, head_base, ld, row0, seq, dqa, scale, scale);
}

// The split backward's dk/dv launch: a CTA's keys against query tiles that
// a two-stage ring brings in (q, dO, lse, delta); dV += P^T dO and dK +=
// dS^T Q with P^T and dS^T in registers.  Above kMaxWholeDkvHeadDim
// (kDkvCols = 2) two warpgroups share the CTA's 64 keys, each forming S^T
// and dP^T whole and holding its half of the columns of dK and dV, as
// flash2_bwd_fused_wg_kernel does.
template <int kD, bool kHeadSplit, bool kDropout>
__global__ void __launch_bounds__(wg::kGroupThreads * kDkvGroups * kDkvCols<kD>)
flash_bwd_dkv_wg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta_in, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int seq, int hidden, float score_mult,
                        float scale, Dropout drop) {
  constexpr int kCols = kDkvCols<kD>, kC = kD / kCols;  // column groups, their columns
  constexpr int kKeys = 64 * kDkvGroups, kThr = wg::kGroupThreads * kDkvGroups * kCols;
  constexpr int kQ = kDkvQueries, kN = kQ / 8, kTile = kQ * wg::kRowBytes<kD>;
  constexpr bool kFold = kFoldDo<kHeadSplit, kDropout>;
  static_assert(kCols == 1 || kDkvGroups == 1, "column groups share one warpgroup's keys");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* kb_s = wg::align_smem(smem_raw);        // this CTA's keys
  unsigned char* vb_s = kb_s + kKeys * wg::kRowBytes<kD>;
  unsigned char* q_s = vb_s + kKeys * wg::kRowBytes<kD>;  // two ring stages
  unsigned char* do_s = q_s + 2 * kTile;                   // two ring stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTile);  // [2][kQ]
  float* delta_s = lse_s + 2 * kQ;                            // [2][kQ]

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, c = lane & 3;
  // the key warp (its 16 keys of the CTA's), the warpgroup's columns
  const int warp = kCols == 1 ? tid >> 5 : (tid >> 5) & 3;
  const int col0 = kCols == 1 ? 0 : (tid / wg::kGroupThreads) * kC;
  const int a_row = 64 * (warp >> 2);
  const int b = blockIdx.z, head = blockIdx.y, kb0 = blockIdx.x * kKeys;
  const size_t head_base = head_offset<kD, kHeadSplit>(b, head, seq, hidden);
  const int ld = row_stride<kD, kHeadSplit>(hidden);
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int key0 = kb0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  const uint32_t grp = (uint32_t)(kb0 + warp * 16) / 16u;  // the warp's Philox group
  const int n_tiles = (seq + kQ - 1) / kQ;

  // q, dO rows [i0, i0 + kQ) and their lse and delta into ring stage st;
  // zero-filled past seq
  auto load_tile = [&](int st, int i0) {
    wg::stage_rows<kD>(q_s + st * kTile, q, head_base, ld, i0, kQ, seq, tid, kThr);
    wg::stage_rows<kD>(do_s + st * kTile, dout, head_base, ld, i0, kQ, seq, tid, kThr);
    for (int j = tid; j < 2 * kQ; j += kThr) {
      const int jj = j % kQ;
      const bool ok = i0 + jj < seq;
      const float* src = (j < kQ ? lse : delta_in) + row_base + (ok ? i0 + jj : 0);
      tc::cp_async4((j < kQ ? lse_s : delta_s) + st * kQ + jj, src, ok);
    }
  };

  float bias2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    bias2[r] = key < seq ? key_bias[(size_t)b * seq + key] * kLog2e : -INFINITY;
  }
  wg::stage_rows<kD>(kb_s, k, head_base, ld, kb0, kKeys, seq, tid, kThr);
  wg::stage_rows<kD>(vb_s, v, head_base, ld, kb0, kKeys, seq, tid, kThr);
  load_tile(0, 0);
  cp_async_commit();

  Frag<kC / 8> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, i0 = t * kQ;
    if (t + 1 < n_tiles) {  // tile t + 1 lands while tile t is computed
      load_tile(st ^ 1, i0 + kQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const unsigned char* qt = q_s + st * kTile;
    unsigned char* dot = do_s + st * kTile;
    // the split route's delta came from the unscaled dO: fold as it lands
    if constexpr (kFold) wg::scale_own_rows<kD>(dot, kQ, fold_factor<__nv_bfloat16>(drop.scale), tid, kThr);
    wg::fence_proxy_async();
    __syncthreads();

    // S^T and dP^T: rows = this warpgroup's keys, columns = the tile's queries
    float st_[kN][4], dpt[kN][4];
    wg::fence();
    wg_nt<kD, kQ>(st_, kb_s, a_row, qt);
    wg_nt<kD, kQ>(dpt, vb_s, a_row, dot);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(st_);
    wg::fence_operand(dpt);
    const float* lt = lse_s + st * kQ;
    const float* dt = delta_s + st * kQ;
    uint32_t mine = kFull;  // keep bits of queries lane, lane + 32 (16 keys each)
    if constexpr (kDropout) {
      mine = keep_bits16(drop, grp, row_base + i0 + lane) |
             (keep_bits16(drop, grp, row_base + i0 + lane + 32) << 16);
    }
#pragma unroll
    for (int n = 0; n < kN / 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t w = kFull;
        if constexpr (kDropout) w = __shfl_sync(kFull, mine, n * 8 + 2 * c + e);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {  // query columns n*8 + ... and +32
          const int nn = n + hi * (kN / 2);
          const int col = nn * 8 + 2 * c + e;
          const uint32_t bits = w >> (16 * hi);
          // p = 0 past seq; the head-split lse arrives in natural-log units
          const float l = i0 + col < seq ? lt[col] * (kHeadSplit ? kLog2e : 1.f) : INFINITY;
          const float dl = dt[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p = exp2f(fmaf(st_[nn][2 * r + e], score_mult, bias2[r]) - l);
            float pd = p, dpm = dpt[nn][2 * r + e];
            if constexpr (kDropout) {
              // the kept p unscaled; a product with the keep bit, as in
              // flash_bwd_dkv_kernel
              const float kept = ((bits >> (g + 8 * r)) & 1u) ? 1.f : 0.f;
              pd = p * kept;
              dpm *= kFold ? kept : kept * drop.scale;
            }
            st_[nn][2 * r + e] = p * (dpm - dl);  // dS^T
            dpt[nn][2 * r + e] = pd;              // P^T with dropout
          }
        }
      }
    }
    uint32_t pa[kN / 2][4], da[kN / 2][4];  // rounded to bf16, as JAX's
    wg::to_a(dpt, pa);
    wg::to_a(st_, da);
    wg::fence_operand(dv_acc.x);
    wg::fence_operand(dk_acc.x);
    wg::fence_operand(pa);
    wg::fence_operand(da);
    wg::fence();
    wg_nn<kD, kN / 2, kC>(dv_acc.x, pa, dot, 0, col0);  // dV += P^T dO
    wg_nn<kD, kN / 2, kC>(dk_acc.x, da, qt, 0, col0);   // dK += dS^T Q
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(dv_acc.x);
    wg::fence_operand(dk_acc.x);
    wg::fence_operand(pa);
    wg::fence_operand(da);
    __syncthreads();  // the ring stage is reloaded next
  }
  // the head-split kernels' dV carries 1 / (1 - rate) from here (JAX's
  // _flash_dkv_kernel scales each tile's f32 product)
  const float dv_mult = kDropout && kHeadSplit ? drop.scale : 1.f;
  store_frag(dk, head_base + col0, ld, key0, seq, dk_acc, scale, scale);
  store_frag(dv, head_base + col0, ld, key0, seq, dv_acc, dv_mult, dv_mult);
}

// The dk/dv launch above kMaxWholeDkvHeadDim split by role (kDkvByRole): a
// CTA of two warpgroups per 64 keys over the ring of 64-query tiles.
// Warpgroup 0 forms S^T = K Q^T, p and the keep bits, hands p to the other
// through shared memory in f32 (dS takes the unrounded p, as JAX's rule;
// dropped values negated: the sign is the keep bit) and takes dV += P^T
// dO; warpgroup 1 forms dP^T = V dO^T, then,
// with p, dS^T = p (dpm - delta) and dK += dS^T Q.  Each holds one
// accumulator [64 x 256] f32 (128 registers), and S^T and dP^T are formed
// once: 4 products of [64 x 64 x 256] a query tile, where the column split
// does 6.  Both warpgroups run one code for their products (the operand
// tiles picked by role), so no wgmma sits on a divergent path; p goes
// through a named barrier that warpgroup 0 arrives at and warpgroup 1 waits
// on.  Thread t of warpgroup 1 reads the p that thread t of warpgroup 0
// wrote (the same keys and queries), as float4s 128 apart.
template <int kD, bool kHeadSplit, bool kDropout>
__global__ void __launch_bounds__(2 * wg::kGroupThreads, 1)
flash_bwd_dkv_role_wg_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ key_bias,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta_in,
                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                             int seq, int hidden, float score_mult, float scale, Dropout drop) {
  constexpr int kKeys = 64, kQ = kDkvQueries, kN = kQ / 8, kThr = 2 * wg::kGroupThreads;
  constexpr int kTile = kQ * wg::kRowBytes<kD>;
  constexpr bool kFold = kFoldDo<kHeadSplit, kDropout>;
  constexpr int kPBar = 1;  // the named barrier p goes through
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* kb_s = wg::align_smem(smem_raw);         // this CTA's keys
  unsigned char* vb_s = kb_s + kKeys * wg::kRowBytes<kD>;
  unsigned char* q_s = vb_s + kKeys * wg::kRowBytes<kD>;  // two ring stages
  unsigned char* do_s = q_s + 2 * kTile;                   // two ring stages
  float4* p_s = reinterpret_cast<float4*>(do_s + 2 * kTile);  // [kN][128] float4
  float* lse_s = reinterpret_cast<float*>(p_s + kN * wg::kGroupThreads);  // [2][kQ]
  float* delta_s = lse_s + 2 * kQ;                                        // [2][kQ]

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int tl = tid % wg::kGroupThreads, warp = tl >> 5;
  // 0: S^T, p and dV; 1: dP^T, dS^T and dK (lane 0's, so warp-uniform to ptxas)
  const int role = __shfl_sync(kFull, tid / wg::kGroupThreads, 0);
  const int b = blockIdx.z, head = blockIdx.y, kb0 = blockIdx.x * kKeys;
  const size_t head_base = head_offset<kD, kHeadSplit>(b, head, seq, hidden);
  const int ld = row_stride<kD, kHeadSplit>(hidden);
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int key0 = kb0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  const uint32_t grp = (uint32_t)(kb0 + warp * 16) / 16u;  // the warp's Philox group
  const int n_tiles = (seq + kQ - 1) / kQ;

  auto load_tile = [&](int st, int i0) {  // as flash_bwd_dkv_wg_kernel's
    wg::stage_rows<kD>(q_s + st * kTile, q, head_base, ld, i0, kQ, seq, tid, kThr);
    wg::stage_rows<kD>(do_s + st * kTile, dout, head_base, ld, i0, kQ, seq, tid, kThr);
    for (int j = tid; j < 2 * kQ; j += kThr) {
      const int jj = j % kQ;
      const bool ok = i0 + jj < seq;
      const float* src = (j < kQ ? lse : delta_in) + row_base + (ok ? i0 + jj : 0);
      tc::cp_async4((j < kQ ? lse_s : delta_s) + st * kQ + jj, src, ok);
    }
  };

  float bias2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    bias2[r] = key < seq ? key_bias[(size_t)b * seq + key] * kLog2e : -INFINITY;
  }
  wg::stage_rows<kD>(kb_s, k, head_base, ld, kb0, kKeys, seq, tid, kThr);
  wg::stage_rows<kD>(vb_s, v, head_base, ld, kb0, kKeys, seq, tid, kThr);
  load_tile(0, 0);
  cp_async_commit();

  Frag<kD / 8> acc;  // dV (role 0) or dK (role 1)
  acc.zero();
  const unsigned char* a_tile = role == 0 ? kb_s : vb_s;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, i0 = t * kQ;
    if (t + 1 < n_tiles) {  // tile t + 1 lands while tile t is computed
      load_tile(st ^ 1, i0 + kQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const unsigned char* qt = q_s + st * kTile;
    unsigned char* dot = do_s + st * kTile;
    if constexpr (kFold) wg::scale_own_rows<kD>(dot, kQ, fold_factor<__nv_bfloat16>(drop.scale), tid, kThr);
    wg::fence_proxy_async();
    __syncthreads();

    // role 0: S^T = K Q^T; role 1: dP^T = V dO^T (rows: the keys)
    float x[kN][4];
    wg::fence();
    wg_nt<kD, kQ>(x, a_tile, 0, role == 0 ? qt : dot);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(x);
    const float* lt = lse_s + st * kQ;
    const float* dt = delta_s + st * kQ;
    if (role == 0) {
      uint32_t mine = kFull;  // keep bits of queries lane, lane + 32 (16 keys each)
      if constexpr (kDropout) {
        mine = keep_bits16(drop, grp, row_base + i0 + lane) |
               (keep_bits16(drop, grp, row_base + i0 + lane + 32) << 16);
      }
#pragma unroll
      for (int n = 0; n < kN / 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t w = kFull;
          if constexpr (kDropout) w = __shfl_sync(kFull, mine, n * 8 + 2 * c + e);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {  // query columns n*8 + ... and +32
            const int nn = n + hi * (kN / 2);
            const int col = nn * 8 + 2 * c + e;
            const uint32_t bits = w >> (16 * hi);
            // p = 0 past seq; the head-split lse arrives in natural-log units
            const float l = i0 + col < seq ? lt[col] * (kHeadSplit ? kLog2e : 1.f) : INFINITY;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float p = exp2f(fmaf(x[nn][2 * r + e], score_mult, bias2[r]) - l);
              // dropped: -p (p >= 0, so the sign bit is the drop)
              x[nn][2 * r + e] = ((bits >> (g + 8 * r)) & 1u) ? p : -p;
            }
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) p_s[n * wg::kGroupThreads + tl] = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
      bar_arrive(kPBar, kThr);
      if constexpr (kDropout) {
#pragma unroll
        for (int n = 0; n < kN; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[n][i] = fmaxf(x[n][i], 0.f);  // the kept p unscaled
        }
      }
    } else {
      bar_sync(kPBar, kThr);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float4 pv = p_s[n * wg::kGroupThreads + tl];
        const float ps[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dl = dt[n * 8 + 2 * c + (i & 1)];
          float dpm = x[n][i];
          if constexpr (kDropout) {
            // a product with the keep bit, as in flash_bwd_dkv_kernel
            const float kept = (__float_as_uint(ps[i]) >> 31) ? 0.f : 1.f;
            dpm *= kFold ? kept : kept * drop.scale;
          }
          x[n][i] = fabsf(ps[i]) * (dpm - dl);  // dS^T
        }
      }
    }
    uint32_t a[kN / 2][4];  // P^T (role 0) or dS^T (role 1), rounded to bf16 as JAX's
    wg::to_a(x, a);
    wg::fence_operand(acc.x);
    wg::fence_operand(a);
    wg::fence();
    wg_nn<kD, kN / 2>(acc.x, a, role == 0 ? dot : qt);  // dV += P^T dO, dK += dS^T Q
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc.x);
    wg::fence_operand(a);
    __syncthreads();  // the ring stage and the p tile are rewritten next
  }
  // the head-split kernels' dV carries 1 / (1 - rate) from here (JAX's
  // _flash_dkv_kernel scales each tile's f32 product)
  const float dv_mult = kDropout && kHeadSplit ? drop.scale : 1.f;
  if (role == 0) {
    store_frag(dv, head_base, ld, key0, seq, acc, dv_mult, dv_mult);
  } else {
    store_frag(dk, head_base, ld, key0, seq, acc, scale, scale);
  }
}

// flash2's fused backward in bf16 above kFusedMmaMaxDim (row 11 at head
// dims 64, 128 and 256), behind flash2_bwd_prep_kernel's delta and zeroed
// dq32: one CTA per (block of keys, head, batch row) over 64-query tiles of
// q, dO, lse and delta in a cp.async ring.  Per tile a warpgroup forms S^T
// = K Q^T and dP^T = V dO^T for its 64 keys once, takes p = exp2(s - lse),
// the dropout keep bits and dS^T = p (dP - delta) in registers, then dV +=
// P^T dO and dK += dS^T Q with P^T and dS^T as register A fragments
// (rounded to bf16 as JAX rounds them), and writes dS^T (bf16, the same
// rounding) into a [keys x 64 queries] swizzled tile; after a barrier it
// takes its columns of dQ = dS K over the CTA's keys (dS from that tile as
// an MN-major A operand, K's rows as B), waiting for dV and dK to land
// first so that dQ's accumulator never sits beside S^T, dP^T and their
// fragments in the registers: 5 products a tile.  The warpgroups of a CTA:
//   * up to kMaxWholeDkvHeadDim (64 and 128) kFusedKeyGroups = 2, each
//     holding dK and dV for its own 64 keys (kD registers a thread) and
//     half of dQ's columns over the CTA's 128 keys (a column offset inside
//     a swizzle atom at 64: wgmma_tiles.cuh::desc_mn);
//   * above it (256) two on the CTA's 64 keys, warpgroup w holding their
//     columns [128 w, 128 w + 128) of dK, dV and dQ (kFusedColGroups) and
//     forming S^T and dP^T whole for itself, as the tiled short backward's
//     dk/dv launch does (short_bwd_tiled.cuh); each writes half of dS^T's
//     queries and takes its dQ 64 columns a product.
// What binds the sweep is dQ's way into dq32: one f32 [64 x kD] tile a
// query tile and CTA, reduced in L2 (1 GB of them at [32, 1024, 1024] and
// 128 keys a CTA).  As 16-byte vector atomics from the warpgroups they
// held each warpgroup until issued (0.32 of a 1.25 ms sweep at head dim
// 64 on the H100, PERF.md §6).  So up to kMaxWholeDkvHeadDim (kFusedTmaDq)
// the warpgroups stage the CTA's dQ tile in shared memory, and one thread
// hands it to the tensor memory accelerator as bulk tensor reductions
// (cp.reduce.async.bulk.tensor: dq32 as a 3-D tensor map whose box is one
// head's [64 rows x kFusedDqBox columns], rows past seq outside it), issued
// after the next tile's first barrier (whose proxy fence publishes the
// staged tile to the accelerator) and read out before the next tile's dQ
// is staged.  The staged tile is kD / kFusedDqBox boxes in the map's
// swizzle (128-byte: a box row's 16-byte chunk j at j ^ (row % 8); 64-byte
// for 16 columns: j ^ (row / 2 % 4)), so a half warp's float2 stores land
// in distinct banks (staged unswizzled, rows 256 bytes apart, the sweep ran
// 0.07 ms slower than with atomics).  At 256 the staged tile would
// overfill shared memory: each warpgroup adds its dQ by atomics.  Either
// way dQ's summation order changes from run to run: dq agrees with a fixed
// order to f32 rounding of its partial sums.  Under dropout dO is folded by
// 1 / (1 - rate) as it lands (delta took it unscaled) and the kept p is
// unscaled.
constexpr int kNarrowFusedKeyGroups = 2, kNarrowFusedStages = 2;
constexpr int kFusedQueries = 64;
template <int kD>
constexpr int kFusedColGroups = kD > kMaxWholeDkvHeadDim ? 2 : 1;
template <int kD>
constexpr int kFusedKeyGroups = kD > kMaxWholeDkvHeadDim ? 1 : kNarrowFusedKeyGroups;
template <int kD>
constexpr int kFusedStages = kD > kMaxWholeDkvHeadDim ? 2 : kNarrowFusedStages;
template <int kD>
constexpr bool kFusedTmaDq = kD <= kMaxWholeDkvHeadDim;
template <int kD>  // dQ columns a box of the bulk tensor reductions
constexpr int kFusedDqBox = kD < 32 ? kD : 32;
template <int kD>  // dQ columns a warpgroup
constexpr int kFusedDqWidth = kD / (kFusedKeyGroups<kD> * kFusedColGroups<kD>);
template <int kD>  // dQ columns a product
constexpr int kFusedDqCols = kD > kMaxWholeDkvHeadDim ? 64 : kFusedDqWidth<kD>;
template <int kD>
constexpr int kFusedThreads = wg::kGroupThreads * kFusedKeyGroups<kD> * kFusedColGroups<kD>;

template <int kD>
constexpr int fused_wg_smem_bytes() {
  // K and V, the ring stages of q and dO, the dS^T tile, the staged dQ
  // tile, the ring stages of lse and delta
  return wg::kAlign +
         (2 * 64 * kFusedKeyGroups<kD> + 2 * kFusedStages<kD> * kFusedQueries) * wg::kRowBytes<kD> +
         64 * kFusedKeyGroups<kD> * wg::kRowBytes<kFusedQueries> +
         (kFusedTmaDq<kD> ? kFusedQueries * kD * 4 : 0) + 2 * kFusedStages<kD> * kFusedQueries * 4;
}

// src, a box in shared memory laid out as tensor map `map` names, added in
// f32 to the box at coordinates (c0, c1, c2) by the tensor memory
// accelerator (boxes outside the tensor clipped): asynchronous, committed
// as a bulk group by the issuing thread, which waits for the group's reads
// of src (bulk_wait_read) before src is rewritten and for the whole group
// (bulk_wait) before the CTA exits.  src's writes are fenced
// (wg::fence_proxy_async) and published by a barrier first.
__device__ __forceinline__ void bulk_reduce_tile(const CUtensorMap* map, const float* src, int c0,
                                                 int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group [%0, {%1, %2, %3}], "
      "[%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(tc::smem_addr(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int kD, bool kDropout>
__global__ void __launch_bounds__(kFusedThreads<kD>, 1)
flash2_bwd_fused_wg_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ key_bias,
                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, float* __restrict__ dq32,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int seq, int hidden, float score_mult, float scale, Dropout drop,
                           const __grid_constant__ CUtensorMap dq_map) {
  constexpr int kKG = kFusedKeyGroups<kD>, kCG = kFusedColGroups<kD>;
  constexpr int kKeys = 64 * kKG, kQ = kFusedQueries, kN = kQ / 8, kStages = kFusedStages<kD>;
  constexpr int kThr = kFusedThreads<kD>;
  constexpr int kC = kD / kCG;                 // dK and dV columns a warpgroup
  constexpr int kDqW = kFusedDqWidth<kD>;      // dQ columns a warpgroup
  constexpr int kDqC = kFusedDqCols<kD>;       // dQ columns a product
  constexpr bool kTma = kFusedTmaDq<kD>;
  constexpr int kBox = kFusedDqBox<kD>;
  constexpr int kTile = kQ * wg::kRowBytes<kD>;
  static_assert(kQ == 64, "the keep bits cover 64 queries");
  static_assert(kKG * kCG <= 2 && kDqW % kDqC == 0 && kDqC % 8 == 0 && kStages >= 2,
                "the fused sweep's shape");
  static_assert(!kTma || kCG == 1, "the staged dQ tile holds every column of the CTA's dQ");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* kb_s = wg::align_smem(smem_raw);         // this CTA's keys
  unsigned char* vb_s = kb_s + kKeys * wg::kRowBytes<kD>;
  unsigned char* q_s = vb_s + kKeys * wg::kRowBytes<kD>;  // kStages ring stages
  unsigned char* do_s = q_s + kStages * kTile;             // kStages ring stages
  unsigned char* dst_s = do_s + kStages * kTile;  // dS^T [key][query], a 64-wide swizzled tile
  // kTma: the staged dQ tile, kD / kBox boxes of [kQ][kBox] f32, swizzled
  float* dq_s = reinterpret_cast<float*>(dst_s + kKeys * wg::kRowBytes<kQ>);
  float* lse_s = dq_s + (kTma ? kQ * kD : 0);  // [kStages][kQ]
  float* delta_s = lse_s + kStages * kQ;       // [kStages][kQ]

  const int tid = threadIdx.x, grp = tid / wg::kGroupThreads;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int kg = kCG == 1 ? grp : 0;  // the warpgroup's keys [64 kg, 64 kg + 64) of the CTA's
  const int col0 = kCG == 1 ? 0 : grp * kC;  // its columns of dK and dV
  const int dq0 = grp * kDqW;                // its columns of dQ
  const int a_row = 64 * kg;
  const int b = blockIdx.z, head = blockIdx.y, kb0 = blockIdx.x * kKeys;
  const size_t head_base = (size_t)b * seq * hidden + (size_t)head * kD;
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int key0 = kb0 + a_row + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  const uint32_t pgrp = (uint32_t)(kb0 + a_row + warp * 16) / 16u;  // the warp's Philox group
  const int n_tiles = (seq + kQ - 1) / kQ;

  // q, dO rows [i0, i0 + kQ) and their lse and delta into ring stage st;
  // zero-filled past seq
  auto load_tile = [&](int st, int i0) {
    wg::stage_rows<kD>(q_s + st * kTile, q, head_base, hidden, i0, kQ, seq, tid, kThr);
    wg::stage_rows<kD>(do_s + st * kTile, dout, head_base, hidden, i0, kQ, seq, tid, kThr);
    for (int j = tid; j < 2 * kQ; j += kThr) {
      const int jj = j % kQ;
      const bool ok = i0 + jj < seq;
      const float* src = (j < kQ ? lse : delta) + row_base + (ok ? i0 + jj : 0);
      tc::cp_async4((j < kQ ? lse_s : delta_s) + st * kQ + jj, src, ok);
    }
  };

  // kTma: the staged dQ of the tile at query row i0 into dq32, a box of
  // kBox columns at a time
  auto reduce_dq = [&](int i0) {
#pragma unroll
    for (int x = 0; x < kD / kBox; ++x) {
      bulk_reduce_tile(&dq_map, dq_s + x * kQ * kBox, head * kD + kBox * x, i0, b);
    }
  };

  float bias2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    bias2[r] = key < seq ? key_bias[(size_t)b * seq + key] * kLog2e : -INFINITY;
  }
  wg::stage_rows<kD>(kb_s, k, head_base, hidden, kb0, kKeys, seq, tid, kThr);
  wg::stage_rows<kD>(vb_s, v, head_base, hidden, kb0, kKeys, seq, tid, kThr);
#pragma unroll
  for (int st = 0; st + 1 < kStages; ++st) {  // one commit group a stage
    if (st < n_tiles) load_tile(st, st * kQ);
    cp_async_commit();
  }

  Frag<kC / 8> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages, i0 = t * kQ;
    // tile t + kStages - 1 lands while tile t is computed (into the stage
    // that tile t - 1 left, after the last tile's closing barrier)
    if (t + kStages - 1 < n_tiles) load_tile((t + kStages - 1) % kStages, i0 + (kStages - 1) * kQ);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    const unsigned char* qt = q_s + st * kTile;
    unsigned char* dot = do_s + st * kTile;
    // fold 1 / (1 - rate) into the chunks of dO this thread copied (delta
    // took the unscaled dO)
    if constexpr (kDropout) {
      wg::scale_own_rows<kD>(dot, kQ, fold_factor<__nv_bfloat16>(drop.scale), tid, kThr);
    }
    wg::fence_proxy_async();  // the ring's tile t, and the last tile's staged dQ
    __syncthreads();
    if (kTma && t > 0 && tid == 0) reduce_dq(i0 - kQ);

    // S^T and dP^T: rows = the warpgroup's keys, columns = the tile's queries
    float st_[kN][4], dpt[kN][4];
    wg::fence();
    wg_nt<kD, kQ>(st_, kb_s, a_row, qt);
    wg_nt<kD, kQ>(dpt, vb_s, a_row, dot);
    wg::commit();
    uint32_t mine = kFull;  // keep bits of queries lane, lane + 32 (16 keys each)
    if constexpr (kDropout) {
      mine = keep_bits16(drop, pgrp, row_base + i0 + lane) |
             (keep_bits16(drop, pgrp, row_base + i0 + lane + 32) << 16);
    }
    wg::wait<0>();
    wg::fence_operand(st_);
    wg::fence_operand(dpt);
    const float* lt = lse_s + st * kQ;
    const float* dt = delta_s + st * kQ;
#pragma unroll
    for (int n = 0; n < kN / 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t w = kFull;
        if constexpr (kDropout) w = __shfl_sync(kFull, mine, n * 8 + 2 * c + e);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {  // query columns n*8 + ... and +32
          const int nn = n + hi * (kN / 2);
          const int col = nn * 8 + 2 * c + e;
          const uint32_t bits = w >> (16 * hi);
          const float l = i0 + col < seq ? lt[col] : INFINITY;  // p = 0 past seq
          const float dl = dt[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p = exp2f(fmaf(st_[nn][2 * r + e], score_mult, bias2[r]) - l);
            float pd = p, dpm = dpt[nn][2 * r + e];
            if constexpr (kDropout) {
              // the kept p unscaled (dO carries 1 / (1 - rate)); a product
            // with the keep bit, as in flash_bwd_dkv_kernel
              const float kept = ((bits >> (g + 8 * r)) & 1u) ? 1.f : 0.f;
              pd = p * kept;
              dpm *= kept;
            }
            st_[nn][2 * r + e] = p * (dpm - dl);  // dS^T
            dpt[nn][2 * r + e] = pd;              // P^T with dropout
          }
        }
      }
    }
    uint32_t pa[kN / 2][4], da[kN / 2][4];  // rounded to bf16, as JAX's
    wg::to_a(dpt, pa);
    wg::to_a(st_, da);
    // dS^T into the shared tile, the warpgroup's key rows (above
    // kMaxWholeDkvHeadDim warpgroup w its queries [32 w, 32 w + 32)):
    // da[kk] holds rows g, g + 8 of the warp's keys at queries 16 kk + 2 c
    // and 16 kk + 8 + 2 c
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {
      if (kCG == 2 && (kk >> 1) != grp) continue;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = a_row + warp * 16 + g + 8 * (x & 1), col = 16 * kk + 8 * (x >> 1) + 2 * c;
        *reinterpret_cast<uint32_t*>(dst_s + wg::swz<kQ>(row, col >> 3) + (col & 7) * 2) =
            da[kk][x];
      }
    }
    wg::fence_operand(dv_acc.x);
    wg::fence_operand(dk_acc.x);
    wg::fence_operand(pa);
    wg::fence_operand(da);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {  // dV += P^T dO
      wg::mma_rs<kC, 1>(dv_acc.x, pa[kk], wg::desc_mn<kD>(dot, kk, col0), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {  // dK += dS^T Q
      wg::mma_rs<kC, 1>(dk_acc.x, da[kk], wg::desc_mn<kD>(qt, kk, col0), 1);
    }
    wg::commit();
    wg::fence_proxy_async();  // the dS^T stores, for the dQ products
    if (kTma && tid == 0) bulk_wait_read();  // the last tile's dQ has left the staged tile
    __syncthreads();          // dS^T is whole, the staged tile free
    // dV and dK land (their A fragments free their registers before dQ's
    // accumulator takes some: beside both, ptxas spilled at 256)
    wg::wait<0>();
    wg::fence_operand(dv_acc.x);
    wg::fence_operand(dk_acc.x);
    wg::fence_operand(pa);
    wg::fence_operand(da);

    // dQ[i0 .. i0 + 64) += dS K over the CTA's keys on the warpgroup's
    // columns, kDqC a product
#pragma unroll
    for (int h = 0; h < kDqW / kDqC; ++h) {
      float dqp[kDqC / 8][4];
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wg::mma_ss<kDqC, 1, 1>(dqp, wg::desc_mn<kQ>(dst_s, kk),
                               wg::desc_mn<kD>(kb_s, kk, dq0 + kDqC * h), kk);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_operand(dqp);
      if constexpr (kTma) {  // into the staged tile, rows g and g + 8 of the warp's
#pragma unroll
        for (int n = 0; n < kDqC / 8; ++n) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r, col = dq0 + kDqC * h + n * 8 + 2 * c;
            const int phase = kBox == 32 ? row & 7 : (row >> 1) & 3;  // the swizzle's
            *reinterpret_cast<float2*>(dq_s + col / kBox * kQ * kBox + row * kBox +
                                       ((col % kBox / 4 ^ phase) << 2) + (col & 3)) =
                make_float2(dqp[n][2 * r] * scale, dqp[n][2 * r + 1] * scale);
          }
        }
      } else {
        // lane pairs swap halves: each lane then holds 4 consecutive
        // columns of one row, odd lanes row g + 8, even lanes row g
        const bool odd = c & 1;
        const int row = i0 + warp * 16 + g + (odd ? 8 : 0);
        float* dst = dq32 + head_base + (size_t)row * hidden + dq0 + kDqC * h + 2 * (c & ~1);
#pragma unroll
        for (int n = 0; n < kDqC / 8; ++n) {
          const float* x = dqp[n];
          const float r0 = __shfl_xor_sync(kFull, odd ? x[0] : x[2], 1);
          const float r1 = __shfl_xor_sync(kFull, odd ? x[1] : x[3], 1);
          const float4 val = odd ? make_float4(r0 * scale, r1 * scale, x[2] * scale, x[3] * scale)
                                 : make_float4(x[0] * scale, x[1] * scale, r0 * scale, r1 * scale);
          if (row < seq) atomicAdd(reinterpret_cast<float4*>(dst + n * 8), val);
        }
      }
    }
    __syncthreads();  // the ring stage, the dS^T and staged dQ tiles are rewritten next
  }
  if constexpr (kTma) {  // the last tile's dQ
    wg::fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      reduce_dq((n_tiles - 1) * kQ);
      bulk_wait();
    }
  }
  store_frag(dk, head_base + col0, hidden, key0, seq, dk_acc, scale, scale);
  store_frag(dv, head_base + col0, hidden, key0, seq, dv_acc, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// The dynamic shared memory an H100 CTA may take.
constexpr int kMaxSmem = 232448;

// Kernels above 48 KB of dynamic shared memory must opt in, once per
// kernel (each instantiation holds its own flag).
template <auto kKernel>
cudaError_t allow_smem(int bytes) {
  static bool done = false;
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

dim3 grid_for(int batch, int seq, int num_heads) {
  return dim3((seq + kBlock - 1) / kBlock, num_heads, batch);
}

// The launchers: `o` is the output delta reads (OutT: f32 for flash2, the
// storage type for the head-split kernels).
template <class P, bool kHeadSplit, bool kDropout, bool kTrain>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias, void* out,
               float* lse, float* out32, int batch, int seq, int hidden, int num_heads,
               float score_mult, Dropout drop, cudaStream_t s) {
  using T = typename P::T;
  constexpr auto kernel = flash_fwd_kernel<P, kHeadSplit, kDropout, kTrain>;
  constexpr int bytes = fwd_smem_bytes<P>();
  cudaError_t err = allow_smem<kernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(batch, seq, num_heads), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), lse, out32, seq, hidden, score_mult, drop);
  return (int)cudaGetLastError();
}

template <class P, bool kHeadSplit, bool kDropout, bool kFused>
int launch_dkv(const void* q, const void* k, const void* v, const float* bias,
               const void* o, const void* dout, const float* lse, const float* delta,
               float* dq32, void* dk, void* dv, int batch, int seq, int hidden,
               int num_heads, float scale, Dropout drop, cudaStream_t s) {
  using T = typename P::T;
  constexpr auto kernel = flash_bwd_dkv_kernel<P, kHeadSplit, kDropout, kFused>;
  constexpr int bytes = dkv_smem_bytes<P, kFused>();
  cudaError_t err = allow_smem<kernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(batch, seq, num_heads), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const OutT<P, kHeadSplit>*>(o), static_cast<const T*>(dout), lse, delta,
      dq32, static_cast<T*>(dk), static_cast<T*>(dv), seq, hidden, scale * kLog2e, scale,
      drop);
  return (int)cudaGetLastError();
}

// dq (writing delta = rowsum(dO o), [B, heads, S] f32, to `delta`), then
// dk/dv reading it.
template <class P, bool kHeadSplit, bool kDropout>
int launch_split(const void* q, const void* k, const void* v, const float* bias,
                 const void* o, const void* dout, const float* lse, float* delta,
                 void* dq, void* dk, void* dv, int batch, int seq, int hidden,
                 int num_heads, float scale, Dropout drop, cudaStream_t s) {
  using T = typename P::T;
  constexpr auto kernel = flash_bwd_dq_kernel<P, kHeadSplit, kDropout>;
  constexpr int bytes = dq_smem_bytes<P>();
  cudaError_t err = allow_smem<kernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(batch, seq, num_heads), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const OutT<P, kHeadSplit>*>(o), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), seq, hidden, scale * kLog2e, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_dkv<P, kHeadSplit, kDropout, false>(q, k, v, bias, o, dout, lse, delta,
                                                    nullptr, dk, dv, batch, seq, hidden,
                                                    num_heads, scale, drop, s);
}

// The bf16 forward and split backward on the warpgroup kernels: the
// forward kernel kKernel (flash_fwd_wg_kernel or
// flash_fwd_wg_overlap_kernel at head dim kD).
template <auto kKernel, int kD>
int launch_fwd_wg_kernel(const void* q, const void* k, const void* v, const float* bias,
                         void* out, float* lse, float* out32, int batch, int seq, int hidden,
                         int num_heads, float score_mult, Dropout drop, cudaStream_t s) {
  using T = __nv_bfloat16;
  constexpr int bytes = wg_fwd_smem_bytes<kD>(), rows = 64 * kFwdGroups;
  static_assert(bytes <= kMaxSmem, "the forward's tiles fit one CTA's shared memory");
  cudaError_t err = allow_smem<kKernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kKernel<<<dim3((seq + rows - 1) / rows, num_heads, batch), wg::kGroupThreads * kFwdGroups,
            bytes, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), bias, static_cast<T*>(out), lse, out32, seq,
                        hidden, score_mult, drop);
  return (int)cudaGetLastError();
}

template <int kD, bool kHeadSplit, bool kDropout, bool kTrain>
int launch_fwd_wg(const void* q, const void* k, const void* v, const float* bias, void* out,
                  float* lse, float* out32, int batch, int seq, int hidden, int num_heads,
                  float score_mult, Dropout drop, cudaStream_t s) {
  if constexpr (kFwdOverlap<kD, kDropout>) {
    return launch_fwd_wg_kernel<flash_fwd_wg_overlap_kernel<kD, kHeadSplit, kDropout, kTrain>,
                                kD>(q, k, v, bias, out, lse, out32, batch, seq, hidden,
                                    num_heads, score_mult, drop, s);
  } else {
    return launch_fwd_wg_kernel<flash_fwd_wg_kernel<kD, kHeadSplit, kDropout, kTrain>, kD>(
        q, k, v, bias, out, lse, out32, batch, seq, hidden, num_heads, score_mult, drop, s);
  }
}

// The dk/dv launch of kernel kKernel (flash_bwd_dkv_wg_kernel or
// flash_bwd_dkv_role_wg_kernel at head dim kD), `threads` a CTA.
template <auto kKernel, int kD>
int launch_dkv_wg(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                  const float* bias, const __nv_bfloat16* dout, const float* lse,
                  const float* delta, void* dk, void* dv, int batch, int seq, int hidden,
                  int num_heads, float scale, Dropout drop, cudaStream_t s, int threads) {
  constexpr int bytes = wg_dkv_smem_bytes<kD>(), keys = 64 * kDkvGroups;
  static_assert(bytes <= kMaxSmem, "the dk/dv launch's tiles fit one CTA's shared memory");
  const cudaError_t err = allow_smem<kKernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kKernel<<<dim3((seq + keys - 1) / keys, num_heads, batch), threads, bytes, s>>>(
      q, k, v, bias, dout, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), seq, hidden, scale * kLog2e, scale, drop);
  return (int)cudaGetLastError();
}

// dq (writing delta, [B, heads, S] f32, to `delta`), then dk/dv reading it
// (above kMaxWholeDkvHeadDim by role where kDkvByRole).
template <int kD, bool kHeadSplit, bool kDropout>
int launch_split_wg(const void* q, const void* k, const void* v, const float* bias,
                    const void* o, const void* dout, const float* lse, float* delta, void* dq,
                    void* dk, void* dv, int batch, int seq, int hidden, int num_heads,
                    float scale, Dropout drop, cudaStream_t s) {
  using T = __nv_bfloat16;
  constexpr auto dq_kernel = flash_bwd_dq_wg_kernel<kD, kHeadSplit, kDropout>;
  constexpr int dq_bytes = wg_dq_smem_bytes<kD, kDropout>();
  constexpr int dq_rows = 64 * kDqRowGroups<kD, kDropout>;
  static_assert(dq_bytes <= kMaxSmem, "the dq launch's tiles fit one CTA's shared memory");
  cudaError_t err = allow_smem<dq_kernel>(dq_bytes);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  dq_kernel<<<dim3((seq + dq_rows - 1) / dq_rows, num_heads, batch),
              wg::kGroupThreads * kDqGroups<kD, kDropout>, dq_bytes, s>>>(
      qt, kt, vt, bias, static_cast<const WgOutT<kHeadSplit>*>(o), dot, lse, delta,
      static_cast<T*>(dq), seq, hidden, scale * kLog2e, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (kDkvByRole<kD>) {
    return launch_dkv_wg<flash_bwd_dkv_role_wg_kernel<kD, kHeadSplit, kDropout>, kD>(
        qt, kt, vt, bias, dot, lse, delta, dk, dv, batch, seq, hidden, num_heads, scale, drop, s,
        2 * wg::kGroupThreads);
  } else {
    return launch_dkv_wg<flash_bwd_dkv_wg_kernel<kD, kHeadSplit, kDropout>, kD>(
        qt, kt, vt, bias, dot, lse, delta, dk, dv, batch, seq, hidden, num_heads, scale, drop, s,
        wg::kGroupThreads * kDkvGroups * kDkvCols<kD>);
  }
}

// The f32 dq scratch [batch, seq, hidden] as a 3-D tensor map (columns,
// rows, batch rows) of boxes [1 x 64 x box] in the 128-byte swizzle (the
// 64-byte one for 16 columns): the fused sweep's bulk tensor reductions'
// destination.  cuTensorMapEncodeTiled lives in libcuda; the runtime hands
// over its entry point (cudaGetDriverEntryPoint), so nothing links libcuda.
inline cudaError_t dq_tensor_map(CUtensorMap* map, float* dq32, int batch, int seq, int hidden,
                                 int box) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)hidden, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)hidden * 4, (cuuint64_t)seq * hidden * 4};
  const cuuint32_t boxes[3] = {(cuuint32_t)box, (cuuint32_t)kFusedQueries, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dq32, dims, strides, boxes,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              box == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The bf16 fused sweep kKernel (flash2_bwd_fused_wg_kernel at head dim
// kD): kKeys keys and kThreads threads a CTA, kBytes of dynamic shared
// memory; kBox > 0: dq32 reduced into through dq_tensor_map's boxes of kBox
// columns.
template <auto kKernel, int kBytes, int kKeys, int kThreads, int kBox>
int launch_fused_sweep(const void* q, const void* k, const void* v, const float* bias,
                       const void* dout, const float* lse, const float* delta, float* dq32,
                       void* dk, void* dv, int batch, int seq, int hidden, int num_heads,
                       float scale, Dropout drop, cudaStream_t s) {
  using T = __nv_bfloat16;
  static_assert(kBytes <= kMaxSmem, "the fused sweep's tiles fit one CTA's shared memory");
  cudaError_t err = allow_smem<kKernel>(kBytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map = {};
  if constexpr (kBox > 0) {
    err = dq_tensor_map(&map, dq32, batch, seq, hidden, kBox);
    if (err != cudaSuccess) return (int)err;
  }
  kKernel<<<dim3((seq + kKeys - 1) / kKeys, num_heads, batch), kThreads, kBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(dout), lse, delta, dq32, static_cast<T*>(dk), static_cast<T*>(dv),
      seq, hidden, scale * kLog2e, scale, drop, map);
  return (int)cudaGetLastError();
}

// flash2's fused backward: the pre-pass (delta into `delta`, [B, heads, S]
// f32, and dq32 zeroed), then the sweep: bf16 flash2_bwd_fused_kernel up to
// kFusedMmaMaxDim, flash2_bwd_fused_wg_kernel above; f32
// flash_bwd_dkv_kernel<SimtF32, ..., kFused = true>
// (which takes its own delta per tile and leaves the pre-pass's unread),
// refused above kMaxF32HeadDim.
template <int kD, bool kDropout>
int launch_fused(const void* q, const void* k, const void* v, const float* bias,
                 const float* o32, const void* dout, const float* lse, float* delta,
                 float* dq32, void* dk, void* dv, int batch, int seq, int hidden,
                 int num_heads, int dtype, float scale, Dropout drop, cudaStream_t s) {
  const long long chunks = (long long)batch * seq * hidden / 8;
  const long long blocks = (chunks + kPrepThreads - 1) / kPrepThreads;
  if (blocks > 0x7fffffffLL || (kD > kMaxF32HeadDim && dtype == 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    flash2_bwd_prep_kernel<float, kD><<<(unsigned)blocks, kPrepThreads, 0, s>>>(
        o32, static_cast<const float*>(dout), delta, dq32, seq, hidden, num_heads, chunks);
  } else {
    flash2_bwd_prep_kernel<__nv_bfloat16, kD><<<(unsigned)blocks, kPrepThreads, 0, s>>>(
        o32, static_cast<const __nv_bfloat16*>(dout), delta, dq32, seq, hidden, num_heads,
        chunks);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (kD <= kMaxF32HeadDim) {
    if (dtype == 0) {
      return launch_dkv<SimtF32<kD>, false, kDropout, true>(q, k, v, bias, o32, dout, lse,
                                                            nullptr, dq32, dk, dv, batch, seq,
                                                            hidden, num_heads, scale, drop, s);
    }
  }
  using T = __nv_bfloat16;
  if constexpr (kD <= kFusedMmaMaxDim) {
    constexpr auto kernel = flash2_bwd_fused_kernel<kD, kDropout>;
    constexpr int bytes = fused_tc_smem_bytes<kD>();
    err = allow_smem<kernel>(bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((seq + kFKeys - 1) / kFKeys, num_heads, batch), kFThreads, bytes, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
        static_cast<const T*>(dout), lse, delta, dq32, static_cast<T*>(dk), static_cast<T*>(dv),
        seq, hidden, scale * kLog2e, scale, drop);
    return (int)cudaGetLastError();
  } else {
    return launch_fused_sweep<flash2_bwd_fused_wg_kernel<kD, kDropout>, fused_wg_smem_bytes<kD>(),
                              64 * kFusedKeyGroups<kD>, kFusedThreads<kD>,
                              kFusedTmaDq<kD> ? kFusedDqBox<kD> : 0>(
        q, k, v, bias, dout, lse, delta, dq32, dk, dv, batch, seq, hidden, num_heads, scale, drop,
        s);
  }
}

// The forward of either dtype at head dim kD: bf16 on the warpgroup kernels,
// f32 on SimtF32 (refused above kMaxF32HeadDim).
template <int kD, bool kHeadSplit, bool kDropout, bool kTrain>
int launch_fwd_for(const void* q, const void* k, const void* v, const float* bias, void* out,
                   float* lse, float* out32, int batch, int seq, int hidden, int num_heads,
                   int dtype, float score_mult, Dropout drop, cudaStream_t s) {
  if (dtype == 0) {
    if constexpr (kD > kMaxF32HeadDim) {
      return (int)cudaErrorInvalidValue;
    } else {
      return launch_fwd<SimtF32<kD>, kHeadSplit, kDropout, kTrain>(
          q, k, v, bias, out, lse, out32, batch, seq, hidden, num_heads, score_mult, drop, s);
    }
  }
  return launch_fwd_wg<kD, kHeadSplit, kDropout, kTrain>(
      q, k, v, bias, out, lse, out32, batch, seq, hidden, num_heads, score_mult, drop, s);
}

// The split backward of either dtype at head dim kD: bf16 on the warpgroup
// kernels, f32 on SimtF32 (refused above kMaxF32HeadDim).
template <int kD, bool kHeadSplit, bool kDropout>
int launch_split_for(const void* q, const void* k, const void* v, const float* bias,
                     const void* o, const void* dout, const float* lse, float* delta,
                     void* dq, void* dk, void* dv, int batch, int seq, int hidden,
                     int num_heads, int dtype, float scale, Dropout drop, cudaStream_t s) {
  if (dtype == 0) {
    if constexpr (kD > kMaxF32HeadDim) {
      return (int)cudaErrorInvalidValue;
    } else {
      return launch_split<SimtF32<kD>, kHeadSplit, kDropout>(
          q, k, v, bias, o, dout, lse, delta, dq, dk, dv, batch, seq, hidden, num_heads, scale,
          drop, s);
    }
  }
  return launch_split_wg<kD, kHeadSplit, kDropout>(q, k, v, bias, o, dout, lse, delta, dq, dk,
                                                   dv, batch, seq, hidden, num_heads, scale,
                                                   drop, s);
}

bool bad_args(int batch, int seq, int hidden, int num_heads, int dtype, double drop_rate) {
  return seq <= 0 || batch <= 0 || batch > 65535 || num_heads <= 0 || num_heads > 65535 ||
         tc::head_dim_of(hidden, num_heads) == 0 || !msa_dropout::rate_ok(drop_rate) ||
         (dtype != 0 && dtype != 1);
}

}  // namespace
