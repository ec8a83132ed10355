// The blockwise attention kernels of two sources, head dim 32 or 64:
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
// Inside, both run the softmax in base 2 (scores carry scale * log2e, exp2
// replaces exp); the head-split kernels convert their lse at the store
// and the load.  flash2.cu's header says how the kernels are laid out and
// what bounds them.  The bf16 tile products, copies and dropout words are
// mma_tiles.cuh's, shared with the short-attention kernels.  The head dim
// kD is a parameter of the tile policy P (MmaBf16<kD>, SimtF32<kD>): a
// score tile is [16 x 64] keys whatever kD, the output and gradient tiles
// [16 x kD].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dropout.cuh"
#include "mma_tiles.cuh"

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

constexpr int kBlock = 64;             // rows of a block and of a loop tile
constexpr int kWarps = kBlock / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kSN = kBlock / 8;        // 8-column tiles of a [16 x 64] score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using SFrag = Frag<kSN>;               // scores, probabilities, dS: [16 x 64]

static_assert(msa_dropout::kGroup == 16, "one Philox draw per 16 keys");
static_assert(kThreads == 2 * kBlock, "row_delta takes two threads per row");

// The tile products of a policy P on [kBlock][kStride] row tiles (q, k, v,
// dO; kD values a row) and one [kBlock][kTStride] tile of dS^T (fused only):
//   nt(a, m0, b, c):       c  = a[m0 .. m0+16) . b^T  [16 x 64], over kD columns
//   nn(f, b, c):           c += f . b                 [16 x kD], f [16 x 64]
//   tn(at, m0, b, c):      c  = at[:, m0 .. m0+16)^T . b  [16 x kD], over 64 rows
//                          of at (row stride kTStride)

// bf16 on the tensor cores (mma_tiles.cuh).
template <int kDim>
struct MmaBf16 {
  using T = __nv_bfloat16;
  static constexpr int kD = kDim;
  static constexpr int kON = kD / 8;              // column tiles of an output tile
  static constexpr int kStride = tc::kStride<kD>;  // kD + 8
  static constexpr int kTStride = kBlock + 8;      // 144-byte rows: conflict-free
  static constexpr int kSStride = 0;               // no stage
  static constexpr int kStageFloats = 0;
  using OFrag = Frag<kON>;

  __device__ static void nt(const T* a, int m0, const T* b, SFrag& c, float*) {
    tc::mma_nt<kD, kSN>(a, m0, b, c.x);
  }
  __device__ static void nn(const SFrag& f, const T* b, OFrag& c, float*) {
    tc::mma_nn<kD, kSN>(f.x, b, c.x);
  }
  __device__ static void tn(const T* at, int m0, const T* b, OFrag& c, float*) {
    tc::mma_tn<kD, kBlock / 16>(at, kTStride, m0, b, c.x);
  }
};

// f32: the same products on the CUDA cores, each lane computing the
// elements its Frag holds.  nn stages f in the warp's shared scratch
// ([16][kSStride]).  Rows of kD + 4 floats (an odd multiple of 16 bytes).
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

// The key bias of keys [k0, k0 + 64) in the log2 domain; -inf past seq.
__device__ __forceinline__ void load_bias(float* dst, const float* bias_row, int k0,
                                          int seq) {
  for (int j = threadIdx.x; j < kBlock; j += kThreads) {
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
  load_bias(bias_s, bias_row, 0, seq);

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
      load_bias(bias_s + nb * kBlock, bias_row, (t + 1) * kBlock, seq);
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
  load_bias(bias_s, bias_row, 0, seq);
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
      load_bias(bias_s + nb * kBlock, bias_row, (t + 1) * kBlock, seq);
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
// false, delta from the dq launch) and the fused single-sweep backward (row
// 11, kFused = true: delta per query tile, dq by f32 atomics)
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
// Launchers
// ---------------------------------------------------------------------------

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

bool bad_args(int batch, int seq, int hidden, int num_heads, int dtype, int threshold) {
  return seq <= 0 || batch <= 0 || batch > 65535 || num_heads <= 0 || num_heads > 65535 ||
         tc::head_dim_of(hidden, num_heads) == 0 || threshold < 0 || threshold > 255 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace
