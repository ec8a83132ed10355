// v1 short attention (S <= 128, head dim 16, 32, 64 or 128, the source
// built once a head dim): whole-sequence softmax per head with in-kernel
// attention-probs dropout, and its backward in one launch.  Above 128 keys
// (to S = 1023) the wrappers run v1 on short_attention.cu's forms, which
// compute the same function with the same mask: the forward (bf16 the
// two-sweep form, f32 the key-tiled CUDA-core kernel), and for the backward
// that forward's training form (for the row lse, which v1 keeps nowhere;
// its ctx is dropped) then the v2 pair, whose rule, delta = rowsum(p *
// dpm), is v1's.
//
// Replaces the TPU kernels msa_tpu/ops/short_attention.py::_fwd_kernel
// (:139) and ::_bwd_kernel (:177), entry short_attention (:667), the v1 pair
// that JAX's tests and short-attention benchmarks call.  The same contract
// as the port's v2 kernels (short_attention.cu): q, k, v, the output ctx and
// the gradients are [B, S, H] in natural layout, heads sliced inside the
// kernels, key_bias an additive [B, S] f32 mask, the softmax in f32 in base
// 2 (scores carry scale * log2e, exp2 replaces exp; dq and dk scale by the
// natural 1/sqrt(d)), no gradient for the bias or the seed.  What makes it
// v1, as on the TPU:
//
//   * the pair keeps no residual but its inputs: the forward writes ctx
//     only (no f32 output, no row lse);
//   * the softmax is the plain one over the whole row: max, then the sum,
//     then p = exp2(s - max) / sum, then dropout (kept p times
//     256 / (256 - t)), and the dropped p is rounded to the input dtype
//     before the PV product (p.astype(v.dtype));
//   * the backward recomputes max, sum and p itself and forms delta =
//     rowsum(p * dpm), dpm the kept dP = dO.V^T over 1 - rate (_bwd_kernel
//     :216), not from o; dS and the dropped p are rounded to the input dtype
//     before their products, as there.
//
// What bounds them on the H100: bytes (at S = 80 a (batch, head) pair does
// 4*S*S*d FLOPs on 4*S*d elements, 80 FLOPs an element, far
// below the ~295 FLOPs per byte where the tensor cores would be the
// limit).  Both kernels take one CTA per (head, batch row).
//
//   * The bf16 forward runs on the tensor cores: the stride-H serving form
//     of short_fwd_tc.cuh, the template the v2 and v2p forwards of
//     short_attention.cu share (one warp per 16 query rows, Q, K and V
//     staged once in bf16 by cp.async, the whole score row in registers,
//     P V by mma.sync), one launch.
//   * The bf16 backward runs on the tensor cores too: short_bwd_tc.cuh, the
//     template it shares with the v3 backward of short_attention.cu (delta
//     from the score row here), one launch.
//   * The f32 forward and backward run on the CUDA cores in f32 (on the
//     tensor cores f32 would be TF32, three decimal digits): K and V staged
//     once as f32 (rows padded to d + 1 floats, so a warp's 32 keys read 32
//     banks), query tiles of 32 rows whose [32, S] score rows also stay in
//     shared memory (S <= 128 keeps a CTA within 116 KB at head dim 64,
//     194 KB at 128).  The backward
//     keeps each key's dk and dv in the registers of two threads
//     (interleaved dims) across all query tiles and writes dq per tile: one
//     launch, no atomics, no [S, S] tensor in device memory.
//
// Dropout: the rule of dropout.cuh (Philox4x32-10 of the seed and the
// element's index (b, head, i, j)), so at one seed this pair and the v2
// kernels draw the same mask.  The TPU kernels' 2-head lane groups answer
// the TPU's 128-lane matrix unit and have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "mma_tiles.cuh"
#include "short_bwd_tc.cuh"
#include "short_fwd_tc.cuh"

namespace {

namespace tc = msa_mma;

using msa_dropout::Dropout;
using msa_dropout::keep_bits16;
using msa_dropout::make_dropout;

constexpr int kMaxSeq = 128;    // keys a CTA holds; two threads per key
constexpr int kRows = 32;       // query rows per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
template <int kD>
inline constexpr int kPad = kD + 1;  // f32 row stride of the staged K and V
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads == 2 * kMaxSeq, "two threads per key in the backward");
static_assert(msa_dropout::kGroup == 16, "one Philox draw per 16 keys");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and widened back (the TPU kernel's .astype before a dot)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// Rows [r0, r0 + n) of one head of x ([B, S, H] at x + base, row stride
// `hidden`) into shared memory as f32 with row stride `stride`.
template <typename T, int kD>
__device__ __forceinline__ void stage_rows(const T* x, size_t base, int hidden, int r0, int n,
                                           float* dst, int stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kD / kVec;
  for (int idx = threadIdx.x; idx < n * kChunks; idx += kThreads) {
    const int r = idx / kChunks, ch = idx - r * kChunks;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(x + base + (size_t)(r0 + r) * hidden + ch * kVec);
    const T* vals = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * stride + ch * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) d[e] = to_float(vals[e]);
  }
}

template <int kD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < kD; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One warp's softmax of score row s[0 .. seq) (base 2, in place): p =
// exp2(s - max) / sum.  Returns nothing; s holds p afterwards.
__device__ __forceinline__ void softmax_row(float* s, int seq) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int j = lane; j < seq; j += 32) m = fmaxf(m, s[j]);
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < seq; j += 32) {
    const float e = exp2f(s[j] - m);
    s[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < seq; j += 32) s[j] = s[j] / sum;
}

// Keep bits of probability row `prob_row` for this lane's keys: lane g <
// ceil(seq / 16) draws group g; keep_of(bits, j) reads key j's bit.
__device__ __forceinline__ uint32_t row_keep_bits(const Dropout& drop, uint32_t prob_row,
                                                  int seq) {
  const int lane = threadIdx.x & 31;
  return lane * 16 < seq ? keep_bits16(drop, (uint32_t)lane, prob_row) : 0u;
}
__device__ __forceinline__ bool keep_of(uint32_t bits, int j) {
  return (__shfl_sync(kFull, bits, j >> 4) >> (j & 15)) & 1u;
}

// ---------------------------------------------------------------------------
// Forward, f32: ctx only, on the CUDA cores
// ---------------------------------------------------------------------------

template <int kD>
int fwd_smem_bytes(int seq) {
  return (2 * seq * kPad<kD> + kRows * kD + kRows * seq + seq) * (int)sizeof(float);
}

template <int kD, bool kDropout>
__global__ void __launch_bounds__(kThreads)
short_v1_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ key_bias,
                    float* __restrict__ out, int seq, int hidden, float score_mult,
                    Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                  // [seq][kPad<kD>]
  float* v_s = k_s + seq * kPad<kD>;  // [seq][kPad<kD>]
  float* q_s = v_s + seq * kPad<kD>;  // [kRows][kD]
  float* p_s = q_s + kRows * kD;        // [kRows][seq]
  float* bias_s = p_s + kRows * seq;    // [seq], log2 domain

  const int head = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kD;
  const uint32_t row_base = ((uint32_t)b * gridDim.x + head) * (uint32_t)seq;

  stage_rows<float, kD>(k, base, hidden, 0, seq, k_s, kPad<kD>);
  stage_rows<float, kD>(v, base, hidden, 0, seq, v_s, kPad<kD>);
  for (int j = threadIdx.x; j < seq; j += kThreads) {
    bias_s[j] = key_bias[(size_t)b * seq + j] * kLog2e;
  }
  for (int i0 = 0; i0 < seq; i0 += kRows) {
    const int rows = min(kRows, seq - i0);
    __syncthreads();  // the previous tile is done with q_s and p_s
    stage_rows<float, kD>(q, base, hidden, i0, rows, q_s, kD);
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * seq; idx += kThreads) {
      const int i = idx / seq, j = idx - i * seq;
      p_s[idx] = fmaf(dot<kD>(&q_s[i * kD], &k_s[j * kPad<kD>]), score_mult, bias_s[j]);
    }
    __syncthreads();
    for (int i = warp; i < rows; i += kWarps) {
      float* p = p_s + i * seq;
      softmax_row(p, seq);
      uint32_t bits = 0u;
      if constexpr (kDropout) bits = row_keep_bits(drop, row_base + i0 + i, seq);
      for (int j0 = 0; j0 < seq; j0 += 32) {
        const int j = j0 + lane;
        bool kept = true;
        if constexpr (kDropout) kept = keep_of(bits, min(j, seq - 1));
        if (j < seq) p[j] = kept ? p[j] * drop.scale : 0.f;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * kD; idx += kThreads) {
      const int i = idx / kD, d = idx - i * kD;
      const float* p = p_s + i * seq;
      float acc = 0.f;
      for (int j = 0; j < seq; ++j) acc = fmaf(p[j], v_s[j * kPad<kD> + d], acc);
      out[base + (size_t)(i0 + i) * hidden + d] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dq, dk, dv in one launch, from the inputs alone, on the CUDA
// cores; the entry takes it for f32 only (bf16: short_bwd_tc.cuh)
// ---------------------------------------------------------------------------

template <int kD>
int bwd_smem_bytes(int seq) {
  return (2 * seq * kPad<kD> + 2 * kRows * kD + 2 * kRows * seq + seq) * (int)sizeof(float);
}

template <typename T, int kD, bool kDropout>
__global__ void __launch_bounds__(kThreads)
short_v1_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ key_bias,
                    const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
                    T* __restrict__ dv, int seq, int hidden, float score_mult, float scale,
                    Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                  // [seq][kPad<kD>]
  float* v_s = k_s + seq * kPad<kD>;  // [seq][kPad<kD>]
  float* q_s = v_s + seq * kPad<kD>;  // [kRows][kD]
  float* do_s = q_s + kRows * kD;       // [kRows][kD]
  float* p_s = do_s + kRows * kD;       // [kRows][seq]: scores, p, then dropped p
  float* ds_s = p_s + kRows * seq;      // [kRows][seq]: dP, dpm, then dS
  float* bias_s = ds_s + kRows * seq;   // [seq], log2 domain

  const int head = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kD;
  const uint32_t row_base = ((uint32_t)b * gridDim.x + head) * (uint32_t)seq;
  // dk / dv: key `key`, dims 2e + half (interleaved: the two threads of a
  // key read different banks of a q / dO row)
  const int key = threadIdx.x >> 1, half = threadIdx.x & 1;
  float dk_acc[kD / 2], dv_acc[kD / 2];
#pragma unroll
  for (int e = 0; e < kD / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  stage_rows<T, kD>(k, base, hidden, 0, seq, k_s, kPad<kD>);
  stage_rows<T, kD>(v, base, hidden, 0, seq, v_s, kPad<kD>);
  for (int j = threadIdx.x; j < seq; j += kThreads) {
    bias_s[j] = key_bias[(size_t)b * seq + j] * kLog2e;
  }
  for (int i0 = 0; i0 < seq; i0 += kRows) {
    const int rows = min(kRows, seq - i0);
    __syncthreads();
    stage_rows<T, kD>(q, base, hidden, i0, rows, q_s, kD);
    stage_rows<T, kD>(dout, base, hidden, i0, rows, do_s, kD);
    __syncthreads();
    // scores and dP = dO.V^T
    for (int idx = threadIdx.x; idx < rows * seq; idx += kThreads) {
      const int i = idx / seq, j = idx - i * seq;
      p_s[idx] = fmaf(dot<kD>(&q_s[i * kD], &k_s[j * kPad<kD>]), score_mult, bias_s[j]);
      ds_s[idx] = dot<kD>(&do_s[i * kD], &v_s[j * kPad<kD>]);
    }
    __syncthreads();
    // per row: p, dpm, delta = sum p * dpm, then dS = p (dpm - delta) and
    // the dropped p, both rounded to T
    for (int i = warp; i < rows; i += kWarps) {
      float* p = p_s + i * seq;
      float* ds = ds_s + i * seq;
      softmax_row(p, seq);
      uint32_t bits = 0u;
      if constexpr (kDropout) bits = row_keep_bits(drop, row_base + i0 + i, seq);
      float delta = 0.f;
      for (int j0 = 0; j0 < seq; j0 += 32) {
        const int j = j0 + lane;
        bool kept = true;
        if constexpr (kDropout) kept = keep_of(bits, min(j, seq - 1));
        if (j < seq) {
          const float dpm = kept ? ds[j] * drop.scale : 0.f;
          ds[j] = dpm;
          delta = fmaf(p[j], dpm, delta);
        }
      }
      delta = warp_sum(delta);
      for (int j0 = 0; j0 < seq; j0 += 32) {
        const int j = j0 + lane;
        bool kept = true;
        if constexpr (kDropout) kept = keep_of(bits, min(j, seq - 1));
        if (j < seq) {
          const float pj = p[j];
          ds[j] = round_to<T>(pj * (ds[j] - delta));
          p[j] = round_to<T>(kept ? pj * drop.scale : 0.f);
        }
      }
    }
    __syncthreads();
    // dQ rows of this tile = dS K * scale
    for (int idx = threadIdx.x; idx < rows * kD; idx += kThreads) {
      const int i = idx / kD, d = idx - i * kD;
      const float* ds = ds_s + i * seq;
      float acc = 0.f;
      for (int j = 0; j < seq; ++j) acc = fmaf(ds[j], k_s[j * kPad<kD> + d], acc);
      dq[base + (size_t)(i0 + i) * hidden + d] = from_float<T>(acc * scale);
    }
    // dK += dS^T Q, dV += P_dropped^T dO for this thread's key
    if (key < seq) {
      for (int i = 0; i < rows; ++i) {
        const float w = ds_s[i * seq + key], u = p_s[i * seq + key];
        const float* qr = q_s + i * kD + half;
        const float* dr = do_s + i * kD + half;
#pragma unroll
        for (int e = 0; e < kD / 2; ++e) {
          dk_acc[e] = fmaf(w, qr[2 * e], dk_acc[e]);
          dv_acc[e] = fmaf(u, dr[2 * e], dv_acc[e]);
        }
      }
    }
  }
  if (key < seq) {
    T* dkr = dk + base + (size_t)key * hidden + half;
    T* dvr = dv + base + (size_t)key * hidden + half;
#pragma unroll
    for (int e = 0; e < kD / 2; ++e) {
      dkr[2 * e] = from_float<T>(dk_acc[e] * scale);
      dvr[2 * e] = from_float<T>(dv_acc[e]);
    }
  }
}

template <auto kKernel>
cudaError_t allow_smem(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool bad_args(int batch, int seq, int hidden, int num_heads, int dtype, double drop_rate) {
  return seq <= 0 || seq > kMaxSeq || batch <= 0 || batch > 65535 ||
         tc::head_dim_of(hidden, num_heads) == 0 || !msa_dropout::rate_ok(drop_rate) ||
         (dtype != 0 && dtype != 1);
}

template <int kD, bool kDropout>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias, void* out,
               int batch, int seq, int hidden, int num_heads, float score_mult, Dropout drop,
               cudaStream_t s) {
  constexpr auto kernel = short_v1_fwd_kernel<kD, kDropout>;
  const int bytes = fwd_smem_bytes<kD>(seq);
  cudaError_t err = allow_smem<kernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(num_heads, batch), kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(out), seq, hidden, score_mult,
      drop);
  return (int)cudaGetLastError();
}

template <typename T, int kD, bool kDropout>
int launch_bwd(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, void* dq, void* dk, void* dv, int batch, int seq, int hidden,
               int num_heads, float score_mult, float scale, Dropout drop, cudaStream_t s) {
  constexpr auto kernel = short_v1_bwd_kernel<T, kD, kDropout>;
  const int bytes = bwd_smem_bytes<kD>(seq);
  cudaError_t err = allow_smem<kernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(num_heads, batch), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), seq, hidden, score_mult, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The head dim hidden / num_heads is 32
// or 64.  drop_rate in [0, 1): 0 = no dropout, else the
// keep rule of dropout.cuh.  Every entry launches once on
// `stream` and returns cudaGetLastError() (0 on success).  The caller has
// checked shapes, contiguity, 16-byte alignment and S <= 128.
extern "C" int msa_short_attention_v1_fwd(const void* q, const void* k, const void* v,
                                          const void* key_bias, void* out, int batch, int seq,
                                          int hidden, int num_heads, int dtype, float scale,
                                          unsigned seed_lo, unsigned seed_hi,
                                          double drop_rate, void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* bias = static_cast<const float*>(key_bias);
  const Dropout d = make_dropout(seed_lo, seed_hi, drop_rate);
  const float sm = scale * kLog2e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    constexpr int kD = decltype(hd)::value;
    // f32 on the CUDA cores, bf16 on the tensor cores (short_fwd_tc.cuh)
#define MSA_FWD(D) launch_fwd<kD, D>(q, k, v, bias, out, batch, seq, hidden, num_heads, sm, d, s)
    if (dtype == 0) return drop_rate > 0.0 ? MSA_FWD(true) : MSA_FWD(false);
#undef MSA_FWD
#define MSA_TC(D)                                                                        \
  msa_short_fwd::launch<kD, D, false>(q, k, v, bias, out, nullptr, batch, seq, hidden,   \
                                      hidden, num_heads, sm, d, s)
    return drop_rate > 0.0 ? MSA_TC(true) : MSA_TC(false);
#undef MSA_TC
  });
}

// dq, dk, dv from q, k, v, key_bias and dout alone, for the same seed and
// rate as the forward: f32 on the CUDA cores, bf16 on the tensor cores
// (short_bwd_tc.cuh, delta = rowsum(p * dpm)).  One launch either way.
extern "C" int msa_short_attention_v1_bwd(const void* q, const void* k, const void* v,
                                          const void* key_bias, const void* dout, void* dq,
                                          void* dk, void* dv, int batch, int seq, int hidden,
                                          int num_heads, int dtype, float scale,
                                          unsigned seed_lo, unsigned seed_hi,
                                          double drop_rate, void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* bias = static_cast<const float*>(key_bias);
  const Dropout d = make_dropout(seed_lo, seed_hi, drop_rate);
  const float sm = scale * kLog2e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    constexpr int kD = decltype(hd)::value;
#define MSA_BWD(T, D)                                                                       \
  launch_bwd<T, kD, D>(q, k, v, bias, dout, dq, dk, dv, batch, seq, hidden, num_heads, sm, \
                       scale, d, s)
    if (dtype == 0) return drop_rate > 0.0 ? MSA_BWD(float, true) : MSA_BWD(float, false);
#undef MSA_BWD
#define MSA_TC(D)                                                                         \
  msa_short_bwd::launch<kD, D, msa_short_bwd::kRecompute>(                                \
      q, k, v, bias, nullptr, nullptr, dout, dq, dk, dv, nullptr, nullptr, batch, seq,    \
      hidden, hidden, num_heads, sm, scale, d, s)
    return drop_rate > 0.0 ? MSA_TC(true) : MSA_TC(false);
#undef MSA_TC
  });
}
