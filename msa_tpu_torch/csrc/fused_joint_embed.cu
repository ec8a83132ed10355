// Fused joint embedding: per batch row, out[0:L] = LN(text_emb) and
// out[L:L+Lp] = LN(relu(feats @ W + b)), written as one [L+Lp, H] block.
//
// Replaces the TPU kernel msa_tpu/ops/fused_joint_embed.py::_kernel (entry
// fused_joint_embed).  As there, the projection and the LayerNorm run in
// f32 and the output is stored in the compute dtype; W, b and the LN
// scale/bias arrive in f32.
//
// What bounds it on the H100: bytes.  Each output row reads one H-wide text
// row or one D-wide frame (D <= 371) and writes one H-wide row, with
// 2*D*H FLOPs per frame row -- under 1 FLOP per byte of the rows it
// touches.  The TPU kernel keeps the projection and the concatenation out
// of HBM; this one does the same per output row:
//
//   * one CTA of 256 threads per output row, each thread owning the
//     columns t, t + 256, ... below H, every global access coalesced; H a
//     multiple of 256 (bert-large, bert-base) gives every thread H / 256
//     of them, any other H <= 2048 (kRagged) some threads fewer (the tiny
//     preset's H = 64: a quarter of the threads, one column each);
//   * a frame row's features are staged once in shared memory and the
//     projection row is accumulated in registers (no [B, Lp, H] projection
//     tensor, no concatenation copy);
//   * the LayerNorm's mean and variance are two block reductions built on
//     warp shuffles (two-pass variance, as jnp.var computes it).
//
// W itself ([D, H] f32, 0.2 MB at D = 47) is re-read from L2 by every frame
// row's CTA; sharing it across several rows per CTA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 8;   // H <= 2048
constexpr int kMaxFeat = 1024;     // D <= 1024

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the CTA; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // `red` is free from any earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < kThreads / 32 ? red[lane] : 0.f);
}

template <typename T, bool kRagged>
__global__ void __launch_bounds__(kThreads)
fused_joint_embed_kernel(const T* __restrict__ text, const T* __restrict__ feats,
                         const float* __restrict__ w, const float* __restrict__ b,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ out,
                         int text_len, int pair_len, int feat_dim, int hidden,
                         float eps) {
  __shared__ float feat_s[kMaxFeat];
  __shared__ float red_s[kThreads / 32];

  const int rows = text_len + pair_len;
  const int bi = blockIdx.y;
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  // columns this thread owns: t + i * kThreads for i < nv
  const int nv = !kRagged ? hidden / kThreads
                          : t < hidden ? (hidden - t + kThreads - 1) / kThreads : 0;

  float x[kMaxPerThread];
  if (r < text_len) {  // uniform across the CTA
    const T* src = text + ((size_t)bi * text_len + r) * hidden;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      x[i] = i < nv ? to_f32(src[t + i * kThreads]) : 0.f;
    }
  } else {
    const T* f = feats + ((size_t)bi * pair_len + (r - text_len)) * feat_dim;
    for (int kk = t; kk < feat_dim; kk += kThreads) feat_s[kk] = to_f32(f[kk]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) x[i] = 0.f;
    for (int kk = 0; kk < feat_dim; ++kk) {
      const float fk = feat_s[kk];
      const float* wrow = w + (size_t)kk * hidden + t;
#pragma unroll
      for (int i = 0; i < kMaxPerThread; ++i) {
        if (i < nv) x[i] = fmaf(fk, __ldg(wrow + i * kThreads), x[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      if (i < nv) x[i] = fmaxf(x[i] + b[t + i * kThreads], 0.f);
    }
  }

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) sum += x[i];  // x[i] = 0 past nv
  const float mean = block_sum(sum, red_s) / hidden;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const float d = i < nv ? x[i] - mean : 0.f;
    sq = fmaf(d, d, sq);
  }
  const float rstd = rsqrtf(block_sum(sq, red_s) / hidden + eps);

  T* dst = out + ((size_t)bi * rows + r) * hidden;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    if (i < nv) {
      const int col = t + i * kThreads;
      dst[col] = from_f32<T>((x[i] - mean) * rstd * gamma[col] + beta[col]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (text, feats and out share it; w, b,
// gamma, beta are f32).  Launches on `stream` and returns cudaGetLastError().
// The caller has checked shapes, contiguity, hidden <= 2048 and
// feat_dim <= 1024.
extern "C" int msa_fused_joint_embed(const void* text, const void* feats,
                                     const void* w, const void* b,
                                     const void* gamma, const void* beta,
                                     void* out, int batch, int text_len,
                                     int pair_len, int feat_dim, int hidden,
                                     float eps, int dtype, void* stream) {
  if (batch <= 0 || text_len + pair_len <= 0 || hidden <= 0 ||
      hidden > kThreads * kMaxPerThread || feat_dim <= 0 || feat_dim > kMaxFeat) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(text_len + pair_len, batch);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* gf = static_cast<const float*>(gamma);
  const float* ef = static_cast<const float*>(beta);
  const bool ragged = hidden % kThreads != 0;
#define MSA_EMBED(T, R)                                                                  \
  fused_joint_embed_kernel<T, R><<<grid, kThreads, 0, s>>>(                              \
      static_cast<const T*>(text), static_cast<const T*>(feats), wf, bf, gf, ef,         \
      static_cast<T*>(out), text_len, pair_len, feat_dim, hidden, eps)
  if (dtype == 0) {
    if (ragged) MSA_EMBED(float, true); else MSA_EMBED(float, false);
  } else if (dtype == 1) {
    if (ragged) MSA_EMBED(__nv_bfloat16, true); else MSA_EMBED(__nv_bfloat16, false);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef MSA_EMBED
  return (int)cudaGetLastError();
}
