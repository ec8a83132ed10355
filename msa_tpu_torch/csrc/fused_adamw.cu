// One tensor's AdamW update in one pass, in place:
//
//   g   = g * clip                         (clip: the global-norm scale, or 1)
//   mu' = b1 mu + (1 - b1) g               nu' = b2 nu + (1 - b2) g g
//   p'  = p - lr ((mu' / c1) / (sqrt(nu' / c2) + eps) + wd p)
//
// with c1 = 1 - b1^t and c2 = 1 - b2^t.  p and g are f32 (the trainer's
// master weights and gradients); mu and nu are each f32 or bf16, read
// widened to f32 and stored back rounded to nearest even.
//
// Replaces the TPU kernel msa_tpu/ops/fused_adamw.py::_kernel (entry
// fused_adamw_leaf), with its arithmetic (_adamw_math) in its order: every
// product, sum and quotient is a separately rounded f32 operation (the
// __f*_rn intrinsics keep nvcc from contracting them into FMAs), the
// division and the square root are IEEE (this file is built without
// --use_fast_math), and (1 - b1), (1 - b2) arrive rounded once from the
// host's double, as JAX rounds the Python float.  The result is the plain
// PyTorch expression's, bit for bit.
//
// What bounds it on the H100: bytes.  Per element it reads p, g, mu, nu and
// writes p, mu, nu -- 20 bytes with bf16 moments, 28 with f32 -- for about
// fifteen flops: a pure streaming pass.  The TPU kernel tiled the flattened
// tensor into [256, 1024] blocks for VMEM; here a grid-stride loop moves 8
// elements a thread per iteration in 16-byte vectors (two float4 of p and
// of g, one uint4 of bf16 moments or two float4 of f32 ones), neighbouring
// threads on neighbouring addresses, and a scalar loop takes the tail (a
// leaf's length need not be a multiple of 8, nor its pointers 16-byte
// aligned: then the whole leaf runs scalar).  The global-norm clip scale is
// read from device memory, so clipping costs no host synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;          // elements a thread moves per iteration
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, lr, wd, c1, c2;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void narrow(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// 8 consecutive moments (16-byte aligned) as f32, and back.
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// _adamw_math on one element, in f32, each operation rounded on its own.
__device__ __forceinline__ void adamw(float& p, float g, float& mu, float& nu,
                                      const Hyper& h) {
  mu = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.one_minus_b1, g));
  nu = __fadd_rn(__fmul_rn(h.b2, nu), __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
  const float mu_hat = __fdiv_rn(mu, h.c1);
  const float nu_hat = __fdiv_rn(nu, h.c2);
  const float upd = __fadd_rn(__fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), h.eps)),
                              __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, upd));
}

template <typename M, typename N>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
                   M* __restrict__ mu, N* __restrict__ nu, long long n,
                   bool vectorized, Hyper h, const float* __restrict__ clip) {
  const float scale = clip != nullptr ? *clip : 1.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_vec = vectorized ? n / kVec : 0;
  for (long long i = tid; i < n_vec; i += stride) {
    const long long e = i * kVec;
    float pv[kVec], gv[kVec], mv[kVec], nv[kVec];
    load8(p + e, pv);
    load8(g + e, gv);
    load8(mu + e, mv);
    load8(nu + e, nv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float gj = clip != nullptr ? __fmul_rn(gv[j], scale) : gv[j];
      adamw(pv[j], gj, mv[j], nv[j], h);
    }
    store8(p + e, pv);
    store8(mu + e, mv);
    store8(nu + e, nv);
  }
  for (long long e = n_vec * kVec + tid; e < n; e += stride) {
    float pe = p[e];
    float me = widen(mu[e]);
    float ne = widen(nu[e]);
    const float ge = clip != nullptr ? __fmul_rn(g[e], scale) : g[e];
    adamw(pe, ge, me, ne, h);
    p[e] = pe;
    narrow(mu + e, me);
    narrow(nu + e, ne);
  }
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

template <typename M, typename N>
void launch(void* p, const void* g, void* mu, void* nu, long long n, const Hyper& h,
            const float* clip, cudaStream_t s) {
  const bool vectorized = aligned16(p) && aligned16(g) && aligned16(mu) && aligned16(nu);
  const long long work = vectorized ? (n + kVec - 1) / kVec : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want));
  fused_adamw_kernel<M, N><<<blocks, kThreads, 0, s>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<M*>(mu),
      static_cast<N*>(nu), n, vectorized, h, clip);
}

}  // namespace

// One leaf's AdamW update, in place.  p, g: n f32; mu, nu: n elements of
// mu_dtype / nu_dtype (0 = float32, 1 = bfloat16); one_minus_b1/b2 are
// (1 - b1), (1 - b2) rounded from double; clip_scale: a device f32 scalar
// multiplying g, or null for none.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  The caller has checked devices,
// dtypes, sizes and contiguity.
extern "C" int msa_fused_adamw(void* p, const void* g, void* mu, void* nu,
                               long long n, int mu_dtype, int nu_dtype, float b1,
                               float one_minus_b1, float b2, float one_minus_b2,
                               float eps, float lr, float wd, float c1, float c2,
                               const void* clip_scale, void* stream) {
  if (n < 0 || (mu_dtype != 0 && mu_dtype != 1) || (nu_dtype != 0 && nu_dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, lr, wd, c1, c2};
  const float* clip = static_cast<const float*>(clip_scale);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (mu_dtype == 0 && nu_dtype == 0) {
    launch<float, float>(p, g, mu, nu, n, h, clip, s);
  } else if (mu_dtype == 0) {
    launch<float, __nv_bfloat16>(p, g, mu, nu, n, h, clip, s);
  } else if (nu_dtype == 0) {
    launch<__nv_bfloat16, float>(p, g, mu, nu, n, h, clip, s);
  } else {
    launch<__nv_bfloat16, __nv_bfloat16>(p, g, mu, nu, n, h, clip, s);
  }
  return (int)cudaGetLastError();
}
