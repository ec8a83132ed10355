// Fused residual add + LayerNorm + int8 quantize, for int8 serving:
//
//   h  = LayerNorm(x + res)            stored in x's dtype (the residual stream)
//   xi = clip(rint(h' / s), -127, 127) int8 (the next int8 GEMM's input)
//
// where h' is h rounded to its stored dtype and widened back, so xi equals
// quantize_act(h) of the unfused composition.  Static mode reads one f32
// scale s from device memory (a calibrated per-layer scale); dynamic mode
// uses s = max|h'| / 127 + 1e-12 per row and writes it to `row`.
//
// Replaces the TPU kernels msa_tpu/ops/ln_quant.py::_kernel_static and
// ::_kernel_dynamic (entry ln_quant).  Same arithmetic: the sum in f32, a
// two-pass mean and variance (mean, then the mean of squared deviations,
// never E[x^2] - mean^2), rsqrt(var + eps), the scale applied by a true
// IEEE division (this file is built without --use_fast_math), rint's round
// half to even, then the clip.
//
// What bounds it on the H100: bytes.  Per element it reads x and res and
// writes h and xi (7 bytes in bf16) for some ten flops.  The TPU kernel's
// point, one pass over HBM instead of an LN pass plus a quantize pass that
// re-reads h, is kept: one warp owns one row, holds it in registers
// (H / 32 values a lane, 32 at H = 1024), reduces with warp shuffles (no
// shared memory, no block barrier) and writes both outputs from the
// registers.  Every access is a 16-byte vector (8 bf16 or 2 x 4 f32; 8
// bytes of int8), neighbouring lanes on neighbouring addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kVec = 8;           // elements a lane moves per access
constexpr int kMaxChunks = 8;     // H = 256 * chunks <= 2048

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Stores v in the output dtype and replaces v by the stored (rounded) values.
__device__ __forceinline__ void store8(float* p, float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int kChunks, bool kDynamic>
__global__ void __launch_bounds__(kThreads)
ln_quant_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ ascale, T* __restrict__ h,
                int8_t* __restrict__ xi, float* __restrict__ row, int n_rows,
                float eps) {
  constexpr int kHidden = kChunks * kWarp * kVec;
  const int lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (r >= n_rows) return;  // the whole warp: no barrier below spans warps
  const size_t base = (size_t)r * kHidden;

  float v[kChunks][kVec];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * kWarp + lane) * kVec;
    float a[kVec];
    load8(x + base + col, v[c]);
    load8(res + base + col, a);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      v[c][i] += a[i];
      sum += v[c][i];
    }
  }
  const float mean = warp_sum(sum) / kHidden;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float d = v[c][i] - mean;
      sq = fmaf(d, d, sq);
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / kHidden + eps);

  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * kWarp + lane) * kVec;
    float g[kVec], b[kVec];
    load8(gamma + col, g);
    load8(beta + col, b);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[c][i] = (v[c][i] - mean) * rstd * g[i] + b[i];
    store8(h + base + col, v[c]);  // v now holds h as stored
#pragma unroll
    for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(v[c][i]));
  }

  float s;
  if (kDynamic) {
    s = warp_max(amax) / 127.0f + 1e-12f;
    if (lane == 0) row[r] = s;
  } else {
    s = *ascale;
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * kWarp + lane) * kVec;
    union { int8_t q[kVec]; uint2 u; } out;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float q = fminf(fmaxf(rintf(v[c][i] / s), -127.f), 127.f);
      out.q[i] = (int8_t)__float2int_rn(q);
    }
    *reinterpret_cast<uint2*>(xi + base + col) = out.u;
  }
}

template <typename T, bool kDynamic>
int launch(const void* x, const void* res, const float* gamma, const float* beta,
           const float* ascale, void* h, int8_t* xi, float* row, int n_rows,
           int hidden, float eps, cudaStream_t s) {
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ht = static_cast<T*>(h);
  switch (hidden / (kWarp * kVec)) {
#define MSA_LN_QUANT_CASE(C)                                                      \
  case C:                                                                         \
    ln_quant_kernel<T, C, kDynamic><<<grid, kThreads, 0, s>>>(                    \
        xt, rt, gamma, beta, ascale, ht, xi, row, n_rows, eps);                   \
    break;
    MSA_LN_QUANT_CASE(1)
    MSA_LN_QUANT_CASE(2)
    MSA_LN_QUANT_CASE(3)
    MSA_LN_QUANT_CASE(4)
    MSA_LN_QUANT_CASE(5)
    MSA_LN_QUANT_CASE(6)
    MSA_LN_QUANT_CASE(7)
    MSA_LN_QUANT_CASE(8)
#undef MSA_LN_QUANT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int check_args(int n_rows, int hidden) {
  if (n_rows <= 0 || hidden <= 0 || hidden % (kWarp * kVec) != 0 ||
      hidden > kMaxChunks * kWarp * kVec) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// x, res, h: [n_rows, hidden] in `dtype` (0 = float32, 1 = bfloat16); gamma,
// beta: [hidden] f32; ascale: one f32 on the device; xi: [n_rows, hidden]
// int8.  The caller has checked contiguity, 16-byte alignment and
// hidden % 256 == 0, hidden <= 2048.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int msa_ln_quant_static(const void* x, const void* res,
                                   const void* gamma, const void* beta,
                                   const void* ascale, void* h, void* xi,
                                   int n_rows, int hidden, float eps, int dtype,
                                   void* stream) {
  if (const int err = check_args(n_rows, hidden)) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* a = static_cast<const float*>(ascale);
  int8_t* q = static_cast<int8_t*>(xi);
  if (dtype == 0) return launch<float, false>(x, res, g, b, a, h, q, nullptr, n_rows, hidden, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16, false>(x, res, g, b, a, h, q, nullptr, n_rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}

// As msa_ln_quant_static, with the per-row scale computed and written to
// row: [n_rows] f32.
extern "C" int msa_ln_quant_dynamic(const void* x, const void* res,
                                    const void* gamma, const void* beta, void* h,
                                    void* xi, void* row, int n_rows, int hidden,
                                    float eps, int dtype, void* stream) {
  if (const int err = check_args(n_rows, hidden)) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  int8_t* q = static_cast<int8_t*>(xi);
  float* rw = static_cast<float*>(row);
  if (dtype == 0) return launch<float, true>(x, res, g, b, nullptr, h, q, rw, n_rows, hidden, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16, true>(x, res, g, b, nullptr, h, q, rw, n_rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}
