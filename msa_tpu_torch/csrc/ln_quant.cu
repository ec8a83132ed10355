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
// re-reads h, is kept: a team of kLanes lanes of one warp (32, 16 or 8:
// the most that divide the row's 8-value chunks) owns one row, holds it in
// registers (H / kLanes values a lane: 32 at H = 1024, 8 at H = 64, where
// a warp takes four rows), reduces with shuffles inside the team (no
// shared memory, no block barrier) and writes both outputs from the
// registers.  Every access is a 16-byte vector (8 bf16 or 2 x 4 f32; 8
// bytes of int8), neighbouring lanes on neighbouring addresses.  The team
// forms take H a multiple of 64 up to 512, of 128 up to 1024, or of 256 up
// to 2048 (at most 8 chunks a lane).
//
// Every other H (32, 312, 4096, 100, ...) takes the generic form,
// ln_quant_rows_kernel: a warp a row below H = 1024 (8 rows a CTA), a CTA
// of 256 threads a row from there, the row swept in 8-value vectors where
// H % 8 == 0 (else value by value), a tail-masked column loop with no
// values held: a sweep each for the sum, the squared deviations and h
// (stored, and its max |h|), then one over the stored h for xi (a thread
// reads back only what it wrote), reduced by warp shuffles and, for a
// CTA's row, across warps through shared memory.  The same arithmetic as
// the team forms, in a generic summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;     // eight warps
constexpr int kVec = 8;           // elements a lane moves per access
constexpr int kMaxChunks = 8;     // chunks a lane holds: H <= 8 * kVec * kLanes

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

// v rounded to the output dtype T and widened back (the stored values).
template <typename T>
__device__ __forceinline__ void round8(float (&v)[kVec]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = __bfloat162float(__float2bfloat16_rn(v[i]));
  }
}

// Stores v (already rounded to the output dtype) in that dtype.
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Sum and max over the kLanes lanes of a row's team (lanes that differ in
// their low log2(kLanes) bits).
template <int kLanes>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int kLanes>
__device__ __forceinline__ float team_max(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int kLanes, int kChunks, bool kDynamic>
__global__ void __launch_bounds__(kThreads)
ln_quant_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ ascale, T* __restrict__ h,
                int8_t* __restrict__ xi, float* __restrict__ row, int n_rows,
                float eps) {
  constexpr int kHidden = kChunks * kLanes * kVec;
  constexpr int kRowsPerBlock = kThreads / kLanes;
  const int lane = threadIdx.x % kLanes;  // within the row's team
  const int warp_row0 = blockIdx.x * kRowsPerBlock + (threadIdx.x / kWarp) * (kWarp / kLanes);
  if (warp_row0 >= n_rows) return;  // the whole warp: no barrier below spans warps
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  // a team past the last row works on that row and stores nothing: every
  // lane of the warp takes part in the shuffles
  const bool active = r < n_rows;
  const size_t base = (size_t)(active ? r : n_rows - 1) * kHidden;

  float v[kChunks][kVec];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * kLanes + lane) * kVec;
    float a[kVec];
    load8(x + base + col, v[c]);
    load8(res + base + col, a);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      v[c][i] += a[i];
      sum += v[c][i];
    }
  }
  const float mean = team_sum<kLanes>(sum) / kHidden;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float d = v[c][i] - mean;
      sq = fmaf(d, d, sq);
    }
  }
  const float rstd = rsqrtf(team_sum<kLanes>(sq) / kHidden + eps);

  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * kLanes + lane) * kVec;
    float g[kVec], b[kVec];
    load8(gamma + col, g);
    load8(beta + col, b);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[c][i] = (v[c][i] - mean) * rstd * g[i] + b[i];
    round8<T>(v[c]);  // v now holds h as stored
    if (active) store8(h + base + col, v[c]);
#pragma unroll
    for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(v[c][i]));
  }

  float s;
  if (kDynamic) {
    s = team_max<kLanes>(amax) / 127.0f + 1e-12f;
    if (active && lane == 0) row[r] = s;
  } else {
    s = *ascale;
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * kLanes + lane) * kVec;
    union { int8_t q[kVec]; uint2 u; } out;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float q = fminf(fmaxf(rintf(v[c][i] / s), -127.f), 127.f);
      out.q[i] = (int8_t)__float2int_rn(q);
    }
    if (active) *reinterpret_cast<uint2*>(xi + base + col) = out.u;
  }
}

// The lanes of a row's team: the most of 32, 16, 8 that divide the row's
// chunks (H / 8), with at most kMaxChunks chunks a lane; 0 if none fits.
int team_lanes(int hidden) {
  if (hidden <= 0 || hidden % (8 * kVec)) return 0;
  for (int lanes = kWarp; lanes >= 8; lanes /= 2) {
    const int chunks = hidden / kVec;
    if (chunks % lanes == 0) return chunks / lanes <= kMaxChunks ? lanes : 0;
  }
  return 0;
}

template <typename T, int kLanes, int kChunks, bool kDynamic>
int launch_rows(const void* x, const void* res, const float* gamma, const float* beta,
                const float* ascale, void* h, int8_t* xi, float* row, int n_rows, float eps,
                cudaStream_t s) {
  constexpr int kRowsPerBlock = kThreads / kLanes;
  ln_quant_kernel<T, kLanes, kChunks, kDynamic>
      <<<(n_rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(res), gamma, beta, ascale,
          static_cast<T*>(h), xi, row, n_rows, eps);
  return (int)cudaGetLastError();
}

// One launch for hidden = kVec * lanes * chunks (team_lanes(hidden) lanes;
// 16 and 8 lanes only with an odd number of chunks, else a larger team
// divides them).
template <typename T, bool kDynamic>
int launch(const void* x, const void* res, const float* gamma, const float* beta,
           const float* ascale, void* h, int8_t* xi, float* row, int n_rows,
           int hidden, float eps, cudaStream_t s) {
  const int lanes = team_lanes(hidden);
  const int chunks = lanes ? hidden / (kVec * lanes) : 0;
#define MSA_LN_QUANT_CASE(L, C)                                                       \
  if (lanes == L && chunks == C)                                                      \
    return launch_rows<T, L, C, kDynamic>(x, res, gamma, beta, ascale, h, xi, row,    \
                                          n_rows, eps, s);
  MSA_LN_QUANT_CASE(32, 1) MSA_LN_QUANT_CASE(32, 2) MSA_LN_QUANT_CASE(32, 3)
  MSA_LN_QUANT_CASE(32, 4) MSA_LN_QUANT_CASE(32, 5) MSA_LN_QUANT_CASE(32, 6)
  MSA_LN_QUANT_CASE(32, 7) MSA_LN_QUANT_CASE(32, 8)
  MSA_LN_QUANT_CASE(16, 1) MSA_LN_QUANT_CASE(16, 3) MSA_LN_QUANT_CASE(16, 5)
  MSA_LN_QUANT_CASE(16, 7)
  MSA_LN_QUANT_CASE(8, 1) MSA_LN_QUANT_CASE(8, 3) MSA_LN_QUANT_CASE(8, 5)
  MSA_LN_QUANT_CASE(8, 7)
#undef MSA_LN_QUANT_CASE
  return (int)cudaErrorInvalidValue;
}

// ---- The generic form: any H ----

constexpr int kWideRow = 1024;  // from this H on a CTA takes a row, below a warp

// Sum or max over the kTeam threads of a row: a warp's shuffles, then (a
// CTA's row) its warps' partials through red[kWarps].
template <int kTeam, bool kMax>
__device__ __forceinline__ float row_reduce(float v, float* red) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if constexpr (kTeam > kWarp) {
    constexpr int kWarps = kTeam / kWarp;
    const int warp = threadIdx.x / kWarp;
    __syncthreads();  // red[] is free: the previous reduction was read
    if (threadIdx.x % kWarp == 0) red[warp] = v;
    __syncthreads();
    v = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  }
  return v;
}

// One value of p as f32; its store as T.
template <typename T>
__device__ __forceinline__ float load1(const T* p) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  } else {
    return *p;
  }
}
template <typename T>
__device__ __forceinline__ void store1(T* p, float v) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v);
  } else {
    *p = v;
  }
}

// kTeam threads (a warp, or the CTA) a row; kV values a step (8: 16-byte
// vectors, H % 8 == 0; 1: any H).
template <typename T, int kTeam, int kV, bool kDynamic>
__global__ void __launch_bounds__(kThreads)
ln_quant_rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const float* __restrict__ ascale, T* __restrict__ h,
                     int8_t* __restrict__ xi, float* __restrict__ row, int n_rows,
                     int hidden, float eps) {
  __shared__ float red[kThreads / kWarp];
  constexpr int kRowsPerBlock = kThreads / kTeam;
  const int t = threadIdx.x % kTeam;
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x / kTeam;
  if (kTeam == kWarp && r >= n_rows) return;  // a whole warp: no CTA barrier
  const size_t base = (size_t)r * hidden;
  const int steps = hidden / kV;  // kV divides hidden

  // v[0 .. kV) = x + res at step i
  auto sum_at = [&](int i, float (&v)[kV]) {
    if constexpr (kV == 8) {
      float a[kVec];
      load8(x + base + i * kV, v);
      load8(res + base + i * kV, a);
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] += a[e];
    } else {
      v[0] = load1(x + base + i) + load1(res + base + i);
    }
  };
  float sum = 0.f;
  for (int i = t; i < steps; i += kTeam) {
    float v[kV];
    sum_at(i, v);
#pragma unroll
    for (int e = 0; e < kV; ++e) sum += v[e];
  }
  const float mean = row_reduce<kTeam, false>(sum, red) / hidden;
  float sq = 0.f;
  for (int i = t; i < steps; i += kTeam) {
    float v[kV];
    sum_at(i, v);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float d = v[e] - mean;
      sq = fmaf(d, d, sq);
    }
  }
  const float rstd = rsqrtf(row_reduce<kTeam, false>(sq, red) / hidden + eps);
  float amax = 0.f;
  for (int i = t; i < steps; i += kTeam) {
    float v[kV];
    sum_at(i, v);
    float g[kV], b[kV];
    if constexpr (kV == 8) {
      load8(gamma + i * kV, g);
      load8(beta + i * kV, b);
    } else {
      g[0] = gamma[i];
      b[0] = beta[i];
    }
#pragma unroll
    for (int e = 0; e < kV; ++e) v[e] = (v[e] - mean) * rstd * g[e] + b[e];
    if constexpr (kV == 8) {
      round8<T>(v);  // v now holds h as stored
      store8(h + base + i * kV, v);
    } else {
      store1(h + base + i, v[0]);
      v[0] = load1(h + base + i);
    }
#pragma unroll
    for (int e = 0; e < kV; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  float s;
  if (kDynamic) {
    s = row_reduce<kTeam, true>(amax, red) / 127.0f + 1e-12f;
    if (t == 0) row[r] = s;
  } else {
    s = *ascale;
  }
  for (int i = t; i < steps; i += kTeam) {  // this thread's own stores of h
    float v[kV];
    if constexpr (kV == 8) {
      load8(h + base + i * kV, v);
    } else {
      v[0] = load1(h + base + i);
    }
    union { int8_t q[kV]; uint2 u; } out;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      out.q[e] = (int8_t)__float2int_rn(fminf(fmaxf(rintf(v[e] / s), -127.f), 127.f));
    }
    if constexpr (kV == 8) {
      *reinterpret_cast<uint2*>(xi + base + i * kV) = out.u;
    } else {
      xi[base + i] = out.q[0];
    }
  }
}

template <typename T, int kTeam, int kV, bool kDynamic>
int launch_generic(const void* x, const void* res, const float* gamma, const float* beta,
                   const float* ascale, void* h, int8_t* xi, float* row, int n_rows,
                   int hidden, float eps, cudaStream_t s) {
  constexpr int kRowsPerBlock = kThreads / kTeam;
  ln_quant_rows_kernel<T, kTeam, kV, kDynamic>
      <<<(n_rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(res), gamma, beta, ascale,
          static_cast<T*>(h), xi, row, n_rows, hidden, eps);
  return (int)cudaGetLastError();
}

// The team forms where team_lanes(hidden) holds, else the generic form.
template <typename T, bool kDynamic>
int launch_any(const void* x, const void* res, const float* gamma, const float* beta,
               const float* ascale, void* h, int8_t* xi, float* row, int n_rows, int hidden,
               float eps, cudaStream_t s) {
  if (team_lanes(hidden)) {
    return launch<T, kDynamic>(x, res, gamma, beta, ascale, h, xi, row, n_rows, hidden, eps, s);
  }
  const bool vec = hidden % kVec == 0;
#define MSA_GENERIC(TEAM, V)                                                          \
  launch_generic<T, TEAM, V, kDynamic>(x, res, gamma, beta, ascale, h, xi, row, n_rows, \
                                       hidden, eps, s)
  if (hidden < kWideRow) return vec ? MSA_GENERIC(kWarp, 8) : MSA_GENERIC(kWarp, 1);
  return vec ? MSA_GENERIC(kThreads, 8) : MSA_GENERIC(kThreads, 1);
#undef MSA_GENERIC
}

int check_args(int n_rows, int hidden) {
  return n_rows <= 0 || hidden <= 0 ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// x, res, h: [n_rows, hidden] in `dtype` (0 = float32, 1 = bfloat16); gamma,
// beta: [hidden] f32; ascale: one f32 on the device; xi: [n_rows, hidden]
// int8.  hidden: any H >= 1 (the team forms where they fit, else the
// generic form).  The caller has checked contiguity and 16-byte alignment.
// Launches on `stream` and returns cudaGetLastError().
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
  if (dtype == 0) return launch_any<float, false>(x, res, g, b, a, h, q, nullptr, n_rows, hidden, eps, s);
  if (dtype == 1) return launch_any<__nv_bfloat16, false>(x, res, g, b, a, h, q, nullptr, n_rows, hidden, eps, s);
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
  if (dtype == 0) return launch_any<float, true>(x, res, g, b, nullptr, h, q, rw, n_rows, hidden, eps, s);
  if (dtype == 1) return launch_any<__nv_bfloat16, true>(x, res, g, b, nullptr, h, q, rw, n_rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}
