// Whole-sequence attention for short sequences (S < 1024, head dim 16, 32,
// 64, 128 or 256, a template parameter kD of every kernel, picked by the C
// entries from hidden / num_heads; bf16 on the tensor cores at every head
// dim, f32 on the CUDA cores):
// forward with in-kernel attention-probs dropout, the backward pair, and a
// keep-mask export.
//
// Replaces the TPU kernels msa_tpu/ops/short_attention.py::_fwd_kernel_v2
// and ::_bwd_kernel_v2 (entry short_attention_v2), its A/B backward
// ::_bwd_kernel_v3 (under the module switch _USE_V3_BWD: delta from the
// ctx in its own dtype, the row lse recomputed; see
// msa_short_attention_v3_bwd), and two variants of the pair that the remat
// policies call: _fwd_kernel_v2p / _bwd_kernel_v2p
// (entry short_attention_v2p, 'save_pack': the same kernels reading q, k, v
// as the thirds of one packed [B, S, 3H] buffer at row stride 3H and writing
// one packed dqkv) and _fwd_kernel_v2s / _bwd_kernel_v2s (entry
// short_attention_v2s, '+probs': a forward that also writes the signed
// softmax probabilities and a backward that reads them, see the section
// below).  q, k, v, the output ctx
// and the gradients are [B, S, H] in natural layout, heads are sliced
// inside the kernels, key_bias is an additive [B, S] f32 mask, the softmax
// runs in f32 (base-2 fold: scores carry scale*log2e, exp2 replaces exp;
// the backward formulas are unchanged in natural units, so dq and dk scale
// by the natural 1/sqrt(d)).
//
// What bounds them on the H100: bytes.  At the flagship shapes (S = 40 /
// 80, d = 64; the tiny preset's d = 32) a (batch, head) pair does 4*S*S*d
// forward FLOPs on 4*S*d elements of q/k/v/o -- S FLOPs per element, far
// below the ~295 FLOP/byte at which the tensor cores, rather than memory,
// would be the limit.  So
// every kernel reads each q/k/v/dO byte once from device memory, keeps the
// softmax on chip and stores nothing of size [S, S]:
//
//   * forward, bf16 (v2 and v2p): on the tensor cores.  S <= 128 at kD <=
//     128 is the whole-row template of short_fwd_tc.cuh (one CTA per
//     (head, batch row), each warp's score row in registers, K and V read
//     once); above, and at every S at kD = 256 (where a warp's [16 x 256]
//     f32 accumulator is 128 registers a lane), the two-sweep form below
//     v2s's (the same ring without the probs).  Both round the dropped p to
//     bf16 before P V as _fwd_kernel_v2 does.
//     The training form also writes the row's log2-sum-exp (lse), which
//     the v2 backward pairs read (bf16 above 128 keys or at kD = 256, and
//     f32).
//   * forward, f32: on the CUDA cores (on the tensor cores f32 would be
//     TF32, three decimal digits).  One CTA per (query tile, head, batch
//     row); a query tile holds up to 128 rows, so S <= 128 is one tile and
//     K/V are read once.  Two threads per query row, each owning half of
//     the d head dims in registers.  K and V are staged in shared memory
//     as f32, 64 keys per tile, under an online softmax that takes 16 keys
//     per update; the training form also writes the lse.
//   * backward, bf16 (v2, v2p, v3 and v2s), on the tensor cores: at S <=
//     128 and kD <= 128 one launch of the template short_bwd_tc.cuh shares
//     with v1's backward, which recomputes each row's max and sum from q
//     and k; above, and at every S at kD = 256, the dq and dk/dv pair of
//     short_bwd_tiled.cuh over 64-row tiles (v2 reads the training
//     forward's lse there).  v2 takes v1's
//     rule, v2p and v3 take delta from the ctx, v2s reads p from its
//     stashed probs.  Both round dS and the dropped p to bf16 before their
//     products, as the TPU kernels' .astype does.
//   * backward, f32: a pair of launches on the CUDA cores in the
//     flash-attention-2 manner (no [S, S] tensor, any S):
//       - dq: the forward's layout.  Each query row recomputes its scores,
//         p = exp2(s - lse) and dp = dO.v.  v2: the lse is the training
//         forward's, delta = sum_j p_ij * dpm_ij (dropout included:
//         _bwd_kernel_v2's rule), summed in the same pass as dq = sum_j p
//         dpm k_j - delta * sum_j p k_j.  v2p and v3: delta = dO . o from
//         the ctx, the lse recomputed (one more pass over K).  It writes
//         delta (and v3's lse) for the second launch.
//       - dk/dv: one CTA per (key tile, head, batch row), two threads per
//         key row holding k, v and the dk/dv accumulators; query tiles of 64
//         rows (q pre-scaled, dO, lse, delta) are staged in shared memory.
//     f32 is the parity dtype (on the tensor cores it would be TF32).
//
// Dropout: the rule of dropout.cuh (Philox4x32-10 of the seed and the
// element's index), so the forward, both backward launches, the export
// entry and flash2.cu's kernels compute the same mask whatever their
// tiling; ops/dropout.py holds the same rule in plain PyTorch.
//
// The TPU kernels' block-diagonal lane packing (_block_diag_rows) answers
// the TPU's 128-lane matrix unit and has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "mma_tiles.cuh"
#include "short_bwd_tc.cuh"
#include "short_bwd_tiled.cuh"
#include "short_fwd_tc.cuh"

namespace {

namespace tc = msa_mma;
using bf16 = __nv_bfloat16;
using msa_dropout::Dropout;
using msa_dropout::keep_bits16;
using msa_dropout::kGroup;
using msa_dropout::make_dropout;

constexpr int kKeyTile = 64;    // forward / dq: keys staged per tile
constexpr int kQueryTile = 64;  // dk/dv: queries staged per tile
constexpr int kKeyChunk = 16;   // keys scored per online-softmax update
constexpr int kMaxRows = 128;   // query (or key) rows per CTA
constexpr int kMaxThreads = 2 * kMaxRows;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kKeyTile % kKeyChunk == 0, "chunks must tile the key tile");
// The CUDA-core (f32) kernels' staged tiles at head dim kD: the tiles
// above, halved at 128 and quartered at 256, so that their static shared
// memory (f32 rows of kD) stays within the 48 KB a kernel may declare.
template <int kD>
inline constexpr int kKeyTileOf = kD == 256 ? kKeyTile / 4 : kD == 128 ? kKeyTile / 2 : kKeyTile;
template <int kD>
inline constexpr int kQueryTileOf =
    kD == 256 ? kQueryTile / 4 : kD == 128 ? kQueryTile / 2 : kQueryTile;
static_assert(kKeyTileOf<256> % kKeyChunk == 0, "chunks must tile the key tile");
// The whole-row templates (short_fwd_tc.cuh, short_bwd_tc.cuh) stop at head
// dim 128: above it bf16 runs the two-sweep forward and the tiled backward
// pair at every S.
constexpr int kMaxWholeRowHeadDim = 128;
static_assert(kKeyChunk == kGroup, "one Philox draw per key chunk");

// 16-byte vector loads/stores between global memory and f32 (every
// CUDA-core kernel here is f32; bf16 runs on the tensor cores).
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

// Per-thread layout shared by every CUDA-core kernel, head dim kD: the two
// threads of a row own interleaved 16-byte chunks (chunk u of a thread is
// the head row's chunk 2*u + half), so their shared-memory reads fall in
// different banks and global accesses are 16-byte vectors.
template <typename T, int kD>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr int kChunks = kD / kVec;    // chunks per head row
  static constexpr int kOwn = kChunks / 2;     // chunks per thread
  static constexpr int kPart = kD / 2;         // head dims per thread
  static_assert(kChunks % 2 == 0, "the two threads of a row own kOwn chunks each");
};

// Load this thread's half of a head row (zeros when !active), times `mult`.
template <typename T, int kD>
__device__ __forceinline__ void load_half(const T* row_ptr, int half, bool active,
                                          float mult, float* dst) {
  using L = Layout<T, kD>;
#pragma unroll
  for (int u = 0; u < L::kOwn; ++u) {
    float tmp[L::kVec];
    if (active) {
      load16(row_ptr + (2 * u + half) * L::kVec, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) dst[u * L::kVec + e] = tmp[e] * mult;
  }
}

template <typename T, int kD>
__device__ __forceinline__ void store_half(T* row_ptr, int half, const float* src,
                                           float mult) {
  using L = Layout<T, kD>;
#pragma unroll
  for (int u = 0; u < L::kOwn; ++u) {
    float tmp[L::kVec];
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) tmp[e] = src[u * L::kVec + e] * mult;
    store16(row_ptr + (2 * u + half) * L::kVec, tmp);
  }
}

// Half-row dot product against a shared-memory f32 row (the two halves are
// joined by the caller with one shuffle).
template <typename T, int kD>
__device__ __forceinline__ float dot_half(const float* mine, const float* srow,
                                          int half) {
  using L = Layout<T, kD>;
  float part = 0.f;
#pragma unroll
  for (int u = 0; u < L::kOwn; ++u) {
#pragma unroll
    for (int e = 0; e < L::kVec; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(srow + (2 * u + half) * L::kVec + e);
      const float* m = &mine[u * L::kVec + e];
      part = fmaf(m[0], x.x, part);
      part = fmaf(m[1], x.y, part);
      part = fmaf(m[2], x.z, part);
      part = fmaf(m[3], x.w, part);
    }
  }
  return part;
}

// acc += w * srow (this thread's half).
template <typename T, int kD>
__device__ __forceinline__ void axpy_half(float* acc, float w, const float* srow,
                                          int half) {
  using L = Layout<T, kD>;
#pragma unroll
  for (int u = 0; u < L::kOwn; ++u) {
#pragma unroll
    for (int e = 0; e < L::kVec; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(srow + (2 * u + half) * L::kVec + e);
      float* a = &acc[u * L::kVec + e];
      a[0] = fmaf(w, x.x, a[0]);
      a[1] = fmaf(w, x.y, a[1]);
      a[2] = fmaf(w, x.z, a[2]);
      a[3] = fmaf(w, x.w, a[3]);
    }
  }
}

// Stage rows [r0, r0 + n) of one head of x and of y (row strides x_stride
// and y_stride elements; x_base and y_base point at the head's row 0) into
// shared memory as f32 [n, kD]; x times `x_mult` when kScaleX.  Both loads
// of an iteration are issued together, so two are in flight.
template <typename T, int kD, bool kScaleX = false>
__device__ __forceinline__ void stage_pair(const T* x, const T* y, size_t x_base,
                                           int x_stride, size_t y_base, int y_stride,
                                           int r0, int n, float x_mult,
                                           float* x_s, float* y_s) {
  using L = Layout<T, kD>;
  for (int idx = threadIdx.x; idx < n * L::kChunks; idx += blockDim.x) {
    const int j = idx / L::kChunks;
    const int c = idx - j * L::kChunks;
    float* xd = &x_s[j * kD + c * L::kVec];
    load16(x + x_base + (size_t)(r0 + j) * x_stride + c * L::kVec, xd);
    load16(y + y_base + (size_t)(r0 + j) * y_stride + c * L::kVec,
           &y_s[j * kD + c * L::kVec]);
    if constexpr (kScaleX) {
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) xd[e] *= x_mult;
    }
  }
}


// Stage rows [r0, r0 + n) of one head of x into shared memory as f32.
template <typename T, int kD>
__device__ __forceinline__ void stage_one(const T* x, size_t base, int stride, int r0,
                                          int n, float* x_s) {
  using L = Layout<T, kD>;
  for (int idx = threadIdx.x; idx < n * L::kChunks; idx += blockDim.x) {
    const int j = idx / L::kChunks;
    const int c = idx - j * L::kChunks;
    load16(x + base + (size_t)(r0 + j) * stride + c * L::kVec,
           &x_s[j * kD + c * L::kVec]);
  }
}

// The log2-sum-exp of one query row's scores (qr holds this thread's half
// of q * scale * log2e) over every key, by the CUDA-core forward's online
// max / sum: the same products, chunks and order, so the same bits as the
// f32 forward's lse.  Every thread of the CTA calls it (it stages K
// through k_s).
template <typename T, int kD>
__device__ float row_lse_sweep(const float* qr, const T* k, size_t base, int stride,
                               int seq, const float* bias_row, int half, float* k_s,
                               float* bias_s) {
  float run_max = -INFINITY;
  float run_sum = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kKeyTileOf<kD>) {
    const int kn = min(kKeyTileOf<kD>, seq - k0);
    __syncthreads();
    stage_one<T, kD>(k, base, stride, k0, kn, k_s);
    for (int j = threadIdx.x; j < kn; j += blockDim.x) {
      bias_s[j] = bias_row[k0 + j] * kLog2e;
    }
    __syncthreads();
    for (int j0 = 0; j0 < kn; j0 += kKeyChunk) {
      float s[kKeyChunk];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        const int j = j0 + jj;
        float part = 0.f;
        if (j < kn) part = dot_half<T, kD>(qr, &k_s[j * kD], half);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        s[jj] = (j < kn) ? part + bias_s[j] : -INFINITY;
        chunk_max = fmaxf(chunk_max, s[jj]);
      }
      const float new_max = fmaxf(run_max, chunk_max);
      run_sum = __fmul_rn(run_sum, exp2f(run_max - new_max));
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        run_sum = __fadd_rn(run_sum, exp2f(s[jj] - new_max));  // + 0 past kn
      }
      run_max = new_max;
    }
  }
  return run_max + log2f(run_sum);
}

// ---------------------------------------------------------------------------
// Forward, f32 (bf16: short_fwd_tc.cuh and the two-sweep form below)
// ---------------------------------------------------------------------------

// `stride` is the row stride of q, k and v in elements: H for three [B, S, H]
// tensors, 3H for the thirds of one packed [B, S, 3H] q|k|v (the caller
// offsets k and v by H and 2H).  out is [B, S, H].  Launched for T = float
// only.
template <typename T, int kD, bool kDropout, bool kTrain>
__global__ void __launch_bounds__(kMaxThreads)
short_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ key_bias,
                           T* __restrict__ out, float* __restrict__ lse, int seq,
                           int hidden, int stride, int rows_per_cta, float score_mult,
                           Dropout drop) {
  using L = Layout<T, kD>;
  __shared__ __align__(16) float k_s[kKeyTileOf<kD> * kD];
  __shared__ __align__(16) float v_s[kKeyTileOf<kD> * kD];
  __shared__ float bias_s[kKeyTileOf<kD>];

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * rows_per_cta + (threadIdx.x >> 1);
  const bool active = row < seq;
  const size_t in_base = (size_t)b * seq * stride + (size_t)head * kD;
  const size_t out_base = (size_t)b * seq * hidden + (size_t)head * kD;
  const uint32_t prob_row = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq + row;

  // This thread's half of the query row, pre-scaled into the log2 domain.
  float qr[L::kPart];
  load_half<T, kD>(q + in_base + (size_t)row * stride, half, active, score_mult, qr);

  float acc[L::kPart];
#pragma unroll
  for (int i = 0; i < L::kPart; ++i) acc[i] = 0.f;
  float run_max = -INFINITY;
  float run_sum = 0.f;
  const float* bias_row = key_bias + (size_t)b * seq;

  for (int k0 = 0; k0 < seq; k0 += kKeyTileOf<kD>) {
    const int kn = min(kKeyTileOf<kD>, seq - k0);
    __syncthreads();  // every thread is done with the previous tile
    stage_pair<T, kD>(k, v, in_base, stride, in_base, stride, k0, kn, 1.f, k_s, v_s);
    for (int j = threadIdx.x; j < kn; j += blockDim.x) {
      bias_s[j] = bias_row[k0 + j] * kLog2e;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kn; j0 += kKeyChunk) {
      float s[kKeyChunk];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        const int j = j0 + jj;  // < the tile: j0 <= its width - kKeyChunk
        float part = 0.f;
        if (j < kn) part = dot_half<T, kD>(qr, &k_s[j * kD], half);  // uniform
        part += __shfl_xor_sync(0xffffffffu, part, 1);  // join the two halves
        s[jj] = (j < kn) ? part + bias_s[j] : -INFINITY;
        chunk_max = fmaxf(chunk_max, s[jj]);
      }
      uint32_t keep = 0xFFFFu;
      if constexpr (kDropout) keep = keep_bits16(drop, (uint32_t)(k0 + j0) / kGroup, prob_row);

      // Online softmax: chunk_max is finite (the chunk holds >= 1 key), so
      // new_max is too and exp2f(-inf - new_max) = 0 on the first chunk.
      // The normaliser sums every probability; dropout only zeroes (and
      // rescales) what reaches the PV product.
      // run_sum's products and sums are rounded one by one (no FMA
      // contraction), so row_lse_sweep reproduces the lse bit for bit.
      const float new_max = fmaxf(run_max, chunk_max);
      const float corr = exp2f(run_max - new_max);
      run_sum = __fmul_rn(run_sum, corr);
#pragma unroll
      for (int i = 0; i < L::kPart; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        const int j = j0 + jj;
        if (j < kn) {
          const float p = exp2f(s[jj] - new_max);
          run_sum = __fadd_rn(run_sum, p);
          float pv = p;
          if constexpr (kDropout) pv = ((keep >> jj) & 1u) ? p * drop.scale : 0.f;
          axpy_half<T, kD>(acc, pv, &v_s[j * kD], half);
        }
      }
      run_max = new_max;
    }
  }

  if (active) {
    store_half<T, kD>(out + out_base + (size_t)row * hidden, half, acc, 1.f / run_sum);
    if constexpr (kTrain) {
      if (half == 0) lse[prob_row] = run_max + log2f(run_sum);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward 1/2: dq (and delta for the dk/dv launch)
// ---------------------------------------------------------------------------

// f32 only.  q, k, v and dq have row stride `stride` (H, or 3H in the
// packed layout, where dq, dk and dv are the thirds of one [B, S, 3H]
// gradient); o and dout are [B, S, H].  v2 (kV3 false, the TPU kernel
// _bwd_kernel_v2): lse is the training forward's row lse, read, o is not
// read, and delta = sum_j p_j * dpm_j (:375), summed in the same pass as
// dq = scale * (sum_j p_j dpm_j k_j - delta * sum_j p_j k_j) (rounding dS
// changes nothing in f32).  v3 (the TPU kernels _bwd_kernel_v3 and
// _bwd_kernel_v2p): o is the ctx, delta = dO . o, and the kernel
// recomputes each row's lse from the scores (row_lse_sweep, one more pass
// over K) and writes it to `lse` for the dk/dv launch; the forward keeps
// nothing but its ctx.
template <int kD, bool kDropout, bool kV3>
__global__ void __launch_bounds__(kMaxThreads)
short_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ key_bias,
                              const float* __restrict__ o,
                              const float* __restrict__ dout,
                              float* __restrict__ lse,
                              float* __restrict__ delta_out, float* __restrict__ dq,
                              int seq, int hidden, int stride, int rows_per_cta,
                              float score_mult, float scale, Dropout drop) {
  using T = float;
  using L = Layout<T, kD>;
  __shared__ __align__(16) float k_s[kKeyTileOf<kD> * kD];
  __shared__ __align__(16) float v_s[kKeyTileOf<kD> * kD];
  __shared__ float bias_s[kKeyTileOf<kD>];

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * rows_per_cta + (threadIdx.x >> 1);
  const bool active = row < seq;
  const size_t in_base = (size_t)b * seq * stride + (size_t)head * kD;
  const size_t in_off = in_base + (size_t)row * stride;
  const size_t row_off = (size_t)b * seq * hidden + (size_t)head * kD +
                         (size_t)row * hidden;
  const uint32_t prob_row = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq + row;

  // v2: one pass, dq from sum_j p_j dpm_j k_j and sum_j p_j k_j
  float qr[L::kPart], dor[L::kPart], acc[L::kPart];
  float pk[kV3 ? 1 : L::kPart];  // sum_j p_j k_j
  load_half<T, kD>(q + in_off, half, active, score_mult, qr);
  load_half<T, kD>(dout + row_off, half, active, 1.f, dor);
  float delta = 0.f;
  const float* bias_row = key_bias + (size_t)b * seq;
  float row_lse;
  if constexpr (kV3) {
    // delta = dO . o over the full head row; acc holds o for a moment.
    load_half<T, kD>(o + row_off, half, active, 1.f, acc);
#pragma unroll
    for (int i = 0; i < L::kPart; ++i) delta = fmaf(dor[i], acc[i], delta);
    delta += __shfl_xor_sync(0xffffffffu, delta, 1);
    if (active && half == 0) delta_out[prob_row] = delta;
    row_lse = row_lse_sweep<T, kD>(qr, k, in_base, stride, seq, bias_row, half, k_s, bias_s);
    if (active && half == 0) lse[prob_row] = row_lse;
  } else {
#pragma unroll
    for (int i = 0; i < L::kPart; ++i) pk[i] = 0.f;
    row_lse = active ? lse[prob_row] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < L::kPart; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += kKeyTileOf<kD>) {
    const int kn = min(kKeyTileOf<kD>, seq - k0);
    __syncthreads();
    stage_pair<T, kD>(k, v, in_base, stride, in_base, stride, k0, kn, 1.f, k_s, v_s);
    for (int j = threadIdx.x; j < kn; j += blockDim.x) {
      bias_s[j] = bias_row[k0 + j] * kLog2e;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kn; j0 += kKeyChunk) {
      uint32_t keep = 0xFFFFu;
      if constexpr (kDropout) keep = keep_bits16(drop, (uint32_t)(k0 + j0) / kGroup, prob_row);
#pragma unroll 4
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        const int j = j0 + jj;
        if (j >= kn) break;  // uniform across the CTA
        float s = dot_half<T, kD>(qr, &k_s[j * kD], half);
        float dp = dot_half<T, kD>(dor, &v_s[j * kD], half);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        const float p = exp2f(s + bias_s[j] - row_lse);
        float dpm = dp;
        if constexpr (kDropout) dpm = ((keep >> jj) & 1u) ? dp * drop.scale : 0.f;
        if constexpr (kV3) {
          axpy_half<T, kD>(acc, p * (dpm - delta), &k_s[j * kD], half);
        } else {
          const float pdpm = p * dpm;
          delta += pdpm;
          axpy_half<T, kD>(acc, pdpm, &k_s[j * kD], half);
          axpy_half<T, kD>(pk, p, &k_s[j * kD], half);
        }
      }
    }
  }

  if constexpr (!kV3) {
#pragma unroll
    for (int i = 0; i < L::kPart; ++i) acc[i] = fmaf(-delta, pk[i], acc[i]);
  }
  if constexpr (!kV3) {
    if (active && half == 0) delta_out[prob_row] = delta;
  }
  if (active) store_half<T, kD>(dq + in_off, half, acc, scale);
}

// ---------------------------------------------------------------------------
// Backward 2/2: dk and dv
// ---------------------------------------------------------------------------

// f32 only; lse and delta are the dq launch's (v2: the forward's lse).
template <int kD, bool kDropout>
__global__ void __launch_bounds__(kMaxThreads)
short_attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ key_bias,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int seq, int hidden, int stride, int rows_per_cta,
                               float score_mult, float dk_mult, Dropout drop) {
  using T = float;
  using L = Layout<T, kD>;
  __shared__ __align__(16) float q_s[kQueryTileOf<kD> * kD];   // q * score_mult
  __shared__ __align__(16) float do_s[kQueryTileOf<kD> * kD];
  __shared__ float lse_s[kQueryTileOf<kD>];
  __shared__ float delta_s[kQueryTileOf<kD>];
  __shared__ uint32_t keep_s[kMaxRows / kGroup][kQueryTileOf<kD>];

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int key0 = blockIdx.x * rows_per_cta;  // a multiple of 16
  const int local = threadIdx.x >> 1;
  const int key = key0 + local;
  const bool active = key < seq;
  const size_t in_base = (size_t)b * seq * stride + (size_t)head * kD;
  const size_t do_base = (size_t)b * seq * hidden + (size_t)head * kD;
  const size_t key_off = in_base + (size_t)key * stride;
  const uint32_t head_rows = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int groups = rows_per_cta / kGroup;

  float kr[L::kPart], vr[L::kPart], dk_acc[L::kPart], dv_acc[L::kPart];
  load_half<T, kD>(k + key_off, half, active, 1.f, kr);
  load_half<T, kD>(v + key_off, half, active, 1.f, vr);
#pragma unroll
  for (int i = 0; i < L::kPart; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float bias2 = active ? key_bias[(size_t)b * seq + key] * kLog2e : 0.f;

  for (int i0 = 0; i0 < seq; i0 += kQueryTileOf<kD>) {
    const int qn = min(kQueryTileOf<kD>, seq - i0);
    __syncthreads();  // every thread is done with the previous tile
    stage_pair<T, kD, true>(q, dout, in_base, stride, do_base, hidden, i0, qn,
                        score_mult, q_s, do_s);
    for (int i = threadIdx.x; i < qn; i += blockDim.x) {
      lse_s[i] = lse[head_rows + i0 + i];
      delta_s[i] = delta[head_rows + i0 + i];
    }
    if constexpr (kDropout) {
      for (int idx = threadIdx.x; idx < groups * qn; idx += blockDim.x) {
        const int g = idx / qn;
        const int i = idx - g * qn;
        keep_s[g][i] = keep_bits16(drop, (uint32_t)(key0 / kGroup + g),
                                   head_rows + i0 + i);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < qn; ++i) {
      // the same products in the same order as the forward's score, so s is
      // bit-identical to it (fmaf(q, k) == fmaf(k, q))
      float s = dot_half<T, kD>(kr, &q_s[i * kD], half);
      float dp = dot_half<T, kD>(vr, &do_s[i * kD], half);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = exp2f(s + bias2 - lse_s[i]);
      float pd = p, dpm = dp;
      if constexpr (kDropout) {
        const bool kept = (keep_s[local / kGroup][i] >> (local % kGroup)) & 1u;
        pd = kept ? p * drop.scale : 0.f;
        dpm = kept ? dp * drop.scale : 0.f;
      }
      axpy_half<T, kD>(dv_acc, pd, &do_s[i * kD], half);
      axpy_half<T, kD>(dk_acc, p * (dpm - delta_s[i]), &q_s[i * kD], half);
    }
  }

  if (active) {
    store_half<T, kD>(dk + key_off, half, dk_acc, dk_mult);
    store_half<T, kD>(dv + key_off, half, dv_acc, 1.f);
  }
}

// ---------------------------------------------------------------------------
// The '+probs' pair (v2s): a forward that also writes the signed
// probabilities, and a backward that reads them instead of recomputing
// ---------------------------------------------------------------------------
//
// Probs layout: [B, heads, S, Sp] in the storage type, Sp = S rounded up to
// 16 (one Philox group): entry (b, head, i, j) is keep ? p : -p, p the
// normalised softmax probability before dropout; columns j >= S hold +-0.
// JAX's v2s layout, [B, S, G * hpg * round_up(S, 128)], answers the TPU's
// 128-lane tiles; each row here is 16-key aligned, so a thread writes and
// reads its row in 16-byte vectors.  A probability that rounds to +-0 loses
// its sign, which is harmless: it contributes 0 to every gradient term, and
// the backward tests keep with ps > 0.
//
// The forward writes ps = keep ? p : -p with p = exp2(s - lse), lse the
// row's log2-sum-exp, and accumulates ctx from pd = keep ? p / (1 - rate)
// : 0 (never from the rounded ps).  It has no final lse until it has seen
// every key:
//
//   * bf16, on the tensor cores (mma_tiles.cuh; one warp per 16 query
//     rows, Q, K and V staged in bf16 by cp.async, S = Q K^T and ctx += P V
//     by mma.sync, pd rounded to bf16 in the pack that feeds P V, as JAX's
//     _fwd_kernel_v2s rounds pd.astype(vg.dtype)).  At S <= 128 one CTA per
//     (head, batch row) holds the head's K and V and each warp its whole
//     score row in registers, so the lse comes from the row itself and K
//     and V are read once.  Above, one CTA per (query tile of <= 128 rows,
//     head, batch row) sweeps the keys twice in 64-key tiles through a
//     two-stage cp.async ring: the online max / sum to the lse, then the
//     scores again, the probs and ctx.  A warp writes its probs (d keys at
//     a time) and ctx through shared memory in 16-byte row vectors.
//   * f32, on the CUDA cores (two threads per query row, K and V staged as
//     f32): the same two sweeps, ctx from pd in f32.
//
// What bounds the pair: bytes, as the v2 backward, plus the probs, which are
// S / 32 times the q/k/v/o bytes at bf16 (heads * S * 2 B per token against
// 4 * H * 2 B): at the joint shape [192, 80] 39 MB written and read back,
// about as many as q, k, v and o together.  The backward saves the score
// recompute (a quarter of its products) and the Philox draws.  The dk/dv
// launch stages a [32 queries, <= 128 keys] block of the probs in shared
// memory, read row by row (coalesced) and used column-wise.

// Store 8 consecutive values (16-byte aligned) in the storage type.
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float* src) {
#pragma unroll
  for (int e = 0; e < 8; e += 16 / (int)sizeof(T)) store16(dst + e, src + e);
}

// Load 16 consecutive values (16-byte aligned) of the storage type as f32.
template <typename T>
__device__ __forceinline__ void load_group(const T* src, float* dst) {
#pragma unroll
  for (int e = 0; e < kGroup; e += 16 / (int)sizeof(T)) load16(src + e, dst + e);
}

__host__ __device__ __forceinline__ int probs_width(int seq) {
  return (seq + kGroup - 1) / kGroup * kGroup;
}

// f32, on the CUDA cores.
template <int kD, bool kDropout>
__global__ void __launch_bounds__(kMaxThreads)
short_attention_probs_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ key_bias,
                                 float* __restrict__ out, float* __restrict__ probs,
                                 int seq, int hidden, int rows_per_cta,
                                 float score_mult, Dropout drop) {
  using T = float;
  using L = Layout<T, kD>;
  __shared__ __align__(16) float k_s[kKeyTileOf<kD> * kD];
  __shared__ __align__(16) float v_s[kKeyTileOf<kD> * kD];
  __shared__ float bias_s[kKeyTileOf<kD>];

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * rows_per_cta + (threadIdx.x >> 1);
  const bool active = row < seq;
  const size_t head_base = (size_t)b * seq * hidden + (size_t)head * kD;
  const uint32_t prob_row = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq + row;
  T* probs_row = probs + (size_t)prob_row * probs_width(seq);
  const float* bias_row = key_bias + (size_t)b * seq;

  float qr[L::kPart];
  load_half<T, kD>(q + head_base + (size_t)row * hidden, half, active, score_mult, qr);

  // Sweep 1: the row's lse (log2 units) by the online max / sum.
  const float row_lse = row_lse_sweep<T, kD>(qr, k, head_base, hidden, seq, bias_row, half,
                                         k_s, bias_s);

  // Sweep 2: the same scores again, the signed probs and ctx.
  float acc[L::kPart];
#pragma unroll
  for (int i = 0; i < L::kPart; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kKeyTileOf<kD>) {
    const int kn = min(kKeyTileOf<kD>, seq - k0);
    __syncthreads();
    stage_pair<T, kD>(k, v, head_base, hidden, head_base, hidden, k0, kn, 1.f, k_s, v_s);
    for (int j = threadIdx.x; j < kn; j += blockDim.x) {
      bias_s[j] = bias_row[k0 + j] * kLog2e;
    }
    __syncthreads();
    for (int j0 = 0; j0 < kn; j0 += kKeyChunk) {
      float p[kKeyChunk];
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        const int j = j0 + jj;
        float part = 0.f;
        if (j < kn) part = dot_half<T, kD>(qr, &k_s[j * kD], half);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        p[jj] = (j < kn) ? exp2f(part + bias_s[j] - row_lse) : 0.f;
      }
      uint32_t keep = 0xFFFFu;
      if constexpr (kDropout) keep = keep_bits16(drop, (uint32_t)(k0 + j0) / kGroup, prob_row);
      if (active) {
        float signed_p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int jj = 8 * half + e;
          signed_p[e] = ((keep >> jj) & 1u) ? p[jj] : -p[jj];
        }
        store8(probs_row + k0 + j0 + 8 * half, signed_p);
      }
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        const int j = j0 + jj;
        if (j < kn) {
          float pd = p[jj];
          if constexpr (kDropout) pd = ((keep >> jj) & 1u) ? p[jj] * drop.scale : 0.f;
          axpy_half<T, kD>(acc, pd, &v_s[j * kD], half);
        }
      }
    }
  }
  if (active) store_half<T, kD>(out + head_base + (size_t)row * hidden, half, acc, 1.f);
}

// ---- bf16, on the tensor cores ----

// p = exp2(s - lse) in place; then, after the signed probs are out (with
// the same keep words), pd = keep ? p * scale : 0.
template <int kN>
__device__ __forceinline__ void probs_from_lse(float (&s)[kN][4], const float* lse) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) s[n][x] = exp2f(s[n][x] - lse[x >> 1]);
  }
}
template <int kN, bool kDropout>
__device__ __forceinline__ void drop_probs(float (&p)[kN][4], const uint32_t* keep,
                                           float scale) {
  if constexpr (kDropout) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        p[n][x] = tc::kept_at(keep, n, x & 1, x >> 1) ? p[n][x] * scale : 0.f;
      }
    }
  }
}

// The warp's signed probs keep ? p : -p of column tiles [0, kN) as bf16,
// kD keys at a time through its [16][kStride<kD>] stage, into dst (its
// first row and key; row stride ld) in 16-byte row vectors: `rows` valid
// rows and `chunks` valid 8-key chunks from the first key.
template <int kD, int kN, bool kDropout>
__device__ __forceinline__ void store_signed_probs(const float (&p)[kN][4],
                                                   const uint32_t* keep, bf16* stage,
                                                   bf16* dst, int ld, int rows, int chunks) {
  constexpr int kW = tc::kNT<kD>;  // 8-key tiles a stage row holds
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < kN; h += kW) {
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (h + j >= kN) break;  // known at compile time once unrolled
      float x[4];
#pragma unroll
      for (int xx = 0; xx < 4; ++xx) {
        const bool kept = !kDropout || tc::kept_at(keep, h + j, xx & 1, xx >> 1);
        x[xx] = kept ? p[h + j][xx] : -p[h + j][xx];
      }
      *reinterpret_cast<uint32_t*>(stage + g * tc::kStride<kD> + j * 8 + 2 * c) =
          tc::pack_bf16(x[0], x[1]);
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * tc::kStride<kD> + j * 8 + 2 * c) =
          tc::pack_bf16(x[2], x[3]);
    }
    __syncwarp();
    tc::stage_to_rows<kD>(stage, dst + h * 8, ld, rows, min(chunks - h, kW));
    __syncwarp();  // the stage is written again next
  }
}

// Q, K and V rows (seq rounded up to 16) and the key bias.
template <int kD>
int probs_tc_smem_bytes(int seq) {
  const int rows = (seq + 15) / 16 * 16;
  return 3 * rows * tc::kStride<kD> * (int)sizeof(bf16) + rows * (int)sizeof(float);
}

// S <= 128: one CTA per (head, batch row) (grid (1, heads, B)), kKT 16-key
// tiles of the padded sequence (seq <= 16 kKT), one warp per 16 query rows,
// each warp's whole score row in registers.
template <int kD, int kKT, bool kDropout>
__global__ void __launch_bounds__(32 * kKT)
short_attention_probs_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v,
                                    const float* __restrict__ key_bias,
                                    bf16* __restrict__ out, bf16* __restrict__ probs,
                                    int seq, int hidden, float score_mult, Dropout drop) {
  constexpr int kPadded = 16 * kKT;  // query rows and keys, padded; the probs width
  constexpr int kN = 2 * kKT;        // 8-key column tiles of a score row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kPadded * tc::kStride<kD>;
  bf16* v_s = k_s + kPadded * tc::kStride<kD>;
  float* bias_s = reinterpret_cast<float*>(v_s + kPadded * tc::kStride<kD>);

  const int b = blockIdx.z, head = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kD;
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int rows = seq - warp * 16;  // this warp's rows below seq

  tc::stage_head<kD>(q_s, k_s, v_s, bias_s, q, k, v, key_bias + (size_t)b * seq, base,
                     hidden, kPadded, seq);  // V lands during the softmax
  tc::cp_async_wait<1>();
  __syncthreads();

  // the row lse (log2 units) from the whole row: its max, then the sum
  float s[kN][4], lse[2], sum[2] = {0.f, 0.f};
  tc::mma_nt<kD, kN>(q_s, warp * 16, k_s, s);
  tc::scores_log2<kN>(s, bias_s, score_mult);
  tc::row_max<kN>(s, lse);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) sum[x >> 1] += exp2f(s[n][x] - lse[x >> 1]);
  }
  lse[0] += log2f(tc::quad_sum(sum[0]));
  lse[1] += log2f(tc::quad_sum(sum[1]));
  probs_from_lse<kN>(s, lse);

  uint32_t keep[8] = {};
  if constexpr (kDropout) {
    const uint32_t prob_row = row_base + warp * 16 + (lane >> 2);
    tc::keep_words_qmajor(drop, prob_row, 0, keep);
    if constexpr (kKT > 4) tc::keep_words_qmajor(drop, prob_row, 64, keep + 4);
  }
  // the warp's own Q rows are its stage from here on
  bf16* stage = q_s + warp * 16 * tc::kStride<kD>;
  __syncwarp();
  store_signed_probs<kD, kN, kDropout>(s, keep, stage,
                                   probs + (size_t)(row_base + warp * 16) * kPadded,
                                   kPadded, rows, kN);
  drop_probs<kN, kDropout>(s, keep, drop.scale);

  tc::cp_async_wait<0>();
  __syncthreads();  // V has landed
  float acc[tc::kNT<kD>][4];
#pragma unroll
  for (int n = 0; n < tc::kNT<kD>; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  tc::mma_nn<kD, kN>(s, v_s, acc);
  tc::store_tile<kD>(acc, stage, out + base + (size_t)warp * 16 * hidden, hidden, rows);
}

// 128 < S < 1024, and every S at kD = 256: one CTA per (query tile, head,
// batch row), 2 * rows_per_cta threads; Q tile, K and V rings of two
// 64-key tiles, the key bias of each, and a [16][kStride<64>] stage a warp
// for the signed probs of a ring tile (the warp's Q rows are its ctx
// stage once both sweeps are done).
constexpr int kRingTile = 64;
constexpr int kRN = kRingTile / 8;  // 8-key column tiles of a ring tile's scores

template <int kD>
constexpr int probs_tc_long_smem_bytes(int rows_per_cta) {
  return ((rows_per_cta + 4 * kRingTile) * tc::kStride<kD> +
          rows_per_cta * tc::kStride<kRingTile>) * (int)sizeof(bf16) +
         2 * kRingTile * (int)sizeof(float);
}
static_assert(probs_tc_long_smem_bytes<256>(kMaxRows) <= msa_short_bwd_tiled::kMaxSmem,
              "the probs ring fits one CTA's shared memory");

__device__ __forceinline__ void load_bias_tile(float* dst, const float* bias_row, int k0,
                                               int seq) {
  for (int j = threadIdx.x; j < kRingTile; j += blockDim.x) {
    dst[j] = k0 + j < seq ? bias_row[k0 + j] * kLog2e : -INFINITY;
  }
}

// Sweep 1 of the two-sweep forms: the online row max and sum (this lane's
// part; the caller sums the quad) of the warp's rows m0 .. m0 + 16 of q_s
// over every key, K (row 0 at k + base, row stride ld) through the ring of
// two 64-key tiles at k_s, their bias at bias_s.  The caller has staged Q
// without committing it.  Every tile holds a key < seq, so the running max
// is finite from the first tile.  Returns with every warp done with the
// ring.
template <int kD>
__device__ __forceinline__ void ring_row_stats(const bf16* q_s, int m0, bf16* k_s,
                                               float* bias_s, const bf16* k, size_t base,
                                               int ld, const float* bias_row, int seq,
                                               float score_mult, float* m_run, float* l_run) {
  constexpr int kTile = kRingTile * tc::kStride<kD>;
  const int n_tiles = (seq + kRingTile - 1) / kRingTile;
  tc::stage_rows<kD>(k_s, k, base, ld, 0, kRingTile, seq);
  tc::cp_async_commit();
  load_bias_tile(bias_s, bias_row, 0, seq);
  m_run[0] = m_run[1] = -INFINITY;
  l_run[0] = l_run[1] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy overlaps this tile's math
      tc::stage_rows<kD>(k_s + (buf ^ 1) * kTile, k, base, ld, (t + 1) * kRingTile, kRingTile,
                     seq);
      tc::cp_async_commit();
      load_bias_tile(bias_s + (buf ^ 1) * kRingTile, bias_row, (t + 1) * kRingTile, seq);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    float s[kRN][4];
    tc::mma_nt<kD, kRN>(q_s, m0, k_s + buf * kTile, s);
    tc::scores_log2<kRN>(s, bias_s + buf * kRingTile, score_mult);
    float mx[2];
    tc::row_max<kRN>(s, mx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r]);
      l_run[r] *= exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
#pragma unroll
      for (int n = 0; n < kRN; ++n) {
        l_run[r] += exp2f(s[n][2 * r] - m_new) + exp2f(s[n][2 * r + 1] - m_new);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
}

// Sweep 2: K and V through the same ring, the scores of the warp's rows in
// the log2 domain for each 64-key tile handed to tile(s, k0, v_tile), which
// forms P from them and adds P V.  Returns with every warp done with the
// ring and with its own Q rows.
template <int kD, class Tile>
__device__ __forceinline__ void ring_sweep(const bf16* q_s, int m0, bf16* k_s, bf16* v_s,
                                           float* bias_s, const bf16* k, const bf16* v,
                                           size_t base, int ld, const float* bias_row,
                                           int seq, float score_mult, Tile&& tile) {
  constexpr int kTile = kRingTile * tc::kStride<kD>;
  const int n_tiles = (seq + kRingTile - 1) / kRingTile;
  tc::stage_rows<kD>(k_s, k, base, ld, 0, kRingTile, seq);
  tc::stage_rows<kD>(v_s, v, base, ld, 0, kRingTile, seq);
  tc::cp_async_commit();
  load_bias_tile(bias_s, bias_row, 0, seq);
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, k0 = t * kRingTile;
    if (t + 1 < n_tiles) {
      tc::stage_rows<kD>(k_s + (buf ^ 1) * kTile, k, base, ld, k0 + kRingTile, kRingTile, seq);
      tc::stage_rows<kD>(v_s + (buf ^ 1) * kTile, v, base, ld, k0 + kRingTile, kRingTile, seq);
      tc::cp_async_commit();
      load_bias_tile(bias_s + (buf ^ 1) * kRingTile, bias_row, k0 + kRingTile, seq);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    float s[kRN][4];
    tc::mma_nt<kD, kRN>(q_s, m0, k_s + buf * kTile, s);
    tc::scores_log2<kRN>(s, bias_s + buf * kRingTile, score_mult);
    tile(s, k0, v_s + buf * kTile);
    __syncthreads();  // every warp is done with this buffer
  }
}

template <int kD, bool kDropout>
__global__ void __launch_bounds__(kMaxThreads)
short_attention_probs_fwd_tc_long_kernel(const bf16* __restrict__ q,
                                         const bf16* __restrict__ k,
                                         const bf16* __restrict__ v,
                                         const float* __restrict__ key_bias,
                                         bf16* __restrict__ out, bf16* __restrict__ probs,
                                         int seq, int hidden, int rows_per_cta,
                                         float score_mult, Dropout drop) {
  constexpr int kTile = kRingTile * tc::kStride<kD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // two buffers
  bf16* v_s = k_s + 2 * kTile;                // two buffers
  bf16* q_s = v_s + 2 * kTile;                // [rows_per_cta][kStride<kD>]
  bf16* stage_s = q_s + rows_per_cta * tc::kStride<kD>;  // [rows_per_cta][kStride<64>]
  float* bias_s =
      reinterpret_cast<float*>(stage_s + rows_per_cta * tc::kStride<kRingTile>);  // [2][64]

  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * rows_per_cta;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kD;
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const float* bias_row = key_bias + (size_t)b * seq;
  const int sp = probs_width(seq);
  const int w0 = q0 + warp * 16;  // this warp's first row
  bf16* stage = stage_s + warp * 16 * tc::kStride<kRingTile>;

  // Sweep 1: the row lse (log2 units) by the online max / sum.
  tc::stage_rows<kD>(q_s, q, base, hidden, q0, rows_per_cta, seq);
  float m_run[2], l_run[2];
  ring_row_stats<kD>(q_s, warp * 16, k_s, bias_s, k, base, hidden, bias_row, seq,
                     score_mult, m_run, l_run);
  const float lse[2] = {m_run[0] + log2f(tc::quad_sum(l_run[0])),
                        m_run[1] + log2f(tc::quad_sum(l_run[1]))};

  // Sweep 2: the scores again, the signed probs and ctx.
  float acc[tc::kNT<kD>][4];
#pragma unroll
  for (int n = 0; n < tc::kNT<kD>; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  ring_sweep<kD>(q_s, warp * 16, k_s, v_s, bias_s, k, v, base, hidden, bias_row, seq,
                 score_mult, [&](float (&s)[kRN][4], int k0, const bf16* v_tile) {
               probs_from_lse<kRN>(s, lse);
               uint32_t keep[4] = {};
               if constexpr (kDropout) {
                 tc::keep_words_qmajor(drop, row_base + w0 + (lane >> 2), k0, keep);
               }
               store_signed_probs<kRingTile, kRN, kDropout>(
                   s, keep, stage, probs + (size_t)(row_base + w0) * sp + k0, sp, seq - w0,
                   (sp - k0) / 8);
               drop_probs<kRN, kDropout>(s, keep, drop.scale);
               tc::mma_nn<kD, kRN>(s, v_tile, acc);
             });
  tc::store_tile<kD>(acc, q_s + warp * 16 * tc::kStride<kD>, out + base + (size_t)w0 * hidden,
                     hidden, seq - w0);
}

// ---- the v2 / v2p forward, bf16, 128 < S < 1024 (every S at kD = 256) ----
//
// short_fwd_tc.cuh's rule in the two-sweep form: one CTA per (query tile of
// <= 128 rows, head, batch row), 2 * rows_per_cta threads, one warp per 16
// query rows, v2s's ring without its probs.  At kD = 256 a warp's
// [16 x 256] f32 ctx accumulator is 128 registers a lane and a ring tile's
// scores 32 more; the rings and a Q tile of 128 rows take 203 KB.  Sweep 1: the online row max
// and sum (ring_row_stats); sweep 2: the scores again, p = exp2(s - max) *
// (1 / sum), the dropout, p rounded to bf16 in the pack that feeds P V.  q,
// k, v at row stride ld; out [B, S, hidden] and lse [B, heads, S]
// (kTrain).  Shared memory: the K and V rings and their bias, and the Q
// tile, whose warp rows are the store stage once both sweeps are done.
template <int kD>
constexpr int fwd_tc_long_smem_bytes(int rows_per_cta) {
  return (rows_per_cta + 4 * kRingTile) * tc::kStride<kD> * (int)sizeof(bf16) +
         2 * kRingTile * (int)sizeof(float);
}
static_assert(fwd_tc_long_smem_bytes<256>(kMaxRows) <= msa_short_bwd_tiled::kMaxSmem,
              "the ring fits one CTA's shared memory");

template <int kD, bool kDropout, bool kTrain>
__global__ void __launch_bounds__(kMaxThreads)
short_attention_fwd_tc_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const float* __restrict__ key_bias, bf16* __restrict__ out,
                                   float* __restrict__ lse, int seq, int ld, int hidden,
                                   int rows_per_cta, float score_mult, Dropout drop) {
  constexpr int kTile = kRingTile * tc::kStride<kD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // two buffers
  bf16* v_s = k_s + 2 * kTile;                // two buffers
  bf16* q_s = v_s + 2 * kTile;                // [rows_per_cta][kStride<kD>]
  float* bias_s = reinterpret_cast<float*>(q_s + rows_per_cta * tc::kStride<kD>);  // [2][64]

  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * rows_per_cta;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t in_base = (size_t)b * seq * ld + (size_t)head * kD;
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const float* bias_row = key_bias + (size_t)b * seq;
  const int w0 = q0 + warp * 16;  // this warp's first row

  tc::stage_rows<kD>(q_s, q, in_base, ld, q0, rows_per_cta, seq);
  float mx[2], sum[2];
  ring_row_stats<kD>(q_s, warp * 16, k_s, bias_s, k, in_base, ld, bias_row, seq, score_mult,
                     mx, sum);
  sum[0] = tc::quad_sum(sum[0]);
  sum[1] = tc::quad_sum(sum[1]);
  if constexpr (kTrain) {
    msa_short_fwd::store_lse(mx[0] + log2f(sum[0]), mx[1] + log2f(sum[1]),
                             lse + row_base + w0, seq - w0);
  }
  sum[0] = 1.f / sum[0];
  sum[1] = 1.f / sum[1];

  float acc[tc::kNT<kD>][4];
#pragma unroll
  for (int n = 0; n < tc::kNT<kD>; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  ring_sweep<kD>(q_s, warp * 16, k_s, v_s, bias_s, k, v, in_base, ld, bias_row, seq,
                 score_mult, [&](float (&s)[kRN][4], int k0, const bf16* v_tile) {
#pragma unroll
               for (int n = 0; n < kRN; ++n) {
#pragma unroll
                 for (int x = 0; x < 4; ++x) {
                   s[n][x] = exp2f(s[n][x] - mx[x >> 1]) * sum[x >> 1];
                 }
               }
               uint32_t keep[4] = {};
               if constexpr (kDropout) {
                 tc::keep_words_qmajor(drop, row_base + w0 + (lane >> 2), k0, keep);
               }
               drop_probs<kRN, kDropout>(s, keep, drop.scale);
               tc::mma_nn<kD, kRN>(s, v_tile, acc);
             });

  const size_t out0 = (size_t)b * seq * hidden + (size_t)head * kD + (size_t)w0 * hidden;
  tc::store_tile<kD>(acc, q_s + warp * 16 * tc::kStride<kD>, out + out0, hidden, seq - w0);
}

// f32: dq from the stashed probs, one CTA per (query tile, head, batch
// row), two threads per query row.  Sweep 1 over the keys sums delta =
// sum_j p * dpm (dp = dO . v_j, dpm its dropout-masked, rescaled value);
// sweep 2 forms ds = p * (dpm - delta) (:931) and accumulates dq = scale *
// sum_j ds k_j.  delta goes to scratch for the dk/dv launch.  No score,
// softmax or Philox draw.
template <int kD, bool kDropout>
__global__ void __launch_bounds__(kMaxThreads)
short_attention_probs_dq_kernel(const float* __restrict__ k, const float* __restrict__ v,
                                const float* __restrict__ probs,
                                const float* __restrict__ dout,
                                float* __restrict__ delta_out, float* __restrict__ dq,
                                int seq, int hidden, int rows_per_cta, float scale,
                                float drop_scale) {
  using T = float;
  using L = Layout<T, kD>;
  __shared__ __align__(16) float k_s[kKeyTileOf<kD> * kD];
  __shared__ __align__(16) float v_s[kKeyTileOf<kD> * kD];

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * rows_per_cta + (threadIdx.x >> 1);
  const bool active = row < seq;
  const size_t head_base = (size_t)b * seq * hidden + (size_t)head * kD;
  const size_t row_off = head_base + (size_t)row * hidden;
  const uint32_t prob_row = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq + row;
  const T* probs_row = probs + (size_t)prob_row * probs_width(seq);

  float dor[L::kPart], acc[L::kPart];
  load_half<T, kD>(dout + row_off, half, active, 1.f, dor);
#pragma unroll
  for (int i = 0; i < L::kPart; ++i) acc[i] = 0.f;

  float delta = 0.f;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < seq; k0 += kKeyTileOf<kD>) {
      const int kn = min(kKeyTileOf<kD>, seq - k0);
      __syncthreads();
      if (sweep == 0) {
        stage_one<T, kD>(v, head_base, hidden, k0, kn, v_s);
      } else {
        stage_pair<T, kD>(k, v, head_base, hidden, head_base, hidden, k0, kn, 1.f, k_s, v_s);
      }
      __syncthreads();
      for (int j0 = 0; j0 < kn; j0 += kKeyChunk) {
        float ps[kGroup];
        if (active) {
          load_group(probs_row + k0 + j0, ps);
        } else {
#pragma unroll
          for (int jj = 0; jj < kGroup; ++jj) ps[jj] = 0.f;
        }
#pragma unroll 4
        for (int jj = 0; jj < kKeyChunk; ++jj) {
          const int j = j0 + jj;
          if (j >= kn) break;  // uniform across the CTA
          float dp = dot_half<T, kD>(dor, &v_s[j * kD], half);
          dp += __shfl_xor_sync(0xffffffffu, dp, 1);
          const float p = fabsf(ps[jj]);
          float dpm = dp;
          if constexpr (kDropout) dpm = ps[jj] > 0.f ? dp * drop_scale : 0.f;
          if (sweep == 0) {
            delta = fmaf(p, dpm, delta);
          } else {
            axpy_half<T, kD>(acc, p * (dpm - delta), &k_s[j * kD], half);
          }
        }
      }
    }
  }
  if (active) {
    if (half == 0) delta_out[prob_row] = delta;
    store_half<T, kD>(dq + row_off, half, acc, scale);
  }
}

// f32: dk and dv from the stashed probs, one CTA per (key tile, head,
// batch row), two threads per key row holding v and the dk / dv
// accumulators.  Query tiles of kProbsQueryTileOf<kD> rows (q, dO, delta
// and the [tile, keys] block of the probs, read row by row, coalesced) are
// staged in shared memory.
constexpr int kProbsQueryTile = 32;
template <int kD>
inline constexpr int kProbsQueryTileOf =
    kD == 256 ? kProbsQueryTile / 4 : kD == 128 ? kProbsQueryTile / 2 : kProbsQueryTile;

template <int kD, bool kDropout>
__global__ void __launch_bounds__(kMaxThreads)
short_attention_probs_dkv_kernel(const float* __restrict__ q, const float* __restrict__ v,
                                 const float* __restrict__ probs,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ delta,
                                 float* __restrict__ dk, float* __restrict__ dv, int seq,
                                 int hidden, int rows_per_cta, float scale,
                                 float drop_scale) {
  using T = float;
  using L = Layout<T, kD>;
  __shared__ __align__(16) float q_s[kProbsQueryTileOf<kD> * kD];
  __shared__ __align__(16) float do_s[kProbsQueryTileOf<kD> * kD];
  __shared__ float p_s[kProbsQueryTileOf<kD>][kMaxRows];
  __shared__ float delta_s[kProbsQueryTileOf<kD>];

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int key0 = blockIdx.x * rows_per_cta;
  const int local = threadIdx.x >> 1;
  const int key = key0 + local;
  const bool active = key < seq;
  const int width = probs_width(seq);
  const size_t head_base = (size_t)b * seq * hidden + (size_t)head * kD;
  const size_t key_off = head_base + (size_t)key * hidden;
  const uint32_t head_rows = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int keys_here = min(rows_per_cta, seq - key0);

  float vr[L::kPart], dk_acc[L::kPart], dv_acc[L::kPart];
  load_half<T, kD>(v + key_off, half, active, 1.f, vr);
#pragma unroll
  for (int i = 0; i < L::kPart; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int i0 = 0; i0 < seq; i0 += kProbsQueryTileOf<kD>) {
    const int qn = min(kProbsQueryTileOf<kD>, seq - i0);
    __syncthreads();
    stage_pair<T, kD>(q, dout, head_base, hidden, head_base, hidden, i0, qn, 1.f, q_s,
                      do_s);
    for (int idx = threadIdx.x; idx < qn * keys_here; idx += blockDim.x) {
      const int i = idx / keys_here;
      const int j = idx - i * keys_here;
      p_s[i][j] = probs[(size_t)(head_rows + i0 + i) * width + key0 + j];
    }
    for (int i = threadIdx.x; i < qn; i += blockDim.x) delta_s[i] = delta[head_rows + i0 + i];
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < qn; ++i) {
      float dp = dot_half<T, kD>(vr, &do_s[i * kD], half);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float ps = active ? p_s[i][local] : 0.f;
      const float p = fabsf(ps);
      float pd = p, dpm = dp;
      if constexpr (kDropout) {
        const bool kept = ps > 0.f;
        pd = kept ? p * drop_scale : 0.f;
        dpm = kept ? dp * drop_scale : 0.f;
      }
      axpy_half<T, kD>(dv_acc, pd, &do_s[i * kD], half);
      axpy_half<T, kD>(dk_acc, p * (dpm - delta_s[i]), &q_s[i * kD], half);
    }
  }

  if (active) {
    store_half<T, kD>(dk + key_off, half, dk_acc, scale);
    store_half<T, kD>(dv + key_off, half, dv_acc, 1.f);
  }
}

// ---------------------------------------------------------------------------
// Keep-mask export
// ---------------------------------------------------------------------------

// One thread per (probability row, 16-key group): out[row * S + j] = keep.
__global__ void dropout_keep_mask_kernel(uint8_t* __restrict__ out, int rows,
                                         int seq, Dropout drop) {
  const int groups = (seq + kGroup - 1) / kGroup;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * groups) return;
  const uint32_t row = (uint32_t)(idx / groups);
  const uint32_t g = (uint32_t)(idx - (long long)row * groups);
  const uint32_t bits = keep_bits16(drop, g, row);
  uint8_t* dst = out + (size_t)row * seq + g * kGroup;
  const int n = min(kGroup, seq - (int)g * kGroup);
  for (int jj = 0; jj < n; ++jj) dst[jj] = (bits >> jj) & 1u;
}

// Balanced tiles of at most kMaxRows rows, rounded to 16 rows (one warp).
void tiles(int seq, int* n_tiles, int* rows) {
  *n_tiles = (seq + kMaxRows - 1) / kMaxRows;
  *rows = ((seq + *n_tiles - 1) / *n_tiles + 15) / 16 * 16;
}

template <typename T, int kD, bool kDropout, bool kTrain>
void launch_fwd(const void* q, const void* k, const void* v, const float* bias,
                void* out, float* lse, int batch, int seq, int hidden, int stride,
                int num_heads, float score_mult, Dropout drop, cudaStream_t s) {
  int n_tiles, rows;
  tiles(seq, &n_tiles, &rows);
  short_attention_fwd_kernel<T, kD, kDropout, kTrain>
      <<<dim3(n_tiles, num_heads, batch), dim3(2 * rows), 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), bias, static_cast<T*>(out), lse, seq, hidden,
          stride, rows, score_mult, drop);
}

// The f32 backward pair on the CUDA cores.
template <int kD, bool kDropout, bool kV3>
int launch_bwd(const void* q, const void* k, const void* v, const float* bias,
               const void* o, const void* dout, float* lse, float* delta,
               void* dq, void* dk, void* dv, int batch, int seq, int hidden,
               int stride, int num_heads, float scale, Dropout drop, cudaStream_t s) {
  using T = float;
  int n_tiles, rows;
  tiles(seq, &n_tiles, &rows);
  const dim3 grid(n_tiles, num_heads, batch);
  const float score_mult = scale * kLog2e;
  short_attention_bwd_dq_kernel<kD, kDropout, kV3><<<grid, dim3(2 * rows), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), seq, hidden, stride, rows, score_mult, scale, drop);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // q is staged as q * score_mult, so dk = sum(ds * q_staged) / log2e
  // (scale * score_mult / score_mult = scale in natural units).
  short_attention_bwd_dkv_kernel<kD, kDropout><<<grid, dim3(2 * rows), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), seq, hidden, stride, rows, score_mult, 1.f / kLog2e, drop);
  return (int)cudaGetLastError();
}

template <int kD, bool kDropout>
void launch_probs_fwd(const void* q, const void* k, const void* v, const float* bias,
                      void* out, void* probs, int batch, int seq, int hidden,
                      int num_heads, float score_mult, Dropout drop, cudaStream_t s) {
  using T = float;
  int n_tiles, rows;
  tiles(seq, &n_tiles, &rows);
  short_attention_probs_fwd_kernel<kD, kDropout>
      <<<dim3(n_tiles, num_heads, batch), dim3(2 * rows), 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), bias, static_cast<T*>(out),
          static_cast<T*>(probs), seq, hidden, rows, score_mult, drop);
}

// Kernels above 48 KB of dynamic shared memory must opt in.
template <auto kKernel>
cudaError_t allow_smem(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int kD, int kKT, bool kDropout>
int launch_probs_fwd_tc(const void* q, const void* k, const void* v, const float* bias,
                        void* out, void* probs, int batch, int seq, int hidden,
                        int num_heads, float score_mult, Dropout drop, cudaStream_t s) {
  constexpr auto kernel = short_attention_probs_fwd_tc_kernel<kD, kKT, kDropout>;
  const int bytes = probs_tc_smem_bytes<kD>(seq);
  const cudaError_t err = allow_smem<kernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(1, num_heads, batch), 32 * kKT, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), static_cast<bf16*>(probs), seq, hidden, score_mult,
      drop);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core forward, its whole-row form for the 16-key tiles
// seq needs up to 128 keys (head dims up to kMaxWholeRowHeadDim), else the
// two-sweep form.
template <int kD, bool kDropout>
int launch_probs_fwd_tc_for(const void* q, const void* k, const void* v, const float* bias,
                            void* out, void* probs, int batch, int seq, int hidden,
                            int num_heads, float score_mult, Dropout drop,
                            cudaStream_t s) {
  if constexpr (kD <= kMaxWholeRowHeadDim) {
#define MSA_TC(KT)                                                                       \
  case KT:                                                                               \
    return launch_probs_fwd_tc<kD, KT, kDropout>(q, k, v, bias, out, probs, batch, seq,  \
                                                 hidden, num_heads, score_mult, drop, s)
    switch ((seq + 15) / 16) {
      MSA_TC(1); MSA_TC(2); MSA_TC(3); MSA_TC(4);
      MSA_TC(5); MSA_TC(6); MSA_TC(7); MSA_TC(8);
      default: break;
    }
#undef MSA_TC
  }
  int n_tiles, rows;
  tiles(seq, &n_tiles, &rows);
  constexpr auto kernel = short_attention_probs_fwd_tc_long_kernel<kD, kDropout>;
  const int bytes = probs_tc_long_smem_bytes<kD>(rows);
  const cudaError_t err = allow_smem<kernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_tiles, num_heads, batch), 2 * rows, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), static_cast<bf16*>(probs), seq, hidden, rows,
      score_mult, drop);
  return (int)cudaGetLastError();
}

// The f32 '+probs' backward pair on the CUDA cores.
template <int kD, bool kDropout>
int launch_probs_bwd(const void* q, const void* k, const void* v, const void* probs,
                     const void* dout, float* delta, void* dq, void* dk, void* dv,
                     int batch, int seq, int hidden, int num_heads, float scale,
                     float drop_scale, cudaStream_t s) {
  using T = float;
  int n_tiles, rows;
  tiles(seq, &n_tiles, &rows);
  const dim3 grid(n_tiles, num_heads, batch);
  short_attention_probs_dq_kernel<kD, kDropout><<<grid, dim3(2 * rows), 0, s>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(probs), static_cast<const T*>(dout), delta,
      static_cast<T*>(dq), seq, hidden, rows, scale, drop_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  short_attention_probs_dkv_kernel<kD, kDropout><<<grid, dim3(2 * rows), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(v),
      static_cast<const T*>(probs), static_cast<const T*>(dout), delta,
      static_cast<T*>(dk), static_cast<T*>(dv), seq, hidden, rows, scale,
      drop_scale);
  return (int)cudaGetLastError();
}

bool bad_args(int batch, int seq, int hidden, int num_heads, int dtype,
              double drop_rate) {
  return seq <= 0 || batch <= 0 || tc::head_dim_of(hidden, num_heads) == 0 ||
         !msa_dropout::rate_ok(drop_rate) || (dtype != 0 && dtype != 1);
}

// The third `part` (0, 1, 2 = q, k, v) of a packed [B, S, 3H] buffer.
const void* third(const void* qkv, int part, int hidden, int dtype) {
  return static_cast<const char*>(qkv) + (size_t)part * hidden * (dtype ? 2 : 4);
}

template <int kD, bool kDropout, bool kTrain>
int launch_fwd_tc_long(const void* q, const void* k, const void* v, const float* bias,
                       void* out, float* lse, int batch, int seq, int ld, int hidden,
                       int num_heads, float score_mult, Dropout drop, cudaStream_t s) {
  int n_tiles, rows;
  tiles(seq, &n_tiles, &rows);
  constexpr auto kernel = short_attention_fwd_tc_long_kernel<kD, kDropout, kTrain>;
  const int bytes = fwd_tc_long_smem_bytes<kD>(rows);
  const cudaError_t err = allow_smem<kernel>(bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_tiles, num_heads, batch), 2 * rows, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), lse, seq, ld, hidden, rows, score_mult, drop);
  return (int)cudaGetLastError();
}

// f32 on the CUDA cores; bf16 on the tensor cores, the whole-row template
// (short_fwd_tc.cuh) up to 128 keys, else the two-sweep form.  lse non-null
// asks for the training form.
template <int kD>
int fwd_dispatch(const void* q, const void* k, const void* v, const void* key_bias,
                 void* out, void* lse, int batch, int seq, int hidden, int stride,
                 int num_heads, int dtype, float scale, unsigned seed_lo, unsigned seed_hi,
                 double drop_rate, void* stream) {
  const float* bias = static_cast<const float*>(key_bias);
  float* l = static_cast<float*>(lse);
  const float sm = scale * kLog2e;
  const Dropout d = make_dropout(seed_lo, seed_hi, drop_rate);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool drop = drop_rate > 0.0;
  if (dtype == 0) {
#define MSA_FWD(D, W) launch_fwd<float, kD, D, W>(q, k, v, bias, out, l, batch, seq, hidden, \
                                                  stride, num_heads, sm, d, s)
    if (drop) { if (l) MSA_FWD(true, true); else MSA_FWD(true, false); }
    else { if (l) MSA_FWD(false, true); else MSA_FWD(false, false); }
#undef MSA_FWD
    return (int)cudaGetLastError();
  }
#define MSA_TC(F, D, W) F<kD, D, W>(q, k, v, bias, out, l, batch, seq, stride, hidden, \
                                    num_heads, sm, d, s)
#define MSA_TC_ALL(F) (drop ? (l ? MSA_TC(F, true, true) : MSA_TC(F, true, false)) \
                            : (l ? MSA_TC(F, false, true) : MSA_TC(F, false, false)))
  if constexpr (kD <= kMaxWholeRowHeadDim) {
    if (seq <= msa_short_fwd::kMaxSeq) return MSA_TC_ALL(msa_short_fwd::launch);
  }
  return MSA_TC_ALL(launch_fwd_tc_long);
#undef MSA_TC_ALL
#undef MSA_TC
}

// A bf16 backward on the tensor cores by rule kRule (short_bwd_tc.cuh's
// arguments): at S <= 128 and head dims up to kMaxWholeRowHeadDim one
// launch of short_bwd_tc.cuh (which needs neither lse nor delta, but
// kFromOut writes both), otherwise the dq and dk/dv pair of
// short_bwd_tiled.cuh (delta scratch, and the lse: the training forward's
// for kRecompute, scratch for kFromOut).  f32 takes the CUDA-core pairs
// instead.
template <int kD, int kRule>
int tc_backward(const void* q, const void* k, const void* v, const float* bias,
                const void* probs, const void* o, const void* dout, void* dq, void* dk,
                void* dv, float* lse, float* delta, int batch, int seq, int ld, int hidden,
                int num_heads, float scale, Dropout d, cudaStream_t s) {
  const bool one = kD <= kMaxWholeRowHeadDim && seq <= msa_short_bwd::kMaxSeq;
  if ((!one || kRule == msa_short_bwd::kFromOut) &&
      (delta == nullptr || (kRule != msa_short_bwd::kFromProbs && lse == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
#define MSA_TC(NS, D)                                                                  \
  NS::launch<kD, D, kRule>(q, k, v, bias, probs, o, dout, dq, dk, dv, lse, delta,       \
                           batch, seq, ld, hidden, num_heads, scale * kLog2e, scale, d, s)
  const bool drop = d.active;
  if constexpr (kD <= kMaxWholeRowHeadDim) {
    if (one) return drop ? MSA_TC(msa_short_bwd, true) : MSA_TC(msa_short_bwd, false);
  }
  return drop ? MSA_TC(msa_short_bwd_tiled, true) : MSA_TC(msa_short_bwd_tiled, false);
#undef MSA_TC
}

// kV3: delta from o, the ctx in the storage type, and the lse recomputed
// and written to `lse` (v3, v2p); else v1's rule (v2), o unread and,
// except for bf16's one launch, `lse` the training forward's, read.  bf16
// on the tensor cores (tc_backward), f32 on the CUDA cores.
// delta: scratch of the pairs.  q, k, v, dq, dk and dv at row stride
// `stride`.
template <int kD, bool kV3>
int bwd_dispatch(const void* q, const void* k, const void* v, const void* key_bias,
                 const void* o, const void* dout, void* lse, void* delta,
                 void* dq, void* dk, void* dv, int batch, int seq, int hidden,
                 int stride, int num_heads, int dtype, float scale, unsigned seed_lo,
                 unsigned seed_hi, double drop_rate, void* stream) {
  const float* bias = static_cast<const float*>(key_bias);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  const Dropout d = make_dropout(seed_lo, seed_hi, drop_rate);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MSA_BWD(D) launch_bwd<kD, D, kV3>(q, k, v, bias, o, dout, l, dl, dq, dk, dv, batch, \
                                          seq, hidden, stride, num_heads, scale, d, s)
  if (dtype == 1) {
    constexpr int kRule = kV3 ? msa_short_bwd::kFromOut : msa_short_bwd::kRecompute;
    return tc_backward<kD, kRule>(q, k, v, bias, nullptr, o, dout, dq, dk, dv, l, dl, batch,
                                  seq, stride, hidden, num_heads, scale, d, s);
  }
  if (l == nullptr || dl == nullptr) return (int)cudaErrorInvalidValue;
  return d.active ? MSA_BWD(true) : MSA_BWD(false);
#undef MSA_BWD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The head dim d = hidden / num_heads is
// the library's (16, 32, 64, 128 or 256: the source is built once a head dim,
// -DMSA_HEAD_DIM; the wrappers zero-pad any other d up to it and hand the
// scale of the true d).  drop_rate in
// [0, 1): 0 = no dropout, else the keep rule of dropout.cuh (the byte rule
// on the t/256 grid, the word rule off it).  The training forward passes lse ([B, heads, S] f32, the
// log2-sum-exp of each score row), which the v2 backward pairs read (bf16
// above 128 keys or at head dim 256, f32); the serving forward passes it null, which runs exactly the no-lse
// kernel.  bf16 runs on the tensor cores (fwd_dispatch), f32 on the CUDA
// cores; both forms give the same out.  Launches once on `stream` and
// returns cudaGetLastError() (0 on success).  The caller has checked
// shapes, contiguity, 16-byte alignment and seq < 1024.
extern "C" int msa_short_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* key_bias,
                                       void* out, void* lse, int batch, int seq,
                                       int hidden, int num_heads, int dtype,
                                       float scale, unsigned seed_lo,
                                       unsigned seed_hi, double drop_rate,
                                       void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    return fwd_dispatch<decltype(hd)::value>(q, k, v, key_bias, out, lse, batch, seq, hidden,
                                             hidden, num_heads, dtype, scale, seed_lo,
                                             seed_hi, drop_rate, stream);
  });
}

// The v2 backward (TPU kernel _bwd_kernel_v2): dq, dk and dv from q, k, v,
// key_bias and dout for the forward's seed and rate, delta =
// rowsum(p * dpm), dS and the dropped p rounded to the storage type before
// their products.  bf16 at S <= 128: one tensor-core launch
// (short_bwd_tc.cuh), which recomputes each row's max and sum; lse and
// delta may be null.  Otherwise a pair, dq (writing delta, [B, heads, S]
// f32 scratch) then dk/dv, both reading lse, the training forward's for
// the same q, k, key_bias: bf16 on the tensor cores (short_bwd_tiled.cuh),
// f32 on the CUDA cores.
extern "C" int msa_short_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* key_bias,
                                       const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv,
                                       int batch, int seq, int hidden,
                                       int num_heads, int dtype, float scale,
                                       unsigned seed_lo, unsigned seed_hi,
                                       double drop_rate, void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    return bwd_dispatch<decltype(hd)::value, false>(
        q, k, v, key_bias, nullptr, dout, const_cast<void*>(lse), delta, dq, dk, dv, batch,
        seq, hidden, hidden, num_heads, dtype, scale, seed_lo, seed_hi, drop_rate,
        stream);
  });
}

// The v3 backward (TPU kernel _bwd_kernel_v3): delta = dO . o taken from the
// ctx `out` in the storage type (the forward's own output), each row's lse
// recomputed from the scores, and dS and the dropped p rounded to the
// storage type before their products.  The forward keeps nothing but its
// ctx.  bf16 at S <= 128: one tensor-core launch (short_bwd_tc.cuh), which
// also writes the lse and delta to the [B, heads, S] f32 scratch `lse` and
// `delta`.  Otherwise a pair (bf16: short_bwd_tiled.cuh; f32: the CUDA
// cores), the dq launch writing the lse and delta there for the dk/dv
// launch.  Same arguments and dropout as msa_short_attention_bwd
// otherwise.
extern "C" int msa_short_attention_v3_bwd(const void* q, const void* k,
                                          const void* v, const void* key_bias,
                                          const void* out, const void* dout,
                                          void* lse, void* delta, void* dq,
                                          void* dk, void* dv, int batch, int seq,
                                          int hidden, int num_heads, int dtype,
                                          float scale, unsigned seed_lo,
                                          unsigned seed_hi, double drop_rate,
                                          void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    return bwd_dispatch<decltype(hd)::value, true>(
        q, k, v, key_bias, out, dout, lse, delta, dq, dk, dv, batch, seq, hidden, hidden,
        num_heads, dtype, scale, seed_lo, seed_hi, drop_rate, stream);
  });
}

// The packed pair (TPU kernels _fwd_kernel_v2p / _bwd_kernel_v2p): q, k and
// v are the thirds of one contiguous [B, S, 3H] qkv, read in place at row
// stride 3H; out and dout are [B, S, H].  The forward is
// msa_short_attention_fwd on the thirds.  The backward takes
// _bwd_kernel_v2p's rule, the v3 backward's: delta = dO . o from the ctx
// `out` in the storage type, the lse recomputed (lse and delta are [B,
// heads, S] f32 scratch), dS and pd rounded; it writes dq, dk and dv into
// the thirds of one [B, S, 3H] dqkv.  bf16 runs on the tensor cores at row
// stride 3H (one launch at S <= 128, else short_bwd_tiled.cuh's pair), f32
// the CUDA-core pair.
extern "C" int msa_short_attention_packed_fwd(const void* qkv, const void* key_bias,
                                              void* out, void* lse, int batch, int seq,
                                              int hidden, int num_heads, int dtype,
                                              float scale, unsigned seed_lo,
                                              unsigned seed_hi, double drop_rate,
                                              void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    return fwd_dispatch<decltype(hd)::value>(
        third(qkv, 0, hidden, dtype), third(qkv, 1, hidden, dtype),
        third(qkv, 2, hidden, dtype), key_bias, out, lse, batch, seq, hidden, 3 * hidden,
        num_heads, dtype, scale, seed_lo, seed_hi, drop_rate, stream);
  });
}

extern "C" int msa_short_attention_packed_bwd(const void* qkv, const void* key_bias,
                                              const void* out, const void* dout,
                                              void* lse, void* delta, void* dqkv,
                                              int batch, int seq, int hidden,
                                              int num_heads, int dtype, float scale,
                                              unsigned seed_lo, unsigned seed_hi,
                                              double drop_rate, void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  void* dq = const_cast<void*>(third(dqkv, 0, hidden, dtype));
  void* dk = const_cast<void*>(third(dqkv, 1, hidden, dtype));
  void* dv = const_cast<void*>(third(dqkv, 2, hidden, dtype));
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    return bwd_dispatch<decltype(hd)::value, true>(
        third(qkv, 0, hidden, dtype), third(qkv, 1, hidden, dtype),
        third(qkv, 2, hidden, dtype), key_bias, out, dout, lse, delta, dq, dk, dv, batch,
        seq, hidden, 3 * hidden, num_heads, dtype, scale, seed_lo, seed_hi, drop_rate,
        stream);
  });
}

// The '+probs' forward (TPU kernel _fwd_kernel_v2s): out [B, S, H] and the
// signed probs [B, heads, S, round_up(S, 16)] in the storage type, under the
// same dropout rule and seed as msa_short_attention_fwd.
extern "C" int msa_short_attention_probs_fwd(const void* q, const void* k,
                                             const void* v, const void* key_bias,
                                             void* out, void* probs, int batch,
                                             int seq, int hidden, int num_heads,
                                             int dtype, float scale,
                                             unsigned seed_lo, unsigned seed_hi,
                                             double drop_rate, void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* bias = static_cast<const float*>(key_bias);
  const float sm = scale * kLog2e;
  const Dropout d = make_dropout(seed_lo, seed_hi, drop_rate);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool drop = drop_rate > 0.0;
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    constexpr int kD = decltype(hd)::value;
    // f32 on the CUDA cores, bf16 on the tensor cores
#define MSA_PFWD(F, D) F<kD, D>(q, k, v, bias, out, probs, batch, seq, hidden, num_heads, sm, d, s)
#define MSA_PSIMT(D) \
  launch_probs_fwd<kD, D>(q, k, v, bias, out, probs, batch, seq, hidden, num_heads, sm, d, s)
    if (dtype == 0) {
      if (drop) MSA_PSIMT(true); else MSA_PSIMT(false);
      return (int)cudaGetLastError();
    }
    return drop ? MSA_PFWD(launch_probs_fwd_tc_for, true)
                : MSA_PFWD(launch_probs_fwd_tc_for, false);
#undef MSA_PSIMT
#undef MSA_PFWD
  });
}

// The '+probs' backward (TPU kernel _bwd_kernel_v2s) from q, k, v, the
// forward's signed probs and dout alone; drop_rate gives the rescale
// (dropout.cuh's scale).  bf16 at S <= 128 and head dims up to 128: one
// tensor-core launch (short_bwd_tc.cuh, p and the keep bit read from the
// probs; delta may be null).  Otherwise a pair, dq (writing delta, [B, heads, S] f32 scratch)
// then dk/dv: bf16 on the tensor cores (short_bwd_tiled.cuh), f32 on the
// CUDA cores.
extern "C" int msa_short_attention_probs_bwd(const void* q, const void* k,
                                             const void* v, const void* probs,
                                             const void* dout, void* delta, void* dq,
                                             void* dk, void* dv, int batch, int seq,
                                             int hidden, int num_heads, int dtype,
                                             float scale, double drop_rate,
                                             void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  float* dl = static_cast<float*>(delta);
  const Dropout d = make_dropout(0, 0, drop_rate);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    constexpr int kD = decltype(hd)::value;
#define MSA_PBWD(D) launch_probs_bwd<kD, D>(q, k, v, probs, dout, dl, dq, dk, dv, batch, seq, \
                                            hidden, num_heads, scale, d.scale, s)
    if (dtype == 1) {
      return tc_backward<kD, msa_short_bwd::kFromProbs>(
          q, k, v, nullptr, probs, nullptr, dout, dq, dk, dv, nullptr, dl, batch, seq, hidden,
          hidden, num_heads, scale, d, s);
    }
    if (dl == nullptr) return (int)cudaErrorInvalidValue;
    return d.active ? MSA_PBWD(true) : MSA_PBWD(false);
#undef MSA_PBWD
  });
}

// The keep mask the kernels above use, as a [B, heads, S, S] uint8 (0/1)
// tensor for the given seed and rate (0 < rate < 1).
extern "C" int msa_dropout_keep_mask(void* out, int batch, int num_heads,
                                     int seq, unsigned seed_lo,
                                     unsigned seed_hi, double drop_rate,
                                     void* stream) {
  if (seq <= 0 || batch <= 0 || num_heads <= 0 || !(drop_rate > 0.0) ||
      !msa_dropout::rate_ok(drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = batch * num_heads * seq;
  const long long work = (long long)rows * ((seq + kGroup - 1) / kGroup);
  const int threads = 256;
  const int blocks = (int)((work + threads - 1) / threads);
  dropout_keep_mask_kernel<<<blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), rows, seq,
      make_dropout(seed_lo, seed_hi, drop_rate));
  return (int)cudaGetLastError();
}
