// The bf16 short-attention forward on the tensor cores, S <= 128, head dim
// kD = 16, 32, 64 or 128 (a template parameter): one (head, batch row) a CTA, the
// whole score row of each query in registers.  One template serves the
// forwards of three TPU kernels of msa_tpu/ops/short_attention.py, which
// compute one function:
//
//   * v2, _fwd_kernel_v2 (:303; short_attention.cu, msa_short_attention_fwd):
//     q, k, v at row stride H; the training form (kTrain) also writes each
//     row's lse (log2 units);
//   * v2p, _fwd_kernel_v2p (:471; msa_short_attention_packed_fwd): the same
//     on the thirds of one packed [B, S, 3H] qkv, read at row stride 3H;
//   * v1, _fwd_kernel (:139; short_attention_v1.cu): the stride-H serving
//     form.
//
// Under autograd the v2 and v2p forwards run the serving form here: their
// backwards at S <= 128 (short_bwd_tc.cuh) recompute the row statistics,
// as JAX's do, so nothing of the forward but ctx is kept.  The training
// form's lse serves the checks (the backward pairs above 128 keys read
// the two-sweep forward's, in short_attention.cu).
//
// ctx ([B, S, H]) and lse ([B, heads, S]) never take the input stride.
// The rule is JAX's (:279-287, :326-332): the row max, the sum, p =
// exp2(s - max) / sum (a product with 1 / sum), the dropout (kept p times
// 256 / (256 - t)), then p rounded to bf16 in the pack that feeds P V
// (p.astype(v.dtype)), the product accumulated in f32 and rounded once to
// the bf16 ctx, so the serving and training forms give the same ctx bit
// for bit.
//
// What bounds it on the H100: bytes (at S = 80 a (batch, head) pair does
// 4 * S * S * d FLOPs on 4 * S * d bf16 elements, 80 FLOPs an element,
// far below the ~295 FLOPs a byte where the tensor cores would be the
// limit).  So every operand is read once and nothing of size [S, S] leaves
// the SM:
//
//   * kKT = ceil(S / 16) warps, one per 16 query rows; Q, K and V staged
//     once in bf16 by cp.async (rows of d + 8 values, zero-filled past S; V lands
//     during the softmax); padded keys score -inf (not the -10000 fill), so
//     a fully masked row keeps its softmax;
//   * S = Q K^T by mma.sync into registers (the whole row: S <= 128 keys is
//     16 n-tiles, 64 f32 a lane), max and sum by two quad shuffles each,
//     the keep words of dropout.cuh's rule for prob_row = (b * heads +
//     head) * S + row (so v1, v2, v2p, v2s and the keep-mask export draw
//     one mask at a seed), the dropped p packed to bf16 as the A operand
//     of P V;
//   * ctx stored in 16-byte row vectors through the warp's own Q rows; the
//     lse, before P V, by the lanes that hold rows g and g + 8 (c == 0).
//
// __launch_bounds__ names the threads only: the CTAs shared memory allows
// (6 at 5 tiles) would cap a thread at 64-68 registers, below the score
// row and the accumulator it holds (the backward's bound, short_bwd_tc.cuh,
// names them: its shared tiles allow fewer CTAs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "mma_tiles.cuh"

namespace msa_short_fwd {

namespace tc = msa_mma;
using bf16 = __nv_bfloat16;
using msa_dropout::Dropout;

constexpr int kMaxSeq = 128;  // 8 16-key tiles: a warp's score row in registers

// Q, K and V rows and the key bias, at kKT tiles.
template <int kD>
__host__ __device__ constexpr int tile_smem_bytes(int kKT) {
  return 3 * 16 * kKT * tc::kStride<kD> * (int)sizeof(bf16) + 16 * kKT * (int)sizeof(float);
}

// The training output of a warp's rows [0, rows): lse[g] = lse0 and
// lse[g + 8] = lse1 from the lanes with c == 0.
__device__ __forceinline__ void store_lse(float lse0, float lse1, float* lse, int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  if (c == 0) {
    if (g < rows) lse[g] = lse0;
    if (g + 8 < rows) lse[g + 8] = lse1;
  }
}

// kKT: 16-key tiles of the padded sequence (seq <= 16 kKT).  q, k, v at row
// stride ld; out [B, S, hidden]; lse [B, heads, S], written under kTrain
// only.
template <int kD, int kKT, bool kDropout, bool kTrain>
__global__ void __launch_bounds__(32 * kKT)
short_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ key_bias,
                    bf16* __restrict__ out, float* __restrict__ lse, int seq, int ld,
                    int hidden, float score_mult, Dropout drop) {
  constexpr int kPadded = 16 * kKT;  // query rows and keys, padded
  constexpr int kN = 2 * kKT;        // 8-key column tiles of a score row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kPadded * tc::kStride<kD>;
  bf16* v_s = k_s + kPadded * tc::kStride<kD>;
  float* bias_s = reinterpret_cast<float*>(v_s + kPadded * tc::kStride<kD>);

  const int head = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const size_t in_base = (size_t)b * seq * ld + (size_t)head * kD;
  const size_t out_base = (size_t)b * seq * hidden + (size_t)head * kD;
  const uint32_t row_base = ((uint32_t)b * gridDim.x + head) * (uint32_t)seq;

  tc::stage_head<kD>(q_s, k_s, v_s, bias_s, q, k, v, key_bias + (size_t)b * seq, in_base, ld,
                 kPadded, seq);  // V lands during the softmax
  tc::cp_async_wait<1>();
  __syncthreads();

  // Scores in the log2 domain; keys past seq are -inf, so every row's max
  // is finite.
  float s[kN][4], mx[2], sum[2] = {0.f, 0.f};
  tc::mma_nt<kD, kN>(q_s, row0, k_s, s);
  tc::scores_log2<kN>(s, bias_s, score_mult);
  tc::row_max<kN>(s, mx);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      s[n][x] = exp2f(s[n][x] - mx[x >> 1]);
      sum[x >> 1] += s[n][x];
    }
  }
  sum[0] = tc::quad_sum(sum[0]);
  sum[1] = tc::quad_sum(sum[1]);
  const int rows = seq - row0;  // this warp's rows below seq (>= 1)
  [[maybe_unused]] const float lse_lo = mx[0] + log2f(sum[0]);
  [[maybe_unused]] const float lse_hi = mx[1] + log2f(sum[1]);
  // where the lse goes out is ptxas's business: each placement but this
  // one (d = 32) and the one after the keep words (d = 64) left a 4-8 byte
  // spill at 3-5 tiles in one of the widths (chip_smoke.py's ptxas check)
  if constexpr (kTrain && kD == 32) store_lse(lse_lo, lse_hi, lse + row_base + row0, rows);
  // one division a row: p = e * (1 / sum)
  sum[0] = 1.f / sum[0];
  sum[1] = 1.f / sum[1];
  uint32_t keep[8] = {};
  if constexpr (kDropout) {
    const uint32_t prob_row = row_base + row0 + (lane >> 2);
    tc::keep_words_qmajor(drop, prob_row, 0, keep);
    if constexpr (kKT > 4) tc::keep_words_qmajor(drop, prob_row, 64, keep + 4);
  }
  if constexpr (kTrain && kD != 32) store_lse(lse_lo, lse_hi, lse + row_base + row0, rows);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float p = s[n][x] * sum[x >> 1];
      if constexpr (kDropout) {
        s[n][x] = tc::kept_at(keep, n, x & 1, x >> 1) ? p * drop.scale : 0.f;
      } else {
        s[n][x] = p;
      }
    }
  }

  tc::cp_async_wait<0>();
  __syncthreads();  // V has landed; every warp is done with its Q rows
  float acc[tc::kNT<kD>][4];
#pragma unroll
  for (int n = 0; n < tc::kNT<kD>; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  tc::mma_nn<kD, kN>(s, v_s, acc);

  // ctx through the warp's own Q rows, out in 16-byte row vectors
  const size_t out0 = out_base + (size_t)row0 * hidden;
  tc::store_tile<kD>(acc, q_s + row0 * tc::kStride<kD>, out + out0, hidden, rows);
}

template <int kD, int kKT, bool kDropout, bool kTrain>
int launch_tiles(const void* q, const void* k, const void* v, const float* bias, void* out,
                 float* lse, int batch, int seq, int ld, int hidden, int num_heads,
                 float score_mult, Dropout drop, cudaStream_t s) {
  constexpr auto kernel = short_fwd_tc_kernel<kD, kKT, kDropout, kTrain>;
  constexpr int bytes = tile_smem_bytes<kD>(kKT);
  if (bytes > 48 * 1024) {  // above 48 KB of dynamic shared memory: opt in
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(num_heads, batch), 32 * kKT, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<bf16*>(out), lse, seq, ld, hidden, score_mult, drop);
  return (int)cudaGetLastError();
}

// One launch for the 16-key tiles seq needs (1 .. 8); the caller has
// checked 0 < seq <= kMaxSeq.  lse: the training output (written under
// kTrain only).
template <int kD, bool kDropout, bool kTrain>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
           float* lse, int batch, int seq, int ld, int hidden, int num_heads,
           float score_mult, Dropout drop, cudaStream_t s) {
#define MSA_TC(KT)                                                                 \
  case KT:                                                                         \
    return launch_tiles<kD, KT, kDropout, kTrain>(q, k, v, bias, out, lse, batch,    \
                                                  seq, ld, hidden, num_heads,         \
                                                  score_mult, drop, s)
  switch ((seq + 15) / 16) {
    MSA_TC(1); MSA_TC(2); MSA_TC(3); MSA_TC(4);
    MSA_TC(5); MSA_TC(6); MSA_TC(7); MSA_TC(8);
  }
#undef MSA_TC
  return (int)cudaErrorInvalidValue;
}

}  // namespace msa_short_fwd
