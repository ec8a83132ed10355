// The bf16 short-attention backward on the tensor cores, S <= 128, head dim
// kD = 16, 32, 64 or 128 (a template parameter): dq, dk and dv of one (head, batch
// row) in one launch, with no [S, S] tensor in device memory.  One template
// serves five TPU kernels of msa_tpu/ops/short_attention.py, which differ
// only in where p and delta come from (kRule) and in the row stride of q,
// k, v and their gradients:
//
//   * kRecompute: v1, _bwd_kernel (:177; short_attention_v1.cu) and v2,
//     _bwd_kernel_v2 (:336; short_attention.cu, msa_short_attention_bwd at
//     S <= 128): p recomputed from the scores, delta = rowsum(p * dpm)
//     (:216, :375), a quad sum over the score row in registers;
//   * kFromOut: v3, _bwd_kernel_v3 (:392; msa_short_attention_v3_bwd at S
//     <= 128) and v2p, _bwd_kernel_v2p (:505; msa_short_attention_packed_bwd
//     at S <= 128): p recomputed, delta = dO . o (:435-439, :544-548), o the
//     forward's ctx in bf16, read row by row.  It also writes each row's lse
//     (log2 units) and delta to the entry's [B, heads, S] scratch, which
//     nothing of this route reads again: the entries keep the pairs'
//     signatures;
//   * kFromProbs: v2s, _bwd_kernel_v2s (:895; msa_short_attention_probs_bwd
//     at S <= 128): p = |ps| and keep = ps > 0 from the forward's stashed
//     signed probs ([B, heads, S, 16 ceil(S / 16)] bf16), staged in place of
//     the score, softmax and Philox draws; delta = rowsum(p * dpm) (:925-929).
//     No key bias: the probs carry the mask.
//
// q, k, v, dq, dk and dv take the row stride ld: H for [B, S, H] tensors
// (v1, v2, v3, v2s), 3H for the thirds of one packed [B, S, 3H] qkv and
// dqkv (v2p).  o and dO are [B, S, H].  The scores are not rescaled from a
// forward's lse: each row's max and sum are recomputed here, as v1, v2, v3
// and v2p recompute their softmax, so those forwards keep nothing but
// their ctx.
//
// All round as the TPU kernels do: scores and dP accumulate in f32 from
// bf16 operands; dS = p (dpm - delta) and the dropped p are rounded to bf16
// before dQ = dS K, dK = dS^T Q and dV = pd^T dO.
//
// What bounds it on the H100: bytes (at S = 80 a (batch, head) pair does
// 10 * S * S * d FLOPs on 7-8 * S * d bf16 elements, ~100 FLOPs an
// element, far below the ~295 FLOPs a byte where the tensor cores would be
// the limit; v2s adds S * S bf16 probs and drops the scores' 2 S * S * d).
// So every operand is read once and nothing of size [S, S] leaves the SM:
//
//   * one CTA of kKT = ceil(S / 16) warps; Q, K, V and dO staged once in
//     bf16 by cp.async (rows of d + 8 values, zero-filled past S; v2s: also
//     the head's probs block into the pd tile); padded keys score -inf (not
//     the -10000 fill), so a fully masked row keeps its softmax;
//   * warp w owns query rows [16w, 16w + 16): the scores Q K^T (v2s: its
//     probs rows), the row max and sum, p, dP = dO V^T, the keep words, pd
//     and dpm live in its registers (two [16 x S] f32 rows); it writes pd
//     and dS as bf16 into two shared [16 kKT][16 kKT + 8] tiles (a row
//     stride of an odd multiple of 16 bytes: ldmatrix reads them
//     conflict-free) and forms dQ = dS K from its registers;
//   * after one __syncthreads warp w forms dK and dV rows [16w, 16w + 16) as
//     dS^T Q and pd^T dO over every query row (msa_mma::mma_tn), and stores
//     dq, dk and dv in 16-byte row vectors through its own K and V rows,
//     which no warp reads after the barrier.
//
// Query rows past S add nothing to dK and dV: their dO rows are zero, so
// dP, dpm, delta and dS vanish there, and their pd meets a zero dO row in
// pd^T dO.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "mma_tiles.cuh"

namespace msa_short_bwd {

namespace tc = msa_mma;
using bf16 = __nv_bfloat16;
using msa_dropout::Dropout;

constexpr int kMaxSeq = 128;  // 8 16-key tiles: a warp's score row in registers

// Where a backward takes p and delta from (see the header).
enum Rule : int { kRecompute = 0, kFromOut = 1, kFromProbs = 2 };

// Q, K, V and dO rows, the pd and dS tiles, the key bias, at kKT tiles.
template <int kD>
__host__ __device__ constexpr int tile_smem_bytes(int kKT) {
  return 4 * 16 * kKT * tc::kStride<kD> * (int)sizeof(bf16) +
         2 * 16 * kKT * (16 * kKT + 8) * (int)sizeof(bf16) + 16 * kKT * (int)sizeof(float);
}
template <int kD>
int smem_bytes(int seq) { return tile_smem_bytes<kD>((seq + 15) / 16); }

// The CTAs an SM holds by shared memory (228 KB, 1 KB reserved a CTA) at
// head dim 64, given to __launch_bounds__ so that ptxas may use the
// registers that occupancy leaves (its default picks fewer and spilled at
// 3-4 tiles).  At head dim 32 and 16 the same bound: the two score rows a
// warp holds do not shrink with d, so registers, not the smaller tiles,
// bound the CTAs (the d = 32 tiles' own count capped ptxas at 96-128
// registers and it spilled from 4 tiles).  At head dim 128 its own tiles,
// which hold fewer CTAs.
template <int kD>
__host__ __device__ constexpr int ctas_by_smem(int kKT) {
  return 233472 / (tile_smem_bytes<(kD > 64 ? kD : 64)>(kKT) + 1024);
}

// The head's probs rows [0, 16 kKT) (row stride 16 kKT, row 0 at src) into
// dst (row stride 16 kKT + 8) by every thread; rows >= seq zero-filled.
template <int kKT>
__device__ __forceinline__ void stage_probs(bf16* dst, const bf16* src, int seq) {
  constexpr int kPadded = 16 * kKT, kChunks = 2 * kKT;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < kPadded * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const bool ok = r < seq;
    tc::cp_async16(dst + r * (kPadded + 8) + ch * 8, src + (size_t)(ok ? r : 0) * kPadded +
                   ch * 8, ok);
  }
}

// kKT: 16-key tiles of the padded sequence (seq <= 16 kKT), one warp per 16
// query rows.  kRule: see the header.  o, lse and delta_out are read /
// written under kFromOut only, probs under kFromProbs only, key_bias
// otherwise.  q, k, v, dq, dk, dv at row stride ld; o and dout at hidden.
template <int kD, int kKT, bool kDropout, int kRule>
__global__ void __launch_bounds__(32 * kKT, ctas_by_smem<kD>(kKT))
short_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ key_bias,
                    const bf16* __restrict__ probs, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ lse,
                    float* __restrict__ delta_out, int seq, int ld, int hidden,
                    float score_mult, float scale, Dropout drop) {
  constexpr int kPadded = 16 * kKT;  // query rows and keys, padded
  constexpr int kN = 2 * kKT;        // 8-key column tiles of a score row
  constexpr int kLd = kPadded + 8;   // row stride of the pd and dS tiles
  constexpr int kStride = tc::kStride<kD>;
  constexpr bool kV3 = kRule == kFromOut, kProbs = kRule == kFromProbs;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kPadded * kStride;
  bf16* v_s = k_s + kPadded * kStride;
  bf16* do_s = v_s + kPadded * kStride;
  bf16* pd_s = do_s + kPadded * kStride;  // [query][key]; v2s: the probs first
  bf16* ds_s = pd_s + kPadded * kLd;      // [query][key]
  float* bias_s = reinterpret_cast<float*>(ds_s + kPadded * kLd);

  const int head = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = warp * 16;
  const int rows = seq - row0;  // this warp's rows below seq (>= 1)
  const size_t in_base = (size_t)b * seq * ld + (size_t)head * kD;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kD;  // o, dO
  const uint32_t row_base = ((uint32_t)b * gridDim.x + head) * (uint32_t)seq;

  // cp.async groups: Q and K (v2s: and the probs) | V | dO
  if constexpr (kProbs) {
    tc::stage_rows<kD>(q_s, q, in_base, ld, 0, kPadded, seq);
    tc::stage_rows<kD>(k_s, k, in_base, ld, 0, kPadded, seq);
    stage_probs<kKT>(pd_s, probs + (size_t)row_base * kPadded, seq);
    tc::cp_async_commit();
    tc::stage_rows<kD>(v_s, v, in_base, ld, 0, kPadded, seq);
    tc::cp_async_commit();
  } else {
    tc::stage_head<kD>(q_s, k_s, v_s, bias_s, q, k, v, key_bias + (size_t)b * seq, in_base,
                       ld, kPadded, seq);
  }
  tc::stage_rows<kD>(do_s, dout, base, hidden, 0, kPadded, seq);
  tc::cp_async_commit();

  // v3: lane l loads half l % 2 of o's row row0 + l / 2 while the rows land
  constexpr int kHalfVecs = kD / 16;  // 16-byte vectors in half a head row
  const int drow = row0 + (lane >> 1);
  uint4 ow[kHalfVecs];
  if constexpr (kV3) {
#pragma unroll
    for (int u = 0; u < kHalfVecs; ++u) {
      ow[u] = drow < seq ? *reinterpret_cast<const uint4*>(o + base + (size_t)drow * hidden +
                                                           (lane & 1) * (kD / 2) + u * 8)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  tc::cp_async_wait<2>();
  __syncthreads();  // Q, K and the bias (v2s: the probs)

  // s: p in the row's registers (v2s: signed by the keep bit)
  float s[kN][4];
  uint32_t keep[8] = {};
  if constexpr (kProbs) {
    const bf16* ps_row = pd_s + (row0 + g) * kLd + 2 * c;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ps_row + n * 8));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ps_row + 8 * kLd + n * 8));
      s[n][0] = lo.x;
      s[n][1] = lo.y;
      s[n][2] = hi.x;
      s[n][3] = hi.y;
    }
  } else {
    // Scores in the log2 domain, the row max and sum, p = e * (1 / sum).
    float mx[2], sum[2] = {0.f, 0.f};
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
    if constexpr (kV3) {
      if (c == 0 && g < rows) lse[row_base + row0 + g] = mx[0] + log2f(sum[0]);
      if (c == 0 && g + 8 < rows) lse[row_base + row0 + g + 8] = mx[1] + log2f(sum[1]);
    }
    sum[0] = 1.f / sum[0];
    sum[1] = 1.f / sum[1];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) s[n][x] *= sum[x >> 1];
    }
    if constexpr (kDropout) {
      const uint32_t prob_row = row_base + row0 + g;
      tc::keep_words_qmajor(drop, prob_row, 0, keep);
      if constexpr (kKT > 4) tc::keep_words_qmajor(drop, prob_row, 64, keep + 4);
    }
  }
  // the keep bit of column tile n, element x; p itself
  auto kept = [&](int n, int x) {
    if constexpr (kProbs) {
      return s[n][x] > 0.f;
    } else {
      return tc::kept_at(keep, n, x & 1, x >> 1);
    }
  };
  auto prob = [&](int n, int x) { return kProbs ? fabsf(s[n][x]) : s[n][x]; };

  tc::cp_async_wait<0>();
  __syncthreads();  // V and dO; every warp has read its probs rows

  // v3: delta = dO . o in f32 over the head row (the bf16 products are
  // exact), from o's half row in registers and dO's in shared memory; a
  // bf16 widens to f32 by a shift of its bits
  float delta[2];
  if constexpr (kV3) {
    const bf16* dor = do_s + drow * kStride + (lane & 1) * (kD / 2);
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < kHalfVecs; ++u) {
      const uint4 dw = *reinterpret_cast<const uint4*>(dor + u * 8);
      const uint32_t dws[4] = {dw.x, dw.y, dw.z, dw.w};
      const uint32_t ows[4] = {ow[u].x, ow[u].y, ow[u].z, ow[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part = fmaf(__uint_as_float(dws[e] << 16), __uint_as_float(ows[e] << 16), part);
        part = fmaf(__uint_as_float(dws[e] & 0xffff0000u),
                    __uint_as_float(ows[e] & 0xffff0000u), part);
      }
    }
    part += __shfl_xor_sync(tc::kFull, part, 1);
    if ((lane & 1) == 0 && drow < seq) delta_out[row_base + drow] = part;
    delta[0] = __shfl_sync(tc::kFull, part, 2 * g);
    delta[1] = __shfl_sync(tc::kFull, part, 2 * g + 16);
  }

  // dP = dO V^T, then dpm = the kept dP over 1 - rate, in place.
  float dp[kN][4];
  tc::mma_nt<kD, kN>(do_s, row0, v_s, dp);
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if constexpr (kDropout) dp[n][x] = kept(n, x) ? dp[n][x] * drop.scale : 0.f;
      if constexpr (!kV3) part[x >> 1] = fmaf(prob(n, x), dp[n][x], part[x >> 1]);
    }
  }
  if constexpr (!kV3) {
    delta[0] = tc::quad_sum(part[0]);
    delta[1] = tc::quad_sum(part[1]);
  }

  // pd and dS = p (dpm - delta) as bf16 into the shared tiles (rows g and
  // g + 8 of the warp's block); dS stays in s for dQ.
  bf16* pd_row = pd_s + (row0 + g) * kLd + 2 * c;
  bf16* ds_row = ds_s + (row0 + g) * kLd + 2 * c;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    float pd[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float p = prob(n, x);
      pd[x] = p;
      if constexpr (kDropout) pd[x] = kept(n, x) ? p * drop.scale : 0.f;
      s[n][x] = p * (dp[n][x] - delta[x >> 1]);
    }
    *reinterpret_cast<uint32_t*>(pd_row + n * 8) = tc::pack_bf16(pd[0], pd[1]);
    *reinterpret_cast<uint32_t*>(pd_row + 8 * kLd + n * 8) = tc::pack_bf16(pd[2], pd[3]);
    *reinterpret_cast<uint32_t*>(ds_row + n * 8) = tc::pack_bf16(s[n][0], s[n][1]);
    *reinterpret_cast<uint32_t*>(ds_row + 8 * kLd + n * 8) = tc::pack_bf16(s[n][2], s[n][3]);
  }

  // dQ = dS K (dS packed to bf16 as the A operand: the values of ds_s)
  float acc[tc::kNT<kD>][4];
#pragma unroll
  for (int n = 0; n < tc::kNT<kD>; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  tc::mma_nn<kD, kN>(s, k_s, acc);
  __syncthreads();  // pd_s and ds_s are whole; no warp reads K or V again

  bf16* stage_k = k_s + row0 * kStride;  // the warp's own K and V rows
  bf16* stage_v = v_s + row0 * kStride;
  const size_t out0 = in_base + (size_t)row0 * ld;
  tc::store_tile<kD>(acc, stage_k, dq + out0, ld, rows, scale);

  // dK rows [row0, row0 + 16) = dS[:, keys]^T Q, dV rows = pd[:, keys]^T dO
  tc::mma_tn<kD, kKT>(ds_s, kLd, row0, q_s, acc);
  tc::store_tile<kD>(acc, stage_v, dk + out0, ld, rows, scale);
  tc::mma_tn<kD, kKT>(pd_s, kLd, row0, do_s, acc);
  __syncwarp();  // every lane is done reading dq from stage_k
  tc::store_tile<kD>(acc, stage_k, dv + out0, ld, rows);
}

template <int kD, int kKT, bool kDropout, int kRule>
int launch_tiles(const void* q, const void* k, const void* v, const float* bias,
                 const void* probs, const void* o, const void* dout, void* dq, void* dk,
                 void* dv, float* lse, float* delta, int batch, int seq, int ld, int hidden,
                 int num_heads, float score_mult, float scale, Dropout drop, cudaStream_t s) {
  constexpr auto kernel = short_bwd_tc_kernel<kD, kKT, kDropout, kRule>;
  const int bytes = smem_bytes<kD>(seq);
  if (bytes > 48 * 1024) {  // above 48 KB of dynamic shared memory: opt in
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(num_heads, batch), 32 * kKT, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, static_cast<const bf16*>(probs), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), lse, delta, seq, ld, hidden, score_mult, scale, drop);
  return (int)cudaGetLastError();
}

// One launch for the 16-key tiles seq needs (1 .. 8); the caller has
// checked 0 < seq <= kMaxSeq.  bias: the key bias (null for kFromProbs);
// probs: v2s's stashed signed probs (null otherwise); o, lse and delta: the
// kFromOut rule's ctx and scratch (null otherwise).  ld: the row stride of
// q, k, v and of dq, dk, dv (hidden, or 3 * hidden for the thirds of a
// packed buffer).
template <int kD, bool kDropout, int kRule>
int launch(const void* q, const void* k, const void* v, const float* bias, const void* probs,
           const void* o, const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int batch, int seq, int ld, int hidden, int num_heads,
           float score_mult, float scale, Dropout drop, cudaStream_t s) {
#define MSA_TC(KT)                                                                        \
  case KT:                                                                                \
    return launch_tiles<kD, KT, kDropout, kRule>(q, k, v, bias, probs, o, dout, dq, dk,   \
                                                 dv, lse, delta, batch, seq, ld, hidden,  \
                                                 num_heads, score_mult, scale, drop, s)
  switch ((seq + 15) / 16) {
    MSA_TC(1); MSA_TC(2); MSA_TC(3); MSA_TC(4);
    MSA_TC(5); MSA_TC(6); MSA_TC(7); MSA_TC(8);
  }
#undef MSA_TC
  return (int)cudaErrorInvalidValue;
}

}  // namespace msa_short_bwd
