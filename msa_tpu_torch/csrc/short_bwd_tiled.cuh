// The bf16 short-attention backward on the tensor cores, head dim kD = 16,
// 32, 64, 128 or 256 (a template parameter): above 128 keys (129 <= S <=
// 1023) at kD <= 128, and at every S (1 <= S <= 1023) at kD = 256, where
// the whole-row template of short_bwd_tc.cuh, which takes S <= 128 in one
// launch at kD <= 128, would hold a [16 x 256] f32 accumulator and its
// score rows in registers.  A dq launch and a dk/dv launch over 64-row
// tiles on Hopper's warpgroup MMA (wgmma_tiles.cuh), with no [S, S] tensor
// in device memory.  It serves the rules of short_bwd_tc.cuh (its Rule
// enum) for four TPU kernels of msa_tpu/ops/short_attention.py:
//
//   * kRecompute: v2, _bwd_kernel_v2 (:336; msa_short_attention_bwd): p =
//     exp2(s - lse) from the scores, the key bias and the row lse that the
//     training forward wrote; delta = rowsum(p * dpm) over the whole row
//     (:362-376), summed before any dS;
//   * kFromOut: v3, _bwd_kernel_v3 (:392; msa_short_attention_v3_bwd) and
//     v2p, _bwd_kernel_v2p (:505; msa_short_attention_packed_bwd, q, k, v
//     and their gradients at row stride 3H): the row lse recomputed from
//     the scores, delta = dO . o from the forward's bf16 ctx;
//   * kFromProbs: v2s, _bwd_kernel_v2s (:895;
//     msa_short_attention_probs_bwd): p = |ps| and keep = ps > 0 from the
//     forward's stashed signed probs ([B, heads, S, 16 ceil(S / 16)] bf16),
//     delta = rowsum(p * dpm).  No scores, key bias or Philox draws.
//
// All round as the TPU kernels do: scores and dP accumulate in f32 from
// bf16 operands; pd = keep p / (1 - rate) and dpm = keep dP / (1 - rate)
// (dropout.cuh's Philox rule, so the masks are the forward's and
// dropout_keep_mask's); dS = p (dpm - delta) and pd rounded to bf16 before
// dQ = dS K, dK = dS^T Q and dV = pd^T dO (the pack into the A fragment).
//
// What bounds it on the H100: from S ~ 470 the tensor cores (10 B S^2 H
// FLOPs against 7 B S H bf16 elements moved: at [32, 540, 1024] 0.0966 ms
// of FLOPs at 989 TFLOP/s against 0.0740 ms of bytes), below it the bytes.
// So every product is a warpgroup MMA, whose B operand (and A, where it is
// a staged tile) a warpgroup reads from swizzled shared memory once for
// its 64 rows -- a warp-level mma.sync form of this design re-read every
// B fragment in each of four warps and ran 1.5-2x slower, bound by those
// shared-memory reads -- and the CUDA-core pair's f32 dot products (67
// TFLOP/s) are gone.  Each launch reads its operands through a two-stage
// cp.async ring of 64-row tiles, one warpgroup (128 threads) a CTA, as
// flash_kernels.cuh's split backward (flash_bwd_dq_wg_kernel,
// flash_bwd_dkv_wg_kernel) does for rows 12 and 13; the short kernels keep
// their own contracts (the [B, S] key bias, the v2 delta rule, dropout
// scaled before the rounding, the probs source, row stride 3H):
//
//   * dq: a CTA per (64 query rows, head, batch row).  Q and dO staged
//     once; K, V and the key bias (v2s: V and the probs tile) swept in
//     64-key tiles.  Sweep 1 sums delta (v2: S and dP; v2s: dP and the
//     probs) or, for v3 / v2p, the online row max and sum of S (delta = dO
//     . o then); sweep 2 forms p, dP, the rounded dS and accumulates dQ +=
//     dS K.  delta (and v3 / v2p's lse) go to the [B, heads, S] f32 scratch
//     for the second launch;
//   * dk/dv: a CTA per (64 keys, head, batch row).  K and V (v2s: V)
//     staged once; Q, dO, the lse and delta (v2s: Q, dO, delta and the
//     probs tile) swept in 64-query tiles: S^T = K Q^T and dP^T = V dO^T
//     (v2s reads p^T from the probs tile by ldmatrix.trans), then dV +=
//     pd^T dO and dK += dS^T Q in registers, written once, no atomics.  The
//     keep words of a warp's 16 keys are one Philox draw per query: lane l
//     draws queries l and l + 32, and the quads take them by shuffles.
//
// At kD = 256 a row of a staged tile is four 128-byte swizzle atoms (a
// 64-row tile is 32 KB, six of them 192 KB of the 227 KB a CTA may take)
// and the accumulators of a 64-row CTA are 256 columns wide.  The dq
// launch keeps one warpgroup: dQ [64 x 256] f32 is 128 registers a thread
// beside the S and dP tiles' 64, and its products dQ += dS K are two of
// 128 columns (wgmma_tiles.cuh::cols).  The dk/dv launch takes two
// warpgroups (kDkvGroups), each holding 128 of the columns of dK and dV (2
// x [64 x 128] f32, 128 registers a thread, where the whole width would be
// 256) and forming S^T and dP^T whole for itself: those products over all
// 256 columns are done twice (1.5x the launch's products), at no shared
// memory and no barrier between the groups.  scripts/short_variants.py
// holds the alternatives that measured slower: the dq launch's dQ split
// over two warpgroups likewise, and the dk/dv contraction split between
// the groups and summed through shared memory.
//
// Warp w of the warpgroup holds rows 16 w + g and 16 w + g + 8 of every
// [64 x 64] tile, columns 8 n + 2 c + {0, 1} (mma.sync's accumulator
// layout), so the per-element code is short_bwd_tc.cuh's.  Ragged S: K and
// V rows past S are zero and their keys score -inf (the bias tile; not the
// -10000 fill, so a fully masked row keeps its softmax), so p = 0 there;
// query rows past S read lse = +inf (p = 0) and zero dO rows, so they add
// nothing to dK and dV.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "mma_tiles.cuh"
#include "short_bwd_tc.cuh"
#include "wgmma_tiles.cuh"

namespace msa_short_bwd_tiled {

namespace tc = msa_mma;
namespace wg = msa_wgmma;
using bf16 = __nv_bfloat16;
using msa_dropout::Dropout;
using msa_short_bwd::kFromOut;
using msa_short_bwd::kFromProbs;
using msa_short_bwd::kRecompute;

constexpr int kMinSeq = 129;   // kD <= 128; S <= 128: short_bwd_tc.cuh's one launch
constexpr int kMaxSeq = 1023;  // S >= 1024 runs the flash kernels
static_assert(kMinSeq == msa_short_bwd::kMaxSeq + 1, "the two templates meet");

constexpr int kTile = 64;                    // rows of a CTA's tile and of a ring tile
constexpr int kN = kTile / 8;                // 8-column tiles of a [64 x 64] score tile
constexpr int kPLd = kTile + 8;              // row stride of a probs tile (144 bytes)
constexpr int kThreads = wg::kGroupThreads;  // the dq launch: one warpgroup
// Warpgroups of a dk/dv CTA, each holding kD / kDkvGroups of the columns
// of dK and dV and forming S^T and dP^T whole
template <int kD>
constexpr int kDkvGroups = kD == 256 ? 2 : 1;
template <int kD>
constexpr int kDkvThreads = kDkvGroups<kD> * wg::kGroupThreads;
// CTAs an SM that ptxas fits the dq launch's registers to (168 a thread;
// at head dim 128, whose dQ accumulator alone takes 64, and 256, one CTA);
// the dk/dv launch, which holds two accumulators, names the threads only
template <int kD>
constexpr int kDqMinBlocks = kD >= 128 ? 1 : 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // dynamic shared memory an H100 CTA may take

template <int kD>
__host__ __device__ constexpr int tile_bytes() { return kTile * wg::kRowBytes<kD>; }
constexpr int kProbsRing = 2 * kTile * kPLd * 2;  // two stages of a probs tile

// The dq launch: Q (not v2s) and dO, two ring stages of K and V, and of the
// key bias (v2s: of the probs tile); aligned to a swizzle atom.
template <int kD, int kRule>
constexpr int dq_smem_bytes() {
  return kRule == kFromProbs ? wg::kAlign + 5 * tile_bytes<kD>() + kProbsRing
                             : wg::kAlign + 6 * tile_bytes<kD>() + 2 * kTile * 4;
}
// The dk/dv launch: K (not v2s) and V, two ring stages of Q and dO, of the
// lse (not v2s) and delta, and (v2s) of the probs tile.
template <int kD, int kRule>
constexpr int dkv_smem_bytes() {
  return kRule == kFromProbs
             ? wg::kAlign + 5 * tile_bytes<kD>() + kProbsRing + 2 * kTile * 4
             : wg::kAlign + 6 * tile_bytes<kD>() + 4 * kTile * 4;
}

// The key bias of keys [k0, k0 + 64) times log2e, -inf past seq.  By every
// thread of the CTA (kCta of them), as the copies below.
template <int kCta>
__device__ __forceinline__ void bias_tile(float* dst, const float* bias_row, int k0, int seq) {
  for (int j = threadIdx.x; j < kTile; j += kCta) {
    dst[j] = k0 + j < seq ? bias_row[k0 + j] * kLog2e : -INFINITY;
  }
}

// Rows [r0, r0 + 64) x keys [c0, c0 + 64) of a head's signed probs (row 0
// at src, row stride sp) into dst (row stride kPLd), asynchronously; rows
// past seq and 8-key chunks at or past sp zero-filled.
template <int kCta>
__device__ __forceinline__ void stage_probs(bf16* dst, const bf16* src, int sp, int r0, int c0,
                                            int seq) {
  for (int idx = threadIdx.x; idx < kTile * 8; idx += kCta) {
    const int r = idx >> 3, ch = idx & 7;
    const bool ok = r0 + r < seq && c0 + 8 * ch < sp;
    tc::cp_async16(dst + r * kPLd + 8 * ch, src + (ok ? (size_t)(r0 + r) * sp + c0 + 8 * ch : 0),
                   ok);
  }
}

// Entries [i0, i0 + 64) of a [S] f32 row (lse or delta) into dst,
// asynchronously; zero-filled past seq.
template <int kCta>
__device__ __forceinline__ void stage_stats(float* dst, const float* src, int i0, int seq) {
  for (int j = threadIdx.x; j < kTile; j += kCta) {
    const bool ok = i0 + j < seq;
    tc::cp_async4(dst + j, src + (ok ? i0 + j : 0), ok);
  }
}

// The two-stage ring: stage(st, r0) issues the copies of the tile of rows
// [r0, r0 + 64) into stage st; tile(st, r0) computes on it.  The caller
// has issued (uncommitted) the copies that must land with the first tile.
// Every thread fences its landed copies for the async proxy (wgmma's)
// before the barrier that publishes them.  Returns with every copy landed
// and every warp done with the ring.
template <class Stage, class Tile>
__device__ __forceinline__ void ring(int n_tiles, Stage&& stage, Tile&& tile) {
  stage(0, 0);
  tc::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // the next tile's copy overlaps this tile's math
      stage(st ^ 1, (t + 1) * kTile);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    wg::fence_proxy_async();
    __syncthreads();
    tile(st, t * kTile);
    __syncthreads();  // every warp is done with stage st
  }
}

// S = A B^T over kD (A the 64 rows of tile a, B the 64 rows of tile b),
// both K-major; the accumulator is overwritten.  Issued, not waited for.
template <int kD>
__device__ __forceinline__ void nt(float (&s)[kN][4], const unsigned char* a,
                                   const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wg::mma_ss<kTile, 0>(s, wg::desc_k<kD>(a, 0, kk), wg::desc_k<kD>(b, 0, kk), kk);
  }
}

// c += F B for F [64 x 64] (A fragments) and B the 64 rows of tile b
// (MN-major: rows the contracted index), products of at most 128 columns;
// issued, then waited for.
template <int kD>
__device__ __forceinline__ void nn_wait(float (&c)[kD / 8][4], uint32_t (&f)[kN / 2][4],
                                        const unsigned char* b) {
  constexpr int kW = kD < 128 ? kD : 128;  // the N of one product
  wg::fence_operand(c);
  wg::fence_operand(f);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
#pragma unroll
    for (int h = 0; h < kD / kW; ++h) {
      wg::mma_rs<kW, 1>(wg::cols<kW / 8>(c, h), f[kk], wg::desc_mn<kD>(b, kk, h * kW), 1);
    }
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_operand(c);
  wg::fence_operand(f);
}

// The pd and dpm of one element: keep ? p / (1 - rate) : 0 and the same of
// dP (dropout.cuh's scale 256 / (256 - t)).
template <bool kDropout>
__device__ __forceinline__ void drop_pair(bool kept, float scale, float& pd, float& dpm) {
  if constexpr (kDropout) {
    pd = kept ? pd * scale : 0.f;
    dpm = kept ? dpm * scale : 0.f;
  }
}

// A [64 x kC] accumulator's rows row0 and row0 + 8 (this lane's) times
// mult into out (its first column; row stride ld) as bf16 pairs; rows past
// seq skipped.
template <int kC>
__device__ __forceinline__ void store_rows(bf16* out, int ld, int row0, int seq,
                                           const float (&f)[kC / 8][4], float mult) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= seq) continue;
    bf16* p = out + (size_t)row * ld + 2 * c;
#pragma unroll
    for (int n = 0; n < kC / 8; ++n) {
      *reinterpret_cast<uint32_t*>(p + n * 8) =
          tc::pack_bf16(f[n][2 * r] * mult, f[n][2 * r + 1] * mult);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 1: dq, delta (and kFromOut's lse)
// ---------------------------------------------------------------------------

// q, k, v and dq at row stride ld; o and dout at hidden.  lse: kRecompute
// reads the training forward's, kFromOut writes the recomputed one (log2
// units); delta_out is written; key_bias (not kFromProbs) [B, S]; probs
// (kFromProbs) [B, heads, S, 16 ceil(S / 16)].
template <int kD, bool kDropout, int kRule>
__global__ void __launch_bounds__(kThreads, kDqMinBlocks<kD>)
short_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ key_bias,
                    const bf16* __restrict__ probs, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ lse,
                    float* __restrict__ delta_out, int seq, int ld, int hidden, float score_mult,
                    float scale, Dropout drop) {
  constexpr bool kV3 = kRule == kFromOut, kProbs = kRule == kFromProbs;
  constexpr int kT = tile_bytes<kD>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* do_s = wg::align_smem(smem_raw);
  unsigned char* k_s = do_s + kT;      // [2] ring stages
  unsigned char* v_s = k_s + 2 * kT;   // [2]
  unsigned char* q_s = v_s + 2 * kT;   // not v2s
  bf16* p_s = reinterpret_cast<bf16*>(q_s);            // v2s: [2][kTile][kPLd] in Q's place
  float* bias_s = reinterpret_cast<float*>(q_s + kT);  // [2][kTile], not v2s

  const int q0 = blockIdx.x * kTile, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int m0 = warp * 16;   // the warp's rows of the tile
  const int row0 = q0 + m0 + g;  // this lane's rows: row0, row0 + 8
  const size_t in_base = (size_t)b * seq * ld + (size_t)head * kD;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kD;  // o, dO
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const int sp = (seq + 15) / 16 * 16;  // the probs row stride
  const int n_tiles = (seq + kTile - 1) / kTile;

  if constexpr (!kProbs) wg::stage_rows<kD>(q_s, q, in_base, ld, q0, kTile, seq, tid, kThreads);
  wg::stage_rows<kD>(do_s, dout, base, hidden, q0, kTile, seq, tid, kThreads);

  // the ring stages: K (sweep 2, and v2 / v3's sweep 1), V (sweep 2, and
  // v2 / v2s's sweep 1), the bias or the probs
  auto stage_for = [&](bool with_k, bool with_v) {
    return [&, with_k, with_v](int st, int k0) {
      if (with_k) wg::stage_rows<kD>(k_s + st * kT, k, in_base, ld, k0, kTile, seq, tid, kThreads);
      if (with_v) wg::stage_rows<kD>(v_s + st * kT, v, in_base, ld, k0, kTile, seq, tid, kThreads);
      if constexpr (kProbs) {
        stage_probs<kThreads>(p_s + st * kTile * kPLd, probs + (size_t)row_base * sp, sp, q0,
                              k0, seq);
      } else {
        bias_tile<kThreads>(bias_s + st * kTile, key_bias + (size_t)b * seq, k0, seq);
      }
    };
  };

  // p of the ring tile in stage st (v2s: signed by the keep bit), rows g
  // and g + 8 of the warp's block
  auto probs_at = [&](int st, float (&s)[kN][4]) {
    const bf16* pr = p_s + st * kTile * kPLd + (m0 + g) * kPLd + 2 * c;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pr + n * 8));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pr + 8 * kPLd + n * 8));
      s[n][0] = lo.x;
      s[n][1] = lo.y;
      s[n][2] = hi.x;
      s[n][3] = hi.y;
    }
  };

  // lse (log2) and delta of this lane's rows
  float l[2], dl[2] = {0.f, 0.f};
  if constexpr (kRule == kRecompute) {
    l[0] = row0 < seq ? lse[row_base + row0] : INFINITY;
    l[1] = row0 + 8 < seq ? lse[row_base + row0 + 8] : INFINITY;
  }

  // S (not v2s) and dP of the ring tile in stage st: issued, then waited
  // for; S in the log2 domain with the bias
  auto products = [&](int st, bool with_s, bool with_dp, float (&s)[kN][4],
                      float (&dp)[kN][4]) {
    wg::fence();
    if (with_s) nt<kD>(s, q_s, k_s + st * kT);
    if (with_dp) nt<kD>(dp, do_s, v_s + st * kT);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(s);
    wg::fence_operand(dp);
    if (with_s) {
      const float* bias_t = bias_s + st * kTile;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bb = bias_t[n * 8 + 2 * c + e];
          s[n][e] = fmaf(s[n][e], score_mult, bb);
          s[n][2 + e] = fmaf(s[n][2 + e], score_mult, bb);
        }
      }
    }
  };

  // Sweep 1
  if constexpr (kV3) {
    // the online row max and sum of the scores
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    ring(n_tiles, stage_for(true, false), [&](int st, int) {
      float s[kN][4], unused[kN][4], mx[2];
      products(st, true, false, s, unused);
      tc::row_max<kN>(s, mx);  // every tile holds a key below seq: finite
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], mx[r]);
        l_run[r] *= exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          l_run[r] += exp2f(s[n][2 * r] - m_new) + exp2f(s[n][2 * r + 1] - m_new);
        }
      }
    });
    l[0] = m_run[0] + log2f(tc::quad_sum(l_run[0]));
    l[1] = m_run[1] + log2f(tc::quad_sum(l_run[1]));
    if (c == 0 && row0 < seq) lse[row_base + row0] = l[0];
    if (c == 0 && row0 + 8 < seq) lse[row_base + row0 + 8] = l[1];
    // delta = dO . o in f32 over the head row (the bf16 products are
    // exact): lane l sums half l % 2 of row m0 + l / 2 from device memory;
    // a bf16 widens to f32 by a shift of its bits
    const int drow = q0 + m0 + (lane >> 1);
    float part = 0.f;
    if (drow < seq) {
      const size_t off = base + (size_t)drow * hidden + (lane & 1) * (kD / 2);
#pragma unroll
      for (int u = 0; u < kD / 16; ++u) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + off + u * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + u * 8);
        const uint32_t ows[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t dws[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part = fmaf(__uint_as_float(dws[e] << 16), __uint_as_float(ows[e] << 16), part);
          part = fmaf(__uint_as_float(dws[e] & 0xffff0000u),
                      __uint_as_float(ows[e] & 0xffff0000u), part);
        }
      }
    }
    part += __shfl_xor_sync(tc::kFull, part, 1);
    if ((lane & 1) == 0 && drow < seq) delta_out[row_base + drow] = part;
    dl[0] = __shfl_sync(tc::kFull, part, 2 * g);
    dl[1] = __shfl_sync(tc::kFull, part, 2 * g + 16);
  } else {
    // delta = rowsum(p * dpm) over the whole row
    float part[2] = {0.f, 0.f};
    ring(n_tiles, stage_for(!kProbs, true), [&](int st, int k0) {
      float s[kN][4], dp[kN][4];
      uint32_t keep[4] = {};
      if constexpr (kProbs) {
        products(st, false, true, s, dp);
        probs_at(st, s);
      } else {
        products(st, true, true, s, dp);
        if constexpr (kDropout) tc::keep_words_qmajor(drop, row_base + row0, k0, keep);
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float p, dpm = dp[n][x];
          bool kept;
          if constexpr (kProbs) {
            p = fabsf(s[n][x]);
            kept = s[n][x] > 0.f;
          } else {
            p = exp2f(s[n][x] - l[x >> 1]);
            kept = tc::kept_at(keep, n, x & 1, x >> 1);
          }
          float pd = p;
          drop_pair<kDropout>(kept, drop.scale, pd, dpm);
          part[x >> 1] = fmaf(p, dpm, part[x >> 1]);
        }
      }
    });
    dl[0] = tc::quad_sum(part[0]);
    dl[1] = tc::quad_sum(part[1]);
    if (c == 0 && row0 < seq) delta_out[row_base + row0] = dl[0];
    if (c == 0 && row0 + 8 < seq) delta_out[row_base + row0 + 8] = dl[1];
  }

  // Sweep 2: dS = p (dpm - delta) rounded to bf16 (the A fragments' pack),
  // dQ += dS K
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  ring(n_tiles, stage_for(true, true), [&](int st, int k0) {
    float s[kN][4], dp[kN][4];
    uint32_t keep[4] = {};
    if constexpr (kProbs) {
      products(st, false, true, s, dp);
      probs_at(st, s);
    } else {
      products(st, true, true, s, dp);
      if constexpr (kDropout) tc::keep_words_qmajor(drop, row_base + row0, k0, keep);
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float p, dpm = dp[n][x];
        bool kept;
        if constexpr (kProbs) {
          p = fabsf(s[n][x]);
          kept = s[n][x] > 0.f;
        } else {
          p = exp2f(s[n][x] - l[x >> 1]);
          kept = tc::kept_at(keep, n, x & 1, x >> 1);
        }
        float pd = p;
        drop_pair<kDropout>(kept, drop.scale, pd, dpm);
        s[n][x] = p * (dpm - dl[x >> 1]);
      }
    }
    uint32_t da[kN / 2][4];
    wg::to_a(s, da);
    nn_wait<kD>(acc, da, k_s + st * kT);
  });
  store_rows<kD>(dq + in_base, ld, row0, seq, acc, scale);
}

// ---------------------------------------------------------------------------
// Launch 2: dk and dv
// ---------------------------------------------------------------------------

// lse (not kFromProbs) and delta [B, heads, S] f32 from the dq launch (v2:
// the training forward's lse).  dk and dv at row stride ld.  Warpgroup
// grp of the CTA forms S^T and dP^T whole and holds columns [kC grp, kC
// (grp + 1)) of dK and dV.
template <int kD, bool kDropout, int kRule>
__global__ void __launch_bounds__(kDkvThreads<kD>)
short_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ key_bias,
                     const bf16* __restrict__ probs, const bf16* __restrict__ dout,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, const float* __restrict__ lse,
                     const float* __restrict__ delta, int seq, int ld, int hidden,
                     float score_mult, float scale, Dropout drop) {
  constexpr bool kProbs = kRule == kFromProbs;
  constexpr int kT = tile_bytes<kD>();
  constexpr int kC = kD / kDkvGroups<kD>;  // dK and dV columns a warpgroup
  constexpr int kCtaThreads = kDkvThreads<kD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* v_s = wg::align_smem(smem_raw);
  unsigned char* q_s = v_s + kT;        // [2] ring stages
  unsigned char* do_s = q_s + 2 * kT;   // [2]
  unsigned char* k_s = do_s + 2 * kT;   // not v2s
  bf16* p_s = reinterpret_cast<bf16*>(k_s);  // v2s: [2][kTile][kPLd] in K's place
  float* delta_s = reinterpret_cast<float*>(kProbs ? k_s + kProbsRing : k_s + kT);  // [2]
  float* lse_s = delta_s + 2 * kTile;  // [2], not v2s

  const int key0 = blockIdx.x * kTile, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int col0 = kC == kD ? 0 : (tid / wg::kGroupThreads) * kC;  // the group's columns
  const int m0 = warp * 16;        // the warp's keys of the tile
  const int wk = key0 + m0;        // its first key of the sequence
  const size_t in_base = (size_t)b * seq * ld + (size_t)head * kD;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kD;  // dO
  const uint32_t row_base = ((uint32_t)b * gridDim.y + head) * (uint32_t)seq;
  const uint32_t grp = (uint32_t)wk / 16u;  // the warp's Philox group
  const int sp = (seq + 15) / 16 * 16;
  const int n_tiles = (seq + kTile - 1) / kTile;

  // this lane's keys wk + g and wk + g + 8 in the log2 domain
  float bias2[2] = {0.f, 0.f};
  if constexpr (!kProbs) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = wk + g + 8 * r;
      bias2[r] = key < seq ? key_bias[(size_t)b * seq + key] * kLog2e : -INFINITY;
    }
    wg::stage_rows<kD>(k_s, k, in_base, ld, key0, kTile, seq, tid, kCtaThreads);
  }
  wg::stage_rows<kD>(v_s, v, in_base, ld, key0, kTile, seq, tid, kCtaThreads);

  float dk_acc[kC / 8][4], dv_acc[kC / 8][4];
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
#pragma unroll
    for (int x = 0; x < 4; ++x) dk_acc[n][x] = dv_acc[n][x] = 0.f;
  }

  ring(
      n_tiles,
      [&](int st, int i0) {
        wg::stage_rows<kD>(q_s + st * kT, q, in_base, ld, i0, kTile, seq, tid, kCtaThreads);
        wg::stage_rows<kD>(do_s + st * kT, dout, base, hidden, i0, kTile, seq, tid, kCtaThreads);
        stage_stats<kCtaThreads>(delta_s + st * kTile, delta + row_base, i0, seq);
        if constexpr (kProbs) {
          stage_probs<kCtaThreads>(p_s + st * kTile * kPLd, probs + (size_t)row_base * sp, sp,
                                   i0, key0, seq);
        } else {
          stage_stats<kCtaThreads>(lse_s + st * kTile, lse + row_base, i0, seq);
        }
      },
      [&](int st, int i0) {
        const unsigned char* qt = q_s + st * kT;
        const unsigned char* dot = do_s + st * kT;
        const float* lt = lse_s + st * kTile;
        const float* dt = delta_s + st * kTile;
        // S^T and dP^T: rows = the tile's keys, columns = its queries
        float s[kN][4], dp[kN][4];
        wg::fence();
        if constexpr (!kProbs) nt<kD>(s, k_s, qt);
        nt<kD>(dp, v_s, dot);
        wg::commit();
        // keep bits of the warp's 16 keys for queries lane, lane + 32
        uint32_t mine = tc::kFull;
        if constexpr (kDropout && !kProbs) {
          mine = msa_dropout::keep_bits16(drop, grp, row_base + i0 + lane) |
                 (msa_dropout::keep_bits16(drop, grp, row_base + i0 + lane + 32) << 16);
        }
        if constexpr (kProbs) {
          // p^T of the stashed [query][key] tile by ldmatrix.trans: matrix
          // j of a load is column tile n0 + j / 2, key half j % 2
          const bf16* pt = p_s + st * kTile * kPLd;
          const int i = lane >> 3, rr = lane & 7;
#pragma unroll
          for (int n0 = 0; n0 < kN; n0 += 2) {
            uint32_t w4[4];
            tc::ldsm_x4_trans(w4, pt + (8 * (n0 + (i >> 1)) + rr) * kPLd + m0 + 8 * (i & 1));
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w4[j]));
              s[n0 + (j >> 1)][2 * (j & 1)] = f.x;
              s[n0 + (j >> 1)][2 * (j & 1) + 1] = f.y;
            }
          }
        }
        wg::wait<0>();
        wg::fence_operand(s);
        wg::fence_operand(dp);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n * 8 + 2 * c + e;
            const float dlv = dt[col];
            float lv = 0.f;
            uint32_t w = tc::kFull;
            if constexpr (!kProbs) {
              lv = i0 + col < seq ? lt[col] : INFINITY;  // p = 0 past seq
              if constexpr (kDropout) {
                w = __shfl_sync(tc::kFull, mine, (n & 3) * 8 + 2 * c + e) >> (16 * (n >> 2));
              }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int x = 2 * r + e;
              float p, dpm = dp[n][x];
              bool kept;
              if constexpr (kProbs) {
                p = fabsf(s[n][x]);
                kept = s[n][x] > 0.f;
              } else {
                p = exp2f(fmaf(s[n][x], score_mult, bias2[r]) - lv);
                kept = (w >> (g + 8 * r)) & 1u;
              }
              float pd = p;
              drop_pair<kDropout>(kept, drop.scale, pd, dpm);
              s[n][x] = p * (dpm - dlv);  // dS^T
              dp[n][x] = pd;              // pd^T
            }
          }
        }
        uint32_t pa[kN / 2][4], da[kN / 2][4];  // rounded to bf16, as JAX's
        wg::to_a(dp, pa);
        wg::to_a(s, da);
        wg::fence_operand(dv_acc);
        wg::fence_operand(dk_acc);
        wg::fence_operand(pa);
        wg::fence_operand(da);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < kN / 2; ++kk) {
          wg::mma_rs<kC, 1>(dv_acc, pa[kk], wg::desc_mn<kD>(dot, kk, col0), 1);  // dV += pd^T dO
        }
#pragma unroll
        for (int kk = 0; kk < kN / 2; ++kk) {
          wg::mma_rs<kC, 1>(dk_acc, da[kk], wg::desc_mn<kD>(qt, kk, col0), 1);   // dK += dS^T Q
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_operand(dv_acc);
        wg::fence_operand(dk_acc);
        wg::fence_operand(pa);
        wg::fence_operand(da);
      });

  store_rows<kC>(dk + in_base + col0, ld, wk + g, seq, dk_acc, scale);
  store_rows<kC>(dv + in_base + col0, ld, wk + g, seq, dv_acc, 1.f);
}

// The pair for kMinSeq <= seq <= kMaxSeq, and for 1 <= seq <= kMaxSeq at
// kD = 256 (the caller has checked it), with
// short_bwd_tc.cuh's launch's arguments: bias null for kFromProbs, probs
// null otherwise, o null unless kFromOut; lse the training forward's
// (kRecompute) or scratch (kFromOut; null for kFromProbs), delta scratch
// ([B, heads, S] f32).
template <int kD, bool kDropout, int kRule>
int launch(const void* q, const void* k, const void* v, const float* bias, const void* probs,
           const void* o, const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int batch, int seq, int ld, int hidden, int num_heads,
           float score_mult, float scale, Dropout drop, cudaStream_t s) {
  const dim3 grid((seq + kTile - 1) / kTile, num_heads, batch);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* pb = static_cast<const bf16*>(probs);
  const bf16* dob = static_cast<const bf16*>(dout);

  constexpr auto dq_kernel = short_bwd_dq_kernel<kD, kDropout, kRule>;
  constexpr int dq_bytes = dq_smem_bytes<kD, kRule>();
  static_assert(dq_bytes <= kMaxSmem && dkv_smem_bytes<kD, kRule>() <= kMaxSmem,
                "the tiles fit one CTA's shared memory");
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<grid, kThreads, dq_bytes, s>>>(qb, kb, vb, bias, pb, static_cast<const bf16*>(o),
                                             dob, static_cast<bf16*>(dq), lse, delta, seq, ld,
                                             hidden, score_mult, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr auto dkv_kernel = short_bwd_dkv_kernel<kD, kDropout, kRule>;
  constexpr int dkv_bytes = dkv_smem_bytes<kD, kRule>();
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<grid, kDkvThreads<kD>, dkv_bytes, s>>>(
      qb, kb, vb, bias, pb, dob, static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, delta, seq,
      ld, hidden, score_mult, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace msa_short_bwd_tiled
