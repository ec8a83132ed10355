#!/usr/bin/env python3
"""Time variants of the bf16 short-attention kernels at head dim 256 on the
card: other designs of the tiled backward pair and the ring forwards.

    python3 scripts/short_variants.py [--parent ROOT] [NAME ...]

Each NAME is a preset of PRESETS: text substitutions in
``msa_tpu_torch/csrc/short_bwd_tiled.cuh`` (the script fails if one no
longer matches), copied into ``build/variants/NAME`` (git-ignored) and
built beside this tree (and the parent ROOT if given) as
``scripts/flash_variants.py`` does; each tree's ptxas report for the tiled
pair and the ring forwards is printed, then the trees are timed in turns
(parent, this tree, each variant, this tree, parent) by ``chip_smoke.py
--short-times`` and its line of the head-dim-256 entries at [192, 80]
(``time_wide_short``) printed.  Needs nvcc and a card.
"""

from __future__ import annotations

import sys
from pathlib import Path

from flash_variants import HERE, run_variants

KERNELS = Path("msa_tpu_torch") / "csrc" / "short_bwd_tiled.cuh"

# The dk/dv launch at d = 256 with the contraction of S^T = K Q^T and dP^T
# = V dO^T split between its two warpgroups (each 128 of the 256 columns)
# and the halves summed through two [64 x 64] f32 tiles of shared memory
# (v2s: one round, dP only; else two rounds and four barriers a tile), in
# place of each warpgroup forming both products whole.
_SPLIT_PRODUCTS = """        float s[kN][4], dp[kN][4];
        constexpr int kHalf = kDkvGroups<kD> == 2 ? kD / 32 : kD / 16;
        const int wgi = tid / wg::kGroupThreads, t = tid % wg::kGroupThreads;
        const int kk0 = kDkvGroups<kD> == 2 ? wgi * kHalf : 0;
        wg::fence();
        if constexpr (!kProbs) {
#pragma unroll
          for (int kk = 0; kk < kHalf; ++kk)
            wg::mma_ss<kTile, 0>(s, wg::desc_k<kD>(k_s, 0, kk0 + kk), wg::desc_k<kD>(qt, 0, kk0 + kk), kk);
        }
#pragma unroll
        for (int kk = 0; kk < kHalf; ++kk)
          wg::mma_ss<kTile, 0>(dp, wg::desc_k<kD>(v_s, 0, kk0 + kk), wg::desc_k<kD>(dot, 0, kk0 + kk), kk);
        wg::commit();"""
_SPLIT_SUM = """        wg::wait<0>();
        wg::fence_operand(s);
        wg::fence_operand(dp);
        if constexpr (kDkvGroups<kD> == 2) {
          auto put = [&](float* dst, float (&f)[kN][4]) {
#pragma unroll
            for (int n = 0; n < kN; ++n)
#pragma unroll
              for (int x = 0; x < 4; ++x) dst[(n * 4 + x) * wg::kGroupThreads + t] = f[n][x];
          };
          auto add = [&](const float* src, float (&f)[kN][4]) {
#pragma unroll
            for (int n = 0; n < kN; ++n)
#pragma unroll
              for (int x = 0; x < 4; ++x) f[n][x] += src[(n * 4 + x) * wg::kGroupThreads + t];
          };
          auto get = [&](const float* src, float (&f)[kN][4]) {
#pragma unroll
            for (int n = 0; n < kN; ++n)
#pragma unroll
              for (int x = 0; x < 4; ++x) f[n][x] = src[(n * 4 + x) * wg::kGroupThreads + t];
          };
          float* X = xch;
          float* Y = xch + kTile * kTile;
          if constexpr (kProbs) {
            put(wgi == 0 ? X : Y, dp);
            __syncthreads();
            if (wgi == 0) {
              add(Y, dp);
            } else {
              float mine2[kN][4];
              get(X, mine2);
              add(Y, mine2);  // dP_0 + dP_1 in both groups' order
#pragma unroll
              for (int n = 0; n < kN; ++n)
#pragma unroll
                for (int x = 0; x < 4; ++x) dp[n][x] = mine2[n][x];
            }
          } else {
            if (wgi == 0) put(X, dp); else put(Y, s);
            __syncthreads();
            if (wgi == 0) add(Y, s); else add(X, dp);
            __syncthreads();
            if (wgi == 0) put(X, s); else put(Y, dp);
            __syncthreads();
            if (wgi == 0) get(Y, dp); else get(X, s);
          }
        }
#pragma unroll
        for (int n = 0; n < kN; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n * 8 + 2 * c + e;"""
# The dq launch at d = 256 on two warpgroups, each holding 128 of dQ's
# columns and forming S and dP whole (group 0 writes the lse and delta).
_DQ_GROUPS2 = {
    """constexpr int kThreads = wg::kGroupThreads;  // the dq launch: one warpgroup
// Warpgroups of a dk/dv CTA, each holding kD / kDkvGroups of the columns
// of dK and dV and forming S^T and dP^T whole
template <int kD>
constexpr int kDkvGroups = kD == 256 ? 2 : 1;""":
        """// Warpgroups of a dq CTA, each holding kD / kDqGroups of the columns of
// dQ, and of a dk/dv CTA, each holding kD / kDkvGroups of those of dK and
// dV; every group forms the score tiles whole
template <int kD>
constexpr int kDqGroups = kD == 256 ? 2 : 1;
template <int kD>
constexpr int kDqThreads = kDqGroups<kD> * wg::kGroupThreads;
template <int kD>
constexpr int kDkvGroups = kD == 256 ? 2 : 1;""",
    """// c += F B for F [64 x 64] (A fragments) and B the 64 rows of tile b
// (MN-major: rows the contracted index), products of at most 128 columns;
// issued, then waited for.
template <int kD>
__device__ __forceinline__ void nn_wait(float (&c)[kD / 8][4], uint32_t (&f)[kN / 2][4],
                                        const unsigned char* b) {
  constexpr int kW = kD < 128 ? kD : 128;  // the N of one product""":
        """// c += F B[:, col0 .. col0 + kC) for F [64 x 64] (A fragments) and B the
// 64 rows of tile b (MN-major: rows the contracted index), products of at
// most 128 columns; issued, then waited for.
template <int kD, int kC>
__device__ __forceinline__ void nn_wait(float (&c)[kC / 8][4], uint32_t (&f)[kN / 2][4],
                                        const unsigned char* b, int col0) {
  constexpr int kW = kC < 128 ? kC : 128;  // the N of one product""",
    """    for (int h = 0; h < kD / kW; ++h) {
      wg::mma_rs<kW, 1>(wg::cols<kW / 8>(c, h), f[kk], wg::desc_mn<kD>(b, kk, h * kW), 1);
    }""":
        """    for (int h = 0; h < kC / kW; ++h) {
      wg::mma_rs<kW, 1>(wg::cols<kW / 8>(c, h), f[kk], wg::desc_mn<kD>(b, kk, col0 + h * kW),
                        1);
    }""",
    """// (kFromProbs) [B, heads, S, 16 ceil(S / 16)].
template <int kD, bool kDropout, int kRule>
__global__ void __launch_bounds__(kThreads, kDqMinBlocks<kD>)""":
        """// (kFromProbs) [B, heads, S, 16 ceil(S / 16)].  Warpgroup grp of the CTA
// forms the score tiles, the row lse and delta whole (grp 0 writes them)
// and holds columns [kC grp, kC (grp + 1)) of dQ.
template <int kD, bool kDropout, int kRule>
__global__ void __launch_bounds__(kDqThreads<kD>, kDqMinBlocks<kD>)""",
    """  constexpr int kT = tile_bytes<kD>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* do_s = wg::align_smem(smem_raw);""":
        """  constexpr int kT = tile_bytes<kD>();
  constexpr int kC = kD / kDqGroups<kD>;  // dQ columns a warpgroup
  constexpr int kThreads = kDqThreads<kD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* do_s = wg::align_smem(smem_raw);""",
    """  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int m0 = warp * 16;   // the warp's rows of the tile""":
        """  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int col0 = (tid / wg::kGroupThreads) * kC;  // the warpgroup's columns
  const bool writer = tid < wg::kGroupThreads;      // group 0 writes lse and delta
  const int m0 = warp * 16;   // the warp's rows of the tile""",
    """    if (c == 0 && row0 < seq) lse[row_base + row0] = l[0];
    if (c == 0 && row0 + 8 < seq) lse[row_base + row0 + 8] = l[1];""":
        """    if (writer && c == 0 && row0 < seq) lse[row_base + row0] = l[0];
    if (writer && c == 0 && row0 + 8 < seq) lse[row_base + row0 + 8] = l[1];""",
    """    if ((lane & 1) == 0 && drow < seq) delta_out[row_base + drow] = part;""":
        """    if (writer && (lane & 1) == 0 && drow < seq) delta_out[row_base + drow] = part;""",
    """    if (c == 0 && row0 < seq) delta_out[row_base + row0] = dl[0];
    if (c == 0 && row0 + 8 < seq) delta_out[row_base + row0 + 8] = dl[1];""":
        """    if (writer && c == 0 && row0 < seq) delta_out[row_base + row0] = dl[0];
    if (writer && c == 0 && row0 + 8 < seq) delta_out[row_base + row0 + 8] = dl[1];""",
    """  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;""":
        """  float acc[kC / 8][4];
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;""",
    """    nn_wait<kD>(acc, da, k_s + st * kT);
  });
  store_rows<kD>(dq + in_base, ld, row0, seq, acc, scale);""":
        """    nn_wait<kD, kC>(acc, da, k_s + st * kT, col0);
  });
  store_rows<kC>(dq + in_base + col0, ld, row0, seq, acc, scale);""",
    """  dq_kernel<<<grid, kThreads, dq_bytes, s>>>(""":
        """  dq_kernel<<<grid, kDqThreads<kD>, dq_bytes, s>>>(""",
}
PRESETS = {
    "dq_groups2": _DQ_GROUPS2,
    "dkv_split_k": {
        "  return kRule == kFromProbs\n             ? wg::kAlign + 5 * tile_bytes<kD>() + kProbsRing + 2 * kTile * 4":
            "  return (kRule == kFromProbs\n             ? wg::kAlign + 5 * tile_bytes<kD>() + kProbsRing + 2 * kTile * 4",
        "             : wg::kAlign + 6 * tile_bytes<kD>() + 4 * kTile * 4;\n}":
            "             : wg::kAlign + 6 * tile_bytes<kD>() + 4 * kTile * 4) +\n"
            "         (kD == 256 ? 2 * kTile * kTile * 4 + 2 * kTile * 4 : 0);\n}",
        "  float* lse_s = delta_s + 2 * kTile;  // [2], not v2s\n":
            "  float* lse_s = delta_s + 2 * kTile;  // [2], not v2s\n"
            "  float* xch = lse_s + 2 * kTile;      // kD = 256: [2][32][128] exchange\n",
        "        float s[kN][4], dp[kN][4];\n        wg::fence();\n"
        "        if constexpr (!kProbs) nt<kD>(s, k_s, qt);\n"
        "        nt<kD>(dp, v_s, dot);\n        wg::commit();": _SPLIT_PRODUCTS,
        "        wg::wait<0>();\n        wg::fence_operand(s);\n        wg::fence_operand(dp);\n"
        "#pragma unroll\n        for (int n = 0; n < kN; ++n) {\n#pragma unroll\n"
        "          for (int e = 0; e < 2; ++e) {\n            const int col = n * 8 + 2 * c + e;":
            _SPLIT_SUM},
}


def main() -> int:
    sys.path.insert(0, str(HERE))
    from msa_tpu_torch import _build

    return run_variants(sys.argv[1:], PRESETS, KERNELS, list(_build.KERNELS),
                        ["short_bwd_dq_kernel", "short_bwd_dkv_kernel",
                         "tc_long_kernel"],
                        "--short-times", "bf16 short entries at head dim 256")


if __name__ == "__main__":
    sys.exit(main())
