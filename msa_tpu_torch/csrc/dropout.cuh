// The attention-probs dropout rule shared by every attention kernel of the
// port (short_attention.cu, flash2.cu), so that they all draw the same mask.
//
// The TPU kernels draw from the TPU's own PRNG, which cannot be reproduced
// here.  The port defines the keep decision of element (b, head, i, j) of
// the [B, heads, S, S] probabilities by its index and the seed alone, with
// Philox4x32-10 (Salmon et al., SC'11; the generator behind curand's
// Philox), key = the 64-bit seed, row = (b * heads + head) * S + i, by one
// of two rules that the rate picks (JAX's _keep_mask takes the same two):
//
//   * the byte rule, a rate on the t/256 grid: counter = (j / 16, row, 0,
//     0); the four 32-bit outputs give 16 bytes, byte (j % 16) deciding key
//     j: keep iff byte >= t (four decisions per 32-bit draw, as the TPU
//     kernel takes them).  Kept probabilities are scaled by 256 / (256 - t);
//   * the word rule, any other rate in (0, 1): counter = (j / 4, row, 1, 0)
//     (the third word keeps its stream apart from the byte rule's); word
//     (j % 4) decides key j: keep iff word >= min(floor(rate * 2^32),
//     2^32 - 1).  Kept probabilities are scaled by 1 / (1 - rate) in f32.
//
// Every kernel draws through keep_bits16, the bits of 16 consecutive keys:
// one draw under the byte rule, four under the word rule.  The word rule
// is a runtime branch to a function kept out of line (keep_bits16_word):
// inlined, its loop cost the byte rule's kernels registers, and ptxas
// spilled 4-52 bytes in eight tensor-core kernels at head dims 32 and 64;
// out of line none spills.  A kernel may tile the probabilities any way it likes and still
// compute the same mask; ops/dropout.py holds the same rules in plain
// PyTorch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace msa_dropout {

constexpr int kGroup = 16;  // keys decided by one Philox draw

struct Dropout {
  uint32_t key0, key1;  // the seed
  int threshold;        // the byte rule's t: keep iff byte >= t; 0 otherwise
  uint32_t word;        // the word rule's threshold
  bool by_word;         // the word rule (a rate off the t/256 grid)
  float scale;          // 256 / (256 - t) or 1 / (1 - rate); 1 without dropout
  bool active;          // rate > 0
};

// Philox4x32-10: 10 rounds, the key bumped between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                               uint32_t k0, uint32_t k1) {
  uint32_t c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The word rule's bits of keys [16 * group, 16 * group + 16) of row `row`:
// four draws, counter (4 * group + w, row, 1, 0), word (jj % 4) of draw
// (jj / 4) deciding key jj.
__device__ __noinline__ uint32_t keep_bits16_word(const Dropout& d, uint32_t group,
                                                  uint32_t row) {
  uint32_t bits = 0u;
#pragma unroll 1
  for (int w4 = 0; w4 < 4; ++w4) {
    const uint4 w = philox4x32_10(4u * group + (uint32_t)w4, row, 1u, d.key0, d.key1);
    const uint32_t four = (w.x >= d.word ? 1u : 0u) | (w.y >= d.word ? 2u : 0u) |
                          (w.z >= d.word ? 4u : 0u) | (w.w >= d.word ? 8u : 0u);
    bits |= four << (4 * w4);
  }
  return bits;
}

// Keep bits of the 16 keys [16 * group, 16 * group + 16) of probability row
// `row` ((b * heads + head) * S + i): bit jj set iff key 16*group + jj is kept.
__device__ __forceinline__ uint32_t keep_bits16(const Dropout& d, uint32_t group,
                                                uint32_t row) {
  if (d.by_word) return keep_bits16_word(d, group, row);
  const uint4 w = philox4x32_10(group, row, 0u, d.key0, d.key1);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  const uint32_t t = (uint32_t)d.threshold;
  uint32_t bits = 0u;
#pragma unroll
  for (int jj = 0; jj < kGroup; ++jj) {
    const uint32_t byte = (words[jj >> 2] >> (8 * (jj & 3))) & 0xFFu;
    bits |= (byte >= t ? 1u : 0u) << jj;
  }
  return bits;
}

// Whether a C entry takes the rate: any rate in [0, 1).
inline bool rate_ok(double rate) { return rate >= 0.0 && rate < 1.0; }

// The rule of `rate` (in [0, 1)): the byte rule on the t/256 grid, else the
// word rule (ops/dropout.py: on_grid, word_threshold).
inline Dropout make_dropout(unsigned seed_lo, unsigned seed_hi, double rate) {
  Dropout d;
  d.key0 = seed_lo;
  d.key1 = seed_hi;
  d.threshold = 0;
  d.word = 0u;
  d.by_word = false;
  d.scale = 1.f;
  d.active = rate > 0.0;
  if (!d.active) return d;
  const double t = rate * 256.0;  // exact: a power of two
  if (t == floor(t)) {
    d.threshold = (int)t;
    d.scale = 256.f / (float)(256 - d.threshold);
  } else {
    const double w = floor(rate * 4294967296.0);
    d.word = w >= 4294967295.0 ? 0xFFFFFFFFu : (uint32_t)w;
    d.by_word = true;
    d.scale = (float)(1.0 / (1.0 - rate));
  }
  return d;
}

}  // namespace msa_dropout
