// The attention-probs dropout rule shared by every attention kernel of the
// port (short_attention.cu, flash2.cu), so that they all draw the same mask.
//
// The TPU kernels draw from the TPU's own PRNG, which cannot be reproduced
// here.  The port defines the keep decision of element (b, head, i, j) of
// the [B, heads, S, S] probabilities by its index and the seed alone, with
// Philox4x32-10 (Salmon et al., SC'11; the generator behind curand's
// Philox): key = the 64-bit seed, counter = (j / 16, (b * heads + head) * S
// + i, 0, 0); the four 32-bit outputs give 16 bytes, byte (j % 16) deciding
// key j: keep iff byte >= t, for the rate snapped to t/256 (four decisions
// per 32-bit draw, as the TPU kernel takes them).  Kept probabilities are
// scaled by 256 / (256 - t).  A kernel may tile the probabilities any way
// it likes and still compute the same mask; ops/dropout.py holds the same
// rule in plain PyTorch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace msa_dropout {

constexpr int kGroup = 16;  // keys decided by one Philox draw

struct Dropout {
  uint32_t key0, key1;  // the seed
  int threshold;        // t: keep iff byte >= t; 0 = no dropout
  float scale;          // 256 / (256 - t); 1 without dropout
};

// Philox4x32-10: 10 rounds, the key bumped between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
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

// Keep bits of the 16 keys [16 * group, 16 * group + 16) of probability row
// `row` ((b * heads + head) * S + i): bit jj set iff key 16*group + jj is kept.
__device__ __forceinline__ uint32_t keep_bits16(const Dropout& d, uint32_t group,
                                                uint32_t row) {
  const uint4 w = philox4x32_10(group, row, d.key0, d.key1);
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

inline Dropout make_dropout(unsigned seed_lo, unsigned seed_hi, int threshold) {
  Dropout d;
  d.key0 = seed_lo;
  d.key1 = seed_hi;
  d.threshold = threshold;
  d.scale = threshold > 0 ? 256.f / (float)(256 - threshold) : 1.f;
  return d;
}

}  // namespace msa_dropout
