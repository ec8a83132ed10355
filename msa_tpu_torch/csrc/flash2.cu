// Blockwise attention for long sequences (the frame-level path, S >= 1024;
// the kernels take any S >= 1), head dim 16, 32, 64, 128 or 256 (the source
// is built once a head dim, -DMSA_HEAD_DIM; f32 at 256 is refused here and
// run on short_attention.cu's CUDA-core kernels by the wrappers): the forward with in-kernel
// attention-probs dropout, the fused single-sweep backward and the split
// backward (dq, then dk/dv).
//
// Replaces the TPU kernels of msa_tpu/ops/flash2.py (entry
// flash_attention2): _fwd_kernel (:121), _bwd_fused_kernel (:355), and the
// split pair _dq_kernel (:224) + _dkv_kernel (:283).  The same contract:
// q, k, v, the output and the gradients are [B, S, H] in natural layout
// (heads are sliced inside the kernels), key_bias is an additive [B, S] f32
// mask, the softmax runs in f32 in base 2 (scores carry scale * log2e, exp2
// replaces exp, the row lse is stored in log2 units; the backward formulas
// are unchanged in natural units, so dq and dk scale by the natural
// 1/sqrt(d)), no gradient flows to the bias or the seed.
//
// What bounds them on the H100: operations.  A (batch, head) pair does
// 4*S*S*d forward FLOPs on 4*S*d elements of q/k/v/o: at S = 1024,
// ~1,000 FLOPs per element, ~500 per bf16 byte, above the ~295 FLOPs per
// byte at which the tensor cores rather than memory are the limit.  The
// split backward recomputes S and dP in both of its launches: 7 tile
// products where the fused route does 5.  So the bf16 products run on the
// tensor cores, the forward and both backwards on Hopper's warpgroup
// products (wgmma, wgmma_tiles.cuh; the fused backward from head dim 64),
// which read B (and A where it is a staged tile) straight from shared
// memory: the ldmatrix fragment traffic that bound the mma.sync form of
// these kernels is gone.
//
//   * forward (rows 10, 13): one CTA per 128 query rows of a (head, batch
//     row), two consumer warpgroups of 64 rows looping over key tiles.  Per
//     tile a warpgroup takes S = Q K^T (Q and K from shared memory), the
//     online softmax on the accumulator in registers, p rounded to bf16 and
//     O += P V (P from registers, V an MN-major tile).  At head dims 64 and
//     128 the CTA is warp-specialised (flash_fwd_ws_kernel): a producer
//     warpgroup with few registers keeps the tensor memory accelerator
//     filling a ring of three stages of K, V, the key bias and the dropout
//     keep words, and the consumers, with the registers it gave up, take
//     turns at their products and issue the next tile's S before this
//     tile's P V, so that softmax and products overlap within and across
//     warpgroups (128-key tiles at 64, 64-key tiles at 128).  At 16, 32 and
//     256 every thread copies 64-key tiles into a two-stage cp.async ring,
//     one block barrier a tile (flash_fwd_wg_kernel; at 256 under dropout
//     with the next tile's S issued before this tile's P V,
//     flash_fwd_wg_overlap_kernel).  For training the forward also writes
//     the row lse ([B, heads, S] f32, log2 units) and the output in f32
//     (delta = rowsum(dO o) reads it: the bf16-rounded output would put
//     2^-9 of |dO.o| into every ds);
//   * split backward (row 12), two launches, no atomics: the dq launch
//     (one CTA of two warpgroups per 128 query rows, one per 64 under
//     dropout, key tiles of 64 in a two-stage ring; at head dim 256 one
//     warpgroup per 64 rows over a one-stage ring of 32-key tiles, two
//     CTAs an SM; delta = rowsum(dO o) once a row from device memory,
//     written to scratch; per tile S = Q K^T and dP = dO V^T from shared
//     memory, p and dS in registers, dQ += dS K with dS as the A
//     fragment) and the dk/dv
//     launch (one warpgroup per 64 keys, query tiles of 64 in a ring of q,
//     dO, lse and delta; S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO
//     and dK += dS^T Q with P^T and dS^T as A fragments: no shared-memory
//     dS tile).  At head dim 256, where one warpgroup cannot hold dK and
//     dV for 64 keys, the dk/dv CTA is two warpgroups split by role: one
//     forms S^T, p and dV, the other dP^T, dS^T (p from the first through
//     shared memory, in f32) and dK;
//   * fused backward, bf16 (row 11, flash-attention-2's backward): a
//     pre-pass launch takes delta = rowsum(dO o) once per row and zeroes a
//     [B, S, H] f32 dq scratch; then one sweep per (block of keys, head,
//     batch row) over query tiles of 64 in a cp.async ring recomputes S^T
//     = K Q^T, p = exp2(s - lse) and the dropout mask once and feeds all
//     three gradients from them: dV += P^T dO and dK += dS^T Q from
//     registers, dS^T through a shared tile (bf16) into dQ = dS K, summed
//     into the scratch, which the wrapper casts (flash_kernels.cuh says
//     more): 5 products a tile, where the split pair takes 7.  From head
//     dim 64 the sweep is flash2_bwd_fused_wg_kernel on wgmma (two
//     warpgroups of 64 keys a CTA at 64 and 128, dQ reduced into the
//     scratch by the tensor memory accelerator; at 256 two on 64 keys,
//     each holding half the columns of dK and dV, dQ by atomics); at 16 and
//     32, where it measured faster, flash2_bwd_fused_kernel on mma.sync
//     (4 warps of 32 keys, dQ by atomics).  The reductions change the
//     summation order from run to run: dq agrees with a fixed order to f32
//     rounding of its partial sums.
//
// f32 inputs (the tests and the f32 checks) run the earlier design on the
// CUDA cores in full f32 (SimtF32: 64-row blocks of 4 warps; the fused
// route's sweep takes delta per tile and adds dq by 8-byte atomics) in the
// same fragment layout, so the softmax, masking, dropout and lse code is
// shared.
//
// Under dropout the backwards fold 1 / (1 - rate) into the staged dO tile,
// rounded to the storage type, after delta = rowsum(dO o) is taken from
// the unscaled dO, and round the kept p unscaled: dP and dV arrive
// pre-scaled, as in JAX's _dq_kernel, _dkv_kernel and _bwd_fused_kernel.
//
// Dropout: the rule of dropout.cuh, so these kernels, the short-attention
// kernels and ops/dropout.py agree on every keep decision.  A thread that
// holds a [16 x 64] fragment needs 4 of the 16 bytes of each Philox draw it
// touches; the draws are spread over the lanes that share them and
// exchanged by shuffles, so each is computed once per warp.
//
// The TPU kernels' block-diagonal lane packing (two d = 64 heads per
// 128-lane group) answers the TPU's 128-lane matrix unit; here each CTA
// takes one head.  Their block sizes (bq = 256, bk = 1024) are VMEM-sized;
// here tiles are 64 or 128 rows, sized by registers and shared memory.
//
// The kernels live in flash_kernels.cuh, which flash_attention.cu (the
// head-split flash attention of row 13) shares; this file instantiates
// them for the natural layout (kHeadSplit = false).

#include "flash_kernels.cuh"

// dtype: 0 = float32, 1 = bfloat16.  drop_rate in [0, 1): 0 = no dropout,
// else the keep rule of dropout.cuh (the byte rule on the t/256 grid, the
// word rule off it).  The
// training forward passes lse ([B, heads, S] f32, the log2-sum-exp of each
// score row) and, for bf16, out32 ([B, S, H] f32, the output before its
// rounding; null for f32, whose out is that already); the serving forward
// passes both null.  The head dim hidden / num_heads is the library's
// (16, 32, 64, 128 or 256; the wrappers zero-pad any other up to it).  Every
// entry launches on `stream` and returns cudaGetLastError() (0 on
// success).  The caller has checked shapes, contiguity and 16-byte
// alignment.
extern "C" int msa_flash2_fwd(const void* q, const void* k, const void* v,
                              const void* key_bias, void* out, void* lse, void* out32,
                              int batch, int seq, int hidden, int num_heads, int dtype,
                              float scale, unsigned seed_lo, unsigned seed_hi,
                              double drop_rate, void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* bias = static_cast<const float*>(key_bias);
  float* l = static_cast<float*>(lse);
  float* o32 = static_cast<float*>(out32);
  const float sm = scale * kLog2e;
  const Dropout d = make_dropout(seed_lo, seed_hi, drop_rate);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool drop = drop_rate > 0.0;
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    constexpr int kD = decltype(hd)::value;
#define MSA_FWD(D, W)                                                                   \
  launch_fwd_for<kD, false, D, W>(q, k, v, bias, out, l, o32, batch, seq, hidden, num_heads, \
                                  dtype, sm, d, s)
    if (drop) return l ? MSA_FWD(true, true) : MSA_FWD(true, false);
    return l ? MSA_FWD(false, true) : MSA_FWD(false, false);
#undef MSA_FWD
  });
}

// The fused backward: two launches, the pre-pass (delta = rowsum(dO o32)
// into `delta`, [B, heads, S] f32 scratch, and dq32, a [B, S, H] f32
// buffer, zeroed), then the sweep writing dk and dv and adding dq (times
// the scale) into dq32.  o32 (the output in f32) and lse are the training
// forward's outputs for the same q, k, v, key_bias, seed and rate.
extern "C" int msa_flash2_bwd_fused(const void* q, const void* k, const void* v,
                                    const void* key_bias, const void* o32, const void* dout,
                                    const void* lse, void* delta, void* dq32, void* dk,
                                    void* dv, int batch, int seq, int hidden, int num_heads,
                                    int dtype, float scale, unsigned seed_lo,
                                    unsigned seed_hi, double drop_rate, void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* bias = static_cast<const float*>(key_bias);
  const float* o = static_cast<const float*>(o32);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* dq = static_cast<float*>(dq32);
  const Dropout d = make_dropout(seed_lo, seed_hi, drop_rate);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool drop = drop_rate > 0.0;
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    constexpr int kD = decltype(hd)::value;
#define MSA_FUSED(D)                                                                   \
  launch_fused<kD, D>(q, k, v, bias, o, dout, l, dl, dq, dk, dv, batch, seq, hidden, \
                      num_heads, dtype, scale, d, s)
    return drop ? MSA_FUSED(true) : MSA_FUSED(false);
#undef MSA_FUSED
  });
}

// The split backward: dq (writing delta, [B, heads, S] f32 scratch), then
// dk/dv, both on `stream`.
extern "C" int msa_flash2_bwd_split(const void* q, const void* k, const void* v,
                                    const void* key_bias, const void* o32, const void* dout,
                                    const void* lse, void* delta, void* dq, void* dk,
                                    void* dv, int batch, int seq, int hidden, int num_heads,
                                    int dtype, float scale, unsigned seed_lo,
                                    unsigned seed_hi, double drop_rate, void* stream) {
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* bias = static_cast<const float*>(key_bias);
  const float* o = static_cast<const float*>(o32);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const Dropout d = make_dropout(seed_lo, seed_hi, drop_rate);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool drop = drop_rate > 0.0;
  return tc::by_head_dim(tc::head_dim_of(hidden, num_heads), [&](auto hd) {
    constexpr int kD = decltype(hd)::value;
#define MSA_SPLIT(D)                                                                       \
  launch_split_for<kD, false, D>(q, k, v, bias, o, dout, l, dl, dq, dk, dv, batch, seq, hidden, \
                                 num_heads, dtype, scale, d, s)
    return drop ? MSA_SPLIT(true) : MSA_SPLIT(false);
#undef MSA_SPLIT
  });
}
