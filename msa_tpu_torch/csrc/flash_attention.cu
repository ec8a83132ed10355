// Head-split flash attention, head dim 16, 32, 64, 128 or 256 (the source
// is built once a head dim, -DMSA_HEAD_DIM; f32 at 256 as in flash2.cu): the forward with in-kernel
// attention-probs dropout, then the backward as a pair of launches, dq (one
// CTA per query block) and dk/dv (one CTA per key block).
//
// Replaces the TPU kernels of msa_tpu/ops/attention.py (entry
// _flash_attention :265, the S >= 1024 route of multi_head_attention when
// _USE_FLASH2 is False): _flash_kernel (:117), _flash_dq_kernel (:171) and
// _flash_dkv_kernel (:211).  The same contract: q, k, v, the output and the
// gradients are [B, heads, S, d] (the caller splits and merges the heads),
// key_bias is an additive [B, S] f32 mask, the softmax runs in f32 and
// normalises every probability while dropout zeroes what reaches the PV
// product (out = acc / (l * (1 - rate))), the row lse is m + log(l) in
// natural-log units, [B, heads, S] f32, and the backward recomputes p from
// it, with delta = rowsum(dO o) read from the output in its own dtype, as
// _flash_dq_kernel and _flash_dkv_kernel read o_ref.  Under dropout dV
// takes the kept p unscaled, rounded, and its f32 sum times 1 / (1 - rate),
// as _flash_dkv_kernel orders it (:242-244).  No gradient flows to
// the bias or the seed.  Keys past S carry -inf, JAX's NEG_INF padding; any
// S >= 1.
//
// What bounds them on the H100: operations, as flash2's (4*S*S*d FLOPs a
// (batch, head) pair on 4*S*d elements: ~500 FLOPs per bf16 byte at S =
// 1024, above the ~295 at which the tensor cores are the limit; the pair
// recomputes S and dP in both launches, 7 tile products).  The kernels are
// flash2.cu's (flash_kernels.cuh) with the head-split layout: bf16 on
// Hopper's warpgroup products (wgmma; the forward one CTA per 128 query
// rows, warp-specialised at head dims 64 and 128 as flash2's, its tensor
// maps [B x heads, S, d]; the dq launch one CTA of two warpgroups per 128
// query rows (one per 64 under dropout), the dk/dv launch one warpgroup per
// 64 keys, every operand tile
// swizzled in shared memory, p and dS kept in registers as the next
// product's A operand; at head dim 256 the forward and the pair as
// flash2's), f32 on the CUDA cores, the
// softmax in registers in base 2 (the lse is converted to natural-log
// units at its store and back at its loads).  A head's rows are contiguous
// here (row stride 2d bytes in bf16), so each tile is one block of memory.
// Both TPU kernels sum delta for every tile they visit; here the dq launch
// sums it once a row and writes it to scratch for the dk/dv launch (the
// same values: each dk/dv block would otherwise re-read o for every query
// tile).
//
// Dropout: the rule of dropout.cuh, decided by (b, head, i, j) alone, so at
// one seed these kernels, flash2's and the short-attention kernels draw the
// same mask.  The TPU kernels seed their PRNG per (b, head, q block, k
// block) tile (_tile_id :113), so their mask depends on the block sizes;
// this one does not.  JAX's 512 x 512 blocks are a TPU VMEM tile and have no
// counterpart here.

#include "flash_kernels.cuh"

// dtype: 0 = float32, 1 = bfloat16.  drop_rate in [0, 1): 0 = no dropout,
// else the keep rule of dropout.cuh (the byte rule on the t/256 grid, the
// word rule off it).  The
// training forward passes lse ([B, heads, S] f32, natural-log units); the
// serving forward passes null.  head_dim: the library's (16, 32, 64, 128
// or 256; the wrappers zero-pad any other up to it).  Every entry launches
// on `stream` and returns cudaGetLastError() (0 on success).  The caller
// has checked shapes, contiguity and 16-byte alignment.
extern "C" int msa_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* key_bias, void* out, void* lse,
                                       int batch, int num_heads, int seq, int head_dim,
                                       int dtype, float scale, unsigned seed_lo,
                                       unsigned seed_hi, double drop_rate, void* stream) {
  const int hidden = num_heads * head_dim;
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* bias = static_cast<const float*>(key_bias);
  float* l = static_cast<float*>(lse);
  const float sm = scale * kLog2e;
  const Dropout d = make_dropout(seed_lo, seed_hi, drop_rate);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool drop = drop_rate > 0.0;
  return tc::by_head_dim(head_dim, [&](auto hd) {
    constexpr int kD = decltype(hd)::value;
#define MSA_FWD(D, W)                                                                      \
  launch_fwd_for<kD, true, D, W>(q, k, v, bias, out, l, nullptr, batch, seq, hidden, num_heads, \
                                 dtype, sm, d, s)
    if (drop) return l ? MSA_FWD(true, true) : MSA_FWD(true, false);
    return l ? MSA_FWD(false, true) : MSA_FWD(false, false);
#undef MSA_FWD
  });
}

// The backward pair on `stream`: dq (writing delta, [B, heads, S] f32
// scratch), then dk/dv.  out and lse are the training forward's outputs for
// the same q, k, v, key_bias, seed and rate.
extern "C" int msa_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* key_bias, const void* out,
                                       const void* dout, const void* lse, void* delta,
                                       void* dq, void* dk, void* dv, int batch,
                                       int num_heads, int seq, int head_dim, int dtype,
                                       float scale, unsigned seed_lo, unsigned seed_hi,
                                       double drop_rate, void* stream) {
  const int hidden = num_heads * head_dim;
  if (bad_args(batch, seq, hidden, num_heads, dtype, drop_rate)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* bias = static_cast<const float*>(key_bias);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const Dropout d = make_dropout(seed_lo, seed_hi, drop_rate);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool drop = drop_rate > 0.0;
  return tc::by_head_dim(head_dim, [&](auto hd) {
    constexpr int kD = decltype(hd)::value;
#define MSA_BWD(D)                                                                       \
  launch_split_for<kD, true, D>(q, k, v, bias, out, dout, l, dl, dq, dk, dv, batch, seq, hidden, \
                                num_heads, dtype, scale, d, s)
    return drop ? MSA_BWD(true) : MSA_BWD(false);
#undef MSA_BWD
  });
}
