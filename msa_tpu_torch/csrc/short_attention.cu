// Whole-sequence attention forward for short sequences (S < 1024, head dim 64).
//
// Replaces the TPU kernel msa_tpu/ops/short_attention.py::_fwd_kernel_v2
// (entry short_attention_v2), forward only and without dropout: q, k, v and
// the output ctx are [B, S, H] in natural layout, heads are sliced inside
// the kernel, key_bias is an additive [B, S] f32 mask, the softmax runs in
// f32 (base-2 fold: scores carry scale*log2e, exp2 replaces exp).
//
// What bounds it on the H100: bytes.  At the serving shapes (S = 40 / 80,
// d = 64) a (batch, head) pair does 4*S*S*d FLOPs on 4*S*d elements of
// q/k/v/o, i.e. S FLOPs per element -- far below the ~295 FLOP/byte the
// card needs before its tensor cores, rather than memory, are the limit.
// The design therefore aims at reading every q/k/v byte once and writing
// ctx once, and keeps the whole softmax on chip:
//
//   * one CTA per (query tile, head, batch row); a query tile holds up to
//     128 rows, so S <= 128 is one tile and K/V are read exactly once;
//   * two threads per query row, each owning half of the 64 head dims in
//     registers (q pre-scaled, plus the f32 output accumulator);
//   * K and V of the head are staged in shared memory as f32, 64 keys per
//     tile (32 KB), so S = 512 streams 8 tiles with an online softmax
//     instead of needing 256 KB of f32 K/V at once;
//   * scores are taken 16 keys at a time: one running-max update and one
//     rescale of the accumulator per 16 keys;
//   * the two threads of a row own interleaved 16-byte chunks, so their
//     shared-memory reads fall in different banks and global loads/stores
//     are 16-byte vectors.
//
// The TPU kernel's block-diagonal lane packing (_block_diag_rows) answers
// the TPU's 128-lane matrix unit and has no counterpart here.  The dot
// products run on the CUDA cores in f32; moving them to the tensor cores
// (mma.sync / wgmma) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kKeyTile = 64;    // keys staged in shared memory per tile
constexpr int kKeyChunk = 16;   // keys scored per online-softmax update
constexpr int kMaxRows = 128;   // query rows per CTA
constexpr int kMaxThreads = 2 * kMaxRows;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kKeyTile % kKeyChunk == 0, "chunks must tile the key tile");

// 16-byte vector loads/stores between global memory (storage type) and f32.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* src) {
  uint4 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = x;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
short_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ key_bias,
                           T* __restrict__ out, int seq, int hidden,
                           int rows_per_cta, float score_mult) {
  constexpr int kVec = 16 / sizeof(T);         // elements per 16-byte access
  constexpr int kChunks = kHeadDim / kVec;     // 16-byte chunks per head row
  constexpr int kOwn = kChunks / 2;            // chunks owned by each thread
  constexpr int kPart = kHeadDim / 2;          // head dims owned by each thread

  __shared__ __align__(16) float k_s[kKeyTile * kHeadDim];
  __shared__ __align__(16) float v_s[kKeyTile * kHeadDim];
  __shared__ float bias_s[kKeyTile];

  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * rows_per_cta + (threadIdx.x >> 1);
  const bool active = row < seq;
  const size_t head_base = (size_t)b * seq * hidden + (size_t)head * kHeadDim;

  // This thread's half of the query row, pre-scaled into the log2 domain.
  // Chunk u of the thread is the head row's chunk 2*u + half.
  float qr[kPart];
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    float tmp[kVec];
    if (active) {
      load16(q + head_base + (size_t)row * hidden + (2 * u + half) * kVec, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) qr[u * kVec + e] = tmp[e] * score_mult;
  }

  float acc[kPart];
#pragma unroll
  for (int i = 0; i < kPart; ++i) acc[i] = 0.f;
  float run_max = -INFINITY;
  float run_sum = 0.f;
  const float* bias_row = key_bias + (size_t)b * seq;

  for (int k0 = 0; k0 < seq; k0 += kKeyTile) {
    const int kn = min(kKeyTile, seq - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kn * kChunks; idx += blockDim.x) {
      const int j = idx / kChunks;
      const int c = idx - j * kChunks;
      const size_t off = head_base + (size_t)(k0 + j) * hidden + c * kVec;
      load16(k + off, &k_s[j * kHeadDim + c * kVec]);
      load16(v + off, &v_s[j * kHeadDim + c * kVec]);
    }
    for (int j = threadIdx.x; j < kn; j += blockDim.x) {
      bias_s[j] = bias_row[k0 + j] * kLog2e;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kn; j0 += kKeyChunk) {
      float s[kKeyChunk];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        const int j = j0 + jj;  // < kKeyTile: j0 <= kKeyTile - kKeyChunk
        float part = 0.f;
        if (j < kn) {  // uniform across the CTA
          const float* krow = &k_s[j * kHeadDim];
#pragma unroll
          for (int u = 0; u < kOwn; ++u) {
#pragma unroll
            for (int e = 0; e < kVec; e += 4) {
              const float4 kk =
                  *reinterpret_cast<const float4*>(krow + (2 * u + half) * kVec + e);
              const float* qq = &qr[u * kVec + e];
              part = fmaf(qq[0], kk.x, part);
              part = fmaf(qq[1], kk.y, part);
              part = fmaf(qq[2], kk.z, part);
              part = fmaf(qq[3], kk.w, part);
            }
          }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);  // join the two halves
        s[jj] = (j < kn) ? part + bias_s[j] : -INFINITY;
        chunk_max = fmaxf(chunk_max, s[jj]);
      }

      // Online softmax: chunk_max is finite (the chunk holds >= 1 key), so
      // new_max is too and exp2f(-inf - new_max) = 0 on the first chunk.
      const float new_max = fmaxf(run_max, chunk_max);
      const float corr = exp2f(run_max - new_max);
      run_sum *= corr;
#pragma unroll
      for (int i = 0; i < kPart; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        const int j = j0 + jj;
        if (j < kn) {
          const float p = exp2f(s[jj] - new_max);
          run_sum += p;
          const float* vrow = &v_s[j * kHeadDim];
#pragma unroll
          for (int u = 0; u < kOwn; ++u) {
#pragma unroll
            for (int e = 0; e < kVec; e += 4) {
              const float4 vv =
                  *reinterpret_cast<const float4*>(vrow + (2 * u + half) * kVec + e);
              float* aa = &acc[u * kVec + e];
              aa[0] = fmaf(p, vv.x, aa[0]);
              aa[1] = fmaf(p, vv.y, aa[1]);
              aa[2] = fmaf(p, vv.z, aa[2]);
              aa[3] = fmaf(p, vv.w, aa[3]);
            }
          }
        }
      }
      run_max = new_max;
    }
  }

  if (active) {
    const float inv = 1.f / run_sum;
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      float tmp[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) tmp[e] = acc[u * kVec + e] * inv;
      store16(out + head_base + (size_t)row * hidden + (2 * u + half) * kVec, tmp);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  The caller has checked shapes,
// contiguity, 16-byte alignment, head_dim == 64 and seq < 1024 (the
// kernel itself takes any seq: keys and queries are both tiled).
extern "C" int msa_short_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* key_bias,
                                       void* out, int batch, int seq,
                                       int hidden, int num_heads, int dtype,
                                       float scale, void* stream) {
  if (seq <= 0 || batch <= 0 || hidden != num_heads * kHeadDim) {
    return (int)cudaErrorInvalidValue;
  }
  // Balanced query tiles of at most kMaxRows rows, rounded to 16 rows
  // (8 warps at most; 16 rows = one warp).
  const int n_tiles = (seq + kMaxRows - 1) / kMaxRows;
  const int rows = ((seq + n_tiles - 1) / n_tiles + 15) / 16 * 16;
  const dim3 grid(n_tiles, num_heads, batch);
  const dim3 block(2 * rows);
  const float score_mult = scale * kLog2e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    short_attention_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(key_bias),
        static_cast<float*>(out), seq, hidden, rows, score_mult);
  } else if (dtype == 1) {
    short_attention_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(key_bias),
        static_cast<__nv_bfloat16*>(out), seq, hidden, rows, score_mult);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
