// Fused joint embedding: per batch row, out[0:L] = LN(text_emb) and
// out[L:L+Lp] = LN(relu(feats @ W + b)), written as one [L+Lp, H] block.
//
// Replaces the TPU kernel msa_tpu/ops/fused_joint_embed.py::_kernel (entry
// fused_joint_embed).  As there, the projection and the LayerNorm run in
// f32 and the output is stored in the compute dtype; W, b and the LN
// scale/bias arrive in f32.
//
// What bounds it on the H100: bytes.  Each output row reads one H-wide text
// row or one D-wide frame (D <= 1024) and writes one H-wide row; the
// projection is 2*D*H FLOPs a frame row, under 1 FLOP per byte of the rows
// it touches at the datasets' D (35-371).  The TPU kernel keeps the
// projection and the concatenation out of HBM; so does this one, in one
// launch whose CTAs split by blockIdx.x into two kinds:
//
//   * text CTAs: a team of lanes per row (a warp, or 8 / 16 lanes where H
//     is small, so a warp holds 4 or 2 rows at the tiny preset's H = 64),
//     16-byte loads and stores, the row held in registers for the
//     two-pass variance (jnp.var's), reductions by warp shuffles only: no
//     __syncthreads;
//   * frame CTAs, first in the grid (they run longest; the text CTAs fill
//     in around them): a tile of R consecutive rows of the flattened
//     [B*Lp] frame index (tiles cross batch rows; the tail tile is
//     masked).  The features are staged in shared memory 64 at a time;
//     each thread owns kRPT rows x 4 columns of the projection in
//     registers, and the threads of one chunk of 4 columns (one per row
//     group) sit side by side in a warp, so each W element is read from L2
//     once per CTA (float4 __ldg): W, [D, H] f32, once per R rows instead
//     of once per row.  The projection stays an f32 FMA on the CUDA cores,
//     summed over the features in order.  The relu'd rows go to shared
//     memory [R, H] f32, and teams of lanes take their LayerNorm as the
//     text CTAs do.
//
// Tile shapes by H: at 509 <= H <= 1024, R = 16 rows of 16 a thread (x 4
// columns: 64 accumulators); else 4 rows a thread and R = 4 x (256 / (H /
// 4)) rows, at most 64 (H = 64; above H = 1024, R = 4 in two rounds over
// the columns).  2 CTAs an SM: at 1 (146 registers) it ran 30 % slower,
// at 3 (80 registers) it spilled; 2 columns a thread, a W prefetch a step
// ahead, 32-row tiles of 512 threads and a cp.async ring for W (a barrier
// every 4 rows of W) were all slower or no faster on the H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHidden = 2048;
constexpr int kMaxFeat = 1024;
constexpr int kMaxVals = kMaxHidden / 32;  // row values a lane holds: 64
constexpr unsigned kFull = 0xffffffffu;
constexpr int kKC = 64;                    // features staged per round
constexpr int kKCP = kKC + 4;              // their row stride in floats
constexpr int kSmemLimit = 232448;         // the H100's shared memory a CTA may take

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// kVec consecutive values as f32: eight in 16-byte vectors (the row and
// the pointer 16-byte aligned), or one.
template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (kVec == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    x[0] = *p;
  }
}
template <int kVec>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* x) {
  if constexpr (kVec == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    x[0] = __bfloat162float(*p);
  }
}
template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float* y) {
  if constexpr (kVec == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(y[4], y[5], y[6], y[7]);
  } else {
    *p = y[0];
  }
}
template <int kVec>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* y) {
  if constexpr (kVec == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *p = __float2bfloat16_rn(y[0]);
  }
}

// Sum over a team of `lanes` lanes (a power of two <= 32, aligned within
// the warp).  Every lane of the warp calls it.
__device__ __forceinline__ float team_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// LayerNorm of one H-wide row by a team of `lanes` lanes (this lane is tl
// of them): src is a row of text (global, T) or of relu'd projections
// (shared, f32), dst its output row.  Lane tl takes the vectors tl, tl +
// lanes, ... of kVec = 8 values each and holds them in registers for the
// two-pass variance (kVec = 1 reads src again for each pass).  Every lane
// of the warp calls it; `live` is false for a team without a row.
template <int kVec, typename S, typename T>
__device__ __forceinline__ void ln_row(const S* src, T* dst, bool live, int tl, int lanes,
                                       int hidden, const float* __restrict__ gamma,
                                       const float* __restrict__ beta, float eps) {
  if constexpr (kVec == 1) {  // no 16-byte vectors: three passes over src
    float sum = 0.f, sq = 0.f;
    for (int i = tl; live && i < hidden; i += lanes) sum += to_f32(src[i]);
    const float mean = team_sum(sum, lanes) / hidden;
    for (int i = tl; live && i < hidden; i += lanes) {
      const float d = to_f32(src[i]) - mean;
      sq = fmaf(d, d, sq);
    }
    const float rstd = rsqrtf(team_sum(sq, lanes) / hidden + eps);
    for (int i = tl; live && i < hidden; i += lanes) {
      const float y = (to_f32(src[i]) - mean) * rstd * gamma[i] + beta[i];
      store_vec<1>(dst + i, &y);
    }
    return;
  }
  constexpr int kN = kMaxVals / kVec;  // 8-value vectors a lane may hold
  const int nvec = hidden / kVec;
  float x[kN][kVec];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int vi = tl + i * lanes;
    if (live && vi < nvec) {
      load_vec<kVec>(src + vi * kVec, x[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum += x[i][j];
    }
  }
  const float mean = team_sum(sum, lanes) / hidden;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int vi = tl + i * lanes;
    if (live && vi < nvec) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = x[i][j] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rstd = rsqrtf(team_sum(sq, lanes) / hidden + eps);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int vi = tl + i * lanes;
    if (live && vi < nvec) {
      float gm[kVec], bt[kVec], y[kVec];
      load_vec<kVec>(gamma + vi * kVec, gm);
      load_vec<kVec>(beta + vi * kVec, bt);
#pragma unroll
      for (int j = 0; j < kVec; ++j) y[j] = (x[i][j] - mean) * rstd * gm[j] + bt[j];
      store_vec<kVec>(dst + vi * kVec, y);
    }
  }
}

struct Shape {
  int batch, text_len, pair_len, feat_dim, hidden;
  int lanes;        // lanes of a row's team
  int tile_rows;    // R: frame rows of a frame CTA
  int frame_ctas;   // CTAs [0, frame_ctas) take frame tiles, the rest text
  float eps;
};

// kVec: 8 when H % 8 == 0 and every pointer is 16-byte aligned (16-byte
// row vectors, float4 reads of W), else 1.  kRPT: the frame rows of a
// thread's projection accumulators (x 4 columns).  2 CTAs an SM: 128
// registers.
template <typename T, int kVec, int kRPT>
__global__ void __launch_bounds__(kThreads, 2)
fused_joint_embed_kernel(const T* __restrict__ text, const T* __restrict__ feats,
                         const float* __restrict__ w, const float* __restrict__ b,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         T* __restrict__ out, Shape sh) {
  const int hidden = sh.hidden, lanes = sh.lanes;
  const int rows_out = sh.text_len + sh.pair_len;
  const int lane = threadIdx.x & 31;
  const int team = (threadIdx.x >> 5) * (32 / lanes) + lane / lanes;  // within the CTA
  const int tl = lane & (lanes - 1);
  const int teams = kWarps * (32 / lanes);

  if ((int)blockIdx.x >= sh.frame_ctas) {  // uniform across the CTA: a row a team
    const long long row = (long long)(blockIdx.x - sh.frame_ctas) * teams + team;
    const bool live = row < (long long)sh.batch * sh.text_len;
    const long long r = live ? row : 0;
    const long long bi = r / sh.text_len, l = r - bi * sh.text_len;
    ln_row<kVec>(text + r * hidden, out + (bi * rows_out + l) * hidden, live, tl, lanes,
                 hidden, gamma, beta, sh.eps);
    return;
  }

  extern __shared__ __align__(16) float smem[];
  const int tile_rows = sh.tile_rows;
  const int groups = tile_rows / kRPT;
  // feat_s: [R][kKCP] with row group rg shifted by 4 rg floats (its float4
  // reads then fall in other banks than its neighbour group's); row_s [R][H]
  float* feat_s = smem;
  float* row_s = smem + tile_rows * kKCP + 4 * groups;
  const long long n_frames = (long long)sh.batch * sh.pair_len;
  const long long f0 = (long long)blockIdx.x * tile_rows;
  const int feat_dim = sh.feat_dim;

  // The projection: items of kRPT rows x 4 columns, (column chunk, row
  // group) with the row group fastest, so the threads that share a chunk of
  // W sit in one warp and read it in one request; dealt round-robin, every
  // thread running every round (barriers).
  const int nch = (hidden + 3) / 4;
  const int items = groups * nch;
  const int rounds = (items + kThreads - 1) / kThreads;
  for (int round = 0; round < rounds; ++round) {
    const int item = threadIdx.x + round * kThreads;
    const bool active = item < items;
    const int chunk = active ? item / groups : 0;
    const int rg = active ? item - chunk * groups : 0;
    const int col = chunk * 4;
    float acc[kRPT][4];
#pragma unroll
    for (int r = 0; r < kRPT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    for (int k0 = 0; k0 < feat_dim; k0 += kKC) {
      __syncthreads();  // the previous round's features are read
      for (int e = threadIdx.x; e < tile_rows * kKC; e += kThreads) {
        const int r = e / kKC, kk = e - r * kKC;
        const long long f = f0 + r;
        const bool ok = f < n_frames && k0 + kk < feat_dim;
        feat_s[r * kKCP + (r / kRPT) * 4 + kk] =
            ok ? to_f32(feats[f * feat_dim + k0 + kk]) : 0.f;
      }
      __syncthreads();
      if (!active) continue;
      const int kn = min(kKC, feat_dim - k0);
      const float* fr = feat_s + rg * (kRPT * kKCP + 4);
      for (int kk = 0; kk < kn; kk += 4) {
        float wv[4][4];  // W rows k0 + kk .. +3, columns col .. col + 3 (0 past D)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + kk + j;
          const float* wr = w + (size_t)min(k, feat_dim - 1) * hidden + col;
          if constexpr (kVec == 8) {
            const float4 v4 = __ldg(reinterpret_cast<const float4*>(wr));
            wv[j][0] = v4.x; wv[j][1] = v4.y; wv[j][2] = v4.z; wv[j][3] = v4.w;
          } else {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) wv[j][cc] = col + cc < hidden ? __ldg(wr + cc) : 0.f;
          }
          if (k >= feat_dim) wv[j][0] = wv[j][1] = wv[j][2] = wv[j][3] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
          const float4 f4 = *reinterpret_cast<const float4*>(fr + r * kKCP + kk);
          const float fv[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(fv[j], wv[j][cc], acc[r][cc]);
          }
        }
      }
    }
    if (active) {
      float bb[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) bb[cc] = col + cc < hidden ? b[col + cc] : 0.f;
#pragma unroll
      for (int r = 0; r < kRPT; ++r) {
        float* dst = row_s + (rg * kRPT + r) * hidden + col;
        const float v[4] = {fmaxf(acc[r][0] + bb[0], 0.f), fmaxf(acc[r][1] + bb[1], 0.f),
                            fmaxf(acc[r][2] + bb[2], 0.f), fmaxf(acc[r][3] + bb[3], 0.f)};
        if constexpr (kVec == 8) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            if (col + cc < hidden) dst[cc] = v[cc];
          }
        }
      }
    }
  }
  __syncthreads();

  // The LayerNorm of the tile's rows, a team a row.
  const int per_team = (tile_rows + teams - 1) / teams;  // uniform: shuffles
  for (int it = 0; it < per_team; ++it) {
    const int r = team + it * teams;
    const long long f = f0 + r;
    const bool live = r < tile_rows && f < n_frames;
    const long long ff = live ? f : 0;
    const long long bi = ff / sh.pair_len, j = ff - bi * sh.pair_len;
    ln_row<kVec>(row_s + (live ? r : 0) * hidden,
                 out + (bi * rows_out + sh.text_len + j) * hidden, live, tl, lanes, hidden,
                 gamma, beta, sh.eps);
  }
}

template <typename T, int kVec, int kRPT>
int launch(const void* text, const void* feats, const float* w, const float* b,
           const float* gamma, const float* beta, void* out, const Shape& sh, int grid,
           cudaStream_t s) {
  constexpr auto kernel = fused_joint_embed_kernel<T, kVec, kRPT>;
  const long long bytes =
      4LL * (sh.tile_rows * (kKCP + sh.hidden) + 4 * (sh.tile_rows / kRPT));
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  static long long opted = 48 * 1024;  // the largest tile this instantiation has taken
  if (bytes > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted = bytes;
  }
  kernel<<<grid, kThreads, (size_t)bytes, s>>>(static_cast<const T*>(text), static_cast<const T*>(feats),
                                       w, b, gamma, beta, static_cast<T*>(out), sh);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (text, feats and out share it; w, b,
// gamma, beta are f32).  Launches on `stream` and returns cudaGetLastError().
// The caller has checked shapes, contiguity, hidden <= 2048 and
// feat_dim <= 1024.
extern "C" int msa_fused_joint_embed(const void* text, const void* feats,
                                     const void* w, const void* b,
                                     const void* gamma, const void* beta,
                                     void* out, int batch, int text_len,
                                     int pair_len, int feat_dim, int hidden,
                                     float eps, int dtype, void* stream) {
  if (batch <= 0 || text_len < 0 || pair_len < 0 || text_len + pair_len <= 0 ||
      hidden <= 0 || hidden > kMaxHidden || feat_dim <= 0 || feat_dim > kMaxFeat ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec8 = hidden % 8 == 0 && aligned16(text) && aligned16(feats) && aligned16(w) &&
                    aligned16(b) && aligned16(gamma) && aligned16(beta) && aligned16(out);
  const int per_lane = vec8 ? 8 : 1;
  const int vecs = (hidden + per_lane - 1) / per_lane;
  int lanes = 1;
  while (lanes < 32 && lanes < vecs) lanes <<= 1;
  lanes = lanes < 8 ? 8 : lanes;  // no team narrower than 8 lanes
  const int nch = (hidden + 3) / 4;  // column chunks of 4
  const bool wide = nch >= 128 && nch <= kThreads;
  Shape sh;
  sh.batch = batch;
  sh.text_len = text_len;
  sh.pair_len = pair_len;
  sh.feat_dim = feat_dim;
  sh.hidden = hidden;
  sh.lanes = lanes;
  sh.eps = eps;
  if (wide) {
    sh.tile_rows = 16;
  } else {
    int groups = kThreads / nch;
    groups = groups < 1 ? 1 : groups > 16 ? 16 : groups;  // R <= 64
    sh.tile_rows = 4 * groups;
  }
  const long long text_rows = (long long)batch * text_len;
  const long long frame_rows = (long long)batch * pair_len;
  const long long per_text_cta = (long long)kWarps * (32 / lanes);
  const long long text_ctas = (text_rows + per_text_cta - 1) / per_text_cta;
  const long long frame_ctas = (frame_rows + sh.tile_rows - 1) / sh.tile_rows;
  if (text_ctas + frame_ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sh.frame_ctas = (int)frame_ctas;
  const int grid = (int)(text_ctas + frame_ctas);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* gf = static_cast<const float*>(gamma);
  const float* ef = static_cast<const float*>(beta);
#define MSA_EMBED(T, V)                                                           \
  (wide ? launch<T, V, 16>(text, feats, wf, bf, gf, ef, out, sh, grid, s) \
        : launch<T, V, 4>(text, feats, wf, bf, gf, ef, out, sh, grid, s))
  if (dtype == 0) return vec8 ? MSA_EMBED(float, 8) : MSA_EMBED(float, 1);
  return vec8 ? MSA_EMBED(__nv_bfloat16, 8) : MSA_EMBED(__nv_bfloat16, 1);
#undef MSA_EMBED
}
