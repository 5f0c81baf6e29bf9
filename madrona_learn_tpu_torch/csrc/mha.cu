// mha: entity self-attention forward, [B, S, H, D] in place.
//
// Replaces madrona_learn_tpu/ops/pallas/attention.py:mha (_mha_kernel,
// through _mha_impl). The TPU kernel transposes q, k, v to [B*H, S, D],
// pads B*H to its 8-row block and computes one whole [S, S] score tile per
// (batch block, head) on the MXU. Both are layout choices for the TPU; here
// the kernel reads and writes [B, S, H, D] where it lies.
//
// Contract (the plain version is ops/cuda/mha.py:mha_reference): scores in
// f32, (q . k) * D^-0.5; keys at index valid_len or above take no part
// (the plain version gives them a -1e30 score, whose exponential is exactly
// 0 in f32); an f32 softmax over keys; P . V in f32; the output rounded to
// the storage type. Query rows at and past valid_len are computed like any
// other row (the caller slices them off).
//
// Design:
// - A block owns a tile of (batch, head) problems: tile_b batch items by
//   tile_h heads (tile_h == H whenever a whole batch item fits, so the
//   tile's keys are one contiguous stretch of memory). It stages the K and
//   V rows below valid_len of its problems in shared memory as f32, with
//   16-byte coalesced loads, once.
// - One thread owns one query row: the row of q and the D accumulators of
//   its output stay in registers. Consecutive threads own consecutive
//   query rows of one problem, so a warp reads the same key row of shared
//   memory at once (a broadcast); problems are padded apart by 4 floats so
//   that two problems in one warp read different banks.
// - The softmax is taken over chunks of 8 keys with a running maximum
//   (online softmax): each key and value row is read from shared memory
//   once per query row. The result differs from the plain two-pass
//   softmax by rounding only.
// - Each (b, h) problem is computed by the same instruction sequence
//   whatever B is and wherever it falls in a tile, so the rollout step
//   (B = worlds) and the update pass (B = T x minibatch) agree bit for bit
//   on equal inputs, which PPO's importance ratio needs.
//
// Bound on the H100: bytes. At the flagship's update shape, [131072, 16, 4,
// 32] bf16 with valid_len = 12, the kernel must move q and o whole and the
// 12 valid rows of k and v, 1.88 GB, about 0.56 ms at 3.35 TB/s; the
// products are 17 GFLOP. This first version runs them on CUDA cores (f32
// FMA, one shared-memory broadcast per FMA), which may make it bound by
// shared-memory issue instead; mma.sync / wgmma tiles are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kChunk = 8;           // keys per online-softmax step
constexpr int kPad = 4;             // floats between problems in shared memory
constexpr int kDefaultSmem = 48 * 1024;

using mlt::load16;
using mlt::store16;
using mlt::dot_row;

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int batch,
               int seq, int heads, int valid_len, int tile_b, int tile_h,
               float scale) {
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte access
  constexpr int kVecPerRow = D / kVec;
  extern __shared__ float smem[];
  const int pstride = valid_len * D + kPad;
  float* ks = smem;
  float* vs = smem + tile_b * tile_h * pstride;

  const int h_tiles = heads / tile_h;
  const int b0 = (blockIdx.x / h_tiles) * tile_b;
  const int h0 = (blockIdx.x % h_tiles) * tile_h;
  const int nb = min(tile_b, batch - b0);

  // Stage the valid key / value rows: e runs over (bl, j, hl, vec) with the
  // vector fastest, the order in which they lie in memory.
  const int n_vec = nb * valid_len * tile_h * kVecPerRow;
  for (int e = threadIdx.x; e < n_vec; e += blockDim.x) {
    const int c = e % kVecPerRow;
    int r = e / kVecPerRow;
    const int hl = r % tile_h;
    r /= tile_h;
    const int j = r % valid_len;
    const int bl = r / valid_len;
    const size_t g =
        ((static_cast<size_t>(b0 + bl) * seq + j) * heads + h0 + hl) * D +
        c * kVec;
    const int s = (bl * tile_h + hl) * pstride + j * D + c * kVec;
    float tmp[kVec];
    load16(k + g, tmp);
#pragma unroll
    for (int i = 0; i < kVec; i += 4) store16(ks + s + i, tmp + i);
    load16(v + g, tmp);
#pragma unroll
    for (int i = 0; i < kVec; i += 4) store16(vs + s + i, tmp + i);
  }
  __syncthreads();

  // One query row per thread: r runs over (bl, hl, i) with i fastest.
  const int rows = nb * tile_h * seq;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int i = r % seq;
    const int p = r / seq;               // bl * tile_h + hl
    const int hl = p % tile_h;
    const int bl = p / tile_h;
    const size_t g =
        ((static_cast<size_t>(b0 + bl) * seq + i) * heads + h0 + hl) * D;

    float qr[D];
#pragma unroll
    for (int c = 0; c < kVecPerRow; ++c)
      load16(q + g + c * kVec, qr + c * kVec);

    const float* kp = ks + p * pstride;
    const float* vp = vs + p * pstride;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.0f;
    float m = -INFINITY;
    float l = 0.0f;

    for (int j0 = 0; j0 < valid_len; j0 += kChunk) {
      float s[kChunk];
      float cm = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = -INFINITY;
        if (j0 + jj < valid_len) {
          s[jj] = dot_row<D>(qr, kp + (j0 + jj) * D) * scale;
          cm = fmaxf(cm, s[jj]);
        }
      }
      const float m_new = fmaxf(m, cm);
      const float alpha = expf(m - m_new);   // 0 on the first chunk
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        if (j0 + jj < valid_len) {
          const float pj = expf(s[jj] - m_new);
          l += pj;
          const float* vr = vp + (j0 + jj) * D;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(vr + d);
            acc[d] = fmaf(pj, vv.x, acc[d]);
            acc[d + 1] = fmaf(pj, vv.y, acc[d + 1]);
            acc[d + 2] = fmaf(pj, vv.z, acc[d + 2]);
            acc[d + 3] = fmaf(pj, vv.w, acc[d + 3]);
          }
        }
      }
      m = m_new;
    }

    float out[D];
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = acc[d] / l;
#pragma unroll
    for (int c = 0; c < kVecPerRow; ++c)
      store16(o + g + c * kVec, out + c * kVec);
  }
}

// Problems per block: about kMaxThreads query rows, within the default 48 KB
// of shared memory unless a single problem needs more.
template <typename T, int D>
int launch_mha(const void* q, const void* k, const void* v, void* o,
               int batch, int seq, int heads, int valid_len, float scale,
               cudaStream_t stream) {
  const size_t per_problem =
      2 * static_cast<size_t>(valid_len * D + kPad) * sizeof(float);
  int problems = kMaxThreads / seq > 1 ? kMaxThreads / seq : 1;
  const int fit = static_cast<int>(kDefaultSmem / per_problem);
  if (fit < problems) problems = fit > 1 ? fit : 1;
  int tile_b = 1, tile_h = 1;
  if (problems >= heads) {
    tile_h = heads;
    tile_b = problems / heads;
  } else {
    for (int t = problems; t >= 1; --t)
      if (heads % t == 0) {
        tile_h = t;
        break;
      }
  }
  const size_t smem = per_problem * tile_b * tile_h;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows = tile_b * tile_h * seq;
  int threads = (rows + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long blocks =
      static_cast<long long>((batch + tile_b - 1) / tile_b) * (heads / tile_h);
  mha_fwd_kernel<T, D><<<static_cast<unsigned>(blocks), threads, smem,
                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), batch, seq, heads,
      valid_len, tile_b, tile_h, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mlt_mha_fwd(int dtype, int head_dim, const void* q,
                           const void* k, const void* v, void* o, int batch,
                           int seq, int heads, int valid_len, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_MHA(T, D)                                                       \
  return launch_mha<T, D>(q, k, v, o, batch, seq, heads, valid_len, scale, s)
  if (dtype == 0 && head_dim == 16) MLT_MHA(float, 16);
  if (dtype == 0 && head_dim == 32) MLT_MHA(float, 32);
  if (dtype == 0 && head_dim == 64) MLT_MHA(float, 64);
  if (dtype == 1 && head_dim == 16) MLT_MHA(__nv_bfloat16, 16);
  if (dtype == 1 && head_dim == 32) MLT_MHA(__nv_bfloat16, 32);
  if (dtype == 1 && head_dim == 64) MLT_MHA(__nv_bfloat16, 64);
#undef MLT_MHA
  return -1;
}
