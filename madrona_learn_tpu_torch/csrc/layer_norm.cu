// layer_norm_fwd / layer_norm_bwd: row LayerNorm over [N, D], forward and
// backward.
//
// Replaces madrona_learn_tpu/ops/pallas/layer_norm.py:layer_norm: the
// forward _fwd_kernel (layer_norm_fwd) and the backward _bwd_kernel with its
// dw/db accumulation (layer_norm_bwd).
//
// Math, all in f32 from storage-type x and f32 weight / bias:
//   mu = mean(x); var = mean((x - mu)^2) (two passes); rsigma =
//   rsqrt(var + eps); y = round((x - mu) * rsigma * w + b)
// and, with xhat = (x - mu) * rsigma and wdy = w * dy,
//   dx = round((wdy - mean(wdy) - xhat * mean(wdy * xhat)) * rsigma),
//   dw = sum over rows of dy * xhat, db = sum over rows of dy.
//
// What the TPU layout did, and why it cannot carry over: the TPU kernel
// takes 256-row blocks in one sequential grid and accumulates dw/db of every
// block into one output block. Hopper blocks run in parallel in no order, so
// that accumulator does not exist.
//
// Design here: one warp per row, each lane holding D / 32 of the row's
// values in registers, so a row is read from device memory once and its
// sums are warp shuffles. The forward saves mu and rsigma [N] in f32. The
// backward gives each block a contiguous range of rows; each lane keeps f32
// dw/db sums for its columns over the rows of its warp, the block adds its
// eight warps in order through shared memory into one f32 partial row, and
// sum_splits (weight_grad.cuh) adds the blocks' partials in block order: a
// fixed order, so dw and db are the same run to run, without atomics.
//
// Bound on the H100: device-memory bytes. The forward reads x and writes y
// (plus 8 bytes a row of statistics); the backward reads x and dy and writes
// dx, a few f32 operations per element either way.

#include "common.cuh"
#include "weight_grad.cuh"

namespace {

using namespace mlt;

constexpr int kWarps = kThreads / 32;  // rows in flight per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// kPerLane: values of a row per lane, D <= 32 * kPerLane. Column of value k
// of a lane: lane + 32 * k.
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads) layer_norm_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mu,
    float* __restrict__ rsigma, int n_rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n_rows) return;  // whole warps
  const T* xr = x + static_cast<size_t>(row) * d;

  float v[kPerLane];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < d ? to_f(xr[c]) : 0.0f;
    sum += v[k];
  }
  const float mean = warp_sum(sum) / static_cast<float>(d);
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < d ? v[k] - mean : 0.0f;
    sq += v[k] * v[k];
  }
  const float var = warp_sum(sq) / static_cast<float>(d);
  const float rs = rsqrtf(var + eps);

  T* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < d) yr[c] = from_f<T>(v[k] * rs * w[c] + b[c]);
  }
  if (lane == 0) {
    mu[row] = mean;
    rsigma[row] = rs;
  }
}

// Shared memory: dw [kWarps][d] then db [kWarps][d], f32.
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads) layer_norm_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ mu, const float* __restrict__ rsigma,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part_w,
    float* __restrict__ part_b, int n_rows, int d, int rows_per_block) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(row_begin + rows_per_block, n_rows);

  float wv[kPerLane], dw_acc[kPerLane], db_acc[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    wv[k] = c < d ? w[c] : 0.0f;
    dw_acc[k] = 0.0f;
    db_acc[k] = 0.0f;
  }

  for (int row = row_begin + warp; row < row_end; row += kWarps) {
    const size_t base = static_cast<size_t>(row) * d;
    const float m = mu[row];
    const float rs = rsigma[row];
    float xhat[kPerLane], wdy[kPerLane], g[kPerLane];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane + 32 * k;
      const bool in = c < d;
      g[k] = in ? to_f(dy[base + c]) : 0.0f;
      xhat[k] = in ? (to_f(x[base + c]) - m) * rs : 0.0f;
      wdy[k] = wv[k] * g[k];
      s1 += xhat[k] * wdy[k];
      s2 += wdy[k];
    }
    const float c1 = warp_sum(s1) / static_cast<float>(d);
    const float c2 = warp_sum(s2) / static_cast<float>(d);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < d) dx[base + c] = from_f<T>((wdy[k] - c2 - xhat[k] * c1) * rs);
      dw_acc[k] += g[k] * xhat[k];
      db_acc[k] += g[k];
    }
  }

  float* dw_s = smem;
  float* db_s = smem + kWarps * d;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < d) {
      dw_s[warp * d + c] = dw_acc[k];
      db_s[warp * d + c] = db_acc[k];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sw = 0.0f, sb = 0.0f;
    for (int k = 0; k < kWarps; ++k) {
      sw += dw_s[k * d + c];
      sb += db_s[k * d + c];
    }
    part_w[static_cast<size_t>(blockIdx.x) * d + c] = sw;
    part_b[static_cast<size_t>(blockIdx.x) * d + c] = sb;
  }
}

template <typename T, int kPerLane>
int launch_fwd(const void* x, const void* w, const void* b, void* y,
               void* mu, void* rsigma, int n_rows, int d, float eps,
               cudaStream_t stream) {
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  layer_norm_fwd_kernel<T, kPerLane><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y),
      static_cast<float*>(mu), static_cast<float*>(rsigma), n_rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kPerLane>
int launch_bwd(const void* x, const void* w, const void* mu,
               const void* rsigma, const void* dy, void* dx, void* part_w,
               void* part_b, void* dw, void* db, int n_rows, int d,
               int blocks, cudaStream_t stream) {
  const int smem = 2 * kWarps * d * static_cast<int>(sizeof(float));
  int err = set_smem(layer_norm_bwd_kernel<T, kPerLane>, smem);
  if (err != 0) return err;
  const int rows_per_block = (n_rows + blocks - 1) / blocks;
  layer_norm_bwd_kernel<T, kPerLane><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(mu), static_cast<const float*>(rsigma),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(part_w), static_cast<float*>(part_b), n_rows, d,
      rows_per_block);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = sum_splits<float>(part_w, dw, blocks, d, stream);
  if (err != 0) return err;
  return sum_splits<float>(part_b, db, blocks, d, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; weight, bias, mu, rsigma, dw and db are
// float32. Each entry point returns a cudaError_t, or -1 for arguments
// without an instantiation (D > 1024).
#define MLT_DISPATCH(CALL)                                            \
  if (d <= 0) return -1;                                              \
  if (dtype == 0 && d <= 64) return CALL(float, 2);                   \
  if (dtype == 0 && d <= 128) return CALL(float, 4);                  \
  if (dtype == 0 && d <= 256) return CALL(float, 8);                  \
  if (dtype == 0 && d <= 1024) return CALL(float, 32);                \
  if (dtype == 1 && d <= 64) return CALL(__nv_bfloat16, 2);           \
  if (dtype == 1 && d <= 128) return CALL(__nv_bfloat16, 4);          \
  if (dtype == 1 && d <= 256) return CALL(__nv_bfloat16, 8);          \
  if (dtype == 1 && d <= 1024) return CALL(__nv_bfloat16, 32);        \
  return -1

extern "C" int mlt_layer_norm_fwd(int dtype, int d, const void* x,
                                  const void* w, const void* b, void* y,
                                  void* mu, void* rsigma, int n_rows,
                                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_FWD(T, K) \
  launch_fwd<T, K>(x, w, b, y, mu, rsigma, n_rows, d, eps, s)
  MLT_DISPATCH(MLT_FWD);
#undef MLT_FWD
}

extern "C" int mlt_layer_norm_bwd(int dtype, int d, const void* x,
                                  const void* w, const void* mu,
                                  const void* rsigma, const void* dy,
                                  void* dx, void* part_w, void* part_b,
                                  void* dw, void* db, int n_rows, int blocks,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_BWD(T, K)                                                \
  launch_bwd<T, K>(x, w, mu, rsigma, dy, dx, part_w, part_b, dw, db, \
                   n_rows, d, blocks, s)
  MLT_DISPATCH(MLT_BWD);
#undef MLT_BWD
}

#undef MLT_DISPATCH
