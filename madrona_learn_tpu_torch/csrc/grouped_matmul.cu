// grouped_matmul: y[c] = x[c] . W[chunk_policy[c]] for every chunk c.
//
// Replaces madrona_learn_tpu/ops/pallas/grouped_matmul.py:grouped_matmul
// (_kernel). The TPU kernel scalar-prefetches the chunk -> policy index and
// lets each grid program DMA its policy's [IN, tile_out] weight block, so no
// [B, IN, OUT] copy of the weights is gathered. Here a block reads its
// chunk's policy index itself and addresses that policy's weight tiles
// directly; there is no gather either.
//
// Contract (the plain version is ops/cuda/grouped_matmul.py:
// grouped_matmul_reference): x [B, C, IN] and weights [P, IN, OUT] in one
// storage type (float32 or bfloat16), chunk_policy [B] int32 in [0, P); the
// product summed in f32 over IN and rounded once to the storage type. A
// chunk whose index lies outside [0, P) gets NaN rows instead of a read out
// of bounds.
//
// Design: the classic CUDA-core tiled product. A block of 256 threads owns
// a 64 x 64 tile of one chunk's output; it stages 16-deep slices of the
// chunk's rows and of the policy's weight columns in shared memory as f32,
// and each thread accumulates a 4 x 4 sub-tile in registers, reading two
// 16-byte shared-memory vectors per 16 FMAs. Ragged edges are zero-filled.
//
// Bound on the H100: operations and bytes about equally. At the first
// grouped_matmul_bench.py shape (63 chunks of 512 x 512 -> 2048, 39
// policies, bf16) the product is 68 GFLOP, 0.07 ms on bf16 tensor cores,
// and x, the weights of the policies in use and y are about 0.23 GB, 0.07
// ms at 3.35 TB/s. This first version runs the product as f32 FMAs on CUDA
// cores (67 TFLOP/s at most), so it is bound by CUDA-core issue; mma.sync /
// wgmma tiles are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;   // chunk rows per block
constexpr int kTileN = 64;   // output columns per block
constexpr int kTileK = 16;   // depth per shared-memory slice
constexpr int kPadM = 4;     // floats of padding per row of the x slice

using mlt::from_f;
using mlt::to_f;

// Grid: x over (chunk, row tile, column tile), column tile fastest.
template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ chunk_policy,
                      T* __restrict__ y, int rows, int in, int policies,
                      int out, int m_tiles, int n_tiles) {
  __shared__ __align__(16) float xs[kTileK][kTileM + kPadM];   // x slice^T
  __shared__ __align__(16) float ws[kTileK][kTileN];
  long long t = blockIdx.x;
  const int n0 = static_cast<int>(t % n_tiles) * kTileN;
  t /= n_tiles;
  const int m0 = static_cast<int>(t % m_tiles) * kTileM;
  const long long c = t / m_tiles;
  const int tx = threadIdx.x % (kTileN / 4);   // 4 columns each
  const int ty = threadIdx.x / (kTileN / 4);   // 4 rows each
  const int pol = chunk_policy[c];
  const T* xc = x + c * rows * in;
  const T* wp = w + static_cast<long long>(pol) * in * out;
  const bool valid_policy = 0 <= pol && pol < policies;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = valid_policy ? 0.0f : NAN;

  for (int k0 = 0; valid_policy && k0 < in; k0 += kTileK) {
    __syncthreads();   // the previous slice is consumed
    for (int e = threadIdx.x; e < kTileM * kTileK; e += kThreads) {
      const int r = e / kTileK, kk = e % kTileK;
      const int gr = m0 + r, gk = k0 + kk;
      xs[kk][r] = gr < rows && gk < in
                      ? to_f(xc[static_cast<long long>(gr) * in + gk])
                      : 0.0f;
    }
    for (int e = threadIdx.x; e < kTileK * kTileN; e += kThreads) {
      const int kk = e / kTileN, cc = e % kTileN;
      const int gk = k0 + kk, gc = n0 + cc;
      ws[kk][cc] = gk < in && gc < out
                       ? to_f(wp[static_cast<long long>(gk) * out + gc])
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  T* yc = y + c * rows * out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < out)
        yc[static_cast<long long>(r) * out + col] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* chunk_policy, void* y,
           int chunks, int rows, int in, int policies, int out,
           cudaStream_t stream) {
  const int m_tiles = (rows + kTileM - 1) / kTileM;
  const int n_tiles = (out + kTileN - 1) / kTileN;
  const long long blocks = static_cast<long long>(chunks) * m_tiles * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  grouped_matmul_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), chunk_policy,
      static_cast<T*>(y), rows, in, policies, out, m_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mlt_grouped_matmul(int dtype, const void* x, const void* w,
                                  const void* chunk_policy, void* y,
                                  int chunks, int rows, int in, int policies,
                                  int out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(chunk_policy);
  if (dtype == 0)
    return launch<float>(x, w, idx, y, chunks, rows, in, policies, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, idx, y, chunks, rows, in, policies,
                                 out, s);
  return -1;
}
