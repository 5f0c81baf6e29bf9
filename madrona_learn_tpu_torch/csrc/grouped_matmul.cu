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
// Design, bf16 with IN and OUT multiples of 8 and x and W on 16-byte
// boundaries (grouped_matmul_tc_kernel, Hopper's warpgroup tensor cores):
// - A block of two warpgroups owns a 128 x 128 output tile of one chunk,
//   64 rows a warpgroup. It reads its chunk's policy index itself and, for
//   an index in range, addresses that policy's weights through TMA.
// - The block loops over IN in 64-deep slices through a 3-stage ring in
//   dynamic shared memory; thread 0 issues the TMA loads, which complete on
//   one mbarrier a stage, and refills a stage once both warpgroups have
//   retired the wgmma that read it. Two blocks fit an SM, so one block's
//   ring fill and epilogue overlap the other's products.
// - x comes through a 3-D tensor map [B, C, IN], so a chunk's ragged last
//   row tile zero-fills instead of reading the next chunk; W through a 3-D
//   map [P, IN, OUT] at the policy's index, as two 64-column boxes. Both use
//   the 128-byte swizzle. The maps are encoded on the host for each call
//   (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//   the library needs no -lcuda) and passed as __grid_constant__
//   parameters.
// - wgmma.m64n128k16 (bf16 -> f32): x's [128, 64] slice is the K-major A
//   operand, W's [64, 128] slice the MN-major B operand (the transpose
//   bit), both read by descriptor from shared memory.
// - The f32 accumulators are rounded once to bf16, staged through shared
//   memory and stored 16 bytes a thread. No split over IN: deterministic.
// float32, and bf16 with IN or OUT not a multiple of 8 or x or W off a
// 16-byte boundary (rows TMA cannot address), take grouped_matmul_kernel: the classic CUDA-core tiled
// product. A block of 256 threads owns a 64 x 64 tile of one chunk's
// output; it stages 16-deep slices of the chunk's rows and of the policy's
// weight columns in shared memory as f32, and each thread accumulates a 4 x
// 4 sub-tile in registers. Ragged edges are zero-filled. The wrapper
// (ops/cuda/grouped_matmul.py) picks the path by that rule and passes it
// here.
//
// Bound on the H100: operations and bytes about equally. At the first
// grouped_matmul_bench.py shape (63 chunks of 512 x 512 -> 2048, 39
// policies, bf16) the product is 68 GFLOP, 0.07 ms on bf16 tensor cores,
// and x, the weights of the policies in use and y are about 0.23 GB, 0.07
// ms at 3.35 TB/s. The tensor-core path keeps each SM's tensor cores fed
// from a 3-stage TMA ring; the CUDA-core path is bound by f32 FMA issue (67
// TFLOP/s at most).

#include <cuda.h>   // CUtensorMap
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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

// ------------------------------------------------ bf16 on tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;   // two warpgroups, 64 output rows each
constexpr int kTcM = 128;         // chunk rows a block
constexpr int kTcN = 128;         // output columns a block
constexpr int kTcK = 64;          // depth of a slice: 128 bytes of bf16
constexpr int kTcStages = 3;
constexpr int kTcABytes = kTcM * kTcK * 2;             // x slice, 16 KB
constexpr int kTcBBytes = kTcK * kTcN * 2;             // W slice, 16 KB
constexpr int kTcStageBytes = kTcABytes + kTcBBytes;
constexpr int kTcOutPitch = kTcN + 8;   // bf16 a staged output row
constexpr int kTcSmem = kTcStages * kTcStageBytes + 1024;   // + alignment
static_assert(kTcM * kTcOutPitch * 2 <= kTcStages * kTcStageBytes,
              "the staged output tile reuses the ring");
// Two blocks an SM: 2 x (97 KB + 1 KB reserved) of its 228 KB.
static_assert(2 * (kTcSmem + 1024) <= 233472, "two blocks an SM");

// Grid: x over (chunk, row tile, column tile), column tile fastest.
__global__ void __launch_bounds__(kTcThreads, 2)
grouped_matmul_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w_map,
                         const int* __restrict__ chunk_policy,
                         bf16* __restrict__ y, int rows, int in,
                         int policies, int out, int m_tiles, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kTcStages];
  // The 128-byte swizzle wants 1024-byte aligned tiles.
  const uint32_t raw_s = mlt::smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;
  uint8_t* ring_p = smem_raw + (ring - raw_s);

  long long t = blockIdx.x;
  const int n0 = static_cast<int>(t % n_tiles) * kTcN;
  t /= n_tiles;
  const int m0 = static_cast<int>(t % m_tiles) * kTcM;
  const int c = static_cast<int>(t / m_tiles);
  const int pol = chunk_policy[c];
  const int tid = threadIdx.x;
  bf16* yc = y + static_cast<size_t>(c) * rows * out;

  if (pol < 0 || pol >= policies) {   // NaN rows; nothing is read
    const uint4 nan = make_uint4(0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u,
                                 0x7fc07fc0u);
    for (int e = tid; e < kTcM * (kTcN / 8); e += kTcThreads) {
      const int r = m0 + e / (kTcN / 8), col = n0 + (e % (kTcN / 8)) * 8;
      if (r < rows && col < out)
        *reinterpret_cast<uint4*>(yc + static_cast<size_t>(r) * out + col) =
            nan;
    }
    return;
  }

  const int k_tiles = (in + kTcK - 1) / kTcK;
  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) mlt::mbar_init(&full[s], 1);
    mlt::mbar_fence_init();
  }
  __syncthreads();

  // Thread 0: slice kt of x and W into stage kt % kTcStages.
  const CUtensorMap* xm = &x_map;
  const CUtensorMap* wm = &w_map;
  auto issue = [&](int kt) {
    const int s = kt % kTcStages;
    const uint32_t a = ring + s * kTcStageBytes;
    const uint32_t b = a + kTcABytes;
    mlt::mbar_arrive_expect_tx(&full[s], kTcStageBytes);
    mlt::tma_load_3d(a, xm, &full[s], kt * kTcK, m0, c);
    mlt::tma_load_3d(b, wm, &full[s], n0, kt * kTcK, pol);
    mlt::tma_load_3d(b + kTcBBytes / 2, wm, &full[s], n0 + 64, kt * kTcK,
                     pol);
  };
  if (tid == 0)
    for (int kt = 0; kt < min(kTcStages, k_tiles); ++kt) issue(kt);

  const int wg = tid / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kTcStages;
    mlt::mbar_wait(&full[s], (kt / kTcStages) & 1);
    // This warpgroup's 64 rows of the x slice (128 bytes a row), and the W
    // slice as two [64 K][64 N] boxes.
    const uint32_t a = ring + s * kTcStageBytes + wg * 64 * kTcK * 2;
    const uint32_t b = ring + s * kTcStageBytes + kTcABytes;
#pragma unroll
    for (int i = 0; i < 64; ++i) mlt::wgmma_fence_operand(acc[i]);
    mlt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      // A: K-major, 8-row groups 1024 bytes apart, 16 deep = 32 bytes on.
      // B: MN-major, 8-deep groups 1024 bytes apart, the two 64-column
      // boxes 8192 bytes apart, 16 deep = 2048 bytes on.
      mlt::wgmma_m64n128k16_xn<0>(
          acc, mlt::wgmma_desc(a + kk * 32, 16, 1024, 128),
          mlt::wgmma_desc(b + kk * 2048, kTcBBytes / 2, 1024, 128), 1);
    }
    mlt::wgmma_commit();
    mlt::wgmma_wait<1>();   // slice kt - 1 is retired
#pragma unroll
    for (int i = 0; i < 64; ++i) mlt::wgmma_fence_operand(acc[i]);
    __syncthreads();        // ... by both warpgroups: refill its stage
    if (tid == 0 && kt >= 1 && kt - 1 + kTcStages < k_tiles)
      issue(kt - 1 + kTcStages);
  }
  mlt::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) mlt::wgmma_fence_operand(acc[i]);
  __syncthreads();   // every slice consumed: the ring stages the output

  // Thread (warp w of warpgroup wg, lane l) holds rows 64 wg + 16 w + l / 4
  // (+ 8), columns 8 j + 2 (l % 4) (+ 1) in acc[4 j ..].
  const int lane = tid % 32;
  const int r0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  bf16* stage = reinterpret_cast<bf16*>(ring_p);
#pragma unroll
  for (int j = 0; j < kTcN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          stage + (r0 + 8 * h) * kTcOutPitch + 8 * j + 2 * (lane % 4)) =
          mlt::pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();
  for (int e = tid; e < kTcM * (kTcN / 8); e += kTcThreads) {
    const int r = e / (kTcN / 8), cc = (e % (kTcN / 8)) * 8;
    if (m0 + r < rows && n0 + cc < out)
      *reinterpret_cast<uint4*>(yc + static_cast<size_t>(m0 + r) * out + n0 +
                                cc) =
          *reinterpret_cast<const uint4*>(stage + r * kTcOutPitch + cc);
  }
}

int launch_tc(const void* x, const void* w, const int* chunk_policy, void* y,
              int chunks, int rows, int in, int policies, int out,
              cudaStream_t stream) {
  const int m_tiles = (rows + kTcM - 1) / kTcM;
  const int n_tiles = (out + kTcN - 1) / kTcN;
  const long long blocks = static_cast<long long>(chunks) * m_tiles * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map;
  if (!mlt::make_tma_map(&x_map, x, in, rows, chunks, kTcK, kTcM) ||
      !mlt::make_tma_map(&w_map, w, out, in, policies, 64, kTcK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = mlt::set_smem(grouped_matmul_tc_kernel, kTcSmem);
  if (err != 0) return err;
  grouped_matmul_tc_kernel<<<static_cast<unsigned>(blocks), kTcThreads,
                             kTcSmem, stream>>>(
      x_map, w_map, chunk_policy, static_cast<bf16*>(y), rows, in, policies,
      out, m_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tensor_core: 1 for the bf16 tensor-core path (IN and OUT multiples of 8),
// 0 for the CUDA-core path; the wrapper's rule picks it.
extern "C" int mlt_grouped_matmul(int dtype, int tensor_core, const void* x,
                                  const void* w, const void* chunk_policy,
                                  void* y, int chunks, int rows, int in,
                                  int policies, int out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(chunk_policy);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 ==
      0;
  if (tensor_core)
    return dtype == 1 && in % 8 == 0 && out % 8 == 0 && aligned
               ? launch_tc(x, w, idx, y, chunks, rows, in, policies, out, s)
               : -1;
  if (dtype == 0)
    return launch<float>(x, w, idx, y, chunks, rows, in, policies, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, idx, y, chunks, rows, in, policies,
                                 out, s);
  return -1;
}
