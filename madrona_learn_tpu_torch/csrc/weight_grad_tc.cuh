// The bf16 weight-gradient pass of the LSTM backward on Hopper's tensor
// cores (lstm.cu's tensor-core path): split-K wgmma partials of
//   dW[i][j] = sum_m a[m][i] * dg[m][j]
// over the M = T*N rows, then weight_grad.cuh's fixed-order sum over the
// splits, so the result is the same run to run. a is [x | h_in]: columns
// i < a0_width come from a0 ([M, a0_width], the projection's x), the rest
// from a1 ([M, a_width - a0_width], the h_in scratch the recurrence
// wrote); both widths are multiples of 128. dg is the rounded dgates [M, G].
//
// Replaces the TPU kernels' fused epilogues dWr += h_in^T . dgates and
// dWi += x^T . dgates (ops/pallas/lstm.py:183-186, :476-479), which sum
// into one VMEM accumulator across a sequential grid; blocks here run in
// parallel, so each split of the rows writes its own f32 partial.
//
// Design (grouped_matmul.cu's tensor-core kernel, with A transposed):
// - A block of two warpgroups owns a 128 (i) x 128 (j) tile of one split's
//   partial, 64 i-rows a warpgroup, and walks its split's rows 64 at a
//   time through a 3-stage TMA ring; thread 0 issues the loads, which
//   complete on one mbarrier a stage, and refills a stage once both
//   warpgroups have retired the wgmma that read it.
// - a's [64 m][128 i] slice arrives as two [64 m][64 i] boxes: A of
//   m64n128k16 read MN-major (the transpose bit), one box a warpgroup; dg's
//   [64 m][128 j] slice as two boxes, B MN-major, as grouped_matmul's W.
//   128-byte swizzle; rows past M arrive as zeros. A split's rows are a
//   multiple of 64, so no slice straddles two splits.
// - bf16 products summed in f32 (the TPU's preferred_element_type=f32),
//   each split in one fixed order, written as f32 partials.
//
// Bound on the H100: the products, 2 M (F + H) 4H operations (at M =
// 131072, F = H = 256: 0.14 TFLOP, 0.14 ms at 989 TFLOP/s), against ~0.4
// GB of a and dg (0.12 ms at 3.35 TB/s; the tiles of a split re-read
// them from L2).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "weight_grad.cuh"

namespace mlt {

constexpr int kWgThreads = 256;   // two warpgroups, 64 i-rows each
constexpr int kWgTile = 128;      // i and j a block
constexpr int kWgK = 64;          // rows of M a stage
constexpr int kWgStages = 3;
constexpr int kWgABytes = kWgK * kWgTile * 2;   // 16 KB
constexpr int kWgStageBytes = 2 * kWgABytes;    // a and dg slices
constexpr int kWgSmem = kWgStages * kWgStageBytes + 1024;   // + alignment
static_assert(2 * (kWgSmem + 1024) <= 233472, "two blocks an SM");

// Grid: (G / 128 j-tiles, a_width / 128 i-tiles, chunks * splits).
static __global__ void __launch_bounds__(kWgThreads, 2)
    weight_grad_tc_kernel(const __grid_constant__ CUtensorMap a0_map,
                          const __grid_constant__ CUtensorMap a1_map,
                          const __grid_constant__ CUtensorMap dg_map,
                          float* __restrict__ part, int a0_width,
                          int a_width, int g, int chunk_tiles, int k_total,
                          int tiles_per_split, int num_chunks) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int j0 = blockIdx.x * kWgTile;
  const int i0 = blockIdx.y * kWgTile;
  // Chunk c's split: its k-tiles [k_begin, k_begin + k_tiles); k-tile q is
  // rows 64 (q % chunk_tiles) .. of the chunk at step q / chunk_tiles.
  const int splits = gridDim.z / num_chunks;
  const int c = blockIdx.z / splits;
  const int k_begin = (blockIdx.z % splits) * tiles_per_split;
  const int k_tiles = min(k_total, k_begin + tiles_per_split) - k_begin;
  const bool from_a0 = i0 < a0_width;
  const CUtensorMap* am = from_a0 ? &a0_map : &a1_map;
  const int ai0 = from_a0 ? i0 : i0 - a0_width;
  const CUtensorMap* gm = &dg_map;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto issue = [&](int kt) {
    const int s = kt % kWgStages;
    const uint32_t a = ring + s * kWgStageBytes;
    const uint32_t b = a + kWgABytes;
    const int q = k_begin + kt;
    const int r0 = (q % chunk_tiles) * kWgK;
    const int z = (q / chunk_tiles) * num_chunks + c;
    mbar_arrive_expect_tx(&full[s], kWgStageBytes);
    tma_load_3d(a, am, &full[s], ai0, r0, z);
    tma_load_3d(a + kWgABytes / 2, am, &full[s], ai0 + 64, r0, z);
    tma_load_3d(b, gm, &full[s], j0, r0, z);
    tma_load_3d(b + kWgABytes / 2, gm, &full[s], j0 + 64, r0, z);
  };
  if (tid == 0)
    for (int kt = 0; kt < min(kWgStages, k_tiles); ++kt) issue(kt);

  const int wg = tid / 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kWgStages;
    mbar_wait(&full[s], (kt / kWgStages) & 1);
    // This warpgroup's [64 m][64 i] box of a, and dg's two [64 m][64 j]
    // boxes, 8192 bytes apart; 16 rows of m = 2048 bytes on.
    const uint32_t a = ring + s * kWgStageBytes + wg * (kWgABytes / 2);
    const uint32_t b = ring + s * kWgStageBytes + kWgABytes;
#pragma unroll
    for (int i = 0; i < 64; ++i) wgmma_fence_operand(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgK / 16; ++kk)
      wgmma_m64n128k16_xn<1>(acc, wgmma_desc(a + kk * 2048, 8192, 1024, 128),
                             wgmma_desc(b + kk * 2048, 8192, 1024, 128), 1);
    wgmma_commit();
    wgmma_wait<1>();   // slice kt - 1 is retired
#pragma unroll
    for (int i = 0; i < 64; ++i) wgmma_fence_operand(acc[i]);
    __syncthreads();   // ... by both warpgroups: refill its stage
    if (tid == 0 && kt >= 1 && kt - 1 + kWgStages < k_tiles)
      issue(kt - 1 + kWgStages);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) wgmma_fence_operand(acc[i]);

  // Rows i0 + 64 wg + 16 w + l / 4 (+ 8), columns 8 j + 2 (l % 4) (+ 1).
  const int lane = tid % 32;
  const int r0 = i0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  float* out = part + static_cast<size_t>(blockIdx.z) * a_width * g;
#pragma unroll
  for (int j = 0; j < kWgTile / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(
          out + static_cast<size_t>(r0 + 8 * h) * g + j0 + 8 * j +
          2 * (lane % 4)) = make_float2(acc[4 * j + 2 * h],
                                        acc[4 * j + 2 * h + 1]);
}

// The split partials part [num_chunks * used, a_width, g] (f32 scratch) of
// rows laid out [steps][num_chunks][chunk] (kernel comment), each chunk's
// boxes in `splits` splits; `used` (<= splits) of them hold boxes.
static int weight_grad_tc_partials(const void* a0, int a0_width,
                                   const void* a1, int a_width,
                                   const void* dg, int g, int steps,
                                   int chunk, int num_chunks, int splits,
                                   void* part, int* used,
                                   cudaStream_t stream) {
  const int chunk_tiles = (chunk + kWgK - 1) / kWgK;
  const int k_total = steps * chunk_tiles;
  const int tiles_per_split = (k_total + splits - 1) / splits;
  *used = (k_total + tiles_per_split - 1) / tiles_per_split;
  const int slices = steps * num_chunks;
  CUtensorMap a0_map, a1_map, dg_map;
  const int a1_width = a_width - a0_width;
  if (!make_tma_map(&a0_map, a0, a0_width, chunk, slices, 64, kWgK) ||
      !make_tma_map(&a1_map, a1 != nullptr ? a1 : a0,
                    a1 != nullptr ? a1_width : a0_width, chunk, slices, 64,
                    kWgK) ||
      !make_tma_map(&dg_map, dg, g, chunk, slices, 64, kWgK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem(weight_grad_tc_kernel, kWgSmem);
  if (err != 0) return err;
  const dim3 grid(g / kWgTile, a_width / kWgTile, num_chunks * *used);
  weight_grad_tc_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      a0_map, a1_map, dg_map, static_cast<float*>(part), a0_width, a_width,
      g, chunk_tiles, k_total, tiles_per_split, num_chunks);
  return static_cast<int>(cudaGetLastError());
}

// dW [a_width, g] (bf16) from the split partials part [splits, a_width, g]
// (f32 scratch) over all total_rows rows: the products, then the
// fixed-order sum.
static int weight_grad_tc(const void* a0, int a0_width, const void* a1,
                          int a_width, const void* dg, int g, int total_rows,
                          int splits, void* part, void* dw,
                          cudaStream_t stream) {
  int used = 0;
  const int err = weight_grad_tc_partials(a0, a0_width, a1, a_width, dg, g,
                                          1, total_rows, 1, splits, part,
                                          &used, stream);
  if (err != 0) return err;
  return sum_splits<__nv_bfloat16>(part, dw, used, a_width * g, stream);
}

}  // namespace mlt
