// Device helpers shared by the LSTM and policy-step kernels: storage-type
// conversion, paired vector loads and the CUDA-core row-tile product.
//
// Thread layout of every kernel that uses the product: a block of kThreads
// threads owns kRows batch rows. Thread (row group rg, unit group ug) owns
// RPT = kRows / kRowGroups consecutive rows and UPT consecutive output units
// of each of G gate blocks, so per-unit math needs no exchange between
// threads. The kUnitGroups threads of one row group are two whole warps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mlt {

constexpr int kThreads = 256;
constexpr int kUnitGroups = 64;                      // threads along units
constexpr int kRowGroups = kThreads / kUnitGroups;   // threads along rows
constexpr int kRows = 16;                            // BN: rows per block
constexpr int kRowsPerThread = kRows / kRowGroups;   // RPT

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the storage type T and back to f32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// UPT consecutive elements (UPT even) of the storage type, as f32.
template <int UPT>
__device__ __forceinline__ void load_units(const float* p, float (&out)[UPT]) {
#pragma unroll
  for (int j = 0; j < UPT; j += 2) {
    const float2 v = *reinterpret_cast<const float2*>(p + j);
    out[j] = v.x;
    out[j + 1] = v.y;
  }
}
template <int UPT>
__device__ __forceinline__ void load_units(const __nv_bfloat16* p,
                                           float (&out)[UPT]) {
#pragma unroll
  for (int j = 0; j < UPT; j += 2) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + j));
    out[j] = v.x;
    out[j + 1] = v.y;
  }
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[i][g][j] +=
//     sum_k a_s[(row_base + i) * K + k] * w[k * ldw + g * gs + u0 + j]
// a_s: [BN][K] f32 in shared memory; w: row-major in global memory (read
// through L2), row stride ldw, gate block g at column offset g * gs. The
// operands are storage-type values converted exactly to f32, so this is an
// f32-accumulated product of storage-type operands.
template <typename T, int G, int RPT, int UPT>
__device__ __forceinline__ void row_tile_fma(const float* a_s, int K,
                                             const T* __restrict__ w, int ldw,
                                             int gs, int row_base, int u0,
                                             float (&acc)[RPT][G][UPT]) {
  for (int k = 0; k < K; ++k) {
    float a[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = a_s[(row_base + i) * K + k];
    const T* wrow = w + static_cast<size_t>(k) * ldw + u0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float wv[UPT];
      load_units<UPT>(wrow + g * gs, wv);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < UPT; ++j)
          acc[i][g][j] = fmaf(a[i], wv[j], acc[i][g][j]);
    }
  }
}

// The same product from zero.
template <typename T, int G, int RPT, int UPT>
__device__ __forceinline__ void row_tile_product(
    const float* a_s, int K, const T* __restrict__ w, int ldw, int gs,
    int row_base, int u0, float (&acc)[RPT][G][UPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < UPT; ++j) acc[i][g][j] = 0.0f;
  row_tile_fma<T, G, RPT, UPT>(a_s, K, w, ldw, gs, row_base, u0, acc);
}

// Copy rows [row0, row0 + kRows) of a row-major [n_rows, width] matrix into
// a_s [kRows][width] as f32; rows past n_rows become zeros. The rows of one
// tile are contiguous in memory, so the copy is one coalesced stretch.
template <typename T>
__device__ __forceinline__ void load_row_tile(float* a_s,
                                              const T* __restrict__ src,
                                              int row0, int n_rows,
                                              int width) {
  const size_t base = static_cast<size_t>(row0) * width;
  const int valid = min(kRows, n_rows - row0) * width;
  for (int e = threadIdx.x; e < kRows * width; e += kThreads)
    a_s[e] = e < valid ? to_f(src[base + e]) : 0.0f;
}

// Allow a kernel more than 48 KB of dynamic shared memory.
template <typename K>
int set_smem(K* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace mlt
