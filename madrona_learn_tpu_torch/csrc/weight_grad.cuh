// The split-M weight-gradient pass shared by the recurrent backward
// kernels (lstm.cu, gru.cu): f32 partials of a^T . dg over contiguous
// splits of the T*N rows, then a fixed-order sum over the splits, so the
// result is the same run to run. The chunk-indexed LSTM backward
// (lstm_sequence_bwd_chunked) takes the N rows as chunks of one policy
// each: every chunk's T*chunk rows are split on their own, and
// sum_by_policy adds a policy's chunks' partials in chunk order. Each .cu
// file is its own translation unit, so the templates live here, static
// (one private copy per file, as when they were defined in lstm.cu's
// unnamed namespace; an unnamed namespace here, inside mlt, makes nvcc's
// launch stubs ambiguous in files that have their own).

#pragma once

#include "common.cuh"

namespace mlt {

// Weight-gradient partials over one contiguous split of the M = T*N rows:
//   part_w[s][i][j] = sum_m a[m][i] * dg[m][j]
//   part_b[s][j]    = sum_m dg[m][j]          (when part_b is given)
// With kHin, a is h_in, rebuilt from ys / keep / h0 exactly as the
// recurrence saw it (a_width = H); else a is a row-major [M, a_width]
// matrix (x of the projection). Tile: 64 (i) x 64 (j) per block, 4 x 4 per
// thread, rows staged through shared memory kTileM at a time.
// The rows are taken as chunks of `chunk` of the N (chunk = N: one chunk),
// each split over its own T * chunk rows, j = t * chunk + n in step order:
// grid z = chunk index * chunk_splits + split, and part_w / part_b hold
// one partial a z.
constexpr int kTileI = 64;
constexpr int kTileJ = 64;
constexpr int kTileM = 32;

template <typename T, bool kHin>
static __global__ void __launch_bounds__(kThreads) weight_grad_partial_kernel(
    const T* __restrict__ dg, const T* __restrict__ a,
    const T* __restrict__ keep, const T* __restrict__ h0,
    float* __restrict__ part_w, float* __restrict__ part_b, int steps,
    int n_rows, int a_width, int g4, int rows_per_split, int chunk,
    int chunk_splits) {
  __shared__ __align__(16) float a_s[kTileM][kTileI];
  __shared__ __align__(16) float b_s[kTileM][kTileJ];
  const int j0 = blockIdx.x * kTileJ;
  const int i0 = blockIdx.y * kTileI;
  const int split = blockIdx.z % chunk_splits;
  const int first_row = (blockIdx.z / chunk_splits) * chunk;
  const long long total = static_cast<long long>(steps) * chunk;
  const long long m_begin = static_cast<long long>(split) * rows_per_split;
  long long m_end = m_begin + rows_per_split;
  if (m_end > total) m_end = total;

  const int ti = threadIdx.x / 16;  // 16 x 16 threads, 4 x 4 outputs each
  const int tj = threadIdx.x % 16;
  float acc[4][4];
  float acc_b[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    acc_b[p] = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
  }

  for (long long m0 = m_begin; m0 < m_end; m0 += kTileM) {
    for (int e = threadIdx.x; e < kTileM * kTileI; e += kThreads) {
      const int mm = e / kTileI;
      const int col = e % kTileI;
      const long long m = m0 + mm;
      float av = 0.0f, gv = 0.0f;
      if (m < m_end) {
        const int t = static_cast<int>(m / chunk);
        const int n = first_row + static_cast<int>(m % chunk);
        const size_t row = static_cast<size_t>(t) * n_rows + n;
        if (kHin) {
          if (t == 0) {
            av = to_f(h0[static_cast<size_t>(n) * a_width + i0 + col]);
          } else {
            const size_t prev = row - n_rows;
            if (to_f(keep[prev]) > 0.5f)
              av = to_f(a[prev * a_width + i0 + col]);
          }
        } else {
          av = to_f(a[row * a_width + i0 + col]);
        }
        gv = to_f(dg[row * g4 + j0 + col]);
      }
      a_s[mm][col] = av;
      b_s[mm][col] = gv;
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < kTileM; ++mm) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[mm][ti * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[mm][tj * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a4[p], b4[q], acc[p][q]);
      if (ti == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_b[q] += b4[q];
      }
    }
    __syncthreads();
  }

  float* out = part_w + static_cast<size_t>(blockIdx.z) * a_width * g4;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[static_cast<size_t>(i0 + ti * 4 + p) * g4 + j0 + tj * 4 + q] =
          acc[p][q];
  if (part_b != nullptr && blockIdx.y == 0 && ti == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      part_b[static_cast<size_t>(blockIdx.z) * g4 + j0 + tj * 4 + q] =
          acc_b[q];
  }
}

// out[e] = sum over splits of part[s][e], in split order (deterministic).
template <typename T>
static __global__ void sum_splits_kernel(const float* __restrict__ part,
                                  T* __restrict__ out, int splits,
                                  int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += part[static_cast<size_t>(k) * count + e];
  out[e] = from_f<T>(s);
}

template <typename T>
static int sum_splits(const void* part, void* out, int splits, int count,
               cudaStream_t stream) {
  sum_splits_kernel<T><<<(count + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(static_cast<const float*>(part),
                                   static_cast<T*>(out), splits, count);
  return static_cast<int>(cudaGetLastError());
}

// out[p][e] (p < num_policies) = the sum over the chunks c of policy p
// (chunk_policy[c] == p), in chunk order, of their per_chunk partials
// part[c * per_chunk + k][e] in order; 0 for a policy that owns no chunk.
// With one chunk this is sum_splits over its partials, bitwise.
template <typename T>
static __global__ void sum_by_policy_kernel(const float* __restrict__ part,
                                            T* __restrict__ out,
                                            const int* __restrict__ chunk_policy,
                                            int num_chunks, int per_chunk,
                                            int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  if (e >= count) return;
  float s = 0.0f;
  for (int c = 0; c < num_chunks; ++c) {
    if (chunk_policy[c] != p) continue;
    for (int k = 0; k < per_chunk; ++k)
      s += part[(static_cast<size_t>(c) * per_chunk + k) * count + e];
  }
  out[static_cast<size_t>(p) * count + e] = from_f<T>(s);
}

template <typename T>
static int sum_by_policy(const void* part, void* out, const void* chunk_policy,
                         int num_chunks, int per_chunk, int num_policies,
                         int count, cudaStream_t stream) {
  const dim3 grid((count + kThreads - 1) / kThreads, num_policies);
  sum_by_policy_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out),
      static_cast<const int*>(chunk_policy), num_chunks, per_chunk, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mlt
