// The rows a block of a recurrent kernel owns, shared by the chunk-indexed
// instances of lstm.cu and gru.cu (lstm_sequence_{fwd,bwd}_chunked,
// gru_sequence_{fwd,bwd}_chunked): the policy-batched passes of a
// population, where JAX vmaps a kernel's pallas_call over chunks of one
// policy each. Each .cu file is its own translation unit, so these live
// here, static, as weight_grad.cuh's templates do.

#pragma once

#include "common.cuh"

namespace mlt {

// The rows a block owns and the policy whose weights it reads. Without
// chunks (chunk_policy null) block i owns rows [i R, (i + 1) R) of the
// n_rows and reads policy 0's weights. The chunk-indexed instances take the
// rows as [num_chunks][chunk], each chunk of one policy: block i owns row
// tile i % tiles of chunk i / tiles, tiles = ceil(chunk / R), so that no
// block straddles two chunks (chunk need not be a multiple of R), and reads
// the weights of policy chunk_policy[chunk] at an offset into the [P, ...]
// stacks. Rows past the chunk's end are treated as rows past N: zero-filled
// and never stored. A row's arithmetic is the same in both: it depends only
// on its own inputs and its policy's weights.
struct FwdRows {
  int first;    // the block's first row
  int end;      // rows from here on are not the block's chunk's
  int policy;
};

// Row tile `tile` (blockIdx.x, or a cluster's index where the blocks of a
// cluster share their rows).
static __device__ __forceinline__ FwdRows fwd_rows(const int* chunk_policy,
                                                   int chunk,
                                                   int rows_per_block,
                                                   int n_rows, int tile) {
  if (chunk_policy == nullptr) return {tile * rows_per_block, n_rows, 0};
  const int tiles = (chunk + rows_per_block - 1) / rows_per_block;
  const int c = tile / tiles;
  return {c * chunk + (tile % tiles) * rows_per_block,
          min(c * chunk + chunk, n_rows), chunk_policy[c]};
}

static __device__ __forceinline__ FwdRows fwd_rows(const int* chunk_policy,
                                                   int chunk,
                                                   int rows_per_block,
                                                   int n_rows) {
  return fwd_rows(chunk_policy, chunk, rows_per_block, n_rows,
                  static_cast<int>(blockIdx.x));
}

// NaN into the block's rows of each of the `steps` slices of a [steps,
// n_rows, width] tensor: a chunk whose policy lies outside [0, P) (custom
// policies, which the simulator plays) runs no step and reads no weight.
template <typename T>
static __device__ void fill_nan(T* out, int steps, int n_rows, int width,
                                FwdRows rows, int rows_per_block) {
  const int count = min(rows.first + rows_per_block, rows.end) - rows.first;
  const T nan = from_f<T>(__int_as_float(0x7fc00000));
  for (int t = 0; t < steps; ++t)
    for (int e = threadIdx.x; e < count * width; e += blockDim.x)
      out[(static_cast<size_t>(t) * n_rows + rows.first) * width + e] = nan;
}

// Row tiles of a pass: ceil(n_rows / R), or, with chunks, ceil(chunk / R)
// a chunk (fwd_rows); a block each, or a cluster each where a cluster's
// blocks split the tile's work.
static inline int fwd_blocks(const void* chunk_policy, int num_chunks,
                             int chunk, int n_rows, int rows_per_block) {
  return chunk_policy == nullptr
             ? (n_rows + rows_per_block - 1) / rows_per_block
             : num_chunks * ((chunk + rows_per_block - 1) / rows_per_block);
}

}  // namespace mlt
