// lstm_sequence_fwd / lstm_sequence_bwd: the fused LSTM sequence pass,
// forward and backward; lstm_sequence_proj_fwd / lstm_sequence_proj_bwd:
// the same pass with the input projection x . Wi inside the kernel.
//
// Replaces madrona_learn_tpu/ops/pallas/lstm.py:lstm_sequence: the forward
// _fwd_kernel (lstm_sequence_fwd) and the custom backward _bwd_kernel with
// its fused dWr/db epilogue (lstm_sequence_bwd); and lstm_sequence_proj:
// _fwd_proj_kernel (lstm_sequence_proj_fwd) and _bwd_proj_kernel with its
// fused dWi/dWr/db epilogue (lstm_sequence_proj_bwd).
//
// What the TPU layout did, and why it cannot carry over: each TPU grid
// program keeps all of Wr [H, 4H] (and Wi [F, 4H]) resident in VMEM next to
// its batch tile and carries (c, h) in VMEM scratch along a sequential time
// grid axis. At H = 256 in bf16 Wr is 512 KiB, more than the 227 KB of
// shared memory a Hopper block can hold, and Hopper blocks run in parallel
// in no order, so neither the resident weight nor a sum carried across grid
// steps exists.
//
// In float32, and float16 at H = 384 and 512 (layout and product in
// common.cuh), forwards and backwards (the projection variant in float32
// only):
// - One block owns kRows batch rows and all H units of those rows, and
//   loops over time inside the kernel (the TPU's sequential grid axis
//   becomes the in-block loop). Each thread computes all four gates of its
//   (row, unit) pairs, so the gate math needs no exchange between threads:
//   the c carry stays in registers, only h (which every unit's product
//   reads) goes through shared memory.
// - Wr and Wi are read from global memory every step; they stay resident
//   in the 50 MB L2, and a block reuses each element for kRows rows.
// - The products are plain f32 FMA loops with storage-type operands
//   converted exactly to f32: the TPU kernel's "f32 accumulate from
//   storage-type operands" contract.
// - Gate math in f32; ys and cs are rounded to the storage type; the carry
//   is cleared after step t where keep[t] == 0, after the outputs are
//   written (step-then-reset, ops/pallas/lstm.py:113-120).
// - Backward: the same row ownership in reverse time. h_in / c_in come from
//   ys / cs at t-1 after the keep mask (h0 / c0 at t = 0), the gates are
//   recomputed, dgates are rounded to the storage type, and
//   dh_prev = dgates . Wr^T runs in the kernel against a transposed copy of
//   Wr so its loads coalesce the same way. dh / dc carry in f32 registers.
// - dWr = sum h_in^T . dgates, db = sum dgates (and dWi = sum x^T . dgates)
//   cannot accumulate in one output block across parallel blocks. A second
//   kernel (weight_grad.cuh, shared with gru.cu) computes per-split f32
//   partials over contiguous slices of the T*N rows (h_in recomputed on
//   the fly from ys, keep and h0), and a third sums the splits in a fixed
//   order, so the result is the same run to run.
// - Projection variant: the block stages its [kRows, F] slice of x_t in
//   shared memory and computes xp = round(x_t . Wi) (the rounding point of
//   the hoisted Dense), then adds h . Wr into the same accumulators. The
//   backward recomputes xp the same way, writes the rounded dgates to a
//   scratch [T, N, 4H] for the weight-gradient pass, and emits
//   dx = round(dgates . Wi^T) in 128-column chunks against a transposed
//   copy of Wi.
// These are bound by CUDA-core FMA issue and shared/L1 load throughput, far
// below the tensor-core rate that bounds the work itself.
//
// In bfloat16, all four on Hopper's tensor cores: the forwards
// (lstm_fwd_tc_kernel) and the backwards (lstm_bwd_tc_kernel, then
// weight_grad_tc.cuh). The TPU kernel's products are bf16 operands with f32
// accumulation, which is what wgmma computes, with only the order of the
// sums changed. The wrappers' rules (ops/cuda/lstm.py: bwd_uses_tensor_cores,
// which fwd_uses_tensor_cores is, and uses_tensor_cores for the projection)
// send the bf16 sequence and projection kernels here at every width (an
// operand off a 16-byte boundary is copied onto one first), and float32
// (and float16 at 384 and 512) to the kernels above. At 384 and 512 the
// units are split over a cluster of two blocks ("Wider layers", at the
// dispatch).
// The float16 sequence kernels (lstm_sequence_fwd / _bwd and their
// chunk-indexed instances, the port's own: JAX sends float16 to its jnp
// twin) take the same kernels at H = 128 and 256 with f16 operands (wgmma
// .f16, f32 sums; ys, cs, dgates, dh0, dc0, dWr and db rounded once to
// f16, where the CUDA-core kernels and the plain twin round them), so the
// float16 backward, too, recomputes the pre-activations of the forward
// that ran, bitwise.
// - Row ownership as above, with R rows a block (kFwdTcRows for the
//   forwards, kTcRows for the backwards: the fastest on the H100, PERF.md):
//   warpgroup w owns units 64 w .. 64 w + 63 of all four gates, so the gate
//   math and the f32 carries (c; dh / dc) stay thread-local. The products
//   run transposed, gates (or units, or input features) as wgmma's M and
//   the block's rows as its N: gates^T = Wr^T . h^T, dh_prev^T = Wr .
//   dgates^T, and for the projection xp^T = Wi^T . x^T (rounded to bf16 in
//   the accumulators before h . Wr is added) and dx^T = Wi . dgates^T
//   (rounded once), each warpgroup's result in the layout of its carries.
//   One helper (preactivations, gate_pre) computes the pre-activations for
//   the forward and for the backward's recompute, so both compute them
//   alike, at every width in bf16 and at H = 128 and 256 in f16.
// - A: 64-deep slices of the weights (128-byte swizzle) through a ring of
//   stages (32 KB at H = 256) filled by TMA (slice_ring.cuh, shared with
//   gru.cu and policy_step.cu): a forward step takes Wi then Wr as
//   MN-major boxes of the weights as they stand ([64 k][64 units], as
//   policy_step.cu reads its weights), so a rollout step copies no weight;
//   a backward step takes K-major slices ([U rows][64], U the block's
//   units) of Wi^T, Wr^T, Wr and Wi, against transposed copies made once a
//   call. The sequence is
//   the same every step, so the ring prefetches across steps and phases.
//   Wr is 512 KiB in bf16 at H = 256, more than a block's
//   shared memory, so it streams from L2 every step; a block reuses each
//   element for its R rows.
// - B: the block's h tile (forward; h_in in the backward) and the x or
//   dgates tile ([R][K] bf16, K-major, the same swizzle) in shared memory.
//   The forward's gate math writes the next step's carry (h after the keep
//   mask, already bf16) straight into the h tile, so h never goes through
//   global memory between steps; x_proj (or x) arrives by 16-byte cp.async
//   with zero-fill, the next step's during this step's products (x of the
//   projection in two buffers where 2 F <= 4H), and each thread stores its
//   own ys / cs elements. The backward's x_proj (or x) lands in
//   the dgates tile, which the gate math then overwrites element by element
//   (each thread rewrites only what it read); h_in, c_in (cleared by keep),
//   cs and dys arrive the same way. Rows past N give exact zeros and are
//   never stored; their dgates are set to 0.
// - The backward writes the rounded dgates (dx_proj, or a scratch), h_in
//   as each step used it ([T, N, H] scratch) and per-block db partials.
//   Then weight_grad_tc.cuh: dW = [x |] h_in^T . dgates as split-K wgmma
//   over the T*N rows ([F + H, 4H] in one launch for the projection), f32
//   partials per split, summed in split order; db from the block partials
//   in block order. Deterministic, and a row's results (ys, cs; dgates,
//   dx, dh0, dc0) depend neither on N, nor on where the row sits, nor, in
//   the forward, on T: the rollout step (T = 1) is step t of the update
//   pass bitwise.
//
// The chunk-indexed instance of the forward (lstm_sequence_fwd_chunked, both
// paths) is the rollout step of a population in the policy-chunk layout:
// JAX vmaps the forward's pallas_call over [B, C] chunks of one policy each
// (madrona_learn_tpu/rollouts.py:580), every program reading its chunk's
// weights. Here the rows are [B][C], a block owns one row tile of one chunk
// (fwd_rows, chunk_rows.cuh: no block straddles two policies, and C need
// not be a multiple of R), and reads its policy's slice of the [P, H, 4H] / [P, 4H] stacks:
// by a pointer offset on CUDA cores (float32; float16 at 384 and 512), by
// the third
// coordinate of one TMA map over the whole stack on tensor cores (no map
// a policy, no gathered copy of the weights; at 384 and 512 both blocks of
// a cluster share the row tile and its policy). A row's arithmetic is the
// single-policy kernel's, so
// every row equals lstm_sequence_fwd's with its policy's weights bitwise.
// Bound as the forward: streaming each block's policy's Wr from L2 a step;
// the 12 policies' 6 MiB stay resident.
//
// The chunk-indexed instance of the backward (lstm_sequence_bwd_chunked,
// both paths) is the learn step of a population: JAX vmaps algo.update, and
// with it the backward's pallas_call, over the train policies
// (madrona_learn_tpu/train.py:315), one chunk a policy's minibatch. The
// recurrence takes the forward's rows (fwd_rows) and reads its policy's Wr
// and Wr^T (a [P, 4H, H] stack, one transposed copy a call) the same way,
// so each row's dx_proj, dh0 and dc0 equal lstm_sequence_bwd's bitwise. A
// policy's rows t * N + n are not contiguous, so the weight-gradient pass
// splits each chunk's own T * chunk rows: the tensor-core pass reads them
// through maps of [T * chunks] slices of [chunk][K] (weight_grad_tc.cuh),
// the CUDA-core pass (float32; float16 at H = 384 and 512) by index
// (weight_grad.cuh),
// each chunk's splits by the
// single-policy rule over its rows, and sum_by_policy adds a policy's
// chunks' partials (db: its chunks' block partials) in chunk order. So a
// policy's dWr / db do not depend on the other chunks: alone or among 8
// they are the same bitwise, and where 64 divides the chunk they are the
// single-policy backward's over the same rows.
//
// The projection kernels have the same two instances
// (lstm_sequence_proj_{fwd,bwd}_chunked, both paths), for a population
// whose LSTM computes its input projection in the kernel (fuse_input_proj):
// JAX vmaps lstm_sequence_proj's pallas_calls with algo.update over the
// train policies. Wi joins the stacks ([P, F, 4H], and [P, 4H, F] of Wi^T
// for the backward, one transposed copy a call), read like Wr; the
// backward's dx is a row's own, and each policy's dWi / dWr / db are its
// chunks' partials summed in chunk order: on tensor cores one pass over
// [x | h_in] of each chunk's [T * chunks] slices gives [F + H, 4H] a split,
// as the single-policy pass gives it over all rows. Where 64 divides the
// chunk, a policy's weight gradients are the single-policy backward's over
// its rows bitwise.
//
// Bound on the H100: the forward is a chain of [BN, H] x [H, 4H] products
// (and [BN, F] x [F, 4H]) with a dependency between steps; its memory
// traffic is one read of x or x_proj and one write of ys/cs per step, 0.12
// ms at [16, 8192, 256] (0.14 ms by operations with the projection). The
// bf16 backward's products take ~0.2 ms on tensor cores at that shape (0.4
// ms with the projection at F = 256). What holds the tensor-core kernels is
// streaming the weights from L2 every step: |Wr| (+ |Wi|) a block a step
// forward, twice that backward; (N / R) T |Wr| is ~2.1 GB a forward call
// at R = 32, ~8.6 GB a backward call.

#include <cuda.h>   // CUtensorMap

#include "chunk_rows.cuh"
#include "common.cuh"
#include "mma.cuh"
#include "slice_ring.cuh"
#include "weight_grad.cuh"
#include "weight_grad_tc.cuh"

namespace {

using namespace mlt;

// A chunk whose policy lies outside [0, P) (custom policies, which the
// simulator plays) runs no step and reads no weight: its rows' ys and cs
// are NaN at every step, as grouped_matmul writes NaN rows for it; in the
// backward its dx_proj, dh0 and dc0, and it adds to no policy's dWr / db.
template <typename T>
__device__ void fill_nan_rows(T* ys, T* cs, int steps, int n_rows,
                              int hidden, FwdRows rows, int rows_per_block) {
  fill_nan(ys, steps, n_rows, hidden, rows, rows_per_block);
  fill_nan(cs, steps, n_rows, hidden, rows, rows_per_block);
}

template <typename T>
__device__ void fill_nan_bwd_rows(T* dx, T* dh0, T* dc0, int steps,
                                  int n_rows, int hidden, FwdRows rows,
                                  int rows_per_block) {
  fill_nan(dx, steps, n_rows, 4 * hidden, rows, rows_per_block);
  fill_nan(dh0, 1, n_rows, hidden, rows, rows_per_block);
  fill_nan(dc0, 1, n_rows, hidden, rows, rows_per_block);
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ keep,
                    const T* __restrict__ wr, const T* __restrict__ bias,
                    const T* __restrict__ c0, const T* __restrict__ h0,
                    T* __restrict__ ys, T* __restrict__ cs, int steps,
                    int n_rows, const int* __restrict__ chunk_policy,
                    int chunk, int num_policies) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G4 = 4 * H;
  __shared__ float h_s[kRows * H];

  const FwdRows rows = fwd_rows(chunk_policy, chunk, kRows, n_rows);
  if (rows.policy < 0 || rows.policy >= num_policies) {
    fill_nan_rows(ys, cs, steps, n_rows, H, rows, kRows);
    return;
  }
  wr += static_cast<size_t>(rows.policy) * H * G4;
  bias += static_cast<size_t>(rows.policy) * G4;

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = rows.first;

  float b[4][UPT];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < UPT; ++j) b[g][j] = to_f(bias[g * H + u0 + j]);

  float c[RPT][UPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const size_t idx = static_cast<size_t>(n) * H + u0 + j;
      c[i][j] = n < rows.end ? to_f(c0[idx]) : 0.0f;
      h_s[(row_base + i) * H + u0 + j] = n < rows.end ? to_f(h0[idx]) : 0.0f;
    }
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    float acc[RPT][4][UPT];
    row_tile_product<T, 4, RPT, UPT>(h_s, H, wr, G4, H, row_base, u0, acc);
    __syncthreads();  // every thread has read h_s for this step

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = block_row + row_base + i;
      if (n >= rows.end) continue;
      const size_t row = static_cast<size_t>(t) * n_rows + n;
      const T* x = xp + row * G4 + u0;
      const bool kept = to_f(keep[row]) > 0.5f;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const float gi = to_f(x[0 * H + j]) + acc[i][0][j] + b[0][j];
        const float gf = to_f(x[1 * H + j]) + acc[i][1][j] + b[1][j];
        const float gg = to_f(x[2 * H + j]) + acc[i][2][j] + b[2][j];
        const float go = to_f(x[3 * H + j]) + acc[i][3][j] + b[3][j];
        const float new_c =
            sigmoid_f(gf) * c[i][j] + sigmoid_f(gi) * tanhf(gg);
        const float new_h = sigmoid_f(go) * tanhf(new_c);
        const T c_t = from_f<T>(new_c);
        const T h_t = from_f<T>(new_h);
        ys[row * H + u0 + j] = h_t;
        cs[row * H + u0 + j] = c_t;
        c[i][j] = kept ? to_f(c_t) : 0.0f;
        h_s[(row_base + i) * H + u0 + j] = kept ? to_f(h_t) : 0.0f;
      }
    }
    __syncthreads();  // the new h is complete before the next product
  }
}

// Projection forward: as lstm_fwd_kernel with the gate pre-activations
// round(x_t . Wi) + h . Wr + b. Shared memory: h_s [kRows][H] then
// x_s [kRows][F]. With chunks (lstm_sequence_proj_fwd_chunked), the rows
// and policy of fwd_rows and that policy's Wi, Wr and bias at an offset
// into the [P, F, 4H], [P, H, 4H] and [P, 4H] stacks.
template <typename T, int H>
__global__ void __launch_bounds__(kThreads) lstm_proj_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ keep,
    const T* __restrict__ wi, const T* __restrict__ wr,
    const T* __restrict__ bias, const T* __restrict__ c0,
    const T* __restrict__ h0, T* __restrict__ ys, T* __restrict__ cs,
    int steps, int n_rows, int f_in, const int* __restrict__ chunk_policy,
    int chunk, int num_policies) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G4 = 4 * H;
  extern __shared__ float smem[];
  float* h_s = smem;
  float* x_s = smem + kRows * H;

  const FwdRows rows = fwd_rows(chunk_policy, chunk, kRows, n_rows);
  if (rows.policy < 0 || rows.policy >= num_policies) {
    fill_nan_rows(ys, cs, steps, n_rows, H, rows, kRows);
    return;
  }
  wi += static_cast<size_t>(rows.policy) * f_in * G4;
  wr += static_cast<size_t>(rows.policy) * H * G4;
  bias += static_cast<size_t>(rows.policy) * G4;
  const int row_end = rows.end;

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = rows.first;

  float b[4][UPT];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < UPT; ++j) b[g][j] = to_f(bias[g * H + u0 + j]);

  float c[RPT][UPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const size_t idx = static_cast<size_t>(n) * H + u0 + j;
      c[i][j] = n < row_end ? to_f(c0[idx]) : 0.0f;
      h_s[(row_base + i) * H + u0 + j] = n < row_end ? to_f(h0[idx]) : 0.0f;
    }
  }

  for (int t = 0; t < steps; ++t) {
    load_row_tile<T>(x_s, x + static_cast<size_t>(t) * n_rows * f_in,
                     block_row, row_end, f_in);
    __syncthreads();  // x_s and h_s of this step are complete

    float acc[RPT][4][UPT];
    row_tile_product<T, 4, RPT, UPT>(x_s, f_in, wi, G4, H, row_base, u0,
                                     acc);
    // xp at the hoisted Dense's rounding point, then + h . Wr.
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < UPT; ++j) acc[i][g][j] = round_to<T>(acc[i][g][j]);
    row_tile_fma<T, 4, RPT, UPT>(h_s, H, wr, G4, H, row_base, u0, acc);
    __syncthreads();  // every thread has read h_s and x_s for this step

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = block_row + row_base + i;
      if (n >= row_end) continue;
      const size_t row = static_cast<size_t>(t) * n_rows + n;
      const bool kept = to_f(keep[row]) > 0.5f;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const float gi = acc[i][0][j] + b[0][j];
        const float gf = acc[i][1][j] + b[1][j];
        const float gg = acc[i][2][j] + b[2][j];
        const float go = acc[i][3][j] + b[3][j];
        const float new_c =
            sigmoid_f(gf) * c[i][j] + sigmoid_f(gi) * tanhf(gg);
        const float new_h = sigmoid_f(go) * tanhf(new_c);
        const T c_t = from_f<T>(new_c);
        const T h_t = from_f<T>(new_h);
        ys[row * H + u0 + j] = h_t;
        cs[row * H + u0 + j] = c_t;
        c[i][j] = kept ? to_f(c_t) : 0.0f;
        h_s[(row_base + i) * H + u0 + j] = kept ? to_f(h_t) : 0.0f;
      }
    }
    // The next step's first barrier orders these h_s writes before its
    // product; its x_s writes touch no data read after this point.
  }
}

// The three steps of the projection backward's time loop below.
// lstm_bwd_kernel (further down) inlines the same code, with x_proj read
// from memory: built on these helpers it ran 9% slower on an H100 80GB
// HBM3 (52 -> 57 ms over one headline update's four calls).

// The carry into step t of rows row_base.. of this block: the cleared
// state after step t-1, or the unmasked initial state at t == 0. h_in goes
// to hin_s, c_in to registers. Rows from row_end on are not the block's
// (past N, or past its chunk); n_rows strides the [T, N] tensors.
template <typename T, int H, int RPT, int UPT>
__device__ __forceinline__ void load_carry_in(
    const T* __restrict__ keep, const T* __restrict__ ys,
    const T* __restrict__ cs, const T* __restrict__ h0,
    const T* __restrict__ c0, int t, int n_rows, int row_end, int block_row,
    int row_base, int u0, float* hin_s, float (&c_in)[RPT][UPT],
    bool (&keep_prev)[RPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
    keep_prev[i] = false;
    if (n < row_end && t > 0)
      keep_prev[i] =
          to_f(keep[static_cast<size_t>(t - 1) * n_rows + n]) > 0.5f;
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      float h_v = 0.0f, c_v = 0.0f;
      if (n < row_end) {
        if (t == 0) {
          const size_t idx = static_cast<size_t>(n) * H + u0 + j;
          h_v = to_f(h0[idx]);
          c_v = to_f(c0[idx]);
        } else if (keep_prev[i]) {
          const size_t idx =
              (static_cast<size_t>(t - 1) * n_rows + n) * H + u0 + j;
          h_v = to_f(ys[idx]);
          c_v = to_f(cs[idx]);
        }
      }
      hin_s[(row_base + i) * H + u0 + j] = h_v;
      c_in[i][j] = c_v;
    }
  }
}

// dgates of step t from the recomputed pre-activations pre (without the
// bias) and the carried cotangents, rounded to the storage type. Written to
// dg (global, [T, N, 4H]) and dg_s (shared, [kRows][4H]); dc_prev gets
// dc_total * f. Rows from row_end on get zero dgates.
template <typename T, int H, int RPT, int UPT>
__device__ __forceinline__ void gate_cotangents(
    const float (&pre)[RPT][4][UPT], const float (&b)[4][UPT],
    const float (&c_in)[RPT][UPT], const float (&dh)[RPT][UPT],
    const float (&dc)[RPT][UPT], const T* __restrict__ cs,
    const T* __restrict__ dys, T* __restrict__ dg, float* dg_s, int t,
    int n_rows, int row_end, int block_row, int row_base, int u0,
    float (&dc_prev)[RPT][UPT]) {
  constexpr int G4 = 4 * H;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
    const int r = row_base + i;
    if (n >= row_end) {
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
#pragma unroll
        for (int g = 0; g < 4; ++g) dg_s[r * G4 + g * H + u0 + j] = 0.0f;
        dc_prev[i][j] = 0.0f;
      }
      continue;
    }
    const size_t row = static_cast<size_t>(t) * n_rows + n;
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const float si = sigmoid_f(pre[i][0][j] + b[0][j]);
      const float sf = sigmoid_f(pre[i][1][j] + b[1][j]);
      const float tg = tanhf(pre[i][2][j] + b[2][j]);
      const float so = sigmoid_f(pre[i][3][j] + b[3][j]);
      const float tanh_c = tanhf(to_f(cs[row * H + u0 + j]));

      const float dh_total = to_f(dys[row * H + u0 + j]) + dh[i][j];
      const float dc_total =
          dc[i][j] + dh_total * so * (1.0f - tanh_c * tanh_c);
      const T d[4] = {
          from_f<T>(dc_total * tg * si * (1.0f - si)),
          from_f<T>(dc_total * c_in[i][j] * sf * (1.0f - sf)),
          from_f<T>(dc_total * si * (1.0f - tg * tg)),
          from_f<T>(dh_total * tanh_c * so * (1.0f - so)),
      };
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dg[row * G4 + g * H + u0 + j] = d[g];
        dg_s[r * G4 + g * H + u0 + j] = to_f(d[g]);
      }
      dc_prev[i][j] = dc_total * sf;
    }
  }
}

// After dh_prev / dc_prev of step t: dh0 / dc0 at t == 0, and the carried
// cotangents, which pick up the clear mask applied between the steps.
template <typename T, int H, int RPT, int UPT>
__device__ __forceinline__ void carry_cotangents(
    const float (&dh_prev)[RPT][1][UPT], const float (&dc_prev)[RPT][UPT],
    const bool (&keep_prev)[RPT], T* __restrict__ dh0, T* __restrict__ dc0,
    int t, int n_rows, int block_row, int row_base, int u0,
    float (&dh)[RPT][UPT], float (&dc)[RPT][UPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      if (t == 0 && n < n_rows) {
        const size_t idx = static_cast<size_t>(n) * H + u0 + j;
        dh0[idx] = from_f<T>(dh_prev[i][0][j]);
        dc0[idx] = from_f<T>(dc_prev[i][j]);
      }
      dh[i][j] = keep_prev[i] ? dh_prev[i][0][j] : 0.0f;
      dc[i][j] = keep_prev[i] ? dc_prev[i][j] : 0.0f;
    }
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(
    const T* __restrict__ xp, const T* __restrict__ keep,
    const T* __restrict__ wr, const T* __restrict__ wr_t,
    const T* __restrict__ bias, const T* __restrict__ c0,
    const T* __restrict__ h0, const T* __restrict__ ys,
    const T* __restrict__ cs, const T* __restrict__ dys, T* __restrict__ dxp,
    T* __restrict__ dh0, T* __restrict__ dc0, int steps, int n_rows,
    const int* __restrict__ chunk_policy, int chunk, int num_policies) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G4 = 4 * H;
  extern __shared__ float smem[];
  float* hin_s = smem;                 // [BN][H]  h entering step t
  float* dg_s = smem + kRows * H;      // [BN][4H] dgates of step t

  // The block's rows and policy, as the forward's (fwd_rows).
  const FwdRows rows = fwd_rows(chunk_policy, chunk, kRows, n_rows);
  if (rows.policy < 0 || rows.policy >= num_policies) {
    fill_nan_bwd_rows(dxp, dh0, dc0, steps, n_rows, H, rows, kRows);
    return;
  }
  wr += static_cast<size_t>(rows.policy) * H * G4;
  wr_t += static_cast<size_t>(rows.policy) * G4 * H;
  bias += static_cast<size_t>(rows.policy) * G4;
  const int row_end = rows.end;

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = rows.first;

  float b[4][UPT];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < UPT; ++j) b[g][j] = to_f(bias[g * H + u0 + j]);

  float dh[RPT][UPT];
  float dc[RPT][UPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      dh[i][j] = 0.0f;
      dc[i][j] = 0.0f;
    }

  for (int t = steps - 1; t >= 0; --t) {
    // The carry into step t: the cleared state after step t-1, or the
    // unmasked initial state at t == 0.
    float c_in[RPT][UPT];
    bool keep_prev[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = block_row + row_base + i;
      keep_prev[i] = false;
      if (n < row_end && t > 0)
        keep_prev[i] =
            to_f(keep[static_cast<size_t>(t - 1) * n_rows + n]) > 0.5f;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        float h_v = 0.0f, c_v = 0.0f;
        if (n < row_end) {
          if (t == 0) {
            const size_t idx = static_cast<size_t>(n) * H + u0 + j;
            h_v = to_f(h0[idx]);
            c_v = to_f(c0[idx]);
          } else if (keep_prev[i]) {
            const size_t idx =
                (static_cast<size_t>(t - 1) * n_rows + n) * H + u0 + j;
            h_v = to_f(ys[idx]);
            c_v = to_f(cs[idx]);
          }
        }
        hin_s[(row_base + i) * H + u0 + j] = h_v;
        c_in[i][j] = c_v;
      }
    }
    __syncthreads();

    float acc[RPT][4][UPT];
    row_tile_product<T, 4, RPT, UPT>(hin_s, H, wr, G4, H, row_base, u0,
                                     acc);

    float dc_prev[RPT][UPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = block_row + row_base + i;
      const int r = row_base + i;
      if (n >= row_end) {
#pragma unroll
        for (int j = 0; j < UPT; ++j) {
#pragma unroll
          for (int g = 0; g < 4; ++g) dg_s[r * G4 + g * H + u0 + j] = 0.0f;
          dc_prev[i][j] = 0.0f;
        }
        continue;
      }
      const size_t row = static_cast<size_t>(t) * n_rows + n;
      const T* x = xp + row * G4 + u0;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const float si =
            sigmoid_f(to_f(x[0 * H + j]) + acc[i][0][j] + b[0][j]);
        const float sf =
            sigmoid_f(to_f(x[1 * H + j]) + acc[i][1][j] + b[1][j]);
        const float tg = tanhf(to_f(x[2 * H + j]) + acc[i][2][j] + b[2][j]);
        const float so =
            sigmoid_f(to_f(x[3 * H + j]) + acc[i][3][j] + b[3][j]);
        const float tanh_c = tanhf(to_f(cs[row * H + u0 + j]));

        const float dh_total = to_f(dys[row * H + u0 + j]) + dh[i][j];
        const float dc_total =
            dc[i][j] + dh_total * so * (1.0f - tanh_c * tanh_c);
        const T d[4] = {
            from_f<T>(dc_total * tg * si * (1.0f - si)),
            from_f<T>(dc_total * c_in[i][j] * sf * (1.0f - sf)),
            from_f<T>(dc_total * si * (1.0f - tg * tg)),
            from_f<T>(dh_total * tanh_c * so * (1.0f - so)),
        };
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dxp[row * G4 + g * H + u0 + j] = d[g];
          dg_s[r * G4 + g * H + u0 + j] = to_f(d[g]);
        }
        dc_prev[i][j] = dc_total * sf;
      }
    }
    __syncthreads();

    // dh_prev = dgates . Wr^T, against Wr^T [4H, H] so loads coalesce.
    float dh_prev[RPT][1][UPT];
    row_tile_product<T, 1, RPT, UPT>(dg_s, G4, wr_t, H, 0, row_base, u0,
                                     dh_prev);

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = block_row + row_base + i;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        if (t == 0 && n < row_end) {
          const size_t idx = static_cast<size_t>(n) * H + u0 + j;
          dh0[idx] = from_f<T>(dh_prev[i][0][j]);
          dc0[idx] = from_f<T>(dc_prev[i][j]);
        }
        // Cotangents flowing into the stored step-(t-1) state pick up the
        // clear mask applied between the steps.
        dh[i][j] = keep_prev[i] ? dh_prev[i][0][j] : 0.0f;
        dc[i][j] = keep_prev[i] ? dc_prev[i][j] : 0.0f;
      }
    }
    // The next iteration writes hin_s only after this point and dg_s only
    // after its own first barrier, by which time every thread has finished
    // reading dg_s here.
  }
}

// Whether the projection backward's x tile shares the dgates tile's
// shared memory: where hin_s, dg_s and an x tile of F = 4H would not fit
// side by side (H = 512: 288 KiB at kRows = 16).
template <int H>
constexpr bool kProjXInDg = kRows * 9 * H * 4 > kSmemLimit;

// Projection backward. Shared memory: hin_s [kRows][H], dg_s [kRows][4H],
// x_s [kRows][F] (in dg_s where kProjXInDg: x is read by the recompute
// alone, before the gate math writes the dgates). With chunks
// (lstm_sequence_proj_bwd_chunked), the rows and policy of fwd_rows, and
// that policy's Wi, Wi^T, Wr, Wr^T and bias at an offset into their
// [P, ...] stacks.
template <typename T, int H>
__global__ void __launch_bounds__(kThreads) lstm_proj_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ keep,
    const T* __restrict__ wi, const T* __restrict__ wi_t,
    const T* __restrict__ wr, const T* __restrict__ wr_t,
    const T* __restrict__ bias, const T* __restrict__ c0,
    const T* __restrict__ h0, const T* __restrict__ ys,
    const T* __restrict__ cs, const T* __restrict__ dys, T* __restrict__ dx,
    T* __restrict__ dg, T* __restrict__ dh0, T* __restrict__ dc0, int steps,
    int n_rows, int f_in, const int* __restrict__ chunk_policy, int chunk,
    int num_policies) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G4 = 4 * H;
  constexpr int kChunk = 2 * kUnitGroups;  // dx columns per pass
  extern __shared__ float smem[];
  float* hin_s = smem;
  float* dg_s = smem + kRows * H;
  float* x_s = kProjXInDg<H> ? dg_s : smem + kRows * 5 * H;

  const FwdRows rows = fwd_rows(chunk_policy, chunk, kRows, n_rows);
  if (rows.policy < 0 || rows.policy >= num_policies) {
    fill_nan(dx, steps, n_rows, f_in, rows, kRows);
    fill_nan(dh0, 1, n_rows, H, rows, kRows);
    fill_nan(dc0, 1, n_rows, H, rows, kRows);
    return;
  }
  const size_t pol = rows.policy;
  wi += pol * f_in * G4;
  wi_t += pol * G4 * f_in;
  wr += pol * H * G4;
  wr_t += pol * G4 * H;
  bias += pol * G4;
  const int row_end = rows.end;

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = rows.first;

  float b[4][UPT];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < UPT; ++j) b[g][j] = to_f(bias[g * H + u0 + j]);

  float dh[RPT][UPT];
  float dc[RPT][UPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      dh[i][j] = 0.0f;
      dc[i][j] = 0.0f;
    }

  for (int t = steps - 1; t >= 0; --t) {
    float c_in[RPT][UPT];
    bool keep_prev[RPT];
    load_carry_in<T, H, RPT, UPT>(keep, ys, cs, h0, c0, t, n_rows, row_end,
                                  block_row, row_base, u0, hin_s, c_in,
                                  keep_prev);
    load_row_tile<T>(x_s, x + static_cast<size_t>(t) * n_rows * f_in,
                     block_row, row_end, f_in);
    __syncthreads();

    // Pre-activations round(x . Wi) + h . Wr, as the forward computes them.
    float acc[RPT][4][UPT];
    row_tile_product<T, 4, RPT, UPT>(x_s, f_in, wi, G4, H, row_base, u0,
                                     acc);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < UPT; ++j) acc[i][g][j] = round_to<T>(acc[i][g][j]);
    row_tile_fma<T, 4, RPT, UPT>(hin_s, H, wr, G4, H, row_base, u0, acc);
    if constexpr (kProjXInDg<H>)
      __syncthreads();   // every thread is done reading x before the dgates

    float dc_prev[RPT][UPT];
    gate_cotangents<T, H, RPT, UPT>(acc, b, c_in, dh, dc, cs, dys, dg, dg_s,
                                    t, n_rows, row_end, block_row, row_base,
                                    u0, dc_prev);
    __syncthreads();

    float dh_prev[RPT][1][UPT];
    row_tile_product<T, 1, RPT, UPT>(dg_s, G4, wr_t, H, 0, row_base, u0,
                                     dh_prev);

    // dx = round(dgates . Wi^T), against Wi^T [4H, F], kChunk columns at a
    // time (F is a multiple of 128).
    for (int f0 = 0; f0 < f_in; f0 += kChunk) {
      float dxa[RPT][1][2];
      row_tile_product<T, 1, RPT, 2>(dg_s, G4, wi_t + f0, f_in, 0, row_base,
                                     ug * 2, dxa);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int n = block_row + row_base + i;
        if (n >= row_end) continue;
        T* out = dx + (static_cast<size_t>(t) * n_rows + n) * f_in + f0 +
                 ug * 2;
        out[0] = from_f<T>(dxa[i][0][0]);
        out[1] = from_f<T>(dxa[i][0][1]);
      }
    }

    carry_cotangents<T, H, RPT, UPT>(dh_prev, dc_prev, keep_prev, dh0, dc0, t,
                                     row_end, block_row, row_base, u0, dh,
                                     dc);
    // As in lstm_bwd_kernel: hin_s and x_s are rewritten before the next
    // first barrier and read by no thread after the second; dg_s is
    // rewritten only after the next first barrier. Where x_s is dg_s, the
    // next step's x waits until every thread has read this step's dgates.
    if constexpr (kProjXInDg<H>) __syncthreads();
  }
}

// dWr and db from the dgates of the whole sequence: partials, then sums.
// With chunks (chunk_policy non-null), `splits` partials a chunk over its
// own T * chunk rows, and each policy's sums over its chunks
// ([num_policies, H, 4H] and [num_policies, 4H]).
template <typename T, int H>
int launch_dwr(const void* dg, const void* ys, const void* keep,
               const void* h0, void* part_w, void* part_b, void* dwr,
               void* db, int steps, int n_rows, int splits,
               cudaStream_t stream, const void* chunk_policy = nullptr,
               int num_chunks = 1, int chunk = 0, int num_policies = 1) {
  if (chunk_policy == nullptr) chunk = n_rows;
  const long long total = static_cast<long long>(steps) * chunk;
  const int rows_per_split = static_cast<int>((total + splits - 1) / splits);
  const dim3 grid(4 * H / kTileJ, H / kTileI, num_chunks * splits);
  weight_grad_partial_kernel<T, true><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dg), static_cast<const T*>(ys),
      static_cast<const T*>(keep), static_cast<const T*>(h0),
      static_cast<float*>(part_w), static_cast<float*>(part_b), steps,
      n_rows, H, 4 * H, rows_per_split, chunk, splits);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (chunk_policy != nullptr) {
    err = sum_by_policy<T>(part_w, dwr, chunk_policy, num_chunks, splits,
                           num_policies, H * 4 * H, stream);
    if (err != 0) return err;
    return sum_by_policy<T>(part_b, db, chunk_policy, num_chunks, splits,
                            num_policies, 4 * H, stream);
  }
  err = sum_splits<T>(part_w, dwr, splits, H * 4 * H, stream);
  if (err != 0) return err;
  return sum_splits<T>(part_b, db, splits, 4 * H, stream);
}

// chunk_policy null: one policy; else the chunk-indexed instance (fwd_rows).
template <typename T, int H>
int launch_fwd(const void* xp, const void* keep, const void* wr,
               const void* bias, const void* c0, const void* h0, void* ys,
               void* cs, int steps, int n_rows, cudaStream_t stream,
               const void* chunk_policy = nullptr, int num_chunks = 0,
               int chunk = 0, int num_policies = 1) {
  const int blocks =
      fwd_blocks(chunk_policy, num_chunks, chunk, n_rows, kRows);
  lstm_fwd_kernel<T, H><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(keep),
      static_cast<const T*>(wr), static_cast<const T*>(bias),
      static_cast<const T*>(c0), static_cast<const T*>(h0),
      static_cast<T*>(ys), static_cast<T*>(cs), steps, n_rows,
      static_cast<const int*>(chunk_policy), chunk, num_policies);
  return static_cast<int>(cudaGetLastError());
}

// chunk_policy null: one policy; else the chunk-indexed instance
// (lstm_sequence_bwd_chunked), `splits` weight-gradient partials a chunk.
template <typename T, int H>
int launch_bwd(const void* xp, const void* keep, const void* wr,
               const void* wr_t, const void* bias, const void* c0,
               const void* h0, const void* ys, const void* cs,
               const void* dys, void* dxp, void* dh0, void* dc0,
               void* part_w, void* part_b, void* dwr, void* db, int steps,
               int n_rows, int splits, cudaStream_t stream,
               const void* chunk_policy = nullptr, int num_chunks = 1,
               int chunk = 0, int num_policies = 1) {
  const int smem = kRows * 5 * H * static_cast<int>(sizeof(float));
  int err = set_smem(lstm_bwd_kernel<T, H>, smem);
  if (err != 0) return err;
  const int blocks =
      fwd_blocks(chunk_policy, num_chunks, chunk, n_rows, kRows);
  lstm_bwd_kernel<T, H><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(keep),
      static_cast<const T*>(wr), static_cast<const T*>(wr_t),
      static_cast<const T*>(bias), static_cast<const T*>(c0),
      static_cast<const T*>(h0), static_cast<const T*>(ys),
      static_cast<const T*>(cs), static_cast<const T*>(dys),
      static_cast<T*>(dxp), static_cast<T*>(dh0), static_cast<T*>(dc0),
      steps, n_rows, static_cast<const int*>(chunk_policy), chunk,
      num_policies);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_dwr<T, H>(dxp, ys, keep, h0, part_w, part_b, dwr, db, steps,
                          n_rows, splits, stream, chunk_policy, num_chunks,
                          chunk, num_policies);
}

// chunk_policy null: one policy; else the chunk-indexed instance
// (lstm_sequence_proj_fwd_chunked, fwd_rows).
template <typename T, int H>
int launch_proj_fwd(const void* x, const void* keep, const void* wi,
                    const void* wr, const void* bias, const void* c0,
                    const void* h0, void* ys, void* cs, int steps,
                    int n_rows, int f_in, cudaStream_t stream,
                    const void* chunk_policy = nullptr, int num_chunks = 0,
                    int chunk = 0, int num_policies = 1) {
  const int smem = kRows * (H + f_in) * static_cast<int>(sizeof(float));
  int err = set_smem(lstm_proj_fwd_kernel<T, H>, smem);
  if (err != 0) return err;
  const int blocks =
      fwd_blocks(chunk_policy, num_chunks, chunk, n_rows, kRows);
  lstm_proj_fwd_kernel<T, H><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(keep),
      static_cast<const T*>(wi), static_cast<const T*>(wr),
      static_cast<const T*>(bias), static_cast<const T*>(c0),
      static_cast<const T*>(h0), static_cast<T*>(ys), static_cast<T*>(cs),
      steps, n_rows, f_in, static_cast<const int*>(chunk_policy), chunk,
      num_policies);
  return static_cast<int>(cudaGetLastError());
}

// chunk_policy null: one policy; else the chunk-indexed instance
// (lstm_sequence_proj_bwd_chunked), `splits` weight-gradient partials a
// chunk over its own T * chunk rows, summed by policy in chunk order.
template <typename T, int H>
int launch_proj_bwd(const void* x, const void* keep, const void* wi,
                    const void* wi_t, const void* wr, const void* wr_t,
                    const void* bias, const void* c0, const void* h0,
                    const void* ys, const void* cs, const void* dys,
                    void* dx, void* dg, void* dh0, void* dc0, void* part_wi,
                    void* part_w, void* part_b, void* dwi, void* dwr,
                    void* db, int steps, int n_rows, int f_in, int splits,
                    cudaStream_t stream, const void* chunk_policy = nullptr,
                    int num_chunks = 1, int chunk = 0, int num_policies = 1) {
  const int smem = kRows * (5 * H + (kProjXInDg<H> ? 0 : f_in)) *
                   static_cast<int>(sizeof(float));
  int err = set_smem(lstm_proj_bwd_kernel<T, H>, smem);
  if (err != 0) return err;
  const int blocks =
      fwd_blocks(chunk_policy, num_chunks, chunk, n_rows, kRows);
  lstm_proj_bwd_kernel<T, H><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(keep),
      static_cast<const T*>(wi), static_cast<const T*>(wi_t),
      static_cast<const T*>(wr), static_cast<const T*>(wr_t),
      static_cast<const T*>(bias), static_cast<const T*>(c0),
      static_cast<const T*>(h0), static_cast<const T*>(ys),
      static_cast<const T*>(cs), static_cast<const T*>(dys),
      static_cast<T*>(dx), static_cast<T*>(dg), static_cast<T*>(dh0),
      static_cast<T*>(dc0), steps, n_rows, f_in,
      static_cast<const int*>(chunk_policy), chunk, num_policies);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  err = launch_dwr<T, H>(dg, ys, keep, h0, part_w, part_b, dwr, db, steps,
                         n_rows, splits, stream, chunk_policy, num_chunks,
                         chunk, num_policies);
  if (err != 0) return err;
  if (chunk_policy == nullptr) chunk = n_rows;
  const long long total = static_cast<long long>(steps) * chunk;
  const int rows_per_split = static_cast<int>((total + splits - 1) / splits);
  const dim3 grid(4 * H / kTileJ, f_in / kTileI, num_chunks * splits);
  weight_grad_partial_kernel<T, false><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dg), static_cast<const T*>(x), nullptr, nullptr,
      static_cast<float*>(part_wi), nullptr, steps, n_rows, f_in, 4 * H,
      rows_per_split, chunk, splits);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (chunk_policy != nullptr)
    return sum_by_policy<T>(part_wi, dwi, chunk_policy, num_chunks, splits,
                            num_policies, f_in * 4 * H, stream);
  return sum_splits<T>(part_wi, dwi, splits, f_in * 4 * H, stream);
}

// ------------------------------------ bf16 and f16 backward on tensor cores

using bf16 = __nv_bfloat16;

// Batch rows a row tile of the tensor-core recurrence (R), by variant: the
// faster of 16 and 32 at the update shape on the H100. R = 32 halves the L2
// weight traffic but spills at H = 256; with the projection it still wins.
// The projection at H = 512 takes 16: at 32 the h_in (32 KiB), dgates
// (128 KiB, which also holds x of F <= 4H) and row tiles (48 KiB) leave no
// room for a ring stage of 32 KiB (TcBwd); at 384 they leave two of 24.
template <bool kProj, int H>
constexpr int kTcRows = kProj && H < 512 ? 32 : 16;

// Shared memory of lstm_bwd_tc_kernel, from a 1024-byte aligned base: the
// ring of weight slices ([U rows][64] each, U = H / kSplit the block's
// units), the block's h_in tile and its dgates tile (K-major wgmma B
// operands over all H units and 4H gates: [K / 64] subtiles of [R][64],
// 128-byte swizzle), then its cs, dys and c_in tiles ([R][U], its units).
template <int H, int R, int kSplit = 1>
struct TcBwd {
  static constexpr int kUnits = H / kSplit;
  static constexpr int kWarpgroups = kUnits / 64;   // 64 units each
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kWarps = 4 * kWarpgroups;
  static constexpr int kSub = R * 128;          // one [R][64] subtile
  static constexpr int kStageBytes = kUnits * 128;
  static constexpr int kHinBytes = R * H * 2;
  static constexpr int kDgBytes = R * 4 * H * 2;
  static constexpr int kTileBytes = R * kUnits * 2;
  static constexpr int kFixed = kHinBytes + kDgBytes + 3 * kTileBytes;
  static constexpr int kStages =
      min_c(4, (kSmemLimit - 2048 - kFixed) / kStageBytes);
  static constexpr int kSmem = kStages * kStageBytes + kFixed + 1024;
  static_assert(kStages >= 2, "a ring of at least two slices");
};

// No witness: the instances on the path write no product.
struct NoWitness {
  template <class A>
  __device__ __forceinline__ void operator()(int, const A&) const {}
};

// The witness of the projection's products (the kWitness instances of
// lstm_fwd_tc_kernel and lstm_bwd_tc_kernel): stage 0, round(x . Wi), and
// stage 1, round(x . Wi) + h . Wr (the pre-activations before the bias),
// of row `row` and unit `unit` of each gate into wit [2][T * N][4H] f32.
template <int H, int R>
struct ProjWitness {
  float* wit;
  size_t trow;      // t * N
  size_t rows;      // T * N
  int first_row;    // the thread's rows: first_row + 8 j + e
  int row_end;
  int unit;         // the thread's unit (+ 8 s)

  __device__ __forceinline__ void operator()(
      int stage, const float (&acc)[4][R / 2]) const {
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = first_row + 8 * j + e;
          if (row >= row_end) continue;
          float* out =
              wit + (stage * rows + trow + row) * 4 * H + unit + 8 * s;
#pragma unroll
          for (int g = 0; g < 4; ++g) out[g * H] = acc[g][4 * j + 2 * s + e];
        }
  }
};

// The gates' pre-activations of one step on tensor cores, gates as wgmma's
// M and the block's rows as its N, shared by the forward and the
// backward's recompute so that both compute them alike: acc[g] =
// round(x . Wi)^T (the hoisted Dense's rounding point) with the
// projection, then (+)= (h . Wr)^T; witness(0, acc) after the first,
// witness(1, acc) after the second (no-ops but in the witness instances).
// The ring's next slices are Wi by (F-chunk, gate), then Wr by (H-chunk,
// gate), each the block's units of
// its gate (all H, or H / 2 in a cluster of two), as K-major slices of the
// transposed weight (kTransA 0, the backward) or MN-major boxes of the
// weight as it stands (kTransA 1, the forward; ring_product); x_s is the
// K-major x tile (read with the projection only), h_s the K-major h tile
// over all H units, a_off this warpgroup's rows of a stage. E: the
// operands' type (bf16; f16 in the float16 backward).
template <int H, int R, bool kProj, int kTransA, typename E, int S,
          class Issue, class Witness = NoWitness>
__device__ __forceinline__ void preactivations(
    SliceRing<S>& slices, Issue& issue, float (&acc)[4][R / 2],
    uint32_t a_off, uint32_t x_s, uint32_t h_s, int f_in,
    const Witness& witness = Witness()) {
  constexpr int kSub = R * 128;   // one [R][64] subtile
  if constexpr (kProj) {
    for (int kc = 0; kc < f_in / kTcK; ++kc)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        ring_product<R, kTransA, E>(slices, issue, acc[g], a_off,
                                    x_s + kc * kSub, kc == 0);
    wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        wgmma_fence_operand(acc[g][i]);
        acc[g][i] = round_to<E>(acc[g][i]);
      }
    witness(0, acc);
  }
  for (int kc = 0; kc < H / kTcK; ++kc)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      ring_product<R, kTransA, E>(slices, issue, acc[g], a_off,
                                  h_s + kc * kSub, !kProj && kc == 0);
  wgmma_wait<0>();
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < R / 2; ++i) wgmma_fence_operand(acc[g][i]);
  if constexpr (kProj) witness(1, acc);
}

// One gate's pre-activation from its product acc: x_proj + h . Wr + b in
// that order (x_proj the E at x), or, with the projection, round(x . Wi)
// + h . Wr (both in acc) + b.
template <bool kProj, typename E>
__device__ __forceinline__ float gate_pre(const uint8_t* x, float acc,
                                          float b) {
  return kProj ? acc + b : ld_elem<E>(x) + acc + b;
}

// The reverse-time recurrence of the tensor-core backward (see the header),
// E the storage type: bf16, or f16 (the float16 instance, without the
// projection). One block owns R batch rows; warpgroup w owns units
// 64 w .. 64 w + 63 of all four gates. Thread (warp v of its warpgroup,
// lane l) holds units 64 w + 16 v + l / 4 (+ 8) and rows 8 j + 2 (l % 4)
// (+ 1) of each m64nR accumulator: element 4 j + 2 s + e is unit + 8 s,
// row 8 j + 2 (l % 4) + e. Outputs: dg (rounded dgates [T, N, 4H]), hin
// (h_in as the step used it, [T, N, H]), dx (projection), dh0, dc0 and
// part_b (this row tile's db partial, [tiles, 4H]).
//
// With kSplit = 2 (H = 384, 512) the two blocks of a cluster own the same
// R rows and H / 2 units each (rank r: units r H / 2 ..), as the forward's
// do, so a block keeps the H = 192 / 256 instance's warpgroups and
// registers. Each loads the whole h_in tile (from ys / h0, no exchange; with
// the projection the whole x tile too), recomputes its units'
// pre-activations from the Wi^T and Wr^T slices of its units in the
// forward's slice order, and streams the Wr rows of its units for
// dh_prev^T = Wr . dgates^T, whose K is all 4H gates: so after the gate
// math a thread writes its dgates into its own dgates tile and its peer's
// (distributed shared memory). With the projection, dx^T = Wi . dgates^T
// (K = 4H as well) is split by input feature: each band of H features
// gives rank r its U features r U .., the Wi rows of the ring's slices, so
// no feature is computed twice (a rank whose features of a band all lie
// past F issues no slice for it). Two cluster barriers a step keep the
// tiles right: the first after both blocks' pre-activations, so that no
// write reaches a dgates tile whose x the peer still reads or that the
// peer's dh_prev (dx) product of the step before still reads; the second
// after the writes (release / acquire, then fence.proxy.async on both
// sides), so that both blocks' products read both halves. A block never
// exits while its peer can still write into it: the last write is before
// the last step's second barrier, and a chunk of no policy is skipped by
// both blocks of its cluster together (they share its rows, so its
// policy). The kWitness instance (H = 384 and 512 with the projection)
// also writes each step's recomputed products to wit (ProjWitness), which
// the forward's kWitness instance writes from the products it computed:
// the witness that the two are the same bitwise. The other instances
// never touch wit.
template <typename E, int H, int R, bool kProj, int kSplit,
          bool kWitness = false>
__global__ void __launch_bounds__(TcBwd<H, R, kSplit>::kThreads, 1)
    lstm_bwd_tc_kernel(const __grid_constant__ CUtensorMap wit_map,
                       const __grid_constant__ CUtensorMap wrt_map,
                       const __grid_constant__ CUtensorMap wr_map,
                       const __grid_constant__ CUtensorMap wi_map,
                       const E* __restrict__ x, const E* __restrict__ keep,
                       const E* __restrict__ bias, const E* __restrict__ c0,
                       const E* __restrict__ h0, const E* __restrict__ ys,
                       const E* __restrict__ cs, const E* __restrict__ dys,
                       E* __restrict__ dx, E* __restrict__ dg,
                       E* __restrict__ hin, E* __restrict__ dh0,
                       E* __restrict__ dc0, float* __restrict__ part_b,
                       int steps, int n_rows, int f_in,
                       const int* __restrict__ chunk_policy, int chunk,
                       int num_policies, float* __restrict__ wit_out) {
  using L = TcBwd<H, R, kSplit>;
  constexpr int G4 = 4 * H;
  constexpr int U = L::kUnits;
  constexpr int S = L::kStages;
  constexpr int kAcc = R / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;
  const uint32_t hin_s = ring + S * L::kStageBytes;
  const uint32_t dg_s = hin_s + L::kHinBytes;
  const uint8_t* hin_p = smem_raw + (hin_s - raw_s);
  uint8_t* dg_p = smem_raw + (dg_s - raw_s);
  const uint8_t* cs_p = dg_p + L::kDgBytes;
  const uint8_t* dys_p = cs_p + L::kTileBytes;
  const uint8_t* cin_p = dys_p + L::kTileBytes;
  const uint32_t cs_s = dg_s + L::kDgBytes;
  const uint32_t dys_s = cs_s + L::kTileBytes;
  const uint32_t cin_s = dys_s + L::kTileBytes;

  // The block's rows and policy (fwd_rows, as the chunked forward's: the
  // cluster's row tile); a chunk of no policy is skipped before any
  // barrier, by the whole cluster (its dgates NaN, and with the projection
  // its dx). The maps span the [P, ...] stacks (P = 1 without chunks); the
  // policy is the third coordinate.
  const int rank = kSplit == 1 ? 0 : static_cast<int>(cluster_rank());
  const int tile = static_cast<int>(blockIdx.x) / kSplit;
  const FwdRows rows = fwd_rows(chunk_policy, chunk, R, n_rows, tile);
  if (rows.policy < 0 || rows.policy >= num_policies) {
    if (rank == 0) {
      fill_nan_bwd_rows(dg, dh0, dc0, steps, n_rows, H, rows, R);
      if constexpr (kProj) fill_nan(dx, steps, n_rows, f_in, rows, R);
    }
    return;
  }
  bias += static_cast<size_t>(rows.policy) * G4;
  const int row_end = rows.end;
  const int pol = rows.policy;

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32;
  const int lt = lane % 4;
  // unit0 counts the block's own units (the ring's rows, the row tiles'
  // columns); unit_base + unit0 is the unit of the layer.
  const int unit_base = rank * U;
  const int unit0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int block_row = rows.first;

  // The weight slices of one step, in the order the step consumes them:
  // Wi^T by (F-chunk, gate), Wr^T by (H-chunk, gate), Wr by 4H-chunk, Wi by
  // (band of H rows, 4H-chunk), each the U rows of the block's units (of
  // Wi: its U features of the band); the same sequence every step. A band
  // whose features of this block all lie past F is not loaded.
  const int xp_loads = kProj ? 4 * (f_in / kTcK) : 0;
  const int g_loads = 4 * (H / kTcK);
  const int d_loads = G4 / kTcK;
  const int bands =
      kProj && f_in > unit_base ? (f_in - unit_base + H - 1) / H : 0;
  const int step_loads = xp_loads + g_loads + d_loads * (1 + bands);
  const int total = steps * step_loads;
  const CUtensorMap* wit = &wit_map;
  const CUtensorMap* wrt = &wrt_map;
  const CUtensorMap* wrm = &wr_map;
  const CUtensorMap* wim = &wi_map;

  auto issue = [&](int q, uint32_t dst, uint64_t* bar) {
    int p = q % step_loads;
    if (p < xp_loads) {
      tma_load_3d(dst, wit, bar, (p / 4) * kTcK, (p % 4) * H + unit_base,
                  pol);
      return;
    }
    p -= xp_loads;
    if (p < g_loads) {
      tma_load_3d(dst, wrt, bar, (p / 4) * kTcK, (p % 4) * H + unit_base,
                  pol);
      return;
    }
    p -= g_loads;
    if (p < d_loads) {
      tma_load_3d(dst, wrm, bar, p * kTcK, unit_base, pol);
      return;
    }
    p -= d_loads;
    tma_load_3d(dst, wim, bar, (p % d_loads) * kTcK,
                (p / d_loads) * H + unit_base, pol);
  };
  SliceRing<S> slices{full, empty, ring, L::kStageBytes, total, 0};
  if (tid == 0) slices.init(L::kWarps);
  __syncthreads();
  if (tid == 0) slices.prime(issue);

  // acc (+)= this warpgroup's 64 rows of the ring's next slice . the [R][64]
  // operand subtile at b (slice_ring.cuh). Every warpgroup issues every
  // product, also where its rows of a Wi band lie past F and arrive as
  // zeros.
  const uint32_t a_off = wg * 64 * 128;
  auto consume = [&](float(&acc)[kAcc], uint32_t b, bool fresh) {
    ring_product<R, 0, E>(slices, issue, acc, a_off, b, fresh);
  };

  // Byte offsets of this thread's elements (rows 2 (l % 4) + e, units
  // unit0 + 8 s) in the K-major tiles and in the row tiles: row 8 j + .. is
  // j * 1024 (j * 16 U) bytes on, gate g of the dgates tile g (H / 64)
  // subtiles on.
  uint32_t kb[2][2], rb[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      kb[s][e] = kmaj_off<R>(2 * lt + e, unit_base + unit0 + 8 * s);
      rb[s][e] = row_off<U>(2 * lt + e, unit0 + 8 * s);
    }
  float b[4][2];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      b[g][s] = to_f(bias[g * H + unit_base + unit0 + 8 * s]);
  float dh[kAcc], dc[kAcc];   // carried cotangents
  float db[4][2];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    dh[i] = 0.0f;
    dc[i] = 0.0f;
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) db[g][0] = db[g][1] = 0.0f;

  // Column c of the block's 4U gate columns (its units of each gate) is
  // column g H + unit_base + u of the layer's 4H.
  auto gate_col = [&](int c) {
    return kSplit == 1 ? c : (c / U) * H + unit_base + c % U;
  };
  const int x_stride = kProj ? f_in : G4;
  const int x_width = kProj ? f_in : 4 * U;
  // The row tiles of step t, by 16-byte cp.async with zero-fill: the carry
  // into step t (h_in over all H units; c_in of the block's: the cleared
  // state after step t - 1, or the unmasked initial state at t == 0), cs
  // and dys of the block's units.
  auto load_rows = [&](int t) {
    const size_t trow = static_cast<size_t>(t) * n_rows;
    const size_t prow = trow - n_rows;
    for (int e = tid; e < R * (H / 8); e += L::kThreads) {
      const int n = e / (H / 8), c = e % (H / 8);
      const int row = block_row + n;
      const bool live = row < row_end;
      bool kept = live;
      const E* hs = h0;
      const E* cp = c0;
      const int cu = unit_base + c * 8;   // the c_in / cs / dys column
      if (live && t == 0) {
        hs = h0 + static_cast<size_t>(row) * H + c * 8;
        cp = c0 + static_cast<size_t>(row) * H + cu;
      } else if (live) {
        kept = to_f(keep[prow + row]) > 0.5f;
        hs = ys + (prow + row) * H + c * 8;
        cp = cs + (prow + row) * H + cu;
      }
      cp_async16(hin_s + kmaj_off<R>(n, c * 8), kept ? hs : h0, kept);
      if (c < U / 8) {
        cp_async16(cin_s + row_off<U>(n, c * 8), kept ? cp : c0, kept);
        const size_t off = live ? (trow + row) * H + cu : 0;
        cp_async16(cs_s + row_off<U>(n, c * 8), cs + off, live);
        cp_async16(dys_s + row_off<U>(n, c * 8), dys + off, live);
      }
    }
  };
  // x_proj (or x) of step t into the dgates tile, free until the gate math:
  // without the projection the block's own gate columns.
  auto load_x = [&](int t) {
    const size_t trow = static_cast<size_t>(t) * n_rows;
    for (int e = tid; e < R * (x_width / 8); e += L::kThreads) {
      const int n = e / (x_width / 8);
      const int col = kProj ? (e % (x_width / 8)) * 8
                            : gate_col((e % (x_width / 8)) * 8);
      const int row = block_row + n;
      const bool live = row < row_end;
      cp_async16(dg_s + kmaj_off<R>(n, col),
                 x + (live ? (trow + row) * x_stride + col : 0), live);
    }
  };
  // The peer's dgates tile, where this block writes its units' dgates.
  const uint32_t peer_dg =
      kSplit == 1 ? 0
                  : map_cluster_rank(dg_s, static_cast<uint32_t>(rank ^ 1));
  for (int t = steps - 1; t >= 0; --t) {
    const size_t trow = static_cast<size_t>(t) * n_rows;
    const size_t prow = trow - n_rows;   // step t - 1 (t > 0)
    load_rows(t);
    load_x(t);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    // h_in as this step used it, for the weight-gradient pass (the block's
    // units' columns).
    for (int e = tid; e < R * (U / 8); e += L::kThreads) {
      const int n = e / (U / 8), c = unit_base + (e % (U / 8)) * 8;
      const int row = block_row + n;
      if (row < row_end)
        *reinterpret_cast<uint4*>(hin + (trow + row) * H + c) =
            *reinterpret_cast<const uint4*>(hin_p + kmaj_off<R>(n, c));
    }
    uint32_t keep_prev = 0;   // bit 2 j + e: row 8 j + 2 (l % 4) + e
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = block_row + 8 * j + 2 * lt + e;
        if (t > 0 && row < row_end && to_f(keep[prow + row]) > 0.5f)
          keep_prev |= 1u << (2 * j + e);
      }

    // Pre-activations as the forward computes them (x in the dgates tile).
    float acc[4][kAcc];
    if constexpr (kWitness)
      preactivations<H, R, kProj, 0, E>(
          slices, issue, acc, a_off, dg_s, hin_s, f_in,
          ProjWitness<H, R>{wit_out, trow, static_cast<size_t>(steps) * n_rows,
                            block_row + 2 * lt, row_end,
                            unit_base + unit0});
    else
      preactivations<H, R, kProj, 0, E>(slices, issue, acc, a_off, dg_s,
                                        hin_s, f_in);
    // The projection's x sits where the dgates go: every warpgroup is done
    // reading it. With a cluster: the peer's too, and the peer's dh_prev
    // (dx) products of step t + 1 are done, before this block writes into
    // its dgates tile.
    if constexpr (kSplit > 1)
      cluster_sync();
    else if constexpr (kProj)
      __syncthreads();

    // Gate math, thread-local: dgates rounded to E into the dgates tile
    // (each thread rewrites only the x_proj elements it read; with a
    // cluster into the peer's too), db, dc_prev.
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * s + e;
          const bool live = block_row + 8 * j + 2 * lt + e < row_end;
          const uint32_t ko = kb[s][e] + j * 1024;
          uint8_t* dgo = dg_p + ko;
          const uint32_t ro = rb[s][e] + j * 16 * U;
          constexpr int kGate = (H / 64) * L::kSub;   // gate stride
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[g] = gate_pre<kProj, E>(dgo + g * kGate, acc[g][i], b[g][s]);
          const float si = sigmoid_f(pre[0]);
          const float sf = sigmoid_f(pre[1]);
          const float tg = tanhf(pre[2]);
          const float so = sigmoid_f(pre[3]);
          const float tanh_c = tanhf(ld_elem<E>(cs_p + ro));
          const float c_in = ld_elem<E>(cin_p + ro);
          const float dh_total = ld_elem<E>(dys_p + ro) + dh[i];
          const float dc_total =
              dc[i] + dh_total * so * (1.0f - tanh_c * tanh_c);
          const E zero = from_f<E>(0.0f);
          const E d[4] = {
              live ? from_f<E>(dc_total * tg * si * (1.0f - si)) : zero,
              live ? from_f<E>(dc_total * c_in * sf * (1.0f - sf)) : zero,
              live ? from_f<E>(dc_total * si * (1.0f - tg * tg)) : zero,
              live ? from_f<E>(dh_total * tanh_c * so * (1.0f - so)) : zero,
          };
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            *reinterpret_cast<E*>(dgo + g * kGate) = d[g];
            if constexpr (kSplit > 1)
              st_cluster_u16(peer_dg + ko + g * kGate, elem_bits(d[g]));
            db[g][s] += to_f(d[g]);
          }
          dc[i] = live ? dc_total * sf : 0.0f;   // dc_prev, masked below
        }
    // The dgates tile is whole for the products: this block's writes, and
    // with a cluster the peer's, visible to wgmma.
    if constexpr (kSplit == 1) {
      fence_proxy_async();
      __syncthreads();
    } else {
      fence_proxy_async_all();
      cluster_sync();
      fence_proxy_async_all();
    }

    // The rounded dgates of the block's units: an output (dx_proj), and
    // the weight-gradient pass's B operand.
    for (int e = tid; e < R * (4 * U / 8); e += L::kThreads) {
      const int n = e / (4 * U / 8), c = gate_col((e % (4 * U / 8)) * 8);
      const int row = block_row + n;
      if (row < row_end)
        *reinterpret_cast<uint4*>(dg + (trow + row) * G4 + c) =
            *reinterpret_cast<const uint4*>(dg_p + kmaj_off<R>(n, c));
    }

    // dh_prev^T = Wr . dgates^T: this warpgroup's 64 units, in the layout
    // of its carries, over all 4H gates.
    float dhp[kAcc];
    for (int kc = 0; kc < G4 / kTcK; ++kc)
      consume(dhp, dg_s + kc * L::kSub, kc == 0);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(dhp[i]);

    // dx^T = Wi . dgates^T, a band of H input features at a time (this
    // block's U of them), rounded once to E.
    if constexpr (kProj) {
      for (int band = 0; band < bands; ++band) {
        const int f0 = band * H + unit_base + wg * 64;
        float dxa[kAcc];
        for (int kc = 0; kc < G4 / kTcK; ++kc)
          consume(dxa, dg_s + kc * L::kSub, kc == 0);
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(dxa[i]);
        if (f0 < f_in) {
#pragma unroll
          for (int j = 0; j < R / 8; ++j)
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int row = block_row + 8 * j + 2 * lt + e;
                if (row < row_end)
                  dx[(trow + row) * f_in + f0 + (unit0 % 64) + 8 * s] =
                      from_f<E>(dxa[4 * j + 2 * s + e]);
              }
        }
      }
    }

    // dh0 / dc0 at t == 0; the carried cotangents pick up the clear mask
    // applied between the steps.
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * s + e;
          const int row = block_row + 8 * j + 2 * lt + e;
          const size_t idx =
              static_cast<size_t>(row) * H + unit_base + unit0 + 8 * s;
          if (t == 0 && row < row_end) {
            dh0[idx] = from_f<E>(dhp[i]);
            dc0[idx] = from_f<E>(dc[i]);
          }
          const bool kept = (keep_prev >> (2 * j + e)) & 1u;
          dh[i] = kept ? dhp[i] : 0.0f;
          dc[i] = kept ? dc[i] : 0.0f;
        }
    __syncthreads();   // every tile of this step is consumed
  }

  // This row tile's db partial over the block's units: the thread's rows
  // and steps, then the four lanes of a unit in a fixed order.
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float v = db[g][s];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (lt == 0)
        part_b[static_cast<size_t>(tile) * G4 + g * H + unit_base + unit0 +
               8 * s] = v;
    }
}

// phases: bit 0 the recurrence, bit 1 the weight gradients (dW from the
// recurrence's dg and hin, db from its part_b). E: __nv_bfloat16, or
// __half without the projection. At H = 384 and 512, clusters of two
// blocks (kTcSplit), launched with their cluster dimension by
// cudaLaunchKernelEx; a refused launch returns its error. wit: null, or
// the recompute's witness (f32 [2][T * N][4H]: the kWitness instance of
// lstm_bwd_tc_kernel, built with the projection at 384 and 512 alone;
// other arguments with wit are refused).
template <typename E, int H, bool kProj>
int launch_bwd_tc(int phases, const void* x, const void* keep,
                  const void* wi, const void* wi_t, const void* wr,
                  const void* wr_t, const void* bias, const void* c0,
                  const void* h0, const void* ys, const void* cs,
                  const void* dys, void* dx, void* dg, void* hin, void* dh0,
                  void* dc0, void* part_w, void* part_b, void* dw, void* db,
                  int steps, int n_rows, int f_in, int splits,
                  cudaStream_t stream, const void* chunk_policy = nullptr,
                  int num_chunks = 1, int chunk = 0, int num_policies = 1,
                  void* wit = nullptr) {
  constexpr int R = kTcRows<kProj, H>;
  constexpr int kSplit = kTcSplit<H>;
  constexpr int U = H / kSplit;
  using L = TcBwd<H, R, kSplit>;
  constexpr bool kWitnessed = kProj && kSplit > 1;
  if (wit != nullptr && !kWitnessed)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = fwd_blocks(chunk_policy, num_chunks, chunk, n_rows, R);
  const int total_rows = steps * n_rows;
  constexpr CUtensorMapDataType dt = tma_dtype<E>();
  // Every map spans the [P, ...] stack (P = 1 without chunks: Wi^T
  // [P, 4H, F] and Wi [P, F, 4H] with the projection), in boxes of the U
  // rows of a block's units (at most 256: TMA's limit of a box dimension).
  // Without the projection, wit / wi alias Wr^T / Wr and are never read.
  if (phases & 1) {
    CUtensorMap wit_map, wrt_map, wr_map, wi_map;
    if (!make_tma_map(&wrt_map, wr_t, H, 4 * H, num_policies, kTcK, U, dt) ||
        !make_tma_map(&wr_map, wr, 4 * H, H, num_policies, kTcK, U, dt) ||
        !make_tma_map(&wit_map, kProj ? wi_t : wr_t, kProj ? f_in : H, 4 * H,
                      num_policies, kTcK, U, dt) ||
        !make_tma_map(&wi_map, kProj ? wi : wr, 4 * H, kProj ? f_in : H,
                      num_policies, kTcK, U, dt))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel =
        wit != nullptr
            ? lstm_bwd_tc_kernel<E, H, R, kProj, kSplit, kWitnessed>
            : lstm_bwd_tc_kernel<E, H, R, kProj, kSplit, false>;
    int err = set_smem(kernel, L::kSmem);
    if (err != 0) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(tiles) * kSplit);
    cfg.blockDim = dim3(L::kThreads);
    cfg.dynamicSmemBytes = L::kSmem;
    cfg.stream = stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = kSplit;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = kSplit > 1 ? 1 : 0;
    const cudaError_t launched = cudaLaunchKernelEx(
        &cfg, kernel, wit_map, wrt_map, wr_map, wi_map,
        static_cast<const E*>(x), static_cast<const E*>(keep),
        static_cast<const E*>(bias), static_cast<const E*>(c0),
        static_cast<const E*>(h0), static_cast<const E*>(ys),
        static_cast<const E*>(cs), static_cast<const E*>(dys),
        static_cast<E*>(dx), static_cast<E*>(dg), static_cast<E*>(hin),
        static_cast<E*>(dh0), static_cast<E*>(dc0),
        static_cast<float*>(part_b), steps, n_rows, f_in,
        static_cast<const int*>(chunk_policy), chunk, num_policies,
        static_cast<float*>(wit));
    if (launched != cudaSuccess) return static_cast<int>(launched);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if ((phases & 2) && chunk_policy != nullptr) {
    // dW of each policy ([F + H, 4H], dWi over dWr, with the projection;
    // dWr [H, 4H] without) from its chunks' own splits of boxes (never a
    // box of two chunks: weight_grad_tc.cuh), db from its chunks' row
    // tiles.
    int used = 0;
    int err = kProj ? weight_grad_tc_partials<E>(
                          x, f_in, hin, f_in + H, dg, 4 * H, steps, chunk,
                          num_chunks, splits, part_w, &used, stream)
                    : weight_grad_tc_partials<E>(
                          hin, H, nullptr, H, dg, 4 * H, steps, chunk,
                          num_chunks, splits, part_w, &used, stream);
    if (err != 0) return err;
    err = sum_by_policy<E>(part_w, dw, chunk_policy, num_chunks, used,
                           num_policies, (f_in + H) * 4 * H, stream);
    if (err != 0) return err;
    return sum_by_policy<E>(part_b, db, chunk_policy, num_chunks,
                            tiles / num_chunks, num_policies, 4 * H, stream);
  }
  if (phases & 2) {
    // dW = [x | h_in]^T . dg ([F + H, 4H], dWi over dWr) for the
    // projection, h_in^T . dg ([H, 4H]) without.
    const int err =
        kProj ? weight_grad_tc<E>(x, f_in, hin, f_in + H, dg, 4 * H,
                                  total_rows, splits, part_w, dw, stream)
              : weight_grad_tc<E>(hin, H, nullptr, H, dg, 4 * H, total_rows,
                                  splits, part_w, dw, stream);
    if (err != 0) return err;
    return sum_splits<E>(part_b, db, tiles, 4 * H, stream);
  }
  return 0;
}

// ------------------------------------ bf16 and f16 forward on tensor cores

// Batch rows a block of the tensor-core forward (R) in both variants, the
// faster of 16 and 32 on the H100 (PERF.md; R = 64 would hold 128
// accumulators a thread, the whole register budget of 512 threads);
// mirrored by ops/cuda/lstm.py:fwd_tc_rows.
constexpr int kFwdTcRows = 32;

// Ring stages of the tensor-core forward at most (as many as fit, up to
// this; PERF.md).
constexpr int kFwdTcStages = 4;

// Shared memory of lstm_fwd_tc_kernel, from a 1024-byte aligned base: the
// ring of weight slices ([64 k][U units] each, U = H / kSplit the
// block's units, as U / 64 TMA boxes of [64 k][64 units]), the block's h
// tile (the K-major B operand of h . Wr over all H units, which the gate
// math overwrites with the next step's carry) and its x tile (K-major
// [R][4U]: the x_proj columns of its units; or x, the whole K of x . Wi in
// every block, in one or two buffers of [R][F], F <= 4H). At H = 512 with
// the projection that is 128 KiB of x and 32 of h, which leave two ring
// stages of 32 KiB (four at 384).
template <int H, int R, int kSplit, bool kProj = false>
struct TcFwd {
  static constexpr int kUnits = H / kSplit;
  static constexpr int kWarpgroups = kUnits / 64;   // 64 units each
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kWarps = 4 * kWarpgroups;
  static constexpr int kSub = R * 128;          // one [R][64] subtile
  static constexpr int kStageBytes = kUnits * 128;
  static constexpr int kHBytes = R * H * 2;
  static constexpr int kXBytes = R * 4 * (kProj ? H : kUnits) * 2;
  static constexpr int kFixed = kHBytes + kXBytes;
  static constexpr int kStages =
      min_c(kFwdTcStages, (kSmemLimit - 2048 - kFixed) / kStageBytes);
  static constexpr int kSmem = kStages * kStageBytes + kFixed + 1024;
  static_assert(kStages >= 2, "a ring of at least two slices");
};

// The forward recurrence of both variants on tensor cores (see the header),
// E the storage type: bf16, or f16 (the float16 instance at H = 128 and
// 256, without the projection). One block owns R batch rows and loops over
// time; warpgroup w owns units 64 w .. 64 w + 63 of all four gates, in the
// accumulator layout of lstm_bwd_tc_kernel (element 4 j + 2 s + e of an
// m64nR accumulator is unit unit0 + 8 s, row 8 j + 2 (l % 4) + e), so the
// gate math and the f32 c carry are thread-local. The maps are TMA maps
// of the row-major weights, Wi [F, 4H] (wi_map; Wr again without the
// projection) and Wr [H, 4H] (wr_map), in boxes of [64 k][64 units]:
// wgmma's MN-major A operand as they stand, so the forward needs no
// transposed copy of a weight.
//
// With kSplit = 2 (H = 384, 512) the two blocks of a cluster own the same
// R rows and H / 2 units each (rank r: units r H / 2 ..), so a block keeps
// the H = 192 / 256 instance's warpgroups and registers. Each streams its
// units' columns of Wr (and Wi), stages its units' x_proj columns (or the
// whole x: the projection's K is F), and holds the whole h tile (the
// product's K = H). After
// the gate math a thread writes its carry into its own h tile and its
// peer's (distributed shared memory). Two cluster barriers a step keep the
// tiles right: the first after both blocks' products, so that no write
// reaches an h tile that wgmma still reads; the second after the writes
// (release / acquire, then fence.proxy.async on both sides), so that the
// next step's products read both halves. A block never exits while its
// peer can still write into it: the last write is before the last step's
// second barrier, and a chunk of no policy is skipped by both blocks of
// its cluster together (they share its rows, so its policy). The kWitness
// instance (H = 384 and 512 with the projection) also writes each step's
// products to wit (ProjWitness): the witness lstm_bwd_tc_kernel's recompute
// is held to.
template <typename E, int H, int R, bool kProj, int kSplit,
          bool kWitness = false>
__global__ void __launch_bounds__(TcFwd<H, R, kSplit, kProj>::kThreads, 1)
    lstm_fwd_tc_kernel(const __grid_constant__ CUtensorMap wi_map,
                       const __grid_constant__ CUtensorMap wr_map,
                       const E* __restrict__ x, const E* __restrict__ keep,
                       const E* __restrict__ bias, const E* __restrict__ c0,
                       const E* __restrict__ h0, E* __restrict__ ys,
                       E* __restrict__ cs, int steps, int n_rows, int f_in,
                       const int* __restrict__ chunk_policy, int chunk,
                       int num_policies, float* __restrict__ wit) {
  using L = TcFwd<H, R, kSplit, kProj>;
  constexpr int S = L::kStages;
  constexpr int U = L::kUnits;
  constexpr int kAcc = R / 2;
  constexpr int kGate = (U / 64) * L::kSub;   // gate stride of the x tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;
  const uint32_t h_s = ring + S * L::kStageBytes;
  const uint32_t x_s = h_s + L::kHBytes;
  uint8_t* h_p = smem_raw + (h_s - raw_s);
  const uint8_t* x_p = smem_raw + (x_s - raw_s);

  // The block's rows and policy (fwd_rows: the cluster's row tile); a chunk
  // of no policy is skipped before any barrier, so the whole block (the
  // whole cluster) leaves together.
  const int rank = kSplit == 1 ? 0 : static_cast<int>(cluster_rank());
  const FwdRows rows = fwd_rows(chunk_policy, chunk, R, n_rows,
                                static_cast<int>(blockIdx.x) / kSplit);
  if (rows.policy < 0 || rows.policy >= num_policies) {
    if (rank == 0) fill_nan_rows(ys, cs, steps, n_rows, H, rows, R);
    return;
  }
  bias += static_cast<size_t>(rows.policy) * 4 * H;
  const int row_end = rows.end;

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32;
  const int lt = lane % 4;
  // unit0 counts the block's own units (the ring's and the x tile's
  // columns); unit_base + unit0 is the unit of the layer.
  const int unit_base = rank * U;
  const int unit0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int block_row = rows.first;
  // The h tile's byte offset of unit u + unit_base over unit u's (U is a
  // multiple of 64: whole [R][64] subtiles).
  const uint32_t h_shift = (unit_base / 64) * L::kSub;

  // The weight slices of one step, in the order the step consumes them:
  // Wi by (F-chunk, gate), then Wr by (H-chunk, gate), each the U / 64
  // boxes of its gate's units of this block; the same sequence every step,
  // so the ring prefetches across steps. The maps span the [P, H, 4H]
  // stack (P = 1 without chunks); the block's policy is the third
  // coordinate.
  const int xp_loads = kProj ? 4 * (f_in / kTcK) : 0;
  const int step_loads = xp_loads + 4 * (H / kTcK);
  const CUtensorMap* wim = &wi_map;
  const CUtensorMap* wrm = &wr_map;
  auto issue = [&](int q, uint32_t dst, uint64_t* bar) {
    int p = q % step_loads;
    const bool xp = p < xp_loads;
    if (!xp) p -= xp_loads;
#pragma unroll
    for (int w = 0; w < U / 64; ++w)
      tma_load_3d(dst + w * 64 * 128, xp ? wim : wrm, bar,
                  (p % 4) * H + unit_base + w * 64, (p / 4) * kTcK,
                  rows.policy);
  };
  SliceRing<S> slices{full, empty, ring, L::kStageBytes, steps * step_loads,
                      0};
  if (tid == 0) slices.init(L::kWarps);
  __syncthreads();
  if (tid == 0) slices.prime(issue);

  // x_proj (or x) of step t into the x tile (buffer t % x_bufs with the
  // projection), by 16-byte cp.async with zero-fill: rows past N arrive as
  // zeros. Two buffers of x where they fit, so that step t + 1's x arrives
  // during step t's products; one (F > 2H) is refilled once step t's
  // products are done. Without the projection the tile holds the block's
  // units of each gate, column g U + u of it column g H + unit_base + u of
  // x_proj.
  const int x_stride = kProj ? f_in : 4 * H;
  const int x_width = kProj ? f_in : 4 * U;
  const int x_bufs = kProj && 2 * f_in <= 4 * H ? 2 : 1;
  const uint32_t x_buf_bytes = R * x_width * 2;
  auto load_x = [&](int t) {
    const uint32_t dst = x_s + (t % x_bufs) * x_buf_bytes;
    const size_t trow = static_cast<size_t>(t) * n_rows;
    for (int e = tid; e < R * (x_width / 8); e += L::kThreads) {
      const int n = e / (x_width / 8), c = (e % (x_width / 8)) * 8;
      const int col =
          kProj || kSplit == 1 ? c : (c / U) * H + unit_base + c % U;
      const int row = block_row + n;
      const bool live = row < row_end;
      cp_async16(dst + kmaj_off<R>(n, c),
                 x + (live ? (trow + row) * x_stride + col : 0), live);
    }
    cp_async_commit();
  };

  // h0 into the h tile (all H units), c0 into the f32 carry (rows past N:
  // zeros).
  for (int e = tid; e < R * (H / 8); e += L::kThreads) {
    const int n = e / (H / 8), c = e % (H / 8);
    const int row = block_row + n;
    const bool live = row < row_end;
    cp_async16(h_s + kmaj_off<R>(n, c * 8),
               h0 + (live ? static_cast<size_t>(row) * H + c * 8 : 0), live);
  }
  load_x(0);
  uint32_t kb[2][2];   // as in lstm_bwd_tc_kernel
  float b[4][2];
  float c[kAcc];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      kb[s][e] = kmaj_off<R>(2 * lt + e, unit0 + 8 * s);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      b[g][s] = to_f(bias[g * H + unit_base + unit0 + 8 * s]);
  }
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = block_row + 8 * j + 2 * lt + e;
        c[4 * j + 2 * s + e] =
            row < row_end
                ? to_f(c0[static_cast<size_t>(row) * H + unit_base +
                          unit0 + 8 * s])
                : 0.0f;
      }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  // The peer's h tile, where this block writes its half of each carry.
  const uint32_t peer_h =
      kSplit == 1 ? 0 : map_cluster_rank(h_s, static_cast<uint32_t>(rank ^ 1));

  const uint32_t a_off = wg * 64 * 128;
  const E zero = from_f<E>(0.0f);
  for (int t = 0; t < steps; ++t) {
    const size_t trow = static_cast<size_t>(t) * n_rows;
    uint32_t kept = 0;   // bit 2 j + e: row 8 j + 2 (l % 4) + e
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = block_row + 8 * j + 2 * lt + e;
        if (row < row_end && to_f(keep[trow + row]) > 0.5f)
          kept |= 1u << (2 * j + e);
      }
    if (x_bufs == 2 && t + 1 < steps) load_x(t + 1);

    float acc[4][kAcc];
    if constexpr (kWitness)
      preactivations<H, R, kProj, 1, E>(
          slices, issue, acc, a_off, x_s + (t % x_bufs) * x_buf_bytes, h_s,
          f_in,
          ProjWitness<H, R>{wit, trow, static_cast<size_t>(steps) * n_rows,
                            block_row + 2 * lt, row_end,
                            unit_base + unit0});
    else
      preactivations<H, R, kProj, 1, E>(slices, issue, acc, a_off,
                                        x_s + (t % x_bufs) * x_buf_bytes,
                                        h_s, f_in);
    if constexpr (!kProj) cp_async_wait<0>();   // x_proj of step t
    // Every warpgroup is done reading the h tile (and x with the
    // projection); x_proj of step t is in. With a cluster: the peer's
    // warpgroups too, before this block writes into its h tile.
    if constexpr (kSplit == 1)
      __syncthreads();
    else
      cluster_sync();
    if (kProj && x_bufs == 1 && t + 1 < steps) load_x(t + 1);

    // Gate math, thread-local; the new carry into the h tile (cleared where
    // keep is 0; with a cluster into the peer's too), the outputs to memory
    // (staging them in shared memory for 16-byte stores measured slower on
    // the H100).
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * s + e;
          const uint32_t ko = kb[s][e] + j * 1024;
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[g] = gate_pre<kProj, E>(x_p + ko + g * kGate, acc[g][i],
                                        b[g][s]);
          const float new_c =
              sigmoid_f(pre[1]) * c[i] + sigmoid_f(pre[0]) * tanhf(pre[2]);
          const float new_h = sigmoid_f(pre[3]) * tanhf(new_c);
          const E c_t = from_f<E>(new_c);
          const E h_t = from_f<E>(new_h);
          const bool k = (kept >> (2 * j + e)) & 1u;
          const E h_next = k ? h_t : zero;
          *reinterpret_cast<E*>(h_p + ko + h_shift) = h_next;
          if constexpr (kSplit > 1)
            st_cluster_u16(peer_h + ko + h_shift, elem_bits(h_next));
          c[i] = k ? to_f(c_t) : 0.0f;
          const int row = block_row + 8 * j + 2 * lt + e;
          if (row < row_end) {
            const size_t o = (trow + row) * H + unit_base + unit0 + 8 * s;
            ys[o] = h_t;
            cs[o] = c_t;
          }
        }
    if constexpr (kProj) cp_async_wait<0>();   // x of step t + 1
    // The carry and next step's x are in for its products: this block's
    // writes, and with a cluster the peer's, visible to wgmma.
    if constexpr (kSplit == 1) {
      fence_proxy_async();
      __syncthreads();
    } else {
      fence_proxy_async_all();
      cluster_sync();
      fence_proxy_async_all();
    }
    // The x tile is free once the gate math has read it.
    if (!kProj && t + 1 < steps) load_x(t + 1);
  }
}

// chunk_policy null: one policy (lstm_sequence_fwd, _proj_fwd); else the
// chunk-indexed instance over [num_policies, H, 4H] and [num_policies, 4H]
// stacks (and [num_policies, F, 4H] of Wi with the projection), one TMA map
// over each whole stack. At H = 384 and 512, clusters of two blocks
// (kTcSplit), launched with their cluster dimension by cudaLaunchKernelEx;
// a refused launch returns its error. E: __nv_bfloat16, or __half without
// the projection at H = 128 and 256. wit: null, or the products' witness
// (f32 [2][T * N][4H]: the kWitness instance of lstm_fwd_tc_kernel, built
// with the projection at 384 and 512 alone; other arguments with wit are
// refused).
template <typename E, int H, bool kProj>
int launch_fwd_tc(const void* x, const void* keep, const void* wi,
                  const void* wr, const void* bias, const void* c0,
                  const void* h0, void* ys, void* cs, int steps, int n_rows,
                  int f_in, cudaStream_t stream,
                  const void* chunk_policy = nullptr, int num_chunks = 0,
                  int chunk = 0, int num_policies = 1, void* wit = nullptr) {
  constexpr int R = kFwdTcRows;
  constexpr int kSplit = kTcSplit<H>;
  using L = TcFwd<H, R, kSplit, kProj>;
  constexpr bool kWitnessed = kProj && kSplit > 1;
  if (wit != nullptr && !kWitnessed)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      wit != nullptr ? lstm_fwd_tc_kernel<E, H, R, kProj, kSplit, kWitnessed>
                     : lstm_fwd_tc_kernel<E, H, R, kProj, kSplit, false>;
  constexpr CUtensorMapDataType dt = tma_dtype<E>();
  CUtensorMap wi_map, wr_map;
  if (!make_tma_map(&wr_map, wr, 4 * H, H, num_policies, 64, kTcK, dt) ||
      !make_tma_map(&wi_map, kProj ? wi : wr, 4 * H, kProj ? f_in : H,
                    num_policies, 64, kTcK, dt))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem(kernel, L::kSmem);
  if (err != 0) return err;
  const int tiles = fwd_blocks(chunk_policy, num_chunks, chunk, n_rows, R);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles) * kSplit);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kSplit;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = kSplit > 1 ? 1 : 0;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, kernel, wi_map, wr_map, static_cast<const E*>(x),
      static_cast<const E*>(keep), static_cast<const E*>(bias),
      static_cast<const E*>(c0), static_cast<const E*>(h0),
      static_cast<E*>(ys), static_cast<E*>(cs), steps, n_rows, f_in,
      static_cast<const int*>(chunk_policy), chunk, num_policies,
      static_cast<float*>(wit));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

bool proj_width_ok(int hidden, int f_in) {
  return f_in > 0 && f_in % 128 == 0 && f_in <= 4 * hidden;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Each entry point returns a
// cudaError_t, or -1 for arguments without an instantiation. The CUDA-core
// sequence kernels, forward and backward, are built for float32 at H = 128,
// 256, 384 and 512 and for float16 at 384 and 512 (bfloat16 takes
// mlt_lstm_fwd_tc and mlt_lstm_bwd_tc at every width, float16 at 128 and
// 256); the
// projection kernels for float32 alone, at every width (bfloat16 takes the
// tensor-core entry points; float16 the unfused kernels, as the JAX
// package's lstm_proj_supported sends it to its unfused route).
//
// Wider layers (H = 384, 512). The tensor-core kernels give each warpgroup
// 64 units of all four gates, so one block would need H / 64 warpgroups:
// 768 threads at H = 384 and 1024 at H = 512, which leaves each thread 80
// and 64 registers (acc alone is 64 at R = 32), where the H = 256 instances
// already take 128 and spill; 288 KiB of shared memory at 512 for the
// forward, past the 227 KiB a block can use (the backward's tiles alone
// leave no room for two ring stages); and the backward's K-major weight
// slices would be TMA boxes of H rows, past TMA's 256 elements a box
// dimension. The bf16 kernels split the units over a cluster of two blocks
// instead (kTcSplit = 2): each block keeps 3 or 4 warpgroups and the H =
// 192 / 256 register layout and streams the weight slices of its H / 2
// units (L2 traffic stays |Wr| per R rows a step, twice that backward;
// boxes of H / 2 <= 256 rows). The forward (lstm_fwd_tc_kernel) stages its
// units' x_proj and holds the whole h tile, into which both blocks write
// their halves of each carry through distributed shared memory (224 KiB at
// 512 with a 4-stage ring; with the projection each block holds the whole
// x, 128 KiB at F = 4H = 2048, and the ring keeps two stages). The
// projection's products are split like Wr's: each block computes
// round(x . Wi) for its units' gate columns, then adds h . Wr, in the
// single block's slice order. The backward (lstm_bwd_tc_kernel) loads the
// whole h_in tile from ys / h0 (no exchange), recomputes its units'
// pre-activations through the forward's helper in the forward's slice
// order, so that "both compute them alike" (the header) holds at every
// width, and writes its units' dgates into both blocks' dgates tiles
// through distributed shared memory, so that each computes dh_prev of its
// units over all 4H gates (200 KiB at 512 with a 3-stage ring, 175 KiB at
// 384 with 4); with the projection x arrives in the dgates tile (F <= 4H)
// and dx's features are split between the blocks, at R = 16 at 512 (3
// stages) and 32 at 384 (2 stages): kTcRows. A single block of 4
// warpgroups x 128 units at R = 16 would
// also fit the forward, but it doubles Wr's L2 traffic a row, which bounds
// these kernels; the cluster was taken. float32, and float16 at these
// widths, stay on the CUDA-core kernels (storage-type operands converted
// exactly to f32, f32 sums, the carry rounded to the storage type; the
// float32 projection backward's x tile shares the dgates tile at 512,
// kProjXInDg). Every
// contract of the narrower instances holds: the rollout step is the
// sequence forward's step, a chunked row is the single-policy kernel's, a
// chunk of no policy writes NaN, a policy's dWr / db sum its chunks' split
// partials in chunk order. ops/cuda/lstm.py: fwd_uses_tensor_cores and
// bwd_uses_tensor_cores state it.
#define MLT_DISPATCH_F32(CALL)                                   \
  if (dtype == 0 && hidden == 128) return CALL(float, 128);      \
  if (dtype == 0 && hidden == 256) return CALL(float, 256);      \
  return -1
// The CUDA-core kernels at H = 384 and 512: float32 and float16.
#define MLT_DISPATCH_WIDE(CALL, H)                               \
  if (dtype == 0 && hidden == H) return CALL(float, H);          \
  if (dtype == 2 && hidden == H) return CALL(__half, H)
// The CUDA-core sequence kernels: float32 at every width, float16 at 384
// and 512 (at 128 and 256 it takes the tensor cores).
#define MLT_DISPATCH_SEQ(CALL)                                   \
  MLT_DISPATCH_WIDE(CALL, 384);                                  \
  MLT_DISPATCH_WIDE(CALL, 512);                                  \
  MLT_DISPATCH_F32(CALL)
// The CUDA-core projection kernels: float32 at every width.
#define MLT_DISPATCH_PROJ(CALL)                                  \
  if (dtype == 0 && hidden == 384) return CALL(float, 384);      \
  if (dtype == 0 && hidden == 512) return CALL(float, 512);      \
  MLT_DISPATCH_F32(CALL)

extern "C" int mlt_lstm_fwd(int dtype, int hidden, const void* xp,
                            const void* keep, const void* wr,
                            const void* bias, const void* c0, const void* h0,
                            void* ys, void* cs, int steps, int n_rows,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_FWD(T, H) \
  launch_fwd<T, H>(xp, keep, wr, bias, c0, h0, ys, cs, steps, n_rows, s)
  MLT_DISPATCH_SEQ(MLT_FWD);
#undef MLT_FWD
}

extern "C" int mlt_lstm_bwd(int dtype, int hidden, const void* xp,
                            const void* keep, const void* wr,
                            const void* wr_t, const void* bias,
                            const void* c0, const void* h0, const void* ys,
                            const void* cs, const void* dys, void* dxp,
                            void* dh0, void* dc0, void* part_w, void* part_b,
                            void* dwr, void* db, int steps, int n_rows,
                            int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_BWD(T, H)                                                      \
  launch_bwd<T, H>(xp, keep, wr, wr_t, bias, c0, h0, ys, cs, dys, dxp, dh0, \
                   dc0, part_w, part_b, dwr, db, steps, n_rows, splits, s)
  MLT_DISPATCH_SEQ(MLT_BWD);
#undef MLT_BWD
}

extern "C" int mlt_lstm_proj_fwd(int dtype, int hidden, int f_in,
                                 const void* x, const void* keep,
                                 const void* wi, const void* wr,
                                 const void* bias, const void* c0,
                                 const void* h0, void* ys, void* cs,
                                 int steps, int n_rows, void* stream) {
  if (!proj_width_ok(hidden, f_in)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_PROJ_FWD(T, H)                                                 \
  launch_proj_fwd<T, H>(x, keep, wi, wr, bias, c0, h0, ys, cs, steps,      \
                        n_rows, f_in, s)
  MLT_DISPATCH_PROJ(MLT_PROJ_FWD);
#undef MLT_PROJ_FWD
}

extern "C" int mlt_lstm_proj_bwd(
    int dtype, int hidden, int f_in, const void* x, const void* keep,
    const void* wi, const void* wi_t, const void* wr, const void* wr_t,
    const void* bias, const void* c0, const void* h0, const void* ys,
    const void* cs, const void* dys, void* dx, void* dg, void* dh0,
    void* dc0, void* part_wi, void* part_w, void* part_b, void* dwi,
    void* dwr, void* db, int steps, int n_rows, int splits, void* stream) {
  if (!proj_width_ok(hidden, f_in)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_PROJ_BWD(T, H)                                                 \
  launch_proj_bwd<T, H>(x, keep, wi, wi_t, wr, wr_t, bias, c0, h0, ys, cs, \
                        dys, dx, dg, dh0, dc0, part_wi, part_w, part_b,    \
                        dwi, dwr, db, steps, n_rows, f_in, splits, s)
  MLT_DISPATCH_PROJ(MLT_PROJ_BWD);
#undef MLT_PROJ_BWD
}

// The tensor-core backward of both variants (f_in = 0: lstm_sequence_bwd,
// with x = x_proj and dg = dx_proj; else lstm_sequence_proj_bwd): bfloat16
// (dtype 1) at H = 128, 256, 384 and 512, float16 (dtype 2, no projection)
// at 128 and 256. Returns a cudaError_t, or -1 for arguments without an
// instantiation.
extern "C" int mlt_lstm_bwd_tc(
    int dtype, int hidden, int f_in, int phases, const void* x,
    const void* keep, const void* wi, const void* wi_t, const void* wr,
    const void* wr_t, const void* bias, const void* c0, const void* h0,
    const void* ys, const void* cs, const void* dys, void* dx, void* dg,
    void* hin, void* dh0, void* dc0, void* part_w, void* part_b, void* dw,
    void* db, int steps, int n_rows, int splits, void* stream) {
  if (f_in != 0 && !proj_width_ok(hidden, f_in)) return -1;
  if (static_cast<long long>(steps) * n_rows > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_BWD_TC(E, H, P)                                                 \
  launch_bwd_tc<E, H, P>(phases, x, keep, wi, wi_t, wr, wr_t, bias, c0, h0, \
                         ys, cs, dys, dx, dg, hin, dh0, dc0, part_w, part_b, \
                         dw, db, steps, n_rows, f_in, splits, s)
#define MLT_BWD_TC_H(H)                                                    \
  if (hidden == H)                                                         \
    return f_in == 0 ? MLT_BWD_TC(bf16, H, false) : MLT_BWD_TC(bf16, H, true)
  if (dtype == 1) {
    MLT_BWD_TC_H(128);
    MLT_BWD_TC_H(256);
    MLT_BWD_TC_H(384);
    MLT_BWD_TC_H(512);
  }
  if (dtype == 2 && f_in == 0) {
    if (hidden == 128) return MLT_BWD_TC(__half, 128, false);
    if (hidden == 256) return MLT_BWD_TC(__half, 256, false);
  }
#undef MLT_BWD_TC_H
#undef MLT_BWD_TC
  return -1;
}

// The tensor-core forward of both variants (f_in = 0: lstm_sequence_fwd,
// x = x_proj; else lstm_sequence_proj_fwd), from the weights as they stand,
// Wi [F, 4H] (unread without the projection) and Wr [H, 4H]: bfloat16
// (dtype 1) at H = 128, 256, 384 and 512, float16 (dtype 2, no
// projection) at 128 and 256. Returns a cudaError_t, or -1 for arguments
// without an instantiation.
extern "C" int mlt_lstm_fwd_tc(int dtype, int hidden, int f_in,
                               const void* x, const void* keep,
                               const void* wi, const void* wr,
                               const void* bias, const void* c0,
                               const void* h0, void* ys, void* cs, int steps,
                               int n_rows, void* stream) {
  if (f_in != 0 && !proj_width_ok(hidden, f_in)) return -1;
  if (static_cast<long long>(steps) * n_rows > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_FWD_TC(E, H, P)                                                \
  launch_fwd_tc<E, H, P>(x, keep, wi, wr, bias, c0, h0, ys, cs, steps,     \
                         n_rows, f_in, s)
#define MLT_FWD_TC_H(H)                                                    \
  if (hidden == H)                                                         \
    return f_in == 0 ? MLT_FWD_TC(bf16, H, false) : MLT_FWD_TC(bf16, H, true)
  if (dtype == 1) {
    MLT_FWD_TC_H(128);
    MLT_FWD_TC_H(256);
    MLT_FWD_TC_H(384);
    MLT_FWD_TC_H(512);
  }
  if (dtype == 2 && f_in == 0) {
    if (hidden == 128) return MLT_FWD_TC(__half, 128, false);
    if (hidden == 256) return MLT_FWD_TC(__half, 256, false);
  }
#undef MLT_FWD_TC_H
#undef MLT_FWD_TC
  return -1;
}

// lstm_sequence_fwd_chunked: the forward over [num_chunks * chunk] rows,
// chunk c with the weights of policy chunk_policy[c] of the [num_policies,
// H, 4H] / [num_policies, 4H] stacks (a chunk of no policy is skipped, its
// rows NaN). tensor_core 1 takes the tensor-core kernel (bfloat16 at every
// width, float16 at 128 and 256), 0 the CUDA-core one (float32; float16
// at 384 and 512).
// Returns a cudaError_t, or -1 for arguments without an instantiation.
extern "C" int mlt_lstm_fwd_chunked(int tensor_core, int dtype, int hidden,
                                    const void* xp, const void* keep,
                                    const void* wr, const void* bias,
                                    const void* chunk_policy, const void* c0,
                                    const void* h0, void* ys, void* cs,
                                    int steps, int num_chunks, int chunk,
                                    int num_policies, void* stream) {
  const long long n = static_cast<long long>(num_chunks) * chunk;
  if (num_chunks <= 0 || chunk <= 0 || num_policies <= 0 ||
      n * steps > 0x7fffffffLL)
    return -1;
  const int n_rows = static_cast<int>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
#define MLT_FWD_CHUNKED_TC(E, H)                                            \
  return launch_fwd_tc<E, H, false>(xp, keep, wr, wr, bias, c0, h0, ys, cs, \
                                    steps, n_rows, 0, s, chunk_policy,      \
                                    num_chunks, chunk, num_policies)
    if (dtype == 1 && hidden == 128) MLT_FWD_CHUNKED_TC(bf16, 128);
    if (dtype == 1 && hidden == 256) MLT_FWD_CHUNKED_TC(bf16, 256);
    if (dtype == 1 && hidden == 384) MLT_FWD_CHUNKED_TC(bf16, 384);
    if (dtype == 1 && hidden == 512) MLT_FWD_CHUNKED_TC(bf16, 512);
    if (dtype == 2 && hidden == 128) MLT_FWD_CHUNKED_TC(__half, 128);
    if (dtype == 2 && hidden == 256) MLT_FWD_CHUNKED_TC(__half, 256);
#undef MLT_FWD_CHUNKED_TC
    return -1;
  }
#define MLT_FWD_CHUNKED(T, H)                                              \
  launch_fwd<T, H>(xp, keep, wr, bias, c0, h0, ys, cs, steps, n_rows, s,    \
                   chunk_policy, num_chunks, chunk, num_policies)
  MLT_DISPATCH_SEQ(MLT_FWD_CHUNKED);
#undef MLT_FWD_CHUNKED
}

// lstm_sequence_bwd_chunked: the backward of lstm_sequence_fwd_chunked over
// [num_chunks * chunk] rows, chunk c with the weights of policy
// chunk_policy[c] of the [num_policies, H, 4H] stacks wr and wr_t (Wr^T a
// policy, [num_policies, 4H, H]) and [num_policies, 4H] bias: dxp, dh0, dc0
// a row, each row's bitwise lstm_sequence_bwd's with its policy's weights
// (a chunk of no policy: NaN rows), and dwr [num_policies, H, 4H] / db
// [num_policies, 4H], a policy's summed over its chunks' `splits` partials
// each (0 for a policy without a chunk). tensor_core 1 takes the bf16
// tensor-core recurrence and weight-gradient pass (bfloat16 at every width,
// float16 at 128 and 256; hin: [T, N, H] scratch; part_w [num_chunks *
// splits, H, 4H], part_b [num_chunks * ceil(chunk / 16), 4H]), 0 the
// CUDA-core kernels (float32; float16 at H = 384 and 512; hin unused;
// part_w and part_b [num_chunks * splits, ...]). Returns a cudaError_t, or
// -1 for arguments without an instantiation.
extern "C" int mlt_lstm_bwd_chunked(
    int tensor_core, int dtype, int hidden, const void* xp, const void* keep,
    const void* wr, const void* wr_t, const void* bias,
    const void* chunk_policy, const void* c0, const void* h0, const void* ys,
    const void* cs, const void* dys, void* dxp, void* hin, void* dh0,
    void* dc0, void* part_w, void* part_b, void* dwr, void* db, int steps,
    int num_chunks, int chunk, int num_policies, int splits, void* stream) {
  const long long n = static_cast<long long>(num_chunks) * chunk;
  if (num_chunks <= 0 || chunk <= 0 || num_policies <= 0 || splits <= 0 ||
      num_policies > 65535 || n * steps > 0x7fffffffLL)
    return -1;
  const int n_rows = static_cast<int>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
#define MLT_BWD_CHUNKED_TC(E, H)                                            \
  return launch_bwd_tc<E, H, false>(3, xp, keep, wr, wr_t, wr, wr_t, bias,  \
                                    c0, h0, ys, cs, dys, dxp, dxp, hin, dh0, \
                                    dc0, part_w, part_b, dwr, db, steps,     \
                                    n_rows, 0, splits, s, chunk_policy,      \
                                    num_chunks, chunk, num_policies)
    if (dtype == 1 && hidden == 128) MLT_BWD_CHUNKED_TC(bf16, 128);
    if (dtype == 1 && hidden == 256) MLT_BWD_CHUNKED_TC(bf16, 256);
    if (dtype == 1 && hidden == 384) MLT_BWD_CHUNKED_TC(bf16, 384);
    if (dtype == 1 && hidden == 512) MLT_BWD_CHUNKED_TC(bf16, 512);
    if (dtype == 2 && hidden == 128) MLT_BWD_CHUNKED_TC(__half, 128);
    if (dtype == 2 && hidden == 256) MLT_BWD_CHUNKED_TC(__half, 256);
#undef MLT_BWD_CHUNKED_TC
    return -1;
  }
#define MLT_BWD_CHUNKED(T, H)                                              \
  launch_bwd<T, H>(xp, keep, wr, wr_t, bias, c0, h0, ys, cs, dys, dxp, dh0, \
                   dc0, part_w, part_b, dwr, db, steps, n_rows, splits, s,  \
                   chunk_policy, num_chunks, chunk, num_policies)
  MLT_DISPATCH_SEQ(MLT_BWD_CHUNKED);
#undef MLT_BWD_CHUNKED
}

// lstm_sequence_proj_fwd_chunked: the projection forward over [num_chunks *
// chunk] rows, chunk c with the weights of policy chunk_policy[c] of the
// [num_policies, F, 4H] / [num_policies, H, 4H] / [num_policies, 4H]
// stacks wi, wr and bias (a chunk of no policy is skipped, its rows NaN).
// tensor_core 1 takes the bf16 tensor-core kernel, 0 the float32
// CUDA-core one. Returns a cudaError_t, or -1 for arguments without an
// instantiation.
extern "C" int mlt_lstm_proj_fwd_chunked(
    int tensor_core, int dtype, int hidden, int f_in, const void* x,
    const void* keep, const void* wi, const void* wr, const void* bias,
    const void* chunk_policy, const void* c0, const void* h0, void* ys,
    void* cs, int steps, int num_chunks, int chunk, int num_policies,
    void* stream) {
  const long long n = static_cast<long long>(num_chunks) * chunk;
  if (!proj_width_ok(hidden, f_in) || num_chunks <= 0 || chunk <= 0 ||
      num_policies <= 0 || n * steps > 0x7fffffffLL)
    return -1;
  const int n_rows = static_cast<int>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
    if (dtype != 1) return -1;
#define MLT_PROJ_FWD_CHUNKED_TC(H)                                          \
  if (hidden == H)                                                         \
    return launch_fwd_tc<bf16, H, true>(x, keep, wi, wr, bias, c0, h0, ys, \
                                        cs, steps, n_rows, f_in, s,         \
                                        chunk_policy, num_chunks, chunk,    \
                                        num_policies)
    MLT_PROJ_FWD_CHUNKED_TC(128);
    MLT_PROJ_FWD_CHUNKED_TC(256);
    MLT_PROJ_FWD_CHUNKED_TC(384);
    MLT_PROJ_FWD_CHUNKED_TC(512);
#undef MLT_PROJ_FWD_CHUNKED_TC
    return -1;
  }
#define MLT_PROJ_FWD_CHUNKED(T, H)                                         \
  launch_proj_fwd<T, H>(x, keep, wi, wr, bias, c0, h0, ys, cs, steps,      \
                        n_rows, f_in, s, chunk_policy, num_chunks, chunk,  \
                        num_policies)
  MLT_DISPATCH_PROJ(MLT_PROJ_FWD_CHUNKED);
#undef MLT_PROJ_FWD_CHUNKED
}

// lstm_sequence_proj_bwd_chunked: the backward of
// lstm_sequence_proj_fwd_chunked over [num_chunks * chunk] rows, chunk c
// with the weights of policy chunk_policy[c] of the stacks wi [P, F, 4H],
// wi_t [P, 4H, F] (Wi^T a policy), wr [P, H, 4H], wr_t [P, 4H, H] and bias
// [P, 4H]: dx, dh0, dc0 a row, each row's bitwise lstm_sequence_proj_bwd's
// with its policy's weights (a chunk of no policy: NaN rows), and a
// policy's weight gradients summed over its chunks' `splits` partials each
// (0 for a policy without a chunk). dg is the rounded dgates' [T, N, 4H]
// scratch. tensor_core 1 takes the bf16 tensor-core recurrence and
// weight-gradient pass: hin [T, N, H] scratch, part_w [num_chunks *
// splits, F + H, 4H], part_b [num_chunks * ceil(chunk / R), 4H] (R =
// kTcRows<true, H>: 32, and 16 at H = 512), and dwr
// receives [P, F + H, 4H], dWi over dWr (dwi and part_wi unused); 0 the
// float32 CUDA-core kernels: hin unused, part_wi [num_chunks * splits, F,
// 4H], part_w [.., H, 4H] and part_b [.., 4H], dwi [P, F, 4H] and dwr
// [P, H, 4H]. Returns a cudaError_t, or -1 for arguments without an
// instantiation.
extern "C" int mlt_lstm_proj_bwd_chunked(
    int tensor_core, int dtype, int hidden, int f_in, const void* x,
    const void* keep, const void* wi, const void* wi_t, const void* wr,
    const void* wr_t, const void* bias, const void* chunk_policy,
    const void* c0, const void* h0, const void* ys, const void* cs,
    const void* dys, void* dx, void* dg, void* hin, void* dh0, void* dc0,
    void* part_wi, void* part_w, void* part_b, void* dwi, void* dwr,
    void* db, int steps, int num_chunks, int chunk, int num_policies,
    int splits, void* stream) {
  const long long n = static_cast<long long>(num_chunks) * chunk;
  if (!proj_width_ok(hidden, f_in) || num_chunks <= 0 || chunk <= 0 ||
      num_policies <= 0 || splits <= 0 || num_policies > 65535 ||
      n * steps > 0x7fffffffLL)
    return -1;
  const int n_rows = static_cast<int>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
    if (dtype != 1) return -1;
#define MLT_PROJ_BWD_CHUNKED_TC(H)                                          \
  if (hidden == H)                                                         \
    return launch_bwd_tc<bf16, H, true>(                                   \
        3, x, keep, wi, wi_t, wr, wr_t, bias, c0, h0, ys, cs, dys, dx, dg,  \
        hin, dh0, dc0, part_w, part_b, dwr, db, steps, n_rows, f_in, splits, \
        s, chunk_policy, num_chunks, chunk, num_policies)
    MLT_PROJ_BWD_CHUNKED_TC(128);
    MLT_PROJ_BWD_CHUNKED_TC(256);
    MLT_PROJ_BWD_CHUNKED_TC(384);
    MLT_PROJ_BWD_CHUNKED_TC(512);
#undef MLT_PROJ_BWD_CHUNKED_TC
    return -1;
  }
#define MLT_PROJ_BWD_CHUNKED(T, H)                                         \
  launch_proj_bwd<T, H>(x, keep, wi, wi_t, wr, wr_t, bias, c0, h0, ys, cs, \
                        dys, dx, dg, dh0, dc0, part_wi, part_w, part_b,    \
                        dwi, dwr, db, steps, n_rows, f_in, splits, s,      \
                        chunk_policy, num_chunks, chunk, num_policies)
  MLT_DISPATCH_PROJ(MLT_PROJ_BWD_CHUNKED);
#undef MLT_PROJ_BWD_CHUNKED
}

// The projection's product witness, held bitwise on the card
// (chip_smoke.py): the bf16 tensor-core forward (mlt_lstm_proj_fwd_witness)
// and the backward's recurrence alone (mlt_lstm_proj_bwd_witness, phase 1)
// on their kWitness instances at H = 384 or 512, with the arguments of
// mlt_lstm_fwd_tc / mlt_lstm_bwd_tc, each writing wit, f32 [2][T * N][4H]:
// round(x . Wi), then round(x . Wi) + h . Wr, of every row and step (the
// backward's recomputed from ys). Returns a cudaError_t, or -1 for
// arguments without an instantiation.
extern "C" int mlt_lstm_proj_fwd_witness(
    int hidden, int f_in, const void* x, const void* keep, const void* wi,
    const void* wr, const void* bias, const void* c0, const void* h0,
    void* ys, void* cs, int steps, int n_rows, void* wit, void* stream) {
  if (!proj_width_ok(hidden, f_in) || wit == nullptr ||
      static_cast<long long>(steps) * n_rows > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_FWD_WITNESS(H)                                                  \
  if (hidden == H)                                                         \
    return launch_fwd_tc<bf16, H, true>(x, keep, wi, wr, bias, c0, h0, ys, \
                                        cs, steps, n_rows, f_in, s,         \
                                        nullptr, 0, 0, 1, wit)
  MLT_FWD_WITNESS(384);
  MLT_FWD_WITNESS(512);
#undef MLT_FWD_WITNESS
  return -1;
}

extern "C" int mlt_lstm_proj_bwd_witness(
    int hidden, int f_in, const void* x, const void* keep, const void* wi,
    const void* wi_t, const void* wr, const void* wr_t, const void* bias,
    const void* c0, const void* h0, const void* ys, const void* cs,
    const void* dys, void* dx, void* dg, void* hin, void* dh0, void* dc0,
    void* part_b, int steps, int n_rows, void* wit, void* stream) {
  if (!proj_width_ok(hidden, f_in) || wit == nullptr ||
      static_cast<long long>(steps) * n_rows > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_BWD_WITNESS(H)                                                  \
  if (hidden == H)                                                         \
    return launch_bwd_tc<bf16, H, true>(                                   \
        1, x, keep, wi, wi_t, wr, wr_t, bias, c0, h0, ys, cs, dys, dx, dg,  \
        hin, dh0, dc0, nullptr, part_b, nullptr, nullptr, steps, n_rows,    \
        f_in, 1, s, nullptr, 1, 0, 1, wit)
  MLT_BWD_WITNESS(384);
  MLT_BWD_WITNESS(512);
#undef MLT_BWD_WITNESS
  return -1;
}

#undef MLT_DISPATCH_PROJ
#undef MLT_DISPATCH_SEQ
#undef MLT_DISPATCH_WIDE
#undef MLT_DISPATCH_F32
