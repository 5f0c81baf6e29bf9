// gru_sequence_fwd / gru_sequence_bwd: the fused GRU sequence pass, forward
// and backward.
//
// Replaces madrona_learn_tpu/ops/pallas/gru.py:gru_sequence: the forward
// _fwd_kernel (gru_sequence_fwd) and the custom backward _bwd_kernel with
// its fused dWh/dbh epilogue (gru_sequence_bwd).
//
// Gate math (ops/pallas/gru.py:_gates_fp32), packed [r | z | n] along the
// last axis, cuDNN's linear-before-reset variant:
//   r = sigmoid(x_r + h . W_hr)
//   z = sigmoid(x_z + h . W_hz)
//   n = tanh(x_n + r * (h . W_hn + b_hn))
//   h' = round((1 - z) * n + z * h)
// in f32 from storage-type operands; b_hn arrives already rounded to the
// storage type. The carry is cleared after step t where keep[t] == 0, after
// ys[t] is written (step-then-reset).
//
// What the TPU layout did, and why it cannot carry over: each TPU grid
// program keeps all of Wh [H, 3H] resident in VMEM beside its batch tile
// and carries h in VMEM scratch along a sequential time axis; the backward
// accumulates dWh/dbh in one output block across the whole grid. At H = 256
// in bf16 Wh is 384 KiB, more than the 227 KB of shared memory a Hopper
// block can hold, and Hopper blocks run in parallel in no order.
//
// In float32, forward and backward (the LSTM kernels' layout, common.cuh):
// - One block of kThreads threads owns kRows batch rows and all H units of
//   those rows, and loops over time. Each thread computes all three gates of
//   its (row, unit) pairs through row_tile_product<T, 3, ...>, so the gate
//   math needs no exchange between threads; only h (which every unit's
//   product reads) goes through shared memory.
// - Wh is read from global memory every step; it stays resident in the
//   50 MB L2, and a block reuses each element for kRows rows.
// - Backward, in reverse time: h_in is rebuilt from ys[t-1] under
//   keep[t-1] (h0 at t = 0), the gates are recomputed, and the kernel
//   writes dxp = [dr_pre, dz_pre, dn_pre] and dhp = [dr_pre, dz_pre,
//   dn_pre * r], both rounded to the storage type. dh_prev = dhp . Wh^T +
//   dh_total * z runs against a transposed copy of Wh so its loads
//   coalesce; the dh carry stays in f32 registers.
// - dWh = sum h_in^T . dhp and dbh = sum dhp[..., 2H:] come from the split-M
//   pass of weight_grad.cuh (f32 partials over contiguous row splits, summed
//   in a fixed order); dbh is the last H columns of its bias sums.
//
// These are bound by CUDA-core FMA issue and shared/L1 load throughput,
// far below the tensor-core rate that bounds the work itself; they serve
// float32 alone.
//
// On Hopper's tensor cores: the forward (gru_fwd_tc_kernel) and the
// backward (gru_bwd_tc_kernel, then weight_grad_tc.cuh) in bfloat16 and
// float16 at every width. The TPU kernel's products are bf16 operands with
// f32 accumulation (h . Wh; dhp rounded to the storage type before dh_prev
// = dhp . Wh^T and dWh = h_in^T . dhp), which is what wgmma computes, with
// only the order of the sums changed. They are lstm.cu's
// lstm_fwd_tc_kernel and lstm_bwd_tc_kernel with three gates in place of
// four; the wrappers' rules (ops/cuda/gru.py: fwd_uses_tensor_cores,
// bwd_uses_tensor_cores, one rule) send calls here. One helper computes
// h . Wh (hidden_products) and one the gates (gru_gates) for the forward
// and the backward's recompute, in one slice order, so the backward
// differentiates the forward that ran, and the rollout step is the update
// pass's step. The float16 instances (the port's own: JAX sends float16 to
// its jnp twin) take the bf16 schedules with f16 operands (wgmma .f16, f32
// sums; ys, dxp, dhp, dh0, dWh and dbh rounded once to f16, where the
// CUDA-core kernels and the plain twin round them). At H = 384 and 512
// both split the units over a cluster of two blocks, as lstm.cu's
// lstm_fwd_tc_kernel and lstm_bwd_tc_kernel do.
//
// The forward: one block owns R batch rows (FWD_TC_ROWS in ops/cuda/gru.py)
// and loops over time; warpgroup w owns units 64 w .. 64 w + 63 of r, z
// and n, the products run transposed (hp^T = Wh^T . h^T, three m64nR
// accumulators a warpgroup) and the gate math is thread-local. A: Wh read
// as MN-major TMA boxes ([64 k][64 units]) of the weight as it stands,
// through the slice_ring.cuh ring, so a rollout step copies no weight. B:
// the block's h tile, K-major with the 128-byte swizzle, which the gate
// math overwrites with the next step's carry (E, after keep), so h never
// goes through global memory between steps. x_proj arrives by 16-byte
// cp.async with zero-fill during the step's products; each thread stores
// its own ys elements. Rows past N give zeros and are never stored. A
// row's ys depends neither on N, nor on where the row sits, nor on T: the
// rollout step (T = 1) is step t of the update pass bitwise. At H = 384
// and 512 each block of a cluster owns H / 2 units of the same rows (the
// H = 192 / 256 layout), streams its units' Wh columns, stages its units'
// x_proj and holds the whole h tile, into which both blocks write their
// halves of each carry through distributed shared memory, two cluster
// barriers a step (gru_fwd_tc_kernel).
//
// The backward:
// - One block owns R = kGruTcRows<H> batch rows (the faster of 16 and 32
//   at the update shape on the H100: 32, and 16 at H = 512) and loops over
//   time in reverse;
//   warpgroup w owns units 64 w .. 64 w + 63 of all three gates,
//   so the gate math, the dh_total * z term and the f32 dh carry stay
//   thread-local. The products run transposed, gates (or units) as wgmma's
//   M and the block's rows as its N: hp^T = Wh^T . h_in^T (three m64nR
//   accumulators a warpgroup), dh_prev^T = Wh . dhp^T (K = 3H).
// - A: 64-deep slices of Wh^T, then of Wh, through a TMA ring in one fixed
//   order every step (slice_ring.cuh). Wh is 384 KiB in bf16 at H = 256,
//   more than a block's shared memory, so it streams from L2 every step; a
//   block reuses each element for its R rows.
// - B: the block's h_in and dhp tiles (K-major, 128-byte swizzle). x_proj
//   lands in the dhp tile, which the gate math then overwrites element by
//   element; x_n stays apart from h . W_hn + b_hn (linear before reset), so
//   only r and z take x + h . Wh. h_in, x_proj and dys arrive by 16-byte
//   cp.async with zero-fill, so rows past N give exact zeros in dxp and dhp.
// - dxp = [dr_pre, dz_pre, dn_pre] and dhp = [dr_pre, dz_pre, dn_pre * r]
//   differ in the n slice alone: dn_pre goes to a tile of its own, and both
//   leave shared memory by 16-byte stores. h_in as each step used it goes to
//   a [T, N, H] scratch. Then weight_grad_tc.cuh: dWh = h_in^T . dhp as
//   split-K wgmma over the T*N rows, f32 partials per split summed in split
//   order; dbh from per-block partials of dhp's n slice, summed in block
//   order. Deterministic, and a row's dxp and dh0 do not depend on N or on
//   where the row sits.
// - At H = 384 and 512 each block of a cluster owns H / 2 units of the same
//   rows (the H = 192 / 256 layout), streams the Wh^T and Wh rows of its
//   units, loads the whole h_in tile and recomputes its units' h_in . Wh in
//   the forward cluster's slice order; both blocks write their units' dhp
//   into both dhp tiles through distributed shared memory, two cluster
//   barriers a step, before each computes dh_prev of its units over all 3H
//   gate columns (gru_bwd_tc_kernel).
//
// The chunk-indexed instances (gru_sequence_fwd_chunked and
// gru_sequence_bwd_chunked, both paths) are the GRU's policy-batched passes
// of a population: JAX vmaps a model's apply over policy chunks in collect
// (madrona_learn_tpu/rollouts.py:580) and algo.update over the train
// policies in learn (madrona_learn_tpu/train.py:315), and with them this
// kernel's pallas_calls, every program reading its own policy's Wh. Here
// the rows are [num_chunks][chunk], each chunk of one policy; a block owns
// one row tile of one chunk (fwd_rows, chunk_rows.cuh) and reads its
// policy's slice of the [P, H, 3H] / [P, H] stacks: by a pointer offset on
// CUDA cores, by the third coordinate of one TMA map over the whole stack
// on tensor cores (Wh, and the backward's [P, 3H, H] Wh^T stack). A row's
// arithmetic is the single-policy kernel's, so every row equals
// gru_sequence_fwd's / _bwd's with its policy's weights bitwise; a chunk of
// no policy (index P or -1) writes NaN rows and reads no weight. The
// backward's weight gradients split each chunk's own T * chunk rows (the
// tensor-core pass through maps of [T * chunks] slices of [chunk][K] of
// h_in and dhp, weight_grad_tc.cuh; the CUDA-core pass by index,
// weight_grad.cuh), and sum_by_policy adds a policy's partials (dbh: its
// chunks' block partials) in chunk order: a policy's dWh / dbh do not
// depend on the other chunks, and where 64 divides the chunk they are the
// single-policy backward's over the same rows bitwise.
//
// Bound on the H100: the forward's bytes take 0.082 ms at [16, 8192, 256
// -> 768] (its product 0.05 ms on tensor cores), the backward's three
// products 0.16 ms, about what its bytes take; what holds the tensor-core
// recurrences is streaming the weight from L2 every step: |Wh| (384 KiB) a
// block a step forward, about 1.6 GB a call at R = 32, and Wh^T and Wh
// backward, about 3.2 GB.

#include <cuda.h>   // CUtensorMap

#include "chunk_rows.cuh"
#include "common.cuh"
#include "mma.cuh"
#include "slice_ring.cuh"
#include "weight_grad.cuh"
#include "weight_grad_tc.cuh"

namespace {

using namespace mlt;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ keep,
                   const T* __restrict__ wh, const T* __restrict__ bias_h,
                   const T* __restrict__ h0, T* __restrict__ ys, int steps,
                   int n_rows, const int* __restrict__ chunk_policy,
                   int chunk, int num_policies) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G3 = 3 * H;
  __shared__ float h_s[kRows * H];

  // The block's rows and policy (fwd_rows); a chunk of no policy writes NaN.
  const FwdRows rows = fwd_rows(chunk_policy, chunk, kRows, n_rows);
  if (rows.policy < 0 || rows.policy >= num_policies) {
    fill_nan(ys, steps, n_rows, H, rows, kRows);
    return;
  }
  wh += static_cast<size_t>(rows.policy) * H * G3;
  bias_h += static_cast<size_t>(rows.policy) * H;
  const int row_end = rows.end;

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = rows.first;

  float bn[UPT];
#pragma unroll
  for (int j = 0; j < UPT; ++j) bn[j] = to_f(bias_h[u0 + j]);

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
#pragma unroll
    for (int j = 0; j < UPT; ++j)
      h_s[(row_base + i) * H + u0 + j] =
          n < row_end ? to_f(h0[static_cast<size_t>(n) * H + u0 + j]) : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    float acc[RPT][3][UPT];
    row_tile_product<T, 3, RPT, UPT>(h_s, H, wh, G3, H, row_base, u0, acc);
    __syncthreads();  // every thread has read h_s for this step

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = block_row + row_base + i;
      if (n >= row_end) continue;
      const size_t row = static_cast<size_t>(t) * n_rows + n;
      const T* x = xp + row * G3 + u0;
      const bool kept = to_f(keep[row]) > 0.5f;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        // This thread alone reads and writes its (row, unit) of h_s here.
        float* h = &h_s[(row_base + i) * H + u0 + j];
        const float r = sigmoid_f(to_f(x[0 * H + j]) + acc[i][0][j]);
        const float z = sigmoid_f(to_f(x[1 * H + j]) + acc[i][1][j]);
        const float nn =
            tanhf(to_f(x[2 * H + j]) + r * (acc[i][2][j] + bn[j]));
        const T h_t = from_f<T>((1.0f - z) * nn + z * *h);
        ys[row * H + u0 + j] = h_t;
        *h = kept ? to_f(h_t) : 0.0f;
      }
    }
    __syncthreads();  // the new h is complete before the next product
  }
}

// Shared memory: hin_s [kRows][H] (h entering step t), dg_s [kRows][3H]
// (the rounded dhp of step t).
template <typename T, int H>
__global__ void __launch_bounds__(kThreads) gru_bwd_kernel(
    const T* __restrict__ xp, const T* __restrict__ keep,
    const T* __restrict__ wh, const T* __restrict__ wh_t,
    const T* __restrict__ bias_h, const T* __restrict__ h0,
    const T* __restrict__ ys, const T* __restrict__ dys, T* __restrict__ dxp,
    T* __restrict__ dhp, T* __restrict__ dh0, int steps, int n_rows,
    const int* __restrict__ chunk_policy, int chunk, int num_policies) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G3 = 3 * H;
  extern __shared__ float smem[];
  float* hin_s = smem;
  float* dg_s = smem + kRows * H;

  // The block's rows and policy, as the forward's (fwd_rows).
  const FwdRows rows = fwd_rows(chunk_policy, chunk, kRows, n_rows);
  if (rows.policy < 0 || rows.policy >= num_policies) {
    fill_nan(dxp, steps, n_rows, G3, rows, kRows);
    fill_nan(dhp, steps, n_rows, G3, rows, kRows);
    fill_nan(dh0, 1, n_rows, H, rows, kRows);
    return;
  }
  wh += static_cast<size_t>(rows.policy) * H * G3;
  wh_t += static_cast<size_t>(rows.policy) * G3 * H;
  bias_h += static_cast<size_t>(rows.policy) * H;
  const int row_end = rows.end;

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = rows.first;

  float bn[UPT];
#pragma unroll
  for (int j = 0; j < UPT; ++j) bn[j] = to_f(bias_h[u0 + j]);

  float dh[RPT][UPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < UPT; ++j) dh[i][j] = 0.0f;

  for (int t = steps - 1; t >= 0; --t) {
    // The carry into step t: the cleared state after step t-1, or the
    // unmasked initial state at t == 0.
    float h_in[RPT][UPT];
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
        float h_v = 0.0f;
        if (n < row_end) {
          if (t == 0)
            h_v = to_f(h0[static_cast<size_t>(n) * H + u0 + j]);
          else if (keep_prev[i])
            h_v = to_f(
                ys[(static_cast<size_t>(t - 1) * n_rows + n) * H + u0 + j]);
        }
        hin_s[(row_base + i) * H + u0 + j] = h_v;
        h_in[i][j] = h_v;
      }
    }
    __syncthreads();

    float acc[RPT][3][UPT];
    row_tile_product<T, 3, RPT, UPT>(hin_s, H, wh, G3, H, row_base, u0, acc);

    float dh_z[RPT][UPT];  // dh_total * z: h_in's direct path into h'
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = block_row + row_base + i;
      const int r_s = row_base + i;
      if (n >= row_end) {
#pragma unroll
        for (int j = 0; j < UPT; ++j) {
#pragma unroll
          for (int g = 0; g < 3; ++g) dg_s[r_s * G3 + g * H + u0 + j] = 0.0f;
          dh_z[i][j] = 0.0f;
        }
        continue;
      }
      const size_t row = static_cast<size_t>(t) * n_rows + n;
      const T* x = xp + row * G3 + u0;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const float hn_lin = acc[i][2][j] + bn[j];
        const float r = sigmoid_f(to_f(x[0 * H + j]) + acc[i][0][j]);
        const float z = sigmoid_f(to_f(x[1 * H + j]) + acc[i][1][j]);
        const float nn = tanhf(to_f(x[2 * H + j]) + r * hn_lin);

        const float dh_total = to_f(dys[row * H + u0 + j]) + dh[i][j];
        const float dn = dh_total * (1.0f - z);
        const float dz = dh_total * (h_in[i][j] - nn);
        const float dn_pre = dn * (1.0f - nn * nn);
        const float dr = dn_pre * hn_lin;
        const float dhn = dn_pre * r;
        const float dz_pre = dz * z * (1.0f - z);
        const float dr_pre = dr * r * (1.0f - r);

        const T d_r = from_f<T>(dr_pre);
        const T d_z = from_f<T>(dz_pre);
        T* dx_row = dxp + row * G3 + u0 + j;
        T* dh_row = dhp + row * G3 + u0 + j;
        dx_row[0 * H] = d_r;
        dx_row[1 * H] = d_z;
        dx_row[2 * H] = from_f<T>(dn_pre);
        const T d_hn = from_f<T>(dhn);
        dh_row[0 * H] = d_r;
        dh_row[1 * H] = d_z;
        dh_row[2 * H] = d_hn;
        dg_s[r_s * G3 + 0 * H + u0 + j] = to_f(d_r);
        dg_s[r_s * G3 + 1 * H + u0 + j] = to_f(d_z);
        dg_s[r_s * G3 + 2 * H + u0 + j] = to_f(d_hn);
        dh_z[i][j] = dh_total * z;
      }
    }
    __syncthreads();

    // dh_prev = round(dhp) . Wh^T + dh_total * z, against Wh^T [3H, H].
    float dh_prev[RPT][1][UPT];
    row_tile_product<T, 1, RPT, UPT>(dg_s, G3, wh_t, H, 0, row_base, u0,
                                     dh_prev);

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = block_row + row_base + i;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const float d = dh_prev[i][0][j] + dh_z[i][j];
        if (t == 0 && n < row_end)
          dh0[static_cast<size_t>(n) * H + u0 + j] = from_f<T>(d);
        // The cotangent flowing into the stored step-(t-1) state picks up
        // the clear mask applied between the steps.
        dh[i][j] = keep_prev[i] ? d : 0.0f;
      }
    }
    // The next iteration writes hin_s only after this point and dg_s only
    // after its own first barrier, by which time every thread has finished
    // reading dg_s here.
  }
}

// chunk_policy null: one policy; else the chunk-indexed instance over the
// [num_policies, ...] stacks (fwd_rows).
template <typename T, int H>
int launch_fwd(const void* xp, const void* keep, const void* wh,
               const void* bias_h, const void* h0, void* ys, int steps,
               int n_rows, cudaStream_t stream,
               const void* chunk_policy = nullptr, int num_chunks = 0,
               int chunk = 0, int num_policies = 1) {
  const int blocks =
      fwd_blocks(chunk_policy, num_chunks, chunk, n_rows, kRows);
  gru_fwd_kernel<T, H><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(keep),
      static_cast<const T*>(wh), static_cast<const T*>(bias_h),
      static_cast<const T*>(h0), static_cast<T*>(ys), steps, n_rows,
      static_cast<const int*>(chunk_policy), chunk, num_policies);
  return static_cast<int>(cudaGetLastError());
}

// The recurrence, then dWh / db3 from the split-M pass: db3 gets the sums
// of all 3H columns of dhp, and dbh is its last H entries. With chunks
// (chunk_policy non-null), `splits` partials a chunk over its own T *
// chunk rows, and each policy's sums over its chunks ([num_policies, H,
// 3H] and [num_policies, 3H]).
template <typename T, int H>
int launch_bwd(const void* xp, const void* keep, const void* wh,
               const void* wh_t, const void* bias_h, const void* h0,
               const void* ys, const void* dys, void* dxp, void* dhp,
               void* dh0, void* part_w, void* part_b, void* dwh, void* db3,
               int steps, int n_rows, int splits, cudaStream_t stream,
               const void* chunk_policy = nullptr, int num_chunks = 1,
               int chunk = 0, int num_policies = 1) {
  const int smem = kRows * 4 * H * static_cast<int>(sizeof(float));
  int err = set_smem(gru_bwd_kernel<T, H>, smem);
  if (err != 0) return err;
  const int blocks =
      fwd_blocks(chunk_policy, num_chunks, chunk, n_rows, kRows);
  gru_bwd_kernel<T, H><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(keep),
      static_cast<const T*>(wh), static_cast<const T*>(wh_t),
      static_cast<const T*>(bias_h), static_cast<const T*>(h0),
      static_cast<const T*>(ys), static_cast<const T*>(dys),
      static_cast<T*>(dxp), static_cast<T*>(dhp), static_cast<T*>(dh0),
      steps, n_rows, static_cast<const int*>(chunk_policy), chunk,
      num_policies);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  if (chunk_policy == nullptr) chunk = n_rows;
  const long long total = static_cast<long long>(steps) * chunk;
  const int rows_per_split = static_cast<int>((total + splits - 1) / splits);
  const dim3 grid(3 * H / kTileJ, H / kTileI, num_chunks * splits);
  weight_grad_partial_kernel<T, true><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dhp), static_cast<const T*>(ys),
      static_cast<const T*>(keep), static_cast<const T*>(h0),
      static_cast<float*>(part_w), static_cast<float*>(part_b), steps,
      n_rows, H, 3 * H, rows_per_split, chunk, splits);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (chunk_policy != nullptr) {
    err = sum_by_policy<T>(part_w, dwh, chunk_policy, num_chunks, splits,
                           num_policies, H * 3 * H, stream);
    if (err != 0) return err;
    return sum_by_policy<T>(part_b, db3, chunk_policy, num_chunks, splits,
                            num_policies, 3 * H, stream);
  }
  err = sum_splits<T>(part_w, dwh, splits, H * 3 * H, stream);
  if (err != 0) return err;
  return sum_splits<T>(part_b, db3, splits, 3 * H, stream);
}

// ------------------------------------ bf16 and f16 backward on tensor cores

using bf16 = __nv_bfloat16;

// Batch rows a block (a cluster) of the tensor-core backward owns (R), by
// width, the faster of 16 and 32 on the H100: 32 ran 14-17% faster at
// [16, 8192, 256 -> 768], though it spills at H = 256; at 512, where R =
// 32 leaves room for 2 ring stages and R = 16 for 4, 16 ran 15% faster at
// the learn's [16, 8 x 1280] rows (PERF.md). ops/cuda/gru.py:tc_rows
// mirrors it.
template <int H>
constexpr int kGruTcRows = H == 512 ? 16 : 32;

// Shared memory of gru_bwd_tc_kernel, from a 1024-byte aligned base: the
// ring of weight slices ([U rows][64] each, U = H / kSplit the block's
// units), the block's h_in tile and its x_proj / dhp tile (K-major wgmma B
// operands over all H units and 3H gate columns: [K / 64] subtiles of
// [R][64], 128-byte swizzle), its dn_pre tile (the same layout over its U
// units) and its dys tile ([R][U], row_off).
template <int H, int R, int kSplit = 1>
struct GruTcBwd {
  static constexpr int kUnits = H / kSplit;
  static constexpr int kWarpgroups = kUnits / 64;   // 64 units each
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kWarps = 4 * kWarpgroups;
  static constexpr int kSub = R * 128;          // one [R][64] subtile
  static constexpr int kStageBytes = kUnits * 128;
  static constexpr int kHinBytes = R * H * 2;
  static constexpr int kDgBytes = 3 * kHinBytes;
  static constexpr int kTileBytes = R * kUnits * 2;
  static constexpr int kFixed = kHinBytes + kDgBytes + 2 * kTileBytes;
  static constexpr int kStages =
      min_c(4, (kSmemLimit - 2048 - kFixed) / kStageBytes);
  static constexpr int kSmem = kStages * kStageBytes + kFixed + 1024;
  static_assert(kStages >= 2, "a ring of at least two slices");
};

// h . Wh of one step on tensor cores, gates as wgmma's M and the block's
// rows as its N, shared by the forward and the backward's recompute so that
// both compute it alike: acc[g] = (h . W_hg)^T, this warpgroup's 64 units
// of gate g. The ring's next slices are Wh by (H-chunk, gate): K-major
// slices of Wh^T (kTransA 0, the backward) or MN-major boxes of Wh as it
// stands (kTransA 1, the forward; ring_product), each this block's units
// of its gate (all H, or H / 2 in a cluster of two); h_s is the K-major h
// tile over all H units, a_off this warpgroup's rows of a stage. E: the
// operands' type (bf16, or f16 in the float16 instances).
template <int H, int R, int kTransA, typename E, int S, class Issue>
__device__ __forceinline__ void hidden_products(SliceRing<S>& slices,
                                                Issue& issue,
                                                float (&acc)[3][R / 2],
                                                uint32_t a_off,
                                                uint32_t h_s) {
  for (int kc = 0; kc < H / kTcK; ++kc)
#pragma unroll
    for (int g = 0; g < 3; ++g)
      ring_product<R, kTransA, E>(slices, issue, acc[g], a_off,
                                  h_s + kc * R * 128, kc == 0);
  wgmma_wait<0>();
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < R / 2; ++i) wgmma_fence_operand(acc[g][i]);
}

// The gates of one (row, unit), linear before reset
// (ops/pallas/gru.py:_gates_fp32), from x_proj's three slices (x*) and the
// products (a*): the forward's and the backward's recompute alike.
struct Gates {
  float r, z, n, hn_lin;
};
__device__ __forceinline__ Gates gru_gates(float xr, float xz, float xn,
                                           float ar, float az, float an,
                                           float bn) {
  Gates g;
  g.hn_lin = an + bn;
  g.r = sigmoid_f(xr + ar);
  g.z = sigmoid_f(xz + az);
  g.n = tanhf(xn + g.r * g.hn_lin);
  return g;
}

// The witness of a product: (row, unit)'s h . Wh of each gate (acc[g][i]),
// into the f32 [T * N, 3H] hp at columns g H + unit.
template <int H, int kAcc>
__device__ __forceinline__ void store_products(float* hp, size_t row,
                                               int unit,
                                               const float (&acc)[3][kAcc],
                                               int i) {
#pragma unroll
  for (int g = 0; g < 3; ++g) hp[row * 3 * H + g * H + unit] = acc[g][i];
}

// The reverse-time recurrence of the tensor-core backward (see the header),
// E the storage type: bf16, or f16 (the float16 instance). One block owns R
// batch rows; warpgroup w owns units 64 w .. 64 w + 63 of all three
// gates. Thread (warp v of its warpgroup, lane l) holds units
// 64 w + 16 v + l / 4 (+ 8) and rows 8 j + 2 (l % 4) (+ 1) of each m64nR
// accumulator: element 4 j + 2 s + e is unit + 8 s, row 8 j + 2 (l % 4) +
// e. Outputs: dxp and dhp ([T, N, 3H]), hin (h_in as the step used it,
// [T, N, H]), dh0 and part_b (this row tile's dbh partial, [tiles, H]);
// the kWitness instance also writes each step's recomputed h_in . Wh to hp
// (f32 [T, N, 3H], gate g in columns g H ..), as gru_fwd_tc_kernel's
// kWitness instance writes the product it computed: the witness that the
// two are the same bitwise. The other instances never touch hp.
//
// With kSplit = 2 (H = 384, 512) the two blocks of a cluster own the same R
// rows and H / 2 units each (rank r: units r H / 2 ..), as the forward's
// do, so a block keeps the H = 192 / 256 instance's warpgroups and
// registers. Each loads the whole h_in tile (from ys / h0, no exchange),
// recomputes h_in . Wh for its units through hidden_products from the Wh^T
// slices of its units, in the forward cluster's slice order (so bitwise
// the product the forward's block of the same rank computed), and streams
// the Wh rows of its units for dh_prev^T = Wh . dhp^T, whose K is all 3H
// gate columns: so after the gate math a thread writes its dhp into its
// own dhp tile and its peer's (distributed shared memory). Two cluster
// barriers a step keep the tiles right: the first after both blocks'
// recomputes, so that no write reaches a dhp tile that the peer's dh_prev
// product of the step before still reads; the second after the writes
// (release / acquire, then fence.proxy.async on both sides), so that both
// blocks' products read both halves. A block never exits while its peer
// can still write into it: the last write is before the last step's second
// barrier, and a chunk of no policy is skipped by both blocks of its
// cluster together (they share its rows, so its policy). lstm_bwd_tc_kernel's
// cluster, with three gates.
template <typename E, int H, int R, int kSplit, bool kWitness>
__global__ void __launch_bounds__(GruTcBwd<H, R, kSplit>::kThreads, 1)
    gru_bwd_tc_kernel(const __grid_constant__ CUtensorMap wht_map,
                      const __grid_constant__ CUtensorMap wh_map,
                      const E* __restrict__ xp, const E* __restrict__ keep,
                      const E* __restrict__ bias_h, const E* __restrict__ h0,
                      const E* __restrict__ ys, const E* __restrict__ dys,
                      E* __restrict__ dxp, E* __restrict__ dhp,
                      E* __restrict__ hin, E* __restrict__ dh0,
                      float* __restrict__ part_b, float* __restrict__ hp,
                      int steps, int n_rows,
                      const int* __restrict__ chunk_policy, int chunk,
                      int num_policies) {
  using L = GruTcBwd<H, R, kSplit>;
  constexpr int G3 = 3 * H;
  constexpr int U = L::kUnits;
  constexpr int S = L::kStages;
  constexpr int kAcc = R / 2;
  constexpr int kGate = (H / 64) * L::kSub;   // gate stride in the dhp tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;
  const uint32_t hin_s = ring + S * L::kStageBytes;
  const uint32_t dg_s = hin_s + L::kHinBytes;
  const uint32_t dn_s = dg_s + L::kDgBytes;
  const uint32_t dys_s = dn_s + L::kTileBytes;
  const uint8_t* hin_p = smem_raw + (hin_s - raw_s);
  uint8_t* dg_p = smem_raw + (dg_s - raw_s);
  uint8_t* dn_p = smem_raw + (dn_s - raw_s);
  const uint8_t* dys_p = smem_raw + (dys_s - raw_s);

  // The block's rows and policy (fwd_rows: the cluster's row tile); a chunk
  // of no policy is skipped before any barrier, by the whole cluster. The
  // maps span the [P, ...] stacks (P = 1 without chunks); the policy is the
  // third coordinate.
  const int rank = kSplit == 1 ? 0 : static_cast<int>(cluster_rank());
  const int tile = static_cast<int>(blockIdx.x) / kSplit;
  const FwdRows rows = fwd_rows(chunk_policy, chunk, R, n_rows, tile);
  if (rows.policy < 0 || rows.policy >= num_policies) {
    if (rank == 0) {
      fill_nan(dxp, steps, n_rows, G3, rows, R);
      fill_nan(dhp, steps, n_rows, G3, rows, R);
      fill_nan(dh0, 1, n_rows, H, rows, R);
    }
    return;
  }
  bias_h += static_cast<size_t>(rows.policy) * H;
  const int row_end = rows.end;
  const int pol = rows.policy;

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32;
  const int lt = lane % 4;
  // unit0 counts the block's own units (the ring's rows, the dn_pre and dys
  // tiles' columns); unit_base + unit0 is the unit of the layer.
  const int unit_base = rank * U;
  const int unit0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int block_row = rows.first;

  // The weight slices of one step, in the order the step consumes them:
  // Wh^T by (H-chunk, gate), then Wh by 3H-chunk, each the U rows of the
  // block's units; the same every step.
  constexpr int g_loads = 3 * (H / kTcK);
  constexpr int d_loads = G3 / kTcK;
  constexpr int step_loads = g_loads + d_loads;
  const CUtensorMap* wht = &wht_map;
  const CUtensorMap* whm = &wh_map;
  auto issue = [&](int q, uint32_t dst, uint64_t* bar) {
    const int p = q % step_loads;
    if (p < g_loads)
      tma_load_3d(dst, wht, bar, (p / 3) * kTcK, (p % 3) * H + unit_base,
                  pol);
    else
      tma_load_3d(dst, whm, bar, (p - g_loads) * kTcK, unit_base, pol);
  };
  SliceRing<S> slices{full, empty, ring, L::kStageBytes, steps * step_loads,
                      0};
  if (tid == 0) slices.init(L::kWarps);
  __syncthreads();
  if (tid == 0) slices.prime(issue);
  const uint32_t a_off = wg * 64 * 128;

  // Byte offsets of this thread's elements (rows 2 (l % 4) + e, units
  // unit0 + 8 s): kb in the K-major tiles over all H (h_in; gate g of the
  // dhp tile g * kGate on), ku in the dn_pre tile, rb in the dys tile; row
  // 8 j + .. is j * 1024 (j * 16 U) bytes on.
  uint32_t kb[2][2], ku[2][2], rb[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      kb[s][e] = kmaj_off<R>(2 * lt + e, unit_base + unit0 + 8 * s);
      ku[s][e] = kmaj_off<R>(2 * lt + e, unit0 + 8 * s);
      rb[s][e] = row_off<U>(2 * lt + e, unit0 + 8 * s);
    }
  float bn[2], db[2] = {0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < 2; ++s) bn[s] = to_f(bias_h[unit_base + unit0 + 8 * s]);
  float dh[kAcc];   // the carried cotangent, f32
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dh[i] = 0.0f;

  // Column c of the block's 3U gate columns (its units of each gate) is
  // column g H + unit_base + u of the layer's 3H.
  auto gate_col = [&](int c) {
    return kSplit == 1 ? c : (c / U) * H + unit_base + c % U;
  };
  // The peer's dhp tile, where this block writes its units' dhp.
  const uint32_t peer_dg =
      kSplit == 1 ? 0
                  : map_cluster_rank(dg_s, static_cast<uint32_t>(rank ^ 1));
  const E zero = from_f<E>(0.0f);

  for (int t = steps - 1; t >= 0; --t) {
    const size_t trow = static_cast<size_t>(t) * n_rows;
    const size_t prow = trow - n_rows;   // step t - 1 (t > 0)
    // The tiles of step t, by 16-byte cp.async with zero-fill: the carry
    // into step t over all H units (the cleared state after step t - 1, or
    // the unmasked h0 at t == 0), dys of the block's units, and x_proj of
    // its gate columns into the dhp tile.
    for (int e = tid; e < R * (H / 8); e += L::kThreads) {
      const int n = e / (H / 8), c = e % (H / 8);
      const int row = block_row + n;
      const bool live = row < row_end;
      bool kept = live;
      const E* hs = h0;
      if (live && t == 0) {
        hs = h0 + static_cast<size_t>(row) * H + c * 8;
      } else if (live) {
        kept = to_f(keep[prow + row]) > 0.5f;
        hs = ys + (prow + row) * H + c * 8;
      }
      cp_async16(hin_s + kmaj_off<R>(n, c * 8), hs, kept);
      if (c < U / 8)
        cp_async16(dys_s + row_off<U>(n, c * 8),
                   dys + (live ? (trow + row) * H + unit_base + c * 8 : 0),
                   live);
    }
    for (int e = tid; e < R * (3 * U / 8); e += L::kThreads) {
      const int n = e / (3 * U / 8), col = gate_col((e % (3 * U / 8)) * 8);
      const int row = block_row + n;
      const bool live = row < row_end;
      cp_async16(dg_s + kmaj_off<R>(n, col),
                 xp + (live ? (trow + row) * G3 + col : 0), live);
    }
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

    // hp^T = Wh^T . h_in^T for the block's units, gates as M and rows as N.
    float acc[3][kAcc];
    hidden_products<H, R, 0, E>(slices, issue, acc, a_off, hin_s);
    // With a cluster: the peer's dh_prev product of step t + 1 is done,
    // before this block writes into its dhp tile.
    if constexpr (kSplit > 1) cluster_sync();

    // Gate math, thread-local (ops/pallas/gru.py:_gates_fp32 and the
    // backward's chain): dhp rounded to E into the dhp tile (each thread
    // rewrites only the x_proj elements it read; with a cluster into the
    // peer's too), dn_pre into its tile, the dbh partial, and
    // dh_total * z, h_in's direct path into h'.
    float dhz[kAcc];
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
          const Gates gt =
              gru_gates(ld_elem<E>(dgo), ld_elem<E>(dgo + kGate),
                        ld_elem<E>(dgo + 2 * kGate), acc[0][i], acc[1][i],
                        acc[2][i], bn[s]);
          const float hn_lin = gt.hn_lin, r = gt.r, z = gt.z, nn = gt.n;
          if constexpr (kWitness)
            if (live)
              store_products<H>(hp, trow + block_row + 8 * j + 2 * lt + e,
                                unit_base + unit0 + 8 * s, acc, i);
          const float h_in = ld_elem<E>(hin_p + ko);
          const float dh_total =
              ld_elem<E>(dys_p + rb[s][e] + j * 16 * U) + dh[i];
          const float dn = dh_total * (1.0f - z);
          const float dz = dh_total * (h_in - nn);
          const float dn_pre = dn * (1.0f - nn * nn);
          const float dr = dn_pre * hn_lin;
          const float dhn = dn_pre * r;
          const float dz_pre = dz * z * (1.0f - z);
          const float dr_pre = dr * r * (1.0f - r);
          const E d[3] = {live ? from_f<E>(dr_pre) : zero,
                          live ? from_f<E>(dz_pre) : zero,
                          live ? from_f<E>(dhn) : zero};
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            *reinterpret_cast<E*>(dgo + g * kGate) = d[g];
            if constexpr (kSplit > 1)
              st_cluster_u16(peer_dg + ko + g * kGate, elem_bits(d[g]));
          }
          *reinterpret_cast<E*>(dn_p + ku[s][e] + j * 1024) =
              live ? from_f<E>(dn_pre) : zero;
          db[s] += to_f(d[2]);
          dhz[i] = live ? dh_total * z : 0.0f;
        }
    // The dhp tile is whole for the products: this block's writes, and
    // with a cluster the peer's, visible to wgmma.
    if constexpr (kSplit == 1) {
      fence_proxy_async();
      __syncthreads();
    } else {
      fence_proxy_async_all();
      cluster_sync();
      fence_proxy_async_all();
    }

    // dhp of the block's gate columns (the weight-gradient pass's B
    // operand) and dxp, which differs from it in the n slice alone.
    for (int e = tid; e < R * (3 * U / 8); e += L::kThreads) {
      const int n = e / (3 * U / 8), c = gate_col((e % (3 * U / 8)) * 8);
      const int row = block_row + n;
      if (row < row_end) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(dg_p + kmaj_off<R>(n, c));
        const size_t o = (trow + row) * G3 + c;
        *reinterpret_cast<uint4*>(dhp + o) = v;
        *reinterpret_cast<uint4*>(dxp + o) =
            c < 2 * H ? v
                      : *reinterpret_cast<const uint4*>(
                            dn_p + kmaj_off<R>(n, c - 2 * H - unit_base));
      }
    }

    // dh_prev^T = Wh . dhp^T: this warpgroup's 64 units, in the layout of
    // its carry, over all 3H gate columns; then + dh_total * z.
    float dhp_acc[kAcc];
    for (int kc = 0; kc < G3 / kTcK; ++kc)
      ring_product<R, 0, E>(slices, issue, dhp_acc, a_off,
                            dg_s + kc * L::kSub, kc == 0);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(dhp_acc[i]);

    // dh0 at t == 0; the carried cotangent picks up the clear mask applied
    // between the steps.
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * s + e;
          const int row = block_row + 8 * j + 2 * lt + e;
          const float d = dhp_acc[i] + dhz[i];
          if (t == 0 && row < row_end)
            dh0[static_cast<size_t>(row) * H + unit_base + unit0 + 8 * s] =
                from_f<E>(d);
          dh[i] = (keep_prev >> (2 * j + e)) & 1u ? d : 0.0f;
        }
    __syncthreads();   // every tile of this step is consumed
  }

  // This row tile's dbh partial over the block's units: the thread's rows
  // and steps, then the four lanes of a unit in a fixed order.
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float v = db[s];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (lt == 0)
      part_b[static_cast<size_t>(tile) * H + unit_base + unit0 + 8 * s] = v;
  }
}

// phases: bit 0 the recurrence, bit 1 the weight gradients (dWh from the
// recurrence's dhp and hin, dbh from its part_b). chunk_policy null: one
// policy; else the chunk-indexed instance over the [num_policies, H, 3H]
// stacks wh and wh_t (Wh^T a policy, [num_policies, 3H, H]), `splits`
// weight-gradient splits a chunk. E: __nv_bfloat16 or __half; R rows a
// row tile. At H = 384 and 512, clusters of two blocks (kTcSplit),
// launched with their cluster dimension by cudaLaunchKernelEx; a refused
// launch returns its error. hp: null, or the recompute's witness (f32
// [T, N, 3H]: the kWitness instance of gru_bwd_tc_kernel).
template <typename E, int H, int R = kGruTcRows<H> >
int launch_bwd_tc(int phases, const void* xp, const void* keep,
                  const void* wh, const void* wh_t, const void* bias_h,
                  const void* h0, const void* ys, const void* dys, void* dxp,
                  void* dhp, void* hin, void* dh0, void* part_w,
                  void* part_b, void* dwh, void* dbh, int steps, int n_rows,
                  int splits, cudaStream_t stream,
                  const void* chunk_policy = nullptr, int num_chunks = 1,
                  int chunk = 0, int num_policies = 1, void* hp = nullptr) {
  constexpr int kSplit = kTcSplit<H>;
  constexpr int U = H / kSplit;
  using L = GruTcBwd<H, R, kSplit>;
  const int tiles = fwd_blocks(chunk_policy, num_chunks, chunk, n_rows, R);
  if (phases & 1) {
    // Both maps span the [P, ...] stack, in boxes of the U rows of a
    // block's units (at most 256: TMA's limit of a box dimension).
    constexpr CUtensorMapDataType dt = tma_dtype<E>();
    CUtensorMap wht_map, wh_map;
    if (!make_tma_map(&wht_map, wh_t, H, 3 * H, num_policies, kTcK, U, dt) ||
        !make_tma_map(&wh_map, wh, 3 * H, H, num_policies, kTcK, U, dt))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = hp != nullptr
                            ? gru_bwd_tc_kernel<E, H, R, kSplit, true>
                            : gru_bwd_tc_kernel<E, H, R, kSplit, false>;
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
        &cfg, kernel, wht_map, wh_map, static_cast<const E*>(xp),
        static_cast<const E*>(keep), static_cast<const E*>(bias_h),
        static_cast<const E*>(h0), static_cast<const E*>(ys),
        static_cast<const E*>(dys), static_cast<E*>(dxp),
        static_cast<E*>(dhp), static_cast<E*>(hin), static_cast<E*>(dh0),
        static_cast<float*>(part_b), static_cast<float*>(hp), steps, n_rows,
        static_cast<const int*>(chunk_policy), chunk, num_policies);
    if (launched != cudaSuccess) return static_cast<int>(launched);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if ((phases & 2) && chunk_policy != nullptr) {
    // dWh of each policy from its chunks' own splits of boxes (never a box
    // of two chunks: weight_grad_tc.cuh), dbh from its chunks' row tiles.
    int used = 0;
    int err = weight_grad_tc_partials<E>(hin, H, nullptr, H, dhp, 3 * H,
                                         steps, chunk, num_chunks, splits,
                                         part_w, &used, stream);
    if (err != 0) return err;
    err = sum_by_policy<E>(part_w, dwh, chunk_policy, num_chunks, used,
                           num_policies, H * 3 * H, stream);
    if (err != 0) return err;
    return sum_by_policy<E>(part_b, dbh, chunk_policy, num_chunks,
                            tiles / num_chunks, num_policies, H, stream);
  }
  if (phases & 2) {
    const int err = weight_grad_tc<E>(hin, H, nullptr, H, dhp, 3 * H,
                                      steps * n_rows, splits, part_w, dwh,
                                      stream);
    if (err != 0) return err;
    return sum_splits<E>(part_b, dbh, tiles, H, stream);
  }
  return 0;
}

// ------------------------------------ bf16 and f16 forward on tensor cores

// Rows a block and ring stages of the tensor-core forward at every width
// (the only pair built): the fastest of the pairs swept at 256, 384 and
// 512 on the H100 (PERF.md; ops/cuda/gru.py:FWD_TC_ROWS mirrors R).
constexpr int kGruFwdRows = 32;
constexpr int kGruFwdStages = 4;

// Shared memory of gru_fwd_tc_kernel at R rows a block and at most kStages
// ring stages, from a 1024-byte aligned base: the ring of weight slices
// ([64 k][U units] each, U = H / kSplit the block's units, as U / 64 TMA
// boxes of [64 k][64 units]), the block's h tile (the K-major B operand of
// h . Wh over all H units, which the gate math overwrites with the next
// step's carry) and its x_proj tile (K-major [R][3U]: the x_proj columns of
// its units).
template <int H, int R, int kStages, int kSplit>
struct GruTcFwd {
  static constexpr int kUnits = H / kSplit;
  static constexpr int kWarpgroups = kUnits / 64;   // 64 units each
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kWarps = 4 * kWarpgroups;
  static constexpr int kSub = R * 128;          // one [R][64] subtile
  static constexpr int kStageBytes = kUnits * 128;
  static constexpr int kHBytes = R * H * 2;
  static constexpr int kXBytes = R * 3 * kUnits * 2;
  static constexpr int kFixed = kHBytes + kXBytes;
  static constexpr int kRing =
      min_c(kStages, (kSmemLimit - 2048 - kFixed) / kStageBytes);
  static constexpr int kSmem = kRing * kStageBytes + kFixed + 1024;
  static_assert(kRing >= 2, "a ring of at least two slices");
};

// The forward recurrence on tensor cores (see the header), E the storage
// type: bf16, or f16 (the float16 instance). One block
// owns R batch rows and loops over time; warpgroup w owns units
// 64 w .. 64 w + 63 of r, z and n, in the accumulator layout of
// gru_bwd_tc_kernel (element 4 j + 2 s + e of an m64nR accumulator is unit
// unit0 + 8 s, row 8 j + 2 (l % 4) + e), so the gate math is thread-local.
// wh_map is a TMA map of the row-major Wh [H, 3H] in boxes of
// [64 k][64 units]: wgmma's MN-major A operand as it stands, so a call
// copies no weight.
//
// With kSplit = 2 (H = 384, 512) the two blocks of a cluster own
// the same R rows and H / 2 units each (rank r: units r H / 2 ..), so a
// block keeps the H = 192 / 256 instance's warpgroups and registers: it
// streams its units' columns of Wh, stages its units' x_proj columns and
// holds the whole h tile (the product's K = H). After the gate math a
// thread writes its carry into its own h tile and its peer's (distributed
// shared memory). Two cluster barriers a step keep the tiles right: the
// first after both blocks' products, so that no write reaches an h tile
// that wgmma still reads; the second after the writes (release / acquire,
// then fence.proxy.async on both sides), so that the next step's products
// read both halves. A block never exits while its peer can still write
// into it: the last write is before the last step's second barrier, and a
// chunk of no policy is skipped by both blocks of its cluster together
// (they share its rows, so its policy). lstm_fwd_tc_kernel's cluster, with
// three gates. The kWitness instance also writes each step's h . Wh to hp
// (f32 [T, N, 3H], store_products), for gru_bwd_tc_kernel's witness.
template <typename E, int H, int R, int kStages, int kSplit, bool kWitness>
__global__ void __launch_bounds__(GruTcFwd<H, R, kStages, kSplit>::kThreads,
                                  1)
    gru_fwd_tc_kernel(const __grid_constant__ CUtensorMap wh_map,
                      const E* __restrict__ xp, const E* __restrict__ keep,
                      const E* __restrict__ bias_h, const E* __restrict__ h0,
                      E* __restrict__ ys, float* __restrict__ hp, int steps,
                      int n_rows, const int* __restrict__ chunk_policy,
                      int chunk, int num_policies) {
  using L = GruTcFwd<H, R, kStages, kSplit>;
  constexpr int S = L::kRing;
  constexpr int U = L::kUnits;
  constexpr int G3 = 3 * H;
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
    if (rank == 0) fill_nan(ys, steps, n_rows, H, rows, R);
    return;
  }
  bias_h += static_cast<size_t>(rows.policy) * H;
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

  // The weight slices of one step, in the order hidden_products consumes
  // them: Wh by (H-chunk, gate), each the U / 64 boxes of its gate's units
  // of this block; the same sequence every step, so the ring prefetches
  // across steps. The map spans the [P, H, 3H] stack (P = 1 without
  // chunks); the block's policy is the third coordinate.
  constexpr int step_loads = 3 * (H / kTcK);
  const CUtensorMap* whm = &wh_map;
  auto issue = [&](int q, uint32_t dst, uint64_t* bar) {
    const int p = q % step_loads;
#pragma unroll
    for (int w = 0; w < U / 64; ++w)
      tma_load_3d(dst + w * 64 * 128, whm, bar,
                  (p % 3) * H + unit_base + w * 64, (p / 3) * kTcK,
                  rows.policy);
  };
  SliceRing<S> slices{full, empty, ring, L::kStageBytes, steps * step_loads,
                      0};
  if (tid == 0) slices.init(L::kWarps);
  __syncthreads();
  if (tid == 0) slices.prime(issue);

  // x_proj of step t into the x tile by 16-byte cp.async with zero-fill:
  // rows past N arrive as zeros. Column g U + u of the tile is column
  // g H + unit_base + u of x_proj. Step t + 1's is issued once step t's
  // gate math has read the tile, and lands while step t + 1's products run.
  auto load_x = [&](int t) {
    const size_t trow = static_cast<size_t>(t) * n_rows;
    for (int e = tid; e < R * (3 * U / 8); e += L::kThreads) {
      const int n = e / (3 * U / 8), c = (e % (3 * U / 8)) * 8;
      const int col = kSplit == 1 ? c : (c / U) * H + unit_base + c % U;
      const int row = block_row + n;
      const bool live = row < row_end;
      cp_async16(x_s + kmaj_off<R>(n, c),
                 xp + (live ? (trow + row) * G3 + col : 0), live);
    }
    cp_async_commit();
  };

  // h0 into the h tile, all H units (rows past N: zeros).
  for (int e = tid; e < R * (H / 8); e += L::kThreads) {
    const int n = e / (H / 8), c = e % (H / 8);
    const int row = block_row + n;
    const bool live = row < row_end;
    cp_async16(h_s + kmaj_off<R>(n, c * 8),
               h0 + (live ? static_cast<size_t>(row) * H + c * 8 : 0), live);
  }
  load_x(0);
  uint32_t kb[2][2];   // as in gru_bwd_tc_kernel
  float bn[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      kb[s][e] = kmaj_off<R>(2 * lt + e, unit0 + 8 * s);
    bn[s] = to_f(bias_h[unit_base + unit0 + 8 * s]);
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

    float acc[3][kAcc];
    hidden_products<H, R, 1, E>(slices, issue, acc, a_off, h_s);
    cp_async_wait<0>();   // x_proj of step t
    // Every warpgroup is done reading the h tile; x_proj of step t is in.
    // With a cluster: the peer's warpgroups too, before this block writes
    // into its h tile.
    if constexpr (kSplit == 1)
      __syncthreads();
    else
      cluster_sync();

    // Gate math, thread-local (the contract's, gru_gates): each thread
    // reads and rewrites only its own elements of the h tile (with a
    // cluster also the peer's copies of them), with the new carry (E,
    // cleared where keep is 0); ys straight to memory.
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * s + e;
          const uint32_t ko = kb[s][e] + j * 1024;
          const Gates g = gru_gates(
              ld_elem<E>(x_p + ko), ld_elem<E>(x_p + ko + kGate),
              ld_elem<E>(x_p + ko + 2 * kGate), acc[0][i], acc[1][i],
              acc[2][i], bn[s]);
          const float h = ld_elem<E>(h_p + ko + h_shift);
          const E h_t = from_f<E>((1.0f - g.z) * g.n + g.z * h);
          const E h_next = (kept >> (2 * j + e)) & 1u ? h_t : zero;
          *reinterpret_cast<E*>(h_p + ko + h_shift) = h_next;
          if constexpr (kSplit > 1)
            st_cluster_u16(peer_h + ko + h_shift, elem_bits(h_next));
          const int row = block_row + 8 * j + 2 * lt + e;
          if (row < row_end)
            ys[(trow + row) * H + unit_base + unit0 + 8 * s] = h_t;
          if constexpr (kWitness)
            if (row < row_end)
              store_products<H>(hp, trow + row, unit_base + unit0 + 8 * s,
                                acc, i);
        }
    // The carry is in for the next step's products: this block's writes,
    // and with a cluster the peer's, visible to wgmma.
    if constexpr (kSplit == 1) {
      fence_proxy_async();
      __syncthreads();
    } else {
      fence_proxy_async_all();
      cluster_sync();
      fence_proxy_async_all();
    }
    // The x tile is free once every thread's gate math has read it.
    if (t + 1 < steps) load_x(t + 1);
  }
}

// chunk_policy null: one policy; else the chunk-indexed instance over the
// [num_policies, H, 3H] / [num_policies, H] stacks, one TMA map over the
// whole stack. E: __nv_bfloat16 or __half. At H = 384
// and 512, clusters of two blocks (kTcSplit), launched with their cluster
// dimension by cudaLaunchKernelEx; a refused launch returns its error.
// hp: null, or the products' witness (the kWitness instance of
// gru_fwd_tc_kernel).
template <typename E, int H>
int launch_fwd_tc(const void* xp, const void* keep, const void* wh,
                  const void* bias_h, const void* h0, void* ys, int steps,
                  int n_rows, cudaStream_t stream,
                  const void* chunk_policy = nullptr, int num_chunks = 0,
                  int chunk = 0, int num_policies = 1, void* hp = nullptr) {
  constexpr int R = kGruFwdRows;
  constexpr int kStages = kGruFwdStages;
  constexpr int kSplit = kTcSplit<H>;
  using L = GruTcFwd<H, R, kStages, kSplit>;
  const auto kernel =
      hp != nullptr ? gru_fwd_tc_kernel<E, H, R, kStages, kSplit, true>
                    : gru_fwd_tc_kernel<E, H, R, kStages, kSplit, false>;
  CUtensorMap wh_map;
  if (!make_tma_map(&wh_map, wh, 3 * H, H, num_policies, 64, kTcK,
                    tma_dtype<E>()))
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
      &cfg, kernel, wh_map, static_cast<const E*>(xp),
      static_cast<const E*>(keep), static_cast<const E*>(bias_h),
      static_cast<const E*>(h0), static_cast<E*>(ys),
      static_cast<float*>(hp), steps, n_rows,
      static_cast<const int*>(chunk_policy), chunk, num_policies);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Each entry point returns a
// cudaError_t, or -1 for arguments without an instantiation. The CUDA-core
// kernels serve float32 alone, at every width; bfloat16 and float16 take
// the tensor-core entry points at every width (mlt_gru_fwd_tc,
// mlt_gru_bwd_tc, and tensor_core 1 in the chunk-indexed ones). At H = 384
// and 512 their instances split the units over a cluster of two blocks
// (kTcSplit), as lstm.cu's do ("Wider layers", at its dispatch: one block
// would need H / 64 warpgroups, leaving 80 or 64 registers a thread, and
// the backward's K-major slices of Wh^T would be TMA boxes of H rows, past
// 256). At every width the forward and the backward's recompute share
// hidden_products in one slice order, so the backward differentiates the
// forward that ran.
#define MLT_DISPATCH_F32(CALL)                                   \
  if (dtype == 0 && hidden == 128) return CALL(float, 128);      \
  if (dtype == 0 && hidden == 256) return CALL(float, 256);      \
  if (dtype == 0 && hidden == 384) return CALL(float, 384);      \
  if (dtype == 0 && hidden == 512) return CALL(float, 512);      \
  return -1
// The tensor-core instances: bfloat16 and float16 at every width.
#define MLT_DISPATCH_TC(CALL)                                    \
  if (dtype == 1 && hidden == 128) return CALL(bf16, 128);       \
  if (dtype == 1 && hidden == 256) return CALL(bf16, 256);       \
  if (dtype == 1 && hidden == 384) return CALL(bf16, 384);       \
  if (dtype == 1 && hidden == 512) return CALL(bf16, 512);       \
  if (dtype == 2 && hidden == 128) return CALL(__half, 128);     \
  if (dtype == 2 && hidden == 256) return CALL(__half, 256);     \
  if (dtype == 2 && hidden == 384) return CALL(__half, 384);     \
  if (dtype == 2 && hidden == 512) return CALL(__half, 512);     \
  return -1

extern "C" int mlt_gru_fwd(int dtype, int hidden, const void* xp,
                           const void* keep, const void* wh,
                           const void* bias_h, const void* h0, void* ys,
                           int steps, int n_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_FWD(T, H) \
  launch_fwd<T, H>(xp, keep, wh, bias_h, h0, ys, steps, n_rows, s)
  MLT_DISPATCH_F32(MLT_FWD);
#undef MLT_FWD
}

extern "C" int mlt_gru_bwd(int dtype, int hidden, const void* xp,
                           const void* keep, const void* wh,
                           const void* wh_t, const void* bias_h,
                           const void* h0, const void* ys, const void* dys,
                           void* dxp, void* dhp, void* dh0, void* part_w,
                           void* part_b, void* dwh, void* db3, int steps,
                           int n_rows, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_BWD(T, H)                                                       \
  launch_bwd<T, H>(xp, keep, wh, wh_t, bias_h, h0, ys, dys, dxp, dhp, dh0, \
                   part_w, part_b, dwh, db3, steps, n_rows, splits, s)
  MLT_DISPATCH_F32(MLT_BWD);
#undef MLT_BWD
}

// The tensor-core backward: bfloat16 (dtype 1) and float16 (dtype 2) at
// H = 128, 256, 384 and 512 (two-block clusters at 384 and 512), each with
// kGruTcRows<H> rows a row tile (ops/cuda/gru.py:tc_rows). hp: null, or
// the f32 [T, N, 3H] witness of the recomputed h_in . Wh. Returns a
// cudaError_t, or -1 for arguments without an instantiation.
extern "C" int mlt_gru_bwd_tc(int dtype, int hidden, int phases,
                              const void* xp, const void* keep,
                              const void* wh, const void* wh_t,
                              const void* bias_h, const void* h0,
                              const void* ys, const void* dys, void* dxp,
                              void* dhp, void* hin, void* dh0, void* part_w,
                              void* part_b, void* dwh, void* dbh, int steps,
                              int n_rows, int splits, void* hp,
                              void* stream) {
  if (static_cast<long long>(steps) * n_rows > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_BWD_TC(E, H)                                                    \
  launch_bwd_tc<E, H>(phases, xp, keep, wh, wh_t, bias_h, h0, ys, dys, dxp, \
                      dhp, hin, dh0, part_w, part_b, dwh, dbh, steps,       \
                      n_rows, splits, s, nullptr, 1, 0, 1, hp)
  MLT_DISPATCH_TC(MLT_BWD_TC);
#undef MLT_BWD_TC
}

// The tensor-core forward, from Wh as it stands, at kGruFwdRows rows a
// block and a ring of kGruFwdStages slices: bfloat16 (dtype 1) and float16
// (dtype 2) at H = 128, 256, 384 and 512 (two-block clusters at 384 and
// 512). hp: null, or the f32 [T, N, 3H] witness of the products h . Wh
// (gru_fwd_tc_kernel). Returns a cudaError_t, or -1 for arguments without
// an instantiation.
extern "C" int mlt_gru_fwd_tc(int dtype, int hidden, const void* xp,
                              const void* keep, const void* wh,
                              const void* bias_h, const void* h0, void* ys,
                              int steps, int n_rows, void* hp,
                              void* stream) {
  if (static_cast<long long>(steps) * n_rows > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_FWD_TC(E, H)                                                  \
  launch_fwd_tc<E, H>(xp, keep, wh, bias_h, h0, ys, steps, n_rows, s,     \
                      nullptr, 0, 0, 1, hp)
  MLT_DISPATCH_TC(MLT_FWD_TC);
#undef MLT_FWD_TC
}

// gru_sequence_fwd_chunked: the forward over [num_chunks * chunk] rows,
// chunk c with the weights of policy chunk_policy[c] of the [num_policies,
// H, 3H] / [num_policies, H] stacks (a chunk of no policy is skipped, its
// rows NaN). tensor_core 1 takes the tensor-core kernel (bfloat16 and
// float16 at every width), 0 the CUDA-core one (float32). Returns a
// cudaError_t, or -1 for arguments without an instantiation.
extern "C" int mlt_gru_fwd_chunked(int tensor_core, int dtype, int hidden,
                                   const void* xp, const void* keep,
                                   const void* wh, const void* bias_h,
                                   const void* chunk_policy, const void* h0,
                                   void* ys, int steps, int num_chunks,
                                   int chunk, int num_policies,
                                   void* stream) {
  const long long n = static_cast<long long>(num_chunks) * chunk;
  if (num_chunks <= 0 || chunk <= 0 || num_policies <= 0 ||
      num_policies > 65535 || n * steps > 0x7fffffffLL)
    return -1;
  const int n_rows = static_cast<int>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
#define MLT_FWD_CHUNKED_TC(E, H)                                           \
  launch_fwd_tc<E, H>(xp, keep, wh, bias_h, h0, ys, steps, n_rows, s,      \
                      chunk_policy, num_chunks, chunk, num_policies)
    MLT_DISPATCH_TC(MLT_FWD_CHUNKED_TC);
#undef MLT_FWD_CHUNKED_TC
  }
#define MLT_FWD_CHUNKED(T, H)                                              \
  launch_fwd<T, H>(xp, keep, wh, bias_h, h0, ys, steps, n_rows, s,          \
                   chunk_policy, num_chunks, chunk, num_policies)
  MLT_DISPATCH_F32(MLT_FWD_CHUNKED);
#undef MLT_FWD_CHUNKED
}

// gru_sequence_bwd_chunked: the backward of gru_sequence_fwd_chunked over
// [num_chunks * chunk] rows, chunk c with the weights of policy
// chunk_policy[c] of the [num_policies, H, 3H] stacks wh and wh_t (Wh^T a
// policy, [num_policies, 3H, H]) and [num_policies, H] bias_h: dxp, dhp
// and dh0 a row, each row's bitwise gru_sequence_bwd's with its policy's
// weights (a chunk of no policy: NaN rows), and dwh [num_policies, H, 3H]
// and db, a policy's summed over its chunks' `splits` partials each (0 for
// a policy without a chunk). tensor_core 1 takes the tensor-core recurrence
// and weight-gradient pass (bfloat16 and float16 at every width; hin:
// [T, N, H] scratch; part_w [num_chunks * splits, H, 3H], part_b
// [num_chunks * ceil(chunk / kGruTcRows<H>), H]; db is dbh [num_policies,
// H]), 0 the CUDA-core kernels (float32; hin unused; part_w and part_b
// [num_chunks * splits, ...]; db is db3 [num_policies, 3H], whose last H
// columns are dbh). Returns a cudaError_t, or -1 for arguments without an
// instantiation.
extern "C" int mlt_gru_bwd_chunked(
    int tensor_core, int dtype, int hidden, const void* xp, const void* keep,
    const void* wh, const void* wh_t, const void* bias_h,
    const void* chunk_policy, const void* h0, const void* ys,
    const void* dys, void* dxp, void* dhp, void* hin, void* dh0,
    void* part_w, void* part_b, void* dwh, void* db, int steps,
    int num_chunks, int chunk, int num_policies, int splits, void* stream) {
  const long long n = static_cast<long long>(num_chunks) * chunk;
  if (num_chunks <= 0 || chunk <= 0 || num_policies <= 0 || splits <= 0 ||
      num_policies > 65535 || n * steps > 0x7fffffffLL)
    return -1;
  const int n_rows = static_cast<int>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
#define MLT_BWD_CHUNKED_TC(E, H)                                            \
  launch_bwd_tc<E, H>(3, xp, keep, wh, wh_t, bias_h, h0, ys, dys, dxp, dhp, \
                      hin, dh0, part_w, part_b, dwh, db, steps, n_rows,     \
                      splits, s, chunk_policy, num_chunks, chunk,           \
                      num_policies)
    MLT_DISPATCH_TC(MLT_BWD_CHUNKED_TC);
#undef MLT_BWD_CHUNKED_TC
  }
#define MLT_BWD_CHUNKED(T, H)                                              \
  launch_bwd<T, H>(xp, keep, wh, wh_t, bias_h, h0, ys, dys, dxp, dhp, dh0,  \
                   part_w, part_b, dwh, db, steps, n_rows, splits, s,       \
                   chunk_policy, num_chunks, chunk, num_policies)
  MLT_DISPATCH_F32(MLT_BWD_CHUNKED);
#undef MLT_BWD_CHUNKED
}

#undef MLT_DISPATCH_TC
#undef MLT_DISPATCH_F32
