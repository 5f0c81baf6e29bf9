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
// The forwards, and the backwards in float32 (layout and product in
// common.cuh):
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
// The backwards in bfloat16 (lstm_bwd_tc_kernel, then weight_grad_tc.cuh),
// on Hopper's tensor cores: the TPU kernel's products are bf16 operands
// with f32 accumulation, which is what wgmma computes, with only the order
// of the sums changed. The wrapper's rule (ops/cuda/lstm.py:
// uses_tensor_cores) sends bf16 at H = 128 or 256 here (an operand off a
// 16-byte boundary is copied onto one first), float32 to the kernels above.
// - Row ownership as above, with R = kTcRows rows a block (16, and 32 with
//   the projection: the faster of the two on the H100): warpgroup w
//   owns units 64 w .. 64 w + 63 of all four gates, so the gate math and
//   the f32 dh / dc carries stay thread-local. The products run transposed,
//   gates (or units, or input features) as wgmma's M and the block's rows
//   as its N: gates^T = Wr^T . h_in^T, dh_prev^T = Wr . dgates^T, and for
//   the projection xp^T = Wi^T . x^T (rounded to bf16 in the accumulators
//   before h_in . Wr is added) and dx^T = Wi . dgates^T (rounded once),
//   each warpgroup's result in the layout of its carries.
// - A: 64-deep slices of the weights ([H rows][64], 128-byte swizzle)
//   through a ring of stages (32 KB at H = 256) filled by TMA (thread 0
//   issues, one mbarrier a stage completes it, each warp arrives on an
//   empty barrier when its wgmma has retired the stage): Wr^T, then Wr
//   each step, with Wi^T and Wi for the projection. The sequence is the
//   same every step, so the ring prefetches across phases. Wr is 512 KiB
//   in bf16 at H = 256, more than a block's shared memory, so it streams
//   from L2 every step; a block reuses each element for its R rows.
// - B: the block's h_in and dgates tiles ([R][K] bf16, K-major, the same
//   swizzle) in shared memory; x_proj (or x) lands in the dgates tile,
//   which the gate math then overwrites element by element (each thread
//   rewrites only what it read). h_in, c_in (cleared by keep), cs and dys
//   arrive by 16-byte cp.async with zero-fill, so rows past N give exact
//   zeros; their dgates are set to 0.
// - The kernel writes the rounded dgates (dx_proj, or a scratch), h_in as
//   each step used it ([T, N, H] scratch) and per-block db partials. Then
//   weight_grad_tc.cuh: dW = [x |] h_in^T . dgates as split-K wgmma over
//   the T*N rows ([F + H, 4H] in one launch for the projection), f32
//   partials per split, summed in split order; db from the block
//   partials in block order. Deterministic, and a row's dgates, dx, dh0
//   and dc0 do not depend on N or on where the row sits.
//
// Bound on the H100: the forward is a chain of [BN, H] x [H, 4H] products
// (and [BN, F] x [F, 4H]) with a dependency between steps; its memory
// traffic is one read of x or x_proj and one write of ys/cs per step. The
// bf16 backward's products take ~0.2 ms on tensor cores at [16, 8192, 256]
// (0.4 ms with the projection at F = 256); what holds it is streaming the
// weights from L2 every step, 1 MiB a block a step (2 MiB with Wi), about
// 8.6 GB per call in both variants (R = 16 without Wi, 32 with it).

#include <cuda.h>   // CUtensorMap

#include "common.cuh"
#include "mma.cuh"
#include "weight_grad.cuh"
#include "weight_grad_tc.cuh"

namespace {

using namespace mlt;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ keep,
                    const T* __restrict__ wr, const T* __restrict__ bias,
                    const T* __restrict__ c0, const T* __restrict__ h0,
                    T* __restrict__ ys, T* __restrict__ cs, int steps,
                    int n_rows) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G4 = 4 * H;
  __shared__ float h_s[kRows * H];

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = blockIdx.x * kRows;

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
      c[i][j] = n < n_rows ? to_f(c0[idx]) : 0.0f;
      h_s[(row_base + i) * H + u0 + j] = n < n_rows ? to_f(h0[idx]) : 0.0f;
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
      if (n >= n_rows) continue;
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
// x_s [kRows][F].
template <typename T, int H>
__global__ void __launch_bounds__(kThreads) lstm_proj_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ keep,
    const T* __restrict__ wi, const T* __restrict__ wr,
    const T* __restrict__ bias, const T* __restrict__ c0,
    const T* __restrict__ h0, T* __restrict__ ys, T* __restrict__ cs,
    int steps, int n_rows, int f_in) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G4 = 4 * H;
  extern __shared__ float smem[];
  float* h_s = smem;
  float* x_s = smem + kRows * H;

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = blockIdx.x * kRows;

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
      c[i][j] = n < n_rows ? to_f(c0[idx]) : 0.0f;
      h_s[(row_base + i) * H + u0 + j] = n < n_rows ? to_f(h0[idx]) : 0.0f;
    }
  }

  for (int t = 0; t < steps; ++t) {
    load_row_tile<T>(x_s, x + static_cast<size_t>(t) * n_rows * f_in,
                     block_row, n_rows, f_in);
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
      if (n >= n_rows) continue;
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
// to hin_s, c_in to registers.
template <typename T, int H, int RPT, int UPT>
__device__ __forceinline__ void load_carry_in(
    const T* __restrict__ keep, const T* __restrict__ ys,
    const T* __restrict__ cs, const T* __restrict__ h0,
    const T* __restrict__ c0, int t, int n_rows, int block_row, int row_base,
    int u0, float* hin_s, float (&c_in)[RPT][UPT], bool (&keep_prev)[RPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
    keep_prev[i] = false;
    if (n < n_rows && t > 0)
      keep_prev[i] =
          to_f(keep[static_cast<size_t>(t - 1) * n_rows + n]) > 0.5f;
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      float h_v = 0.0f, c_v = 0.0f;
      if (n < n_rows) {
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
// dc_total * f. Rows past n_rows get zero dgates.
template <typename T, int H, int RPT, int UPT>
__device__ __forceinline__ void gate_cotangents(
    const float (&pre)[RPT][4][UPT], const float (&b)[4][UPT],
    const float (&c_in)[RPT][UPT], const float (&dh)[RPT][UPT],
    const float (&dc)[RPT][UPT], const T* __restrict__ cs,
    const T* __restrict__ dys, T* __restrict__ dg, float* dg_s, int t,
    int n_rows, int block_row, int row_base, int u0,
    float (&dc_prev)[RPT][UPT]) {
  constexpr int G4 = 4 * H;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
    const int r = row_base + i;
    if (n >= n_rows) {
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
    T* __restrict__ dh0, T* __restrict__ dc0, int steps, int n_rows) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G4 = 4 * H;
  extern __shared__ float smem[];
  float* hin_s = smem;                 // [BN][H]  h entering step t
  float* dg_s = smem + kRows * H;      // [BN][4H] dgates of step t

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = blockIdx.x * kRows;

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
      if (n < n_rows && t > 0)
        keep_prev[i] =
            to_f(keep[static_cast<size_t>(t - 1) * n_rows + n]) > 0.5f;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        float h_v = 0.0f, c_v = 0.0f;
        if (n < n_rows) {
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
      if (n >= n_rows) {
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
        if (t == 0 && n < n_rows) {
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

// Projection backward. Shared memory: hin_s [kRows][H], dg_s [kRows][4H],
// x_s [kRows][F].
template <typename T, int H>
__global__ void __launch_bounds__(kThreads) lstm_proj_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ keep,
    const T* __restrict__ wi, const T* __restrict__ wi_t,
    const T* __restrict__ wr, const T* __restrict__ wr_t,
    const T* __restrict__ bias, const T* __restrict__ c0,
    const T* __restrict__ h0, const T* __restrict__ ys,
    const T* __restrict__ cs, const T* __restrict__ dys, T* __restrict__ dx,
    T* __restrict__ dg, T* __restrict__ dh0, T* __restrict__ dc0, int steps,
    int n_rows, int f_in) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G4 = 4 * H;
  constexpr int kChunk = 2 * kUnitGroups;  // dx columns per pass
  extern __shared__ float smem[];
  float* hin_s = smem;
  float* dg_s = smem + kRows * H;
  float* x_s = smem + kRows * 5 * H;

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = blockIdx.x * kRows;

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
    load_carry_in<T, H, RPT, UPT>(keep, ys, cs, h0, c0, t, n_rows, block_row,
                                  row_base, u0, hin_s, c_in, keep_prev);
    load_row_tile<T>(x_s, x + static_cast<size_t>(t) * n_rows * f_in,
                     block_row, n_rows, f_in);
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

    float dc_prev[RPT][UPT];
    gate_cotangents<T, H, RPT, UPT>(acc, b, c_in, dh, dc, cs, dys, dg, dg_s,
                                    t, n_rows, block_row, row_base, u0,
                                    dc_prev);
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
        if (n >= n_rows) continue;
        T* out = dx + (static_cast<size_t>(t) * n_rows + n) * f_in + f0 +
                 ug * 2;
        out[0] = from_f<T>(dxa[i][0][0]);
        out[1] = from_f<T>(dxa[i][0][1]);
      }
    }

    carry_cotangents<T, H, RPT, UPT>(dh_prev, dc_prev, keep_prev, dh0, dc0, t,
                                     n_rows, block_row, row_base, u0, dh, dc);
    // As in lstm_bwd_kernel: hin_s and x_s are rewritten before the next
    // first barrier and read by no thread after the second; dg_s is
    // rewritten only after the next first barrier.
  }
}

// dWr and db from the dgates of the whole sequence: partials, then sums.
template <typename T, int H>
int launch_dwr(const void* dg, const void* ys, const void* keep,
               const void* h0, void* part_w, void* part_b, void* dwr,
               void* db, int steps, int n_rows, int splits,
               cudaStream_t stream) {
  const long long total = static_cast<long long>(steps) * n_rows;
  const int rows_per_split = static_cast<int>((total + splits - 1) / splits);
  const dim3 grid(4 * H / kTileJ, H / kTileI, splits);
  weight_grad_partial_kernel<T, true><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dg), static_cast<const T*>(ys),
      static_cast<const T*>(keep), static_cast<const T*>(h0),
      static_cast<float*>(part_w), static_cast<float*>(part_b), steps,
      n_rows, H, 4 * H, rows_per_split);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = sum_splits<T>(part_w, dwr, splits, H * 4 * H, stream);
  if (err != 0) return err;
  return sum_splits<T>(part_b, db, splits, 4 * H, stream);
}

template <typename T, int H>
int launch_fwd(const void* xp, const void* keep, const void* wr,
               const void* bias, const void* c0, const void* h0, void* ys,
               void* cs, int steps, int n_rows, cudaStream_t stream) {
  const int blocks = (n_rows + kRows - 1) / kRows;
  lstm_fwd_kernel<T, H><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(keep),
      static_cast<const T*>(wr), static_cast<const T*>(bias),
      static_cast<const T*>(c0), static_cast<const T*>(h0),
      static_cast<T*>(ys), static_cast<T*>(cs), steps, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int H>
int launch_bwd(const void* xp, const void* keep, const void* wr,
               const void* wr_t, const void* bias, const void* c0,
               const void* h0, const void* ys, const void* cs,
               const void* dys, void* dxp, void* dh0, void* dc0,
               void* part_w, void* part_b, void* dwr, void* db, int steps,
               int n_rows, int splits, cudaStream_t stream) {
  const int smem = kRows * 5 * H * static_cast<int>(sizeof(float));
  int err = set_smem(lstm_bwd_kernel<T, H>, smem);
  if (err != 0) return err;
  const int blocks = (n_rows + kRows - 1) / kRows;
  lstm_bwd_kernel<T, H><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(keep),
      static_cast<const T*>(wr), static_cast<const T*>(wr_t),
      static_cast<const T*>(bias), static_cast<const T*>(c0),
      static_cast<const T*>(h0), static_cast<const T*>(ys),
      static_cast<const T*>(cs), static_cast<const T*>(dys),
      static_cast<T*>(dxp), static_cast<T*>(dh0), static_cast<T*>(dc0),
      steps, n_rows);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_dwr<T, H>(dxp, ys, keep, h0, part_w, part_b, dwr, db, steps,
                          n_rows, splits, stream);
}

template <typename T, int H>
int launch_proj_fwd(const void* x, const void* keep, const void* wi,
                    const void* wr, const void* bias, const void* c0,
                    const void* h0, void* ys, void* cs, int steps,
                    int n_rows, int f_in, cudaStream_t stream) {
  const int smem = kRows * (H + f_in) * static_cast<int>(sizeof(float));
  int err = set_smem(lstm_proj_fwd_kernel<T, H>, smem);
  if (err != 0) return err;
  const int blocks = (n_rows + kRows - 1) / kRows;
  lstm_proj_fwd_kernel<T, H><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(keep),
      static_cast<const T*>(wi), static_cast<const T*>(wr),
      static_cast<const T*>(bias), static_cast<const T*>(c0),
      static_cast<const T*>(h0), static_cast<T*>(ys), static_cast<T*>(cs),
      steps, n_rows, f_in);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int H>
int launch_proj_bwd(const void* x, const void* keep, const void* wi,
                    const void* wi_t, const void* wr, const void* wr_t,
                    const void* bias, const void* c0, const void* h0,
                    const void* ys, const void* cs, const void* dys,
                    void* dx, void* dg, void* dh0, void* dc0, void* part_wi,
                    void* part_w, void* part_b, void* dwi, void* dwr,
                    void* db, int steps, int n_rows, int f_in, int splits,
                    cudaStream_t stream) {
  const int smem = kRows * (5 * H + f_in) * static_cast<int>(sizeof(float));
  int err = set_smem(lstm_proj_bwd_kernel<T, H>, smem);
  if (err != 0) return err;
  const int blocks = (n_rows + kRows - 1) / kRows;
  lstm_proj_bwd_kernel<T, H><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(keep),
      static_cast<const T*>(wi), static_cast<const T*>(wi_t),
      static_cast<const T*>(wr), static_cast<const T*>(wr_t),
      static_cast<const T*>(bias), static_cast<const T*>(c0),
      static_cast<const T*>(h0), static_cast<const T*>(ys),
      static_cast<const T*>(cs), static_cast<const T*>(dys),
      static_cast<T*>(dx), static_cast<T*>(dg), static_cast<T*>(dh0),
      static_cast<T*>(dc0), steps, n_rows, f_in);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  err = launch_dwr<T, H>(dg, ys, keep, h0, part_w, part_b, dwr, db, steps,
                         n_rows, splits, stream);
  if (err != 0) return err;
  const long long total = static_cast<long long>(steps) * n_rows;
  const int rows_per_split = static_cast<int>((total + splits - 1) / splits);
  const dim3 grid(4 * H / kTileJ, f_in / kTileI, splits);
  weight_grad_partial_kernel<T, false><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dg), static_cast<const T*>(x), nullptr, nullptr,
      static_cast<float*>(part_wi), nullptr, steps, n_rows, f_in, 4 * H,
      rows_per_split);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return sum_splits<T>(part_wi, dwi, splits, f_in * 4 * H, stream);
}

// ------------------------------------ bf16 backward on tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcK = 64;             // depth of a weight slice: 128 bytes
constexpr int kSmemLimit = 232448;   // shared memory a block can use

constexpr int min_c(int a, int b) { return a < b ? a : b; }

// Batch rows a block of the tensor-core recurrence (R), by variant: the
// faster of 16 and 32 at the update shape on the H100. R = 32 halves the L2
// weight traffic but spills at H = 256; with the projection it still wins.
template <bool kProj>
constexpr int kTcRows = kProj ? 32 : 16;

// Shared memory of lstm_bwd_tc_kernel, from a 1024-byte aligned base: the
// ring of weight slices ([H rows][64] bf16 each), the block's h_in tile
// and its dgates tile (K-major wgmma B operands: [K / 64] subtiles of
// [R][64], 128-byte swizzle), then its cs, dys and c_in tiles ([R][H]).
template <int H, int R>
struct TcBwd {
  static constexpr int kWarpgroups = H / 64;   // 64 units each
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kWarps = 4 * kWarpgroups;
  static constexpr int kSub = R * 128;          // one [R][64] subtile
  static constexpr int kStageBytes = H * 128;
  static constexpr int kHinBytes = R * H * 2;
  static constexpr int kDgBytes = R * 4 * H * 2;
  static constexpr int kTileBytes = R * H * 2;
  static constexpr int kFixed = kHinBytes + kDgBytes + 3 * kTileBytes;
  static constexpr int kStages =
      min_c(4, (kSmemLimit - 2048 - kFixed) / kStageBytes);
  static constexpr int kSmem = kStages * kStageBytes + kFixed + 1024;
  static_assert(kStages >= 2, "a ring of at least two slices");
};

// Byte offset of element (n, k) of a K-major [R][K] operand tile.
template <int R>
__device__ __forceinline__ uint32_t kmaj_off(int n, int k) {
  return (k / 64) * (R * 128) + n * 128 + ((((k % 64) / 8) ^ (n % 8)) * 16) +
         (k % 8) * 2;
}

// Byte offset of element (n, u) of a [R][H] tile, 16-byte chunks swizzled
// by row so that a warp's reads of four rows hit distinct banks.
template <int H>
__device__ __forceinline__ uint32_t row_off(int n, int u) {
  return n * H * 2 + (((u / 8) ^ (n % 8)) * 16) + (u % 8) * 2;
}

__device__ __forceinline__ float ld_bf16(const uint8_t* p) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(p));
}

// The reverse-time recurrence of the bf16 backward (see the header). One
// block owns R batch rows; warpgroup w owns units 64 w .. 64 w + 63 of all
// four gates. Thread (warp v of its warpgroup, lane l) holds units
// 64 w + 16 v + l / 4 (+ 8) and rows 8 j + 2 (l % 4) (+ 1) of each
// m64nR accumulator: element 4 j + 2 s + e is unit + 8 s, row 8 j +
// 2 (l % 4) + e. Outputs: dg (rounded dgates [T, N, 4H]), hin (h_in as the
// step used it, [T, N, H]), dx (projection), dh0, dc0 and part_b (this
// block's db partial, [blocks, 4H]).
template <int H, int R, bool kProj>
__global__ void __launch_bounds__(TcBwd<H, R>::kThreads, 1)
    lstm_bwd_tc_kernel(const __grid_constant__ CUtensorMap wit_map,
                       const __grid_constant__ CUtensorMap wrt_map,
                       const __grid_constant__ CUtensorMap wr_map,
                       const __grid_constant__ CUtensorMap wi_map,
                       const bf16* __restrict__ x, const bf16* __restrict__ keep,
                       const bf16* __restrict__ bias,
                       const bf16* __restrict__ c0, const bf16* __restrict__ h0,
                       const bf16* __restrict__ ys, const bf16* __restrict__ cs,
                       const bf16* __restrict__ dys, bf16* __restrict__ dx,
                       bf16* __restrict__ dg, bf16* __restrict__ hin,
                       bf16* __restrict__ dh0, bf16* __restrict__ dc0,
                       float* __restrict__ part_b, int steps, int n_rows,
                       int f_in) {
  using L = TcBwd<H, R>;
  constexpr int G4 = 4 * H;
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

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32;
  const int lt = lane % 4;
  const int unit0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int block_row = blockIdx.x * R;

  // The weight slices of one step, in the order the step consumes them:
  // Wi^T by (F-chunk, gate), Wr^T by (H-chunk, gate), Wr by 4H-chunk, Wi by
  // (band of H rows, 4H-chunk); the same sequence every step.
  const int xp_loads = kProj ? 4 * (f_in / kTcK) : 0;
  const int g_loads = 4 * (H / kTcK);
  const int d_loads = G4 / kTcK;
  const int bands = kProj ? (f_in + H - 1) / H : 0;
  const int step_loads = xp_loads + g_loads + d_loads * (1 + bands);
  const int total = steps * step_loads;
  const CUtensorMap* wit = &wit_map;
  const CUtensorMap* wrt = &wrt_map;
  const CUtensorMap* wrm = &wr_map;
  const CUtensorMap* wim = &wi_map;

  auto issue = [&](int q) {
    const int s = q % S;
    const uint32_t dst = ring + s * L::kStageBytes;
    int p = q % step_loads;
    mbar_arrive_expect_tx(&full[s], L::kStageBytes);
    if (p < xp_loads) {
      tma_load_3d(dst, wit, &full[s], (p / 4) * kTcK, (p % 4) * H, 0);
      return;
    }
    p -= xp_loads;
    if (p < g_loads) {
      tma_load_3d(dst, wrt, &full[s], (p / 4) * kTcK, (p % 4) * H, 0);
      return;
    }
    p -= g_loads;
    if (p < d_loads) {
      tma_load_3d(dst, wrm, &full[s], p * kTcK, 0, 0);
      return;
    }
    p -= d_loads;
    tma_load_3d(dst, wim, &full[s], (p % d_loads) * kTcK, (p / d_loads) * H,
                0);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int q = 0; q < min(S, total); ++q) issue(q);

  // Consume slice q of the ring: acc (+)= this warpgroup's 64 rows of it .
  // the [R][64] operand subtile at b. Then retire slice q - 1: each warp
  // arrives on its stage's empty barrier, and thread 0 refills the stage
  // with slice q - 1 + S once every warp has. (Every warpgroup issues every
  // product, also where its rows of a Wi band lie past F and arrive as
  // zeros: a product skipped by some warpgroups makes ptxas serialize them
  // all.)
  int q = 0;
  const uint32_t a_off = wg * 64 * 128;
  auto consume = [&](float(&acc)[kAcc], uint32_t b, bool fresh) {
    const int s = q % S;
    mbar_wait(&full[s], (q / S) & 1);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(acc[i]);
    wgmma_fence();
    const uint32_t a = ring + s * L::kStageBytes + a_off;
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk)
      wgmma_ss<R>(acc, wgmma_desc(a + kk * 32, 16, 1024, 128),
                  wgmma_desc(b + kk * 32, 16, 1024, 128),
                  fresh && kk == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(acc[i]);
    if (q > 0) {
      const int sp = (q - 1) % S;
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sp]);
      if (tid == 0 && q - 1 + S < total) {
        mbar_wait(&empty[sp], ((q - 1) / S) & 1);
        issue(q - 1 + S);
      }
      __syncwarp();
    }
    ++q;
  };

  // Byte offsets of this thread's elements (rows 2 (l % 4) + e, units
  // unit0 + 8 s) in the K-major tiles and in the row tiles: row 8 j + .. is
  // j * 1024 (j * 16 H) bytes on, gate g of the dgates tile g (H / 64)
  // subtiles on.
  uint32_t kb[2][2], rb[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      kb[s][e] = kmaj_off<R>(2 * lt + e, unit0 + 8 * s);
      rb[s][e] = row_off<H>(2 * lt + e, unit0 + 8 * s);
    }
  float b[4][2];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      b[g][s] = __bfloat162float(bias[g * H + unit0 + 8 * s]);
  float dh[kAcc], dc[kAcc];   // carried cotangents
  float db[4][2];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    dh[i] = 0.0f;
    dc[i] = 0.0f;
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) db[g][0] = db[g][1] = 0.0f;

  const int x_width = kProj ? f_in : G4;
  // The row tiles of step t, by 16-byte cp.async with zero-fill: the carry
  // into step t (h_in, c_in: the cleared state after step t - 1, or the
  // unmasked initial state at t == 0), cs and dys.
  auto load_rows = [&](int t) {
    const size_t trow = static_cast<size_t>(t) * n_rows;
    const size_t prow = trow - n_rows;
    for (int e = tid; e < R * (H / 8); e += L::kThreads) {
      const int n = e / (H / 8), c = e % (H / 8);
      const int row = block_row + n;
      const bool live = row < n_rows;
      bool kept = live;
      const bf16* hs = h0;
      const bf16* cp = c0;
      if (live && t == 0) {
        hs = h0 + static_cast<size_t>(row) * H + c * 8;
        cp = c0 + static_cast<size_t>(row) * H + c * 8;
      } else if (live) {
        kept = __bfloat162float(keep[prow + row]) > 0.5f;
        hs = ys + (prow + row) * H + c * 8;
        cp = cs + (prow + row) * H + c * 8;
      }
      cp_async16(hin_s + kmaj_off<R>(n, c * 8), kept ? hs : h0, kept);
      cp_async16(cin_s + row_off<H>(n, c * 8), kept ? cp : c0, kept);
      const size_t off = live ? (trow + row) * H + c * 8 : 0;
      cp_async16(cs_s + row_off<H>(n, c * 8), cs + off, live);
      cp_async16(dys_s + row_off<H>(n, c * 8), dys + off, live);
    }
  };
  // x_proj (or x) of step t into the dgates tile, free until the gate math.
  auto load_x = [&](int t) {
    const size_t trow = static_cast<size_t>(t) * n_rows;
    for (int e = tid; e < R * (x_width / 8); e += L::kThreads) {
      const int n = e / (x_width / 8), c = e % (x_width / 8);
      const int row = block_row + n;
      const bool live = row < n_rows;
      cp_async16(dg_s + kmaj_off<R>(n, c * 8),
                 x + (live ? (trow + row) * x_width + c * 8 : 0), live);
    }
  };
  for (int t = steps - 1; t >= 0; --t) {
    const size_t trow = static_cast<size_t>(t) * n_rows;
    const size_t prow = trow - n_rows;   // step t - 1 (t > 0)
    load_rows(t);
    load_x(t);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    // h_in as this step used it, for the weight-gradient pass.
    for (int e = tid; e < R * (H / 8); e += L::kThreads) {
      const int n = e / (H / 8), c = e % (H / 8);
      const int row = block_row + n;
      if (row < n_rows)
        *reinterpret_cast<uint4*>(hin + (trow + row) * H + c * 8) =
            *reinterpret_cast<const uint4*>(hin_p + kmaj_off<R>(n, c * 8));
    }
    uint32_t keep_prev = 0;   // bit 2 j + e: row 8 j + 2 (l % 4) + e
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = block_row + 8 * j + 2 * lt + e;
        if (t > 0 && row < n_rows &&
            __bfloat162float(keep[prow + row]) > 0.5f)
          keep_prev |= 1u << (2 * j + e);
      }

    // Pre-activations, gates as M and rows as N: round(x . Wi) (the
    // hoisted Dense's rounding point) for the projection, then h_in . Wr.
    float acc[4][kAcc];
    if constexpr (kProj) {
      for (int kc = 0; kc < f_in / kTcK; ++kc)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          consume(acc[g], dg_s + kc * L::kSub, kc == 0);
      wgmma_wait<0>();
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          wgmma_fence_operand(acc[g][i]);
          acc[g][i] = round_to<bf16>(acc[g][i]);
        }
    }
    for (int kc = 0; kc < H / kTcK; ++kc)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        consume(acc[g], hin_s + kc * L::kSub, !kProj && kc == 0);
    wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(acc[g][i]);
    // The projection's x sits where the dgates go: every warpgroup is done
    // reading it.
    if constexpr (kProj) __syncthreads();

    // Gate math, thread-local: dgates rounded to bf16 into the dgates tile
    // (each thread rewrites only the x_proj elements it read), db, dc_prev.
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * s + e;
          const bool live = block_row + 8 * j + 2 * lt + e < n_rows;
          uint8_t* dgo = dg_p + kb[s][e] + j * 1024;
          const uint32_t ro = rb[s][e] + j * 16 * H;
          constexpr int kGate = (H / 64) * L::kSub;   // gate stride
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[g] = kProj ? acc[g][i] + b[g][s]
                           : ld_bf16(dgo + g * kGate) + acc[g][i] + b[g][s];
          const float si = sigmoid_f(pre[0]);
          const float sf = sigmoid_f(pre[1]);
          const float tg = tanhf(pre[2]);
          const float so = sigmoid_f(pre[3]);
          const float tanh_c = tanhf(ld_bf16(cs_p + ro));
          const float c_in = ld_bf16(cin_p + ro);
          const float dh_total = ld_bf16(dys_p + ro) + dh[i];
          const float dc_total =
              dc[i] + dh_total * so * (1.0f - tanh_c * tanh_c);
          const bf16 zero = __float2bfloat16_rn(0.0f);
          const bf16 d[4] = {
              live ? __float2bfloat16_rn(dc_total * tg * si * (1.0f - si))
                   : zero,
              live ? __float2bfloat16_rn(dc_total * c_in * sf * (1.0f - sf))
                   : zero,
              live ? __float2bfloat16_rn(dc_total * si * (1.0f - tg * tg))
                   : zero,
              live ? __float2bfloat16_rn(dh_total * tanh_c * so * (1.0f - so))
                   : zero,
          };
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            *reinterpret_cast<bf16*>(dgo + g * kGate) = d[g];
            db[g][s] += __bfloat162float(d[g]);
          }
          dc[i] = live ? dc_total * sf : 0.0f;   // dc_prev, masked below
        }
    fence_proxy_async();
    __syncthreads();

    // The rounded dgates: an output (dx_proj), and the weight-gradient
    // pass's B operand.
    for (int e = tid; e < R * (G4 / 8); e += L::kThreads) {
      const int n = e / (G4 / 8), c = e % (G4 / 8);
      const int row = block_row + n;
      if (row < n_rows)
        *reinterpret_cast<uint4*>(dg + (trow + row) * G4 + c * 8) =
            *reinterpret_cast<const uint4*>(dg_p + kmaj_off<R>(n, c * 8));
    }

    // dh_prev^T = Wr . dgates^T: this warpgroup's 64 units, in the layout
    // of its carries.
    float dhp[kAcc];
    for (int kc = 0; kc < G4 / kTcK; ++kc)
      consume(dhp, dg_s + kc * L::kSub, kc == 0);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(dhp[i]);

    // dx^T = Wi . dgates^T, a band of H input features at a time, rounded
    // once to bf16.
    if constexpr (kProj) {
      for (int band = 0; band < bands; ++band) {
        const int f0 = band * H + wg * 64;
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
                if (row < n_rows)
                  dx[(trow + row) * f_in + f0 + (unit0 % 64) + 8 * s] =
                      __float2bfloat16_rn(dxa[4 * j + 2 * s + e]);
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
          const size_t idx = static_cast<size_t>(row) * H + unit0 + 8 * s;
          if (t == 0 && row < n_rows) {
            dh0[idx] = __float2bfloat16_rn(dhp[i]);
            dc0[idx] = __float2bfloat16_rn(dc[i]);
          }
          const bool kept = (keep_prev >> (2 * j + e)) & 1u;
          dh[i] = kept ? dhp[i] : 0.0f;
          dc[i] = kept ? dc[i] : 0.0f;
        }
    __syncthreads();   // every tile of this step is consumed
  }

  // This block's db partial: the thread's rows and steps, then the four
  // lanes of a unit in a fixed order.
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float v = db[g][s];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (lt == 0)
        part_b[static_cast<size_t>(blockIdx.x) * G4 + g * H + unit0 + 8 * s] =
            v;
    }
}

// phases: bit 0 the recurrence, bit 1 the weight gradients (dW from the
// recurrence's dg and hin, db from its part_b).
template <int H, bool kProj>
int launch_bwd_tc(int phases, const void* x, const void* keep,
                  const void* wi, const void* wi_t, const void* wr,
                  const void* wr_t, const void* bias, const void* c0,
                  const void* h0, const void* ys, const void* cs,
                  const void* dys, void* dx, void* dg, void* hin, void* dh0,
                  void* dc0, void* part_w, void* part_b, void* dw, void* db,
                  int steps, int n_rows, int f_in, int splits,
                  cudaStream_t stream) {
  constexpr int R = kTcRows<kProj>;
  using L = TcBwd<H, R>;
  const int blocks = (n_rows + R - 1) / R;
  const int total_rows = steps * n_rows;
  if (phases & 1) {
    CUtensorMap wit_map, wrt_map, wr_map, wi_map;
    if (!make_tma_map(&wrt_map, wr_t, H, 4 * H, 1, kTcK, H) ||
        !make_tma_map(&wr_map, wr, 4 * H, H, 1, kTcK, H) ||
        !make_tma_map(&wit_map, kProj ? wi_t : wr_t, kProj ? f_in : H, 4 * H,
                      1, kTcK, H) ||
        !make_tma_map(&wi_map, kProj ? wi : wr, 4 * H, kProj ? f_in : H, 1,
                      kTcK, H))
      return static_cast<int>(cudaErrorInvalidValue);
    int err = set_smem(lstm_bwd_tc_kernel<H, R, kProj>, L::kSmem);
    if (err != 0) return err;
    lstm_bwd_tc_kernel<H, R, kProj><<<blocks, L::kThreads, L::kSmem,
                                      stream>>>(
        wit_map, wrt_map, wr_map, wi_map, static_cast<const bf16*>(x),
        static_cast<const bf16*>(keep), static_cast<const bf16*>(bias),
        static_cast<const bf16*>(c0), static_cast<const bf16*>(h0),
        static_cast<const bf16*>(ys), static_cast<const bf16*>(cs),
        static_cast<const bf16*>(dys), static_cast<bf16*>(dx),
        static_cast<bf16*>(dg), static_cast<bf16*>(hin),
        static_cast<bf16*>(dh0), static_cast<bf16*>(dc0),
        static_cast<float*>(part_b), steps, n_rows, f_in);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (phases & 2) {
    // dW = [x | h_in]^T . dg ([F + H, 4H], dWi over dWr) for the
    // projection, h_in^T . dg ([H, 4H]) without.
    const int err =
        kProj ? weight_grad_tc(x, f_in, hin, f_in + H, dg, 4 * H, total_rows,
                               splits, part_w, dw, stream)
              : weight_grad_tc(hin, H, nullptr, H, dg, 4 * H, total_rows,
                               splits, part_w, dw, stream);
    if (err != 0) return err;
    return sum_splits<bf16>(part_b, db, blocks, 4 * H, stream);
  }
  return 0;
}

bool proj_width_ok(int hidden, int f_in) {
  return f_in > 0 && f_in % 128 == 0 && f_in <= 4 * hidden;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns a cudaError_t,
// or -1 for arguments without an instantiation. The CUDA-core backwards are
// built for float32 alone: bfloat16 takes mlt_lstm_bwd_tc.
#define MLT_DISPATCH_F32(CALL)                                   \
  if (dtype == 0 && hidden == 128) return CALL(float, 128);      \
  if (dtype == 0 && hidden == 256) return CALL(float, 256);      \
  return -1
#define MLT_DISPATCH(CALL)                                       \
  if (dtype == 1 && hidden == 128) return CALL(__nv_bfloat16, 128); \
  if (dtype == 1 && hidden == 256) return CALL(__nv_bfloat16, 256); \
  MLT_DISPATCH_F32(CALL)

extern "C" int mlt_lstm_fwd(int dtype, int hidden, const void* xp,
                            const void* keep, const void* wr,
                            const void* bias, const void* c0, const void* h0,
                            void* ys, void* cs, int steps, int n_rows,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_FWD(T, H) \
  launch_fwd<T, H>(xp, keep, wr, bias, c0, h0, ys, cs, steps, n_rows, s)
  MLT_DISPATCH(MLT_FWD);
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
  MLT_DISPATCH_F32(MLT_BWD);
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
  MLT_DISPATCH(MLT_PROJ_FWD);
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
  MLT_DISPATCH_F32(MLT_PROJ_BWD);
#undef MLT_PROJ_BWD
}

// The bf16 tensor-core backward of both variants (f_in = 0: lstm_sequence_bwd,
// with x = x_proj and dg = dx_proj; else lstm_sequence_proj_bwd). Returns a
// cudaError_t, or -1 for arguments without an instantiation.
extern "C" int mlt_lstm_bwd_tc(
    int hidden, int f_in, int phases, const void* x,
    const void* keep, const void* wi, const void* wi_t, const void* wr,
    const void* wr_t, const void* bias, const void* c0, const void* h0,
    const void* ys, const void* cs, const void* dys, void* dx, void* dg,
    void* hin, void* dh0, void* dc0, void* part_w, void* part_b, void* dw,
    void* db, int steps, int n_rows, int splits, void* stream) {
  if (f_in != 0 && !proj_width_ok(hidden, f_in)) return -1;
  if (static_cast<long long>(steps) * n_rows > 0x7fffffffLL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_BWD_TC(H, P)                                                   \
  launch_bwd_tc<H, P>(phases, x, keep, wi, wi_t, wr, wr_t, bias, c0, h0, ys, \
                      cs, dys, dx, dg, hin, dh0, dc0, part_w, part_b, dw, db, \
                      steps, n_rows, f_in, splits, s)
#define MLT_BWD_TC_H(H) \
  if (hidden == H) return f_in == 0 ? MLT_BWD_TC(H, false) : MLT_BWD_TC(H, true)
  MLT_BWD_TC_H(128);
  MLT_BWD_TC_H(256);
#undef MLT_BWD_TC_H
#undef MLT_BWD_TC
  return -1;
}

#undef MLT_DISPATCH
#undef MLT_DISPATCH_F32
