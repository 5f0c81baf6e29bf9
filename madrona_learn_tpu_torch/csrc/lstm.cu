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
// Design here (layout and product in common.cuh):
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
//   kernel computes per-split f32 partials over contiguous slices of the
//   T*N rows (h_in recomputed on the fly from ys, keep and h0), and a third
//   sums the splits in a fixed order, so the result is deterministic run
//   to run.
// - Projection variant: the block stages its [kRows, F] slice of x_t in
//   shared memory and computes xp = round(x_t . Wi) (the rounding point of
//   the hoisted Dense), then adds h . Wr into the same accumulators. The
//   backward recomputes xp the same way, writes the rounded dgates to a
//   scratch [T, N, 4H] for the weight-gradient pass, and emits
//   dx = round(dgates . Wi^T) in 128-column chunks against a transposed
//   copy of Wi.
//
// Bound on the H100: the recurrence is a chain of [BN, H] x [H, 4H]
// products (and [BN, F] x [F, 4H] for the projection) with a dependency
// between steps. This first version uses CUDA cores (f32 FMA), so it is
// bound by FMA issue and shared/L1 load throughput, far below the
// tensor-core rate that bounds the work itself; wgmma with the weights
// staged by TMA is the later step. Memory traffic is one read of x or
// x_proj and one write of ys/cs per step, small next to the products.

#include "common.cuh"

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

// Weight-gradient partials over one contiguous split of the M = T*N rows:
//   part_w[s][i][j] = sum_m a[m][i] * dg[m][j]
//   part_b[s][j]    = sum_m dg[m][j]          (when part_b is given)
// With kHin, a is h_in, rebuilt from ys / keep / h0 exactly as the
// recurrence saw it (a_width = H); else a is a row-major [M, a_width]
// matrix (x of the projection). Tile: 64 (i) x 64 (j) per block, 4 x 4 per
// thread, rows staged through shared memory kTileM at a time.
constexpr int kTileI = 64;
constexpr int kTileJ = 64;
constexpr int kTileM = 32;

template <typename T, bool kHin>
__global__ void __launch_bounds__(kThreads) weight_grad_partial_kernel(
    const T* __restrict__ dg, const T* __restrict__ a,
    const T* __restrict__ keep, const T* __restrict__ h0,
    float* __restrict__ part_w, float* __restrict__ part_b, int steps,
    int n_rows, int a_width, int g4, int rows_per_split) {
  __shared__ __align__(16) float a_s[kTileM][kTileI];
  __shared__ __align__(16) float b_s[kTileM][kTileJ];
  const int j0 = blockIdx.x * kTileJ;
  const int i0 = blockIdx.y * kTileI;
  const int split = blockIdx.z;
  const long long total = static_cast<long long>(steps) * n_rows;
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
        if (kHin) {
          const int t = static_cast<int>(m / n_rows);
          const int n = static_cast<int>(m % n_rows);
          if (t == 0) {
            av = to_f(h0[static_cast<size_t>(n) * a_width + i0 + col]);
          } else {
            const size_t prev = static_cast<size_t>(t - 1) * n_rows + n;
            if (to_f(keep[prev]) > 0.5f)
              av = to_f(a[prev * a_width + i0 + col]);
          }
        } else {
          av = to_f(a[static_cast<size_t>(m) * a_width + i0 + col]);
        }
        gv = to_f(dg[static_cast<size_t>(m) * g4 + j0 + col]);
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

  float* out = part_w + static_cast<size_t>(split) * a_width * g4;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[static_cast<size_t>(i0 + ti * 4 + p) * g4 + j0 + tj * 4 + q] =
          acc[p][q];
  if (part_b != nullptr && blockIdx.y == 0 && ti == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      part_b[static_cast<size_t>(split) * g4 + j0 + tj * 4 + q] = acc_b[q];
  }
}

// out[e] = sum over splits of part[s][e], in split order (deterministic).
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  T* __restrict__ out, int splits,
                                  int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += part[static_cast<size_t>(k) * count + e];
  out[e] = from_f<T>(s);
}

template <typename T>
int sum_splits(const void* part, void* out, int splits, int count,
               cudaStream_t stream) {
  sum_splits_kernel<T><<<(count + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(static_cast<const float*>(part),
                                   static_cast<T*>(out), splits, count);
  return static_cast<int>(cudaGetLastError());
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

template <typename K>
int set_smem(K* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
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

bool proj_width_ok(int hidden, int f_in) {
  return f_in > 0 && f_in % 128 == 0 && f_in <= 4 * hidden;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns a cudaError_t,
// or -1 for arguments without an instantiation.
#define MLT_DISPATCH(CALL)                                       \
  if (dtype == 0 && hidden == 128) return CALL(float, 128);      \
  if (dtype == 0 && hidden == 256) return CALL(float, 256);      \
  if (dtype == 1 && hidden == 128) return CALL(__nv_bfloat16, 128); \
  if (dtype == 1 && hidden == 256) return CALL(__nv_bfloat16, 256); \
  return -1

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
  MLT_DISPATCH(MLT_BWD);
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
  MLT_DISPATCH(MLT_PROJ_BWD);
#undef MLT_PROJ_BWD
}

#undef MLT_DISPATCH
