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
// Design here (the LSTM kernels' layout, common.cuh):
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
// Bound on the H100: a chain of [BN, H] x [H, 3H] products (two in the
// backward) with a dependency between steps; on CUDA cores (f32 FMA) this
// first version is bound by FMA issue and shared/L1 load throughput, far
// below the tensor-core rate that bounds the work itself. Memory traffic is
// one read of x_proj and one write of ys per step, small next to the
// products.

#include "common.cuh"
#include "weight_grad.cuh"

namespace {

using namespace mlt;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ keep,
                   const T* __restrict__ wh, const T* __restrict__ bias_h,
                   const T* __restrict__ h0, T* __restrict__ ys, int steps,
                   int n_rows) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G3 = 3 * H;
  __shared__ float h_s[kRows * H];

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = blockIdx.x * kRows;

  float bn[UPT];
#pragma unroll
  for (int j = 0; j < UPT; ++j) bn[j] = to_f(bias_h[u0 + j]);

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
#pragma unroll
    for (int j = 0; j < UPT; ++j)
      h_s[(row_base + i) * H + u0 + j] =
          n < n_rows ? to_f(h0[static_cast<size_t>(n) * H + u0 + j]) : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    float acc[RPT][3][UPT];
    row_tile_product<T, 3, RPT, UPT>(h_s, H, wh, G3, H, row_base, u0, acc);
    __syncthreads();  // every thread has read h_s for this step

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = block_row + row_base + i;
      if (n >= n_rows) continue;
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
    T* __restrict__ dhp, T* __restrict__ dh0, int steps, int n_rows) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G3 = 3 * H;
  extern __shared__ float smem[];
  float* hin_s = smem;
  float* dg_s = smem + kRows * H;

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = blockIdx.x * kRows;

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
      if (n < n_rows && t > 0)
        keep_prev[i] =
            to_f(keep[static_cast<size_t>(t - 1) * n_rows + n]) > 0.5f;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        float h_v = 0.0f;
        if (n < n_rows) {
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
      if (n >= n_rows) {
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
        if (t == 0 && n < n_rows)
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

template <typename T, int H>
int launch_fwd(const void* xp, const void* keep, const void* wh,
               const void* bias_h, const void* h0, void* ys, int steps,
               int n_rows, cudaStream_t stream) {
  const int blocks = (n_rows + kRows - 1) / kRows;
  gru_fwd_kernel<T, H><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(keep),
      static_cast<const T*>(wh), static_cast<const T*>(bias_h),
      static_cast<const T*>(h0), static_cast<T*>(ys), steps, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// The recurrence, then dWh / db3 from the split-M pass: db3 gets the sums
// of all 3H columns of dhp, and dbh is its last H entries.
template <typename T, int H>
int launch_bwd(const void* xp, const void* keep, const void* wh,
               const void* wh_t, const void* bias_h, const void* h0,
               const void* ys, const void* dys, void* dxp, void* dhp,
               void* dh0, void* part_w, void* part_b, void* dwh, void* db3,
               int steps, int n_rows, int splits, cudaStream_t stream) {
  const int smem = kRows * 4 * H * static_cast<int>(sizeof(float));
  int err = set_smem(gru_bwd_kernel<T, H>, smem);
  if (err != 0) return err;
  const int blocks = (n_rows + kRows - 1) / kRows;
  gru_bwd_kernel<T, H><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(keep),
      static_cast<const T*>(wh), static_cast<const T*>(wh_t),
      static_cast<const T*>(bias_h), static_cast<const T*>(h0),
      static_cast<const T*>(ys), static_cast<const T*>(dys),
      static_cast<T*>(dxp), static_cast<T*>(dhp), static_cast<T*>(dh0),
      steps, n_rows);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  const long long total = static_cast<long long>(steps) * n_rows;
  const int rows_per_split = static_cast<int>((total + splits - 1) / splits);
  const dim3 grid(3 * H / kTileJ, H / kTileI, splits);
  weight_grad_partial_kernel<T, true><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dhp), static_cast<const T*>(ys),
      static_cast<const T*>(keep), static_cast<const T*>(h0),
      static_cast<float*>(part_w), static_cast<float*>(part_b), steps,
      n_rows, H, 3 * H, rows_per_split);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = sum_splits<T>(part_w, dwh, splits, H * 3 * H, stream);
  if (err != 0) return err;
  return sum_splits<T>(part_b, db3, splits, 3 * H, stream);
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

extern "C" int mlt_gru_fwd(int dtype, int hidden, const void* xp,
                           const void* keep, const void* wh,
                           const void* bias_h, const void* h0, void* ys,
                           int steps, int n_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_FWD(T, H) \
  launch_fwd<T, H>(xp, keep, wh, bias_h, h0, ys, steps, n_rows, s)
  MLT_DISPATCH(MLT_FWD);
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
  MLT_DISPATCH(MLT_BWD);
#undef MLT_BWD
}

#undef MLT_DISPATCH
