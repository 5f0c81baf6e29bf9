// K2 / K3: the fused LSTM sequence pass, forward and backward.
//
// Replaces madrona_learn_tpu/ops/pallas/lstm.py:lstm_sequence: the forward
// _fwd_kernel (K2) and the custom backward _bwd_kernel with its fused
// dWr/db epilogue (K3).
//
// What the TPU layout did, and why it cannot carry over: each TPU grid
// program keeps all of Wr [H, 4H] resident in VMEM next to its batch tile
// and carries (c, h) in VMEM scratch along a sequential time grid axis. At
// H = 256 in bf16 Wr is 512 KiB, more than the 227 KB of shared memory a
// Hopper block can hold, and Hopper blocks run in parallel in no order, so
// neither the resident weight nor a sum carried across grid steps exists.
//
// Design here:
// - One block owns BN batch rows and all H units of those rows, and loops
//   over time inside the kernel (the TPU's sequential grid axis becomes the
//   in-block loop). Thread (row group, unit group) owns RPT rows x UPT
//   consecutive units and computes all four gates of those (row, unit)
//   pairs, so the gate math needs no exchange between threads: the c carry
//   stays in registers, only h (which every unit's product reads) goes
//   through shared memory.
// - Wr is read from global memory every step. 512 KiB stays resident in
//   the 50 MB L2, and a block reuses each Wr element for BN rows.
// - The recurrent product h.Wr is a plain f32 FMA loop in the kernel body,
//   operands in the storage type converted exactly to f32, so it is the
//   TPU kernel's "f32 accumulate from storage-dtype operands" contract.
// - Gate math in f32; ys and cs are rounded to the storage type; the carry
//   is cleared after step t where keep[t] == 0, after the outputs are
//   written (step-then-reset, ops/pallas/lstm.py:113-120).
// - Backward: the same row ownership in reverse time. h_in / c_in come from
//   ys / cs at t-1 after the keep mask (h0 / c0 at t = 0), the gates are
//   recomputed, dgates (= dx_proj) are written in the storage type, and
//   dh_prev = dgates . Wr^T runs in the kernel against a transposed copy of
//   Wr so its loads coalesce the same way. dh / dc carry in f32 registers.
// - dWr = sum h_in^T . dgates and db = sum dgates cannot accumulate in one
//   output block across parallel blocks. A second kernel computes per-split
//   f32 partials over contiguous slices of the T*N rows (h_in recomputed on
//   the fly from ys, keep and h0), and a third sums the splits in a fixed
//   order, so the result is deterministic run to run.
//
// Bound on the H100: the recurrence is a chain of [BN, H] x [H, 4H]
// products with a dependency between steps. This first version uses CUDA
// cores (f32 FMA), so it is bound by FMA issue and shared/L1 load
// throughput, far below the tensor-core rate; wgmma with Wr staged by TMA
// is the later step. Memory traffic is one read of x_proj and one write of
// ys/cs per step, which is small next to the product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitGroups = 64;                      // threads along units
constexpr int kRowGroups = kThreads / kUnitGroups;   // threads along rows
constexpr int kRows = 16;                            // BN: rows per block

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

// acc[i][g][j] += sum_k a_s[row_i][k] * w[k][g * H + u0 + j]
// a_s: [BN][K] f32 in shared memory; w: [K][G * H] in global memory.
template <typename T, int H, int G, int RPT, int UPT>
__device__ __forceinline__ void row_tile_product(
    const float* a_s, int K, const T* __restrict__ w, int row_base, int u0,
    float (&acc)[RPT][G][UPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < UPT; ++j) acc[i][g][j] = 0.0f;

  for (int k = 0; k < K; ++k) {
    float a[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = a_s[(row_base + i) * K + k];
    const T* wrow = w + static_cast<size_t>(k) * (G * H) + u0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float wv[UPT];
      load_units<UPT>(wrow + g * H, wv);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < UPT; ++j)
          acc[i][g][j] = fmaf(a[i], wv[j], acc[i][g][j]);
    }
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ keep,
                    const T* __restrict__ wr, const T* __restrict__ bias,
                    const T* __restrict__ c0, const T* __restrict__ h0,
                    T* __restrict__ ys, T* __restrict__ cs, int steps,
                    int n_rows) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRows / kRowGroups;
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
    row_tile_product<T, H, 4, RPT, UPT>(h_s, H, wr, row_base, u0, acc);
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

template <typename T, int H>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(
    const T* __restrict__ xp, const T* __restrict__ keep,
    const T* __restrict__ wr, const T* __restrict__ wr_t,
    const T* __restrict__ bias, const T* __restrict__ c0,
    const T* __restrict__ h0, const T* __restrict__ ys,
    const T* __restrict__ cs, const T* __restrict__ dys, T* __restrict__ dxp,
    T* __restrict__ dh0, T* __restrict__ dc0, int steps, int n_rows) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRows / kRowGroups;
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
    row_tile_product<T, H, 4, RPT, UPT>(hin_s, H, wr, row_base, u0, acc);

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
    row_tile_product<T, H, 1, RPT, UPT>(dg_s, G4, wr_t, row_base, u0,
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

// Weight-gradient partials over one contiguous split of the M = T*N rows:
//   part_w[s][i][j] = sum_m h_in[m][i] * dg[m][j]
//   part_b[s][j]    = sum_m dg[m][j]
// h_in is rebuilt from ys / keep / h0 exactly as the recurrence saw it.
// Tile: 64 (i) x 64 (j) per block, 4 x 4 per thread, rows staged through
// shared memory kTileM at a time.
constexpr int kTileI = 64;
constexpr int kTileJ = 64;
constexpr int kTileM = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_dwr_partial_kernel(
    const T* __restrict__ dg, const T* __restrict__ ys,
    const T* __restrict__ keep, const T* __restrict__ h0,
    float* __restrict__ part_w, float* __restrict__ part_b, int steps,
    int n_rows, int hidden, int rows_per_split) {
  __shared__ __align__(16) float a_s[kTileM][kTileI];
  __shared__ __align__(16) float b_s[kTileM][kTileJ];
  const int g4 = 4 * hidden;
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
  for (int a = 0; a < 4; ++a) {
    acc_b[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
  }

  for (long long m0 = m_begin; m0 < m_end; m0 += kTileM) {
    for (int e = threadIdx.x; e < kTileM * kTileI; e += kThreads) {
      const int mm = e / kTileI;
      const int col = e % kTileI;
      const long long m = m0 + mm;
      float hv = 0.0f, gv = 0.0f;
      if (m < m_end) {
        const int t = static_cast<int>(m / n_rows);
        const int n = static_cast<int>(m % n_rows);
        if (t == 0) {
          hv = to_f(h0[static_cast<size_t>(n) * hidden + i0 + col]);
        } else {
          const size_t prev = static_cast<size_t>(t - 1) * n_rows + n;
          if (to_f(keep[prev]) > 0.5f)
            hv = to_f(ys[prev * hidden + i0 + col]);
        }
        gv = to_f(dg[static_cast<size_t>(m) * g4 + j0 + col]);
      }
      a_s[mm][col] = hv;
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
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(a4[a], b4[c], acc[a][c]);
      if (ti == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_b[c] += b4[c];
      }
    }
    __syncthreads();
  }

  float* out = part_w + static_cast<size_t>(split) * hidden * g4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[static_cast<size_t>(i0 + ti * 4 + a) * g4 + j0 + tj * 4 + c] =
          acc[a][c];
  if (blockIdx.y == 0 && ti == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part_b[static_cast<size_t>(split) * g4 + j0 + tj * 4 + c] = acc_b[c];
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
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_rows + kRows - 1) / kRows;
  lstm_bwd_kernel<T, H><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(keep),
      static_cast<const T*>(wr), static_cast<const T*>(wr_t),
      static_cast<const T*>(bias), static_cast<const T*>(c0),
      static_cast<const T*>(h0), static_cast<const T*>(ys),
      static_cast<const T*>(cs), static_cast<const T*>(dys),
      static_cast<T*>(dxp), static_cast<T*>(dh0), static_cast<T*>(dc0),
      steps, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long total = static_cast<long long>(steps) * n_rows;
  const int rows_per_split = static_cast<int>((total + splits - 1) / splits);
  const dim3 grid(4 * H / kTileJ, H / kTileI, splits);
  lstm_dwr_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dxp), static_cast<const T*>(ys),
      static_cast<const T*>(keep), static_cast<const T*>(h0),
      static_cast<float*>(part_w), static_cast<float*>(part_b), steps,
      n_rows, H, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int count_w = H * 4 * H;
  sum_splits_kernel<T><<<(count_w + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(static_cast<const float*>(part_w),
                                   static_cast<T*>(dwr), splits, count_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_splits_kernel<T><<<(4 * H + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(static_cast<const float*>(part_b),
                                   static_cast<T*>(db), splits, 4 * H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t, or -1 for a
// (dtype, hidden) pair without an instantiation.
extern "C" int mlt_lstm_fwd(int dtype, int hidden, const void* xp,
                            const void* keep, const void* wr,
                            const void* bias, const void* c0, const void* h0,
                            void* ys, void* cs, int steps, int n_rows,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hidden == 128)
    return launch_fwd<float, 128>(xp, keep, wr, bias, c0, h0, ys, cs, steps,
                                  n_rows, s);
  if (dtype == 0 && hidden == 256)
    return launch_fwd<float, 256>(xp, keep, wr, bias, c0, h0, ys, cs, steps,
                                  n_rows, s);
  if (dtype == 1 && hidden == 128)
    return launch_fwd<__nv_bfloat16, 128>(xp, keep, wr, bias, c0, h0, ys, cs,
                                          steps, n_rows, s);
  if (dtype == 1 && hidden == 256)
    return launch_fwd<__nv_bfloat16, 256>(xp, keep, wr, bias, c0, h0, ys, cs,
                                          steps, n_rows, s);
  return -1;
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
#define MLT_BWD(T, H)                                                       \
  return launch_bwd<T, H>(xp, keep, wr, wr_t, bias, c0, h0, ys, cs, dys,    \
                          dxp, dh0, dc0, part_w, part_b, dwr, db, steps,    \
                          n_rows, splits, s)
  if (dtype == 0 && hidden == 128) MLT_BWD(float, 128);
  if (dtype == 0 && hidden == 256) MLT_BWD(float, 256);
  if (dtype == 1 && hidden == 128) MLT_BWD(__nv_bfloat16, 128);
  if (dtype == 1 && hidden == 256) MLT_BWD(__nv_bfloat16, 256);
#undef MLT_BWD
  return -1;
}
