// mha_flash: flash attention over large entity sets, [B, S, H, D] in place.
// Forward (output and per-row logsumexp) and the FlashAttention-2 backward
// as two kernels, dK/dV over query rows and dQ over key rows.
//
// Replaces madrona_learn_tpu/ops/pallas/attention.py:mha_flash:
// - flash_fwd_kernel: _mha_flash_kernel through _mha_flash_impl;
// - flash_bwd_dkdv_kernel: _mha_flash_bwd_dkdv_kernel;
// - flash_bwd_dq_kernel: _mha_flash_bwd_dq_kernel.
// The TPU kernels transpose q, k, v to [B*H, S, D], pad B*H to an 8-row
// block and S to 128, and carry the online-softmax state (and the dK / dV /
// dQ accumulators) in VMEM across a sequential grid axis. Those are TPU
// layout and TPU scheduling: here a block owns rows of one (b, h) problem
// and loops over the other operand itself, reading [B, S, H, D] where it
// lies. Padded rows do not exist; keys at valid_len and above are never
// read (the plain versions give them a -1e30 score, whose exponential is
// exactly 0 in f32).
//
// Contract (the plain versions are ops/cuda/mha_flash.py:
// mha_flash_reference, mha_flash_bwd_reference):
// - forward: s = (q . k) * D^-0.5 in f32 over keys j < valid_len, an online
//   softmax over tiles of keys, P . V in f32; out in the storage type, lse =
//   m + log(l) in f32 as [B, H, S]. Query rows at and past valid_len are
//   computed like any other row (the caller slices them off).
// - backward: p = exp(s - lse) rebuilt from the forward's lse; dV = sum_i
//   p dO_i, dS = p (dO . v - delta_i) * D^-0.5, dK = sum_i dS q_i, dQ =
//   sum_j dS k_j, all in f32 over every query row, written once in the
//   storage type; dK and dV of keys at and past valid_len are 0. delta_i =
//   rowsum(dO_i * out_i) is computed by the wrapper with one torch op, as
//   JAX computes it outside Pallas (_mha_flash_bwd_rule).
//
// Design:
// - One thread owns one row (a query row in the forward and in dQ, a key row
//   in dK/dV) and keeps it, its other operand row and its f32 accumulators
//   in registers. The block streams tiles of kTile rows of the operand it
//   loops over through shared memory as f32, 16-byte coalesced loads; all
//   threads read the same row of a tile at once (a broadcast).
// - Each block writes only its own rows, so the two backward kernels need no
//   atomics, the gradients are deterministic, and no [B, H, S, S] tensor
//   exists anywhere.
// - Each (b, h) problem goes through the same instruction sequence whatever
//   B is (the block count grows with B, nothing else does), so the rollout
//   step and the update pass agree bit for bit on equal inputs, which PPO's
//   importance ratio needs.
//
// Bound on the H100: operations. At the update shape [4096, 512, 4, 32] bf16
// with valid_len 511 the forward's two products are 1.1 TFLOP (1.1 ms on
// bf16 tensor cores) against 2.1 GB of q, k, v and out (0.64 ms at 3.35
// TB/s); the backward's five products 2.7 TFLOP. This first version runs
// them as f32 FMAs on CUDA cores (67 TFLOP/s at most), one shared-memory
// broadcast per four FMAs, so it is bound by CUDA-core issue, tens of times
// its bound; mma.sync / wgmma tiles are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRows = 128;   // rows a block owns, one per thread (at most)
constexpr int kTile = 64;    // rows of the streamed operand per tile
constexpr int kChunk = 16;   // keys per online-softmax step of the forward

using mlt::dot_row;
using mlt::load16;
using mlt::store16;

// acc[d] += a * row[d], row in shared memory (16-byte aligned).
template <int D>
__device__ __forceinline__ void axpy_row(float a, const float* row,
                                         float (&acc)[D]) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 r = *reinterpret_cast<const float4*>(row + d);
    acc[d] = fmaf(a, r.x, acc[d]);
    acc[d + 1] = fmaf(a, r.y, acc[d + 1]);
    acc[d + 2] = fmaf(a, r.z, acc[d + 2]);
    acc[d + 3] = fmaf(a, r.w, acc[d + 3]);
  }
}

// One row of D storage-type elements from global memory, as f32.
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* p, float (&out)[D]) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < D; c += kVec) load16(p + c, out + c);
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* p, const float (&in)[D]) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < D; c += kVec) store16(p + c, in + c);
}

// Rows [r0, r0 + n) of one (b, h) problem (row r at base + r * stride) of
// one or two tensors into [kTile][D] f32 tiles of shared memory.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           float* as, float* bs, size_t base,
                                           size_t stride, int r0, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  for (int e = threadIdx.x; e < n * kVecPerRow; e += blockDim.x) {
    const int r = e / kVecPerRow;
    const int c = (e % kVecPerRow) * kVec;
    const size_t g = base + static_cast<size_t>(r0 + r) * stride + c;
    float tmp[kVec];
    load16(a + g, tmp);
#pragma unroll
    for (int i = 0; i < kVec; i += 4) store16(as + r * D + c + i, tmp + i);
    load16(b + g, tmp);
#pragma unroll
    for (int i = 0; i < kVec; i += 4) store16(bs + r * D + c + i, tmp + i);
  }
}

// Grid: x over the B * H problems (b major), y over tiles of blockDim.x
// query rows.
template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, int heads, int valid_len,
                 float scale) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int p = blockIdx.x;
  const size_t stride = static_cast<size_t>(heads) * D;
  const size_t base =
      static_cast<size_t>(p / heads) * seq * stride + (p % heads) * D;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = i < seq;

  float qr[D], acc[D];
  if (active) load_row<T, D>(q + base + i * stride, qr);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  float m = -INFINITY;
  float l = 0.0f;

  for (int t0 = 0; t0 < valid_len; t0 += kTile) {
    const int n = min(kTile, valid_len - t0);
    __syncthreads();   // the previous tile is consumed
    stage_tile<T, D>(k, v, ks, vs, base, stride, t0, n);
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float s[kChunk];
      float cm = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = -INFINITY;
        if (j0 + jj < n) {
          s[jj] = dot_row<D>(qr, ks + (j0 + jj) * D) * scale;
          cm = fmaxf(cm, s[jj]);
        }
      }
      const float m_new = fmaxf(m, cm);
      const float alpha = expf(m - m_new);   // 0 on the first chunk
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        if (j0 + jj < n) {
          const float pj = expf(s[jj] - m_new);
          l += pj;
          axpy_row<D>(pj, vs + (j0 + jj) * D, acc);
        }
      }
      m = m_new;
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] /= l;
  store_row<T, D>(o + base + i * stride, acc);
  lse[static_cast<size_t>(p) * seq + i] = m + logf(l);
}

// Grid: x over the problems, y over tiles of blockDim.x key rows. delta is
// [B, S, H] f32, lse [B, H, S] f32.
template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int seq, int heads, int valid_len,
                      float scale) {
  __shared__ __align__(16) float qs[kTile * D];
  __shared__ __align__(16) float dos[kTile * D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  const int p = blockIdx.x;
  const int b = p / heads, h = p % heads;
  const size_t stride = static_cast<size_t>(heads) * D;
  const size_t base = static_cast<size_t>(b) * seq * stride + h * D;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = j < valid_len;

  float kr[D], vr[D], dkr[D], dvr[D];
  if (active) {
    load_row<T, D>(k + base + j * stride, kr);
    load_row<T, D>(v + base + j * stride, vr);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dkr[d] = 0.0f;
    dvr[d] = 0.0f;
  }

  // A block whose keys are all masked writes zeros only.
  const bool any_key = blockIdx.y * blockDim.x < valid_len;
  for (int i0 = 0; any_key && i0 < seq; i0 += kTile) {
    const int n = min(kTile, seq - i0);
    __syncthreads();
    stage_tile<T, D>(q, dout, qs, dos, base, stride, i0, n);
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      lse_s[r] = lse[static_cast<size_t>(p) * seq + i0 + r];
      delta_s[r] = delta[(static_cast<size_t>(b) * seq + i0 + r) * heads + h];
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < n; ++r) {
      const float* qrow = qs + r * D;
      const float* dorow = dos + r * D;
      const float pr = expf(dot_row<D>(kr, qrow) * scale - lse_s[r]);
      const float dp = dot_row<D>(vr, dorow);
      const float ds = pr * (dp - delta_s[r]) * scale;
      axpy_row<D>(pr, dorow, dvr);
      axpy_row<D>(ds, qrow, dkr);
    }
  }
  if (j >= seq) return;
  store_row<T, D>(dk + base + j * stride, dkr);
  store_row<T, D>(dv + base + j * stride, dvr);
}

// Grid: x over the problems, y over tiles of blockDim.x query rows.
template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int seq, int heads, int valid_len, float scale) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int p = blockIdx.x;
  const int b = p / heads, h = p % heads;
  const size_t stride = static_cast<size_t>(heads) * D;
  const size_t base = static_cast<size_t>(b) * seq * stride + h * D;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = i < seq;

  float qr[D], dor[D], dqr[D];
  float lse_i = 0.0f, delta_i = 0.0f;
  if (active) {
    load_row<T, D>(q + base + i * stride, qr);
    load_row<T, D>(dout + base + i * stride, dor);
    lse_i = lse[static_cast<size_t>(p) * seq + i];
    delta_i = delta[(static_cast<size_t>(b) * seq + i) * heads + h];
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dqr[d] = 0.0f;

  for (int t0 = 0; t0 < valid_len; t0 += kTile) {
    const int n = min(kTile, valid_len - t0);
    __syncthreads();
    stage_tile<T, D>(k, v, ks, vs, base, stride, t0, n);
    __syncthreads();
    if (!active) continue;
    for (int jj = 0; jj < n; ++jj) {
      const float* krow = ks + jj * D;
      const float pr = expf(dot_row<D>(qr, krow) * scale - lse_i);
      const float dp = dot_row<D>(dor, vs + jj * D);
      axpy_row<D>(pr * (dp - delta_i) * scale, krow, dqr);
    }
  }
  if (active) store_row<T, D>(dq + base + i * stride, dqr);
}

dim3 grid_for(int batch, int heads, int rows, int threads) {
  return dim3(static_cast<unsigned>(batch) * heads,
              static_cast<unsigned>((rows + threads - 1) / threads));
}

// Threads per block: a warp multiple, at most kRows, no more than the rows.
int threads_for(int rows) {
  const int t = (rows + 31) / 32 * 32;
  return t < kRows ? t : kRows;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, int seq, int heads, int valid_len,
               float scale, cudaStream_t stream) {
  const int threads = threads_for(seq);
  flash_fwd_kernel<T, D><<<grid_for(batch, heads, seq, threads), threads, 0,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seq, heads,
      valid_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                int batch, int seq, int heads, int valid_len, float scale,
                cudaStream_t stream) {
  const int threads = threads_for(seq);
  flash_bwd_dkdv_kernel<T, D><<<grid_for(batch, heads, seq, threads), threads,
                                0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), seq, heads, valid_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int batch,
              int seq, int heads, int valid_len, float scale,
              cudaStream_t stream) {
  const int threads = threads_for(seq);
  flash_bwd_dq_kernel<T, D><<<grid_for(batch, heads, seq, threads), threads,
                              0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), seq, heads, valid_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MLT_FLASH_DISPATCH(CALL)                                             \
  if (dtype == 0 && head_dim == 16) return CALL(float, 16);                  \
  if (dtype == 0 && head_dim == 32) return CALL(float, 32);                  \
  if (dtype == 0 && head_dim == 64) return CALL(float, 64);                  \
  if (dtype == 1 && head_dim == 16) return CALL(__nv_bfloat16, 16);          \
  if (dtype == 1 && head_dim == 32) return CALL(__nv_bfloat16, 32);          \
  if (dtype == 1 && head_dim == 64) return CALL(__nv_bfloat16, 64);          \
  return -1

extern "C" int mlt_mha_flash_fwd(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v, void* o,
                                 void* lse, int batch, int seq, int heads,
                                 int valid_len, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_CALL(T, D)                                                      \
  launch_fwd<T, D>(q, k, v, o, static_cast<float*>(lse), batch, seq, heads, \
                   valid_len, scale, s)
  MLT_FLASH_DISPATCH(MLT_CALL);
#undef MLT_CALL
}

extern "C" int mlt_mha_flash_bwd_dkdv(int dtype, int head_dim, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dk, void* dv,
                                      int batch, int seq, int heads,
                                      int valid_len, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_CALL(T, D)                                                      \
  launch_dkdv<T, D>(q, k, v, dout, static_cast<const float*>(lse),          \
                    static_cast<const float*>(delta), dk, dv, batch, seq,   \
                    heads, valid_len, scale, s)
  MLT_FLASH_DISPATCH(MLT_CALL);
#undef MLT_CALL
}

extern "C" int mlt_mha_flash_bwd_dq(int dtype, int head_dim, const void* q,
                                    const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dq, int batch,
                                    int seq, int heads, int valid_len,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_CALL(T, D)                                                      \
  launch_dq<T, D>(q, k, v, dout, static_cast<const float*>(lse),            \
                  static_cast<const float*>(delta), dq, batch, seq, heads,  \
                  valid_len, scale, s)
  MLT_FLASH_DISPATCH(MLT_CALL);
#undef MLT_CALL
}
#undef MLT_FLASH_DISPATCH
