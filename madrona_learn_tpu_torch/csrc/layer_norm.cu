// layer_norm_fwd / layer_norm_bwd: row LayerNorm over [N, D], forward and
// backward.
//
// Replaces madrona_learn_tpu/ops/pallas/layer_norm.py:layer_norm: the
// forward _fwd_kernel (layer_norm_fwd) and the backward _bwd_kernel with its
// dw/db accumulation (layer_norm_bwd).
//
// Math, all in f32 from storage-type x and f32 weight / bias:
//   mu = mean(x); var = mean((x - mu)^2) (two passes); rsigma =
//   rsqrt(var + eps); y = round((x - mu) * rsigma * w + b)
// and, with xhat = (x - mu) * rsigma and wdy = w * dy,
//   dx = round((wdy - mean(wdy) - xhat * mean(wdy * xhat)) * rsigma),
//   dw = sum over rows of dy * xhat, db = sum over rows of dy.
//
// What the TPU layout did, and why it cannot carry over: the TPU kernel
// takes 256-row blocks in one sequential grid and accumulates dw/db of every
// block into one output block. Hopper blocks run in parallel in no order, so
// that accumulator does not exist.
//
// Design here. The forward: one warp per row, each lane holding D / 32 of
// the row's values in registers, so a row is read from device memory once
// and its sums are warp shuffles; it saves mu and rsigma [N] in f32. The
// backward (below, at its kernels): one warp per row with each lane's
// columns as whole 16-byte pieces and the next row's loads in flight, dw/db
// as f32 partials over fixed 128-row blocks, then one reduction launch over
// column tiles of both outputs, each in a fixed order: dw and db are the
// same run to run and on any card, without atomics.
//
// Bound on the H100: device-memory bytes. The forward reads x and writes y
// (plus 8 bytes a row of statistics); the backward reads x and dy and writes
// dx, a few f32 operations per element either way.
//
// The chunk-indexed instances (layer_norm_fwd_chunked, layer_norm_bwd_chunked)
// are the LayerNorm of a population's policy-batched passes: JAX vmaps the
// kernel-backed LayerNorm, and with it these pallas_calls, over policy chunks
// in collect (madrona_learn_tpu/rollouts.py:580) and over the train policies
// in learn (madrona_learn_tpu/train.py:315). The rows are [num_chunks][chunk],
// each chunk of one policy, and the f32 scale and bias are [P, D] stacks.
// They are the kernels above with the policy read per row: the forward's
// warp reads its row's chunk's policy and that policy's scale and bias at an
// offset into the stacks, so every row is bitwise one layer_norm_fwd call's
// with its policy's weights; a chunk whose policy lies outside [0, P) writes
// NaN (y, mu, rsigma; dx in the backward). The backward's block owns up to
// kPartRows rows of one chunk (ceil(chunk / kPartRows) blocks a chunk, so no
// partial straddles two policies), its dx rows a row's own, and
// sum_by_policy (weight_grad.cuh) adds each policy's chunks' partials in
// chunk order into dscale / dbias [P, D]: fixed partials in a fixed order,
// so they do not depend on the card's SM count and are the same run to run.

#include "common.cuh"
#include "weight_grad.cuh"

namespace {

using namespace mlt;

constexpr int kWarps = kThreads / 32;  // rows in flight per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// kPerLane: values of a row per lane, D <= 32 * kPerLane. Column of value k
// of a lane: lane + 32 * k.
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads) layer_norm_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mu,
    float* __restrict__ rsigma, int n_rows, int d, float eps,
    const int* __restrict__ chunk_policy, int chunk, int num_policies) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n_rows) return;  // whole warps
  const T* xr = x + static_cast<size_t>(row) * d;
  if (chunk_policy != nullptr) {
    // The chunk-indexed instance: the row's policy's scale and bias.
    const int p = chunk_policy[row / chunk];
    if (p < 0 || p >= num_policies) {
      const float nan = __int_as_float(0x7fc00000);
      for (int c = lane; c < d; c += 32)
        y[static_cast<size_t>(row) * d + c] = from_f<T>(nan);
      if (lane == 0) mu[row] = rsigma[row] = nan;
      return;
    }
    w += static_cast<size_t>(p) * d;
    b += static_cast<size_t>(p) * d;
  }

  float v[kPerLane];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < d ? to_f(xr[c]) : 0.0f;
    sum += v[k];
  }
  const float mean = warp_sum(sum) / static_cast<float>(d);
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < d ? v[k] - mean : 0.0f;
    sq += v[k] * v[k];
  }
  const float var = warp_sum(sq) / static_cast<float>(d);
  const float rs = rsqrtf(var + eps);

  T* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < d) yr[c] = from_f<T>(v[k] * rs * w[c] + b[c]);
  }
  if (lane == 0) {
    mu[row] = mean;
    rsigma[row] = rs;
  }
}

// ------------------------------------------------------------ backward

// The backward is bound by bytes (x and dy read, dx written), so a warp
// takes a row as whole 16-byte pieces: lane l holds piece j of a row,
// columns (32 j + l) V .. (32 j + l) V + V - 1, V = 16 / sizeof(T) (one
// piece a lane for a bf16 row of 256). Widths that are not a multiple of V,
// or rows off a 16-byte boundary, take the same layout element by element.
// Each warp loads its next row's pieces, mu and rsigma before it computes
// the current one, so a row's loads are always in flight.
//
// dw / db: a block owns one partial of kPartRows consecutive rows, a
// compile-time constant, so the partials, and dw / db, depend on the
// inputs alone and not on the card. Warp w of the block takes rows w,
// w + kBwdWarps, ... of its partial in order, each lane summing its
// columns; the block adds its warps in order into one f32 partial row.
// layer_norm_wgrad_kernel then adds the partials of both outputs in one
// launch over column tiles: thread (g, lane) sums partials g, g + kRedGroups,
// ... in order, then a fixed tree through shared memory adds the groups.
constexpr int kBwdWarps = 8;     // warps a block of the main pass
constexpr int kPartRows = 128;   // rows a dw / db partial (one block)
constexpr int kRedCols = 32;     // columns a block of the reduction
constexpr int kRedGroups = 32;   // partial strides a block of the reduction

// 16 bytes of storage type T as V = 16 / sizeof(T) f32 values, and back.
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// The piece of row p starting at column c (c % V == 0), zeros past d.
template <typename T>
__device__ __forceinline__ uint4 load_piece(const T* __restrict__ p, int c,
                                            int d, bool vec) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (vec) {
    if (c < d) raw = *reinterpret_cast<const uint4*>(p + c);
  } else {
    alignas(16) T v[kVec<T>];
#pragma unroll
    for (int e = 0; e < kVec<T>; ++e)
      v[e] = c + e < d ? p[c + e] : from_f<T>(0.0f);
    raw = *reinterpret_cast<const uint4*>(v);
  }
  return raw;
}

template <typename T>
__device__ __forceinline__ void store_piece(T* __restrict__ p, int c, int d,
                                            bool vec,
                                            const float (&v)[kVec<T>]) {
  if (vec) {
    if (c < d) store16(p + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < kVec<T>; ++e)
      if (c + e < d) p[c + e] = from_f<T>(v[e]);
  }
}

// One row's operands in flight: its pieces of x and dy, mu and rsigma.
template <int kPieces>
struct RowLoad {
  uint4 x[kPieces], dy[kPieces];
  float mu, rsigma;
};

template <typename T, int kPieces>
__device__ __forceinline__ void load_row(RowLoad<kPieces>& r,
                                         const T* __restrict__ x,
                                         const T* __restrict__ dy,
                                         const float* __restrict__ mu,
                                         const float* __restrict__ rsigma,
                                         int row, int d, int lane, bool vec) {
  const size_t base = static_cast<size_t>(row) * d;
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int c = (32 * j + lane) * kVec<T>;
    r.x[j] = load_piece(x + base, c, d, vec);
    r.dy[j] = load_piece(dy + base, c, d, vec);
  }
  r.mu = mu[row];
  r.rsigma = rsigma[row];
}

// part: [2][partials][d] f32, dw partials then db partials. Shared memory:
// dw [kBwdWarps][d] then db [kBwdWarps][d], f32. At one piece a lane (the
// main path's bf16 rows of 256) ptxas fits 3 blocks an SM in 80 registers
// without spills: ~10% ahead of 2 (86 registers) and of 4 (64, spilling)
// on the H100 (PERF.md, section 6).
template <typename T, int kPieces>
__global__ void __launch_bounds__(kBwdWarps * 32, kPieces == 1 ? 3 : 1)
    layer_norm_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ mu, const float* __restrict__ rsigma,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
    int n_rows, int d, bool vec, const int* __restrict__ chunk_policy,
    int chunk, int num_policies) {
  constexpr int V = kVec<T>;
  constexpr int kPer = kPieces * V;
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t partials = gridDim.x;
  int first = static_cast<int>(blockIdx.x) * kPartRows;
  int row_end = min(first + kPartRows, n_rows);
  if (chunk_policy != nullptr) {
    // The chunk-indexed instance: up to kPartRows rows of one chunk, with
    // that chunk's policy's scale; a chunk of no policy writes NaN dx and
    // a zero partial, which no policy's sum reads.
    const int tiles = (chunk + kPartRows - 1) / kPartRows;
    const int c = static_cast<int>(blockIdx.x) / tiles;
    first = c * chunk + (static_cast<int>(blockIdx.x) % tiles) * kPartRows;
    row_end = min(first + kPartRows, c * chunk + chunk);
    const int p = chunk_policy[c];
    if (p < 0 || p >= num_policies) {
      const T nan = from_f<T>(__int_as_float(0x7fc00000));
      for (int e = threadIdx.x; e < (row_end - first) * d;
           e += kBwdWarps * 32)
        dx[static_cast<size_t>(first) * d + e] = nan;
      for (int col = threadIdx.x; col < d; col += kBwdWarps * 32) {
        part[blockIdx.x * static_cast<size_t>(d) + col] = 0.0f;
        part[(partials + blockIdx.x) * d + col] = 0.0f;
      }
      return;
    }
    w += static_cast<size_t>(p) * d;
  }

  // Value i = j V + e of a lane is column (32 j + lane) V + e.
  float wv[kPer], dw_acc[kPer], db_acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = (32 * (i / V) + lane) * V + i % V;
    wv[i] = c < d ? w[c] : 0.0f;
    dw_acc[i] = 0.0f;
    db_acc[i] = 0.0f;
  }

  RowLoad<kPieces> next;
  int row = first + warp;
  if (row < row_end)
    load_row<T>(next, x, dy, mu, rsigma, row, d, lane, vec);
  for (; row < row_end; row += kBwdWarps) {
    float xv[kPer], g[kPer];
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      float xp[V], gp[V];
      unpack(next.x[j], xp);
      unpack(next.dy[j], gp);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xv[j * V + e] = xp[e];
        g[j * V + e] = gp[e];
      }
    }
    const float m = next.mu;
    const float rs = next.rsigma;
    if (row + kBwdWarps < row_end)
      load_row<T>(next, x, dy, mu, rsigma, row + kBwdWarps, d, lane, vec);

    float xhat[kPer], wdy[kPer];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = (32 * (i / V) + lane) * V + i % V;
      xhat[i] = c < d ? (xv[i] - m) * rs : 0.0f;
      wdy[i] = wv[i] * g[i];
      s1 += xhat[i] * wdy[i];
      s2 += wdy[i];
    }
    const float c1 = warp_sum(s1) / static_cast<float>(d);
    const float c2 = warp_sum(s2) / static_cast<float>(d);
    T* dxr = dx + static_cast<size_t>(row) * d;
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      float out[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = j * V + e;
        out[e] = (wdy[i] - c2 - xhat[i] * c1) * rs;
        dw_acc[i] += g[i] * xhat[i];
        db_acc[i] += g[i];
      }
      store_piece<T>(dxr, (32 * j + lane) * V, d, vec, out);
    }
  }

  float* dw_s = smem;
  float* db_s = smem + kBwdWarps * d;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = (32 * (i / V) + lane) * V + i % V;
    if (c < d) {
      dw_s[warp * d + c] = dw_acc[i];
      db_s[warp * d + c] = db_acc[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kBwdWarps * 32) {
    float sw = 0.0f, sb = 0.0f;
    for (int k = 0; k < kBwdWarps; ++k) {
      sw += dw_s[k * d + c];
      sb += db_s[k * d + c];
    }
    part[blockIdx.x * static_cast<size_t>(d) + c] = sw;
    part[(partials + blockIdx.x) * d + c] = sb;
  }
}

// dw (blockIdx.y 0) or db (1) over columns blockIdx.x * kRedCols .. + 31:
// the sum of that output's partials in a fixed order.
__global__ void __launch_bounds__(kRedCols * kRedGroups)
    layer_norm_wgrad_kernel(const float* __restrict__ part,
                            float* __restrict__ dw, float* __restrict__ db,
                            int partials, int d) {
  __shared__ float s[kRedGroups][kRedCols];
  const int lane = threadIdx.x % kRedCols;
  const int g = threadIdx.x / kRedCols;
  const int c = blockIdx.x * kRedCols + lane;
  const float* src = part + static_cast<size_t>(blockIdx.y) * partials * d;
  float acc = 0.0f;
  if (c < d) {
#pragma unroll 8
    for (int p = g; p < partials; p += kRedGroups)
      acc += src[static_cast<size_t>(p) * d + c];
  }
  s[g][lane] = acc;
  __syncthreads();
#pragma unroll
  for (int h = kRedGroups / 2; h > 0; h /= 2) {
    if (g < h) s[g][lane] += s[g + h][lane];
    __syncthreads();
  }
  if (g == 0 && c < d) (blockIdx.y == 0 ? dw : db)[c] = s[0][lane];
}

// chunk_policy null: one scale and bias; else the chunk-indexed instance
// over [num_policies, d] stacks, rows in chunks of `chunk`.
template <typename T, int kPerLane>
int launch_fwd(const void* x, const void* w, const void* b, void* y,
               void* mu, void* rsigma, int n_rows, int d, float eps,
               cudaStream_t stream, const void* chunk_policy = nullptr,
               int chunk = 0, int num_policies = 1) {
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  layer_norm_fwd_kernel<T, kPerLane><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y),
      static_cast<float*>(mu), static_cast<float*>(rsigma), n_rows, d, eps,
      static_cast<const int*>(chunk_policy), chunk, num_policies);
  return static_cast<int>(cudaGetLastError());
}

// Partials of an [n_rows, d] backward: one a kPartRows rows, or, with
// chunks, ceil(chunk / kPartRows) a chunk.
int bwd_partials(const void* chunk_policy, int n_rows, int chunk) {
  if (chunk_policy == nullptr) return (n_rows + kPartRows - 1) / kPartRows;
  return (n_rows / chunk) * ((chunk + kPartRows - 1) / kPartRows);
}

// phases: bit 0 the main pass (dx and the partials), bit 1 the reduction
// (dw, db from the partials: [num_policies, d] each with chunks, summed by
// policy in chunk order).
template <typename T, int kPieces>
int launch_bwd(const void* x, const void* w, const void* mu,
               const void* rsigma, const void* dy, void* dx, void* part,
               void* dw, void* db, int n_rows, int d, int phases,
               cudaStream_t stream, const void* chunk_policy = nullptr,
               int chunk = 0, int num_policies = 1) {
  const int partials = bwd_partials(chunk_policy, n_rows, chunk);
  if (phases & 1) {
    const int smem = 2 * kBwdWarps * d * static_cast<int>(sizeof(float));
    if (smem > 48 * 1024) {
      const int err = set_smem(layer_norm_bwd_kernel<T, kPieces>, smem);
      if (err != 0) return err;
    }
    const auto on16 = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const bool vec = d % kVec<T> == 0 && on16(x) && on16(dy) && on16(dx);
    layer_norm_bwd_kernel<T, kPieces>
        <<<partials, kBwdWarps * 32, smem, stream>>>(
            static_cast<const T*>(x), static_cast<const float*>(w),
            static_cast<const float*>(mu), static_cast<const float*>(rsigma),
            static_cast<const T*>(dy), static_cast<T*>(dx),
            static_cast<float*>(part), n_rows, d, vec,
            static_cast<const int*>(chunk_policy), chunk, num_policies);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if ((phases & 2) && chunk_policy != nullptr) {
    const int num_chunks = n_rows / chunk;
    const int per_chunk = partials / num_chunks;
    const float* p = static_cast<const float*>(part);
    const int err = sum_by_policy<float>(p, dw, chunk_policy, num_chunks,
                                         per_chunk, num_policies, d, stream);
    if (err != 0) return err;
    return sum_by_policy<float>(p + static_cast<size_t>(partials) * d, db,
                                chunk_policy, num_chunks, per_chunk,
                                num_policies, d, stream);
  }
  if (phases & 2) {
    const dim3 grid((d + kRedCols - 1) / kRedCols, 2);
    layer_norm_wgrad_kernel<<<grid, kRedCols * kRedGroups, 0, stream>>>(
        static_cast<const float*>(part), static_cast<float*>(dw),
        static_cast<float*>(db), partials, d);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; weight, bias, mu, rsigma, dw and db are
// float32. Each entry point returns a cudaError_t, or -1 for arguments
// without an instantiation (D > 1024).
#define MLT_DISPATCH(CALL)                                            \
  if (d <= 0) return -1;                                              \
  if (dtype == 0 && d <= 64) return CALL(float, 2);                   \
  if (dtype == 0 && d <= 128) return CALL(float, 4);                  \
  if (dtype == 0 && d <= 256) return CALL(float, 8);                  \
  if (dtype == 0 && d <= 1024) return CALL(float, 32);                \
  if (dtype == 1 && d <= 64) return CALL(__nv_bfloat16, 2);           \
  if (dtype == 1 && d <= 128) return CALL(__nv_bfloat16, 4);          \
  if (dtype == 1 && d <= 256) return CALL(__nv_bfloat16, 8);          \
  if (dtype == 1 && d <= 1024) return CALL(__nv_bfloat16, 32);        \
  return -1
// kPieces 16-byte pieces a lane: V = 4 (f32) or 8 (bf16) columns each.
#define MLT_DISPATCH_BWD(CALL)                                        \
  if (d <= 0) return -1;                                              \
  if (dtype == 0 && d <= 128) return CALL(float, 1);                  \
  if (dtype == 0 && d <= 256) return CALL(float, 2);                  \
  if (dtype == 0 && d <= 1024) return CALL(float, 8);                 \
  if (dtype == 1 && d <= 256) return CALL(__nv_bfloat16, 1);          \
  if (dtype == 1 && d <= 512) return CALL(__nv_bfloat16, 2);          \
  if (dtype == 1 && d <= 1024) return CALL(__nv_bfloat16, 4);         \
  return -1

extern "C" int mlt_layer_norm_fwd(int dtype, int d, const void* x,
                                  const void* w, const void* b, void* y,
                                  void* mu, void* rsigma, int n_rows,
                                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_FWD(T, K) \
  launch_fwd<T, K>(x, w, b, y, mu, rsigma, n_rows, d, eps, s)
  MLT_DISPATCH(MLT_FWD);
#undef MLT_FWD
}

// partials must be ceil(n_rows / kPartRows) (the wrapper's scratch rows).
extern "C" int mlt_layer_norm_bwd(int dtype, int d, const void* x,
                                  const void* w, const void* mu,
                                  const void* rsigma, const void* dy,
                                  void* dx, void* part, void* dw, void* db,
                                  int n_rows, int partials, int phases,
                                  void* stream) {
  if (n_rows <= 0 || partials != bwd_partials(nullptr, n_rows, 0))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_BWD(T, P) \
  launch_bwd<T, P>(x, w, mu, rsigma, dy, dx, part, dw, db, n_rows, d, \
                   phases, s)
  MLT_DISPATCH_BWD(MLT_BWD);
#undef MLT_BWD
}

// layer_norm_fwd_chunked: the forward over [num_chunks * chunk] rows, chunk
// c with row chunk_policy[c] of the [num_policies, d] f32 scale and bias
// stacks (a chunk of no policy: NaN y, mu and rsigma).
extern "C" int mlt_layer_norm_fwd_chunked(
    int dtype, int d, const void* x, const void* w, const void* b,
    const void* chunk_policy, void* y, void* mu, void* rsigma,
    int num_chunks, int chunk, int num_policies, float eps, void* stream) {
  const long long n = static_cast<long long>(num_chunks) * chunk;
  if (num_chunks <= 0 || chunk <= 0 || num_policies <= 0 || n > 0x7fffffffLL)
    return -1;
  const int n_rows = static_cast<int>(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_FWD(T, K)                                                     \
  launch_fwd<T, K>(x, w, b, y, mu, rsigma, n_rows, d, eps, s, chunk_policy, \
                   chunk, num_policies)
  MLT_DISPATCH(MLT_FWD);
#undef MLT_FWD
}

// layer_norm_bwd_chunked: the backward of layer_norm_fwd_chunked: dx a row
// (NaN for a chunk of no policy), dw / db [num_policies, d], each policy's
// the sum of its chunks' partials in chunk order (0 for a policy without a
// chunk). partials must be num_chunks * ceil(chunk / kPartRows) (the
// wrapper's scratch rows), part [2][partials][d].
extern "C" int mlt_layer_norm_bwd_chunked(
    int dtype, int d, const void* x, const void* w, const void* chunk_policy,
    const void* mu, const void* rsigma, const void* dy, void* dx, void* part,
    void* dw, void* db, int num_chunks, int chunk, int num_policies,
    int partials, void* stream) {
  const long long n = static_cast<long long>(num_chunks) * chunk;
  if (num_chunks <= 0 || chunk <= 0 || num_policies <= 0 ||
      num_policies > 65535 || n > 0x7fffffffLL)
    return -1;
  const int n_rows = static_cast<int>(n);
  if (partials != bwd_partials(chunk_policy, n_rows, chunk)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_BWD(T, P)                                                     \
  launch_bwd<T, P>(x, w, mu, rsigma, dy, dx, part, dw, db, n_rows, d, 3, s, \
                   chunk_policy, chunk, num_policies)
  MLT_DISPATCH_BWD(MLT_BWD);
#undef MLT_BWD
}

#undef MLT_DISPATCH_BWD

#undef MLT_DISPATCH
