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
// Design, shared by all kernels:
// - Each block writes only its own rows, so the two backward kernels need no
//   atomics, the gradients are deterministic, and no [B, H, S, S] tensor
//   exists anywhere.
// - Each (b, h) problem goes through the same instruction sequence whatever
//   B is (the block count grows with B, nothing else does; no split over
//   keys, no tile chosen by B or occupancy), so the rollout step and the
//   update pass agree bit for bit on equal inputs, which PPO's importance
//   ratio needs.
//
// The bf16 forward, flash_fwd_tc_kernel (FlashAttention-2's shape on
// Hopper's warpgroup tensor cores):
// - A block owns 128 query rows of one (b, h) problem: two warpgroups of 64
//   rows, 8 warps of 16. The grid runs over (problem, query tile), query
//   tile fastest, so the blocks of one problem run together and share its
//   keys through L2.
// - K and V stream in tiles of 64 keys, kept as bf16 in shared memory,
//   through a 4-stage ring filled by 16-byte cp.async (zero-fill past
//   valid_len: those keys are never read). The 16-byte chunks of a row are
//   XOR-swizzled exactly as the hardware's 32-, 64- or 128-byte swizzle for
//   rows of D = 16, 32 or 64 bf16, so wgmma reads the tiles by descriptor
//   and ldmatrix reads Q without bank conflicts.
// - S = Q . K^T on wgmma.m64n64k16 (bf16 -> f32; a product of two bf16 is
//   exact in f32, so this is the contract's f32 score up to summation
//   order), Q's fragments read into registers by ldmatrix for each tile
//   as the A operand, K K-major by descriptor.
// - The online softmax runs in registers, row max and sum across each quad
//   of lanes by shuffles, on scores pre-scaled by scale * log2(e): one FFMA
//   and one ex2.approx per score. lse = (m2 + log2 l) ln 2.
// - P . V in f32, as the contract and JAX keep p in f32: p = p_hi + p_lo,
//   both bf16 (p_lo = bf16(p - p_hi), ~16 mantissa bits together), two
//   wgmma.m64nDk16 per 16 keys into f32 accumulators, V MN-major by
//   descriptor. The score accumulators, rounded and packed in pairs, are
//   the register A operand as they stand: no trip through shared memory.
// - out = acc / l is rounded once to bf16, staged through the Q tile's
//   shared memory and stored 16 bytes a thread.
// The float32 forward (flash_fwd_kernel) and both backward kernels keep the
// first design: one thread owns one row (a query row in the forward and in
// dQ, a key row in dK/dV) and keeps it, its other operand row and its f32
// accumulators in registers, streaming tiles of kTile rows of the other
// operand through shared memory as f32 (a broadcast per four FMAs).
//
// Bound on the H100. At the update shape [4096, 512, 4, 32] bf16 with
// valid_len 511 the forward's two products are 0.55 TFLOP (0.55 ms on bf16
// tensor cores; 0.82 TFLOP, 0.83 ms, with p split in two) against 2.1 GB
// of q, k, v and out (0.64 ms at 3.35 TB/s); its 4.29e9 scores need as
// many exponentials, and the special-function units give ~3.9e12 a second
// (16 a clock an SM): >= 1.1 ms, the bound, since the three units run side
// by side. Each warp issues about ten f32 and conversion
// instructions per score besides, and waits on each wgmma it issues; 16
// warps an SM (two blocks, 114 registers a thread) overlap one warpgroup's
// softmax with another's products. The backward's five products (1.4
// TFLOP) still run as f32 FMAs on CUDA cores (67 TFLOP/s at most), tens of
// times their bound; their tensor-core redesign is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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

// ------------------------------------------------ bf16 forward, tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;                 // warps a block, 16 rows each
constexpr int kTcRows = 16 * kTcWarps;      // query rows a block
constexpr int kTcKeys = 64;                 // keys a tile
constexpr int kTcStages = 4;                // (K, V) tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile. The
// chunks of a row are XOR-swizzled so that the 8 rows one ldmatrix reads at
// one column land in 8 distinct 16-byte bank groups.
template <int D>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  constexpr int kChunks = D / 8;              // 16-byte chunks a row
  constexpr int kRowsPer128 = 8 / kChunks;    // rows in 128 bytes
  return static_cast<uint32_t>(r * D * 2 +
                               ((c ^ ((r / kRowsPer128) % kChunks)) * 16));
}

// Rows [r0, r0 + n) of one (b, h) problem (row r at base + r * stride) into
// a swizzled [kTileRows][D] bf16 tile at shared address dst, by cp.async;
// rows n and up of the tile are zero-filled and not read.
template <int D, int kTileRows>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const bf16* __restrict__ src,
                                                size_t base, size_t stride,
                                                int r0, int n) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < kTileRows * kChunks; e += kTcWarps * 32) {
    const int r = e / kChunks, c = e % kChunks;
    const bool valid = r < n;
    const bf16* g =
        src + base + static_cast<size_t>(r0 + (valid ? r : 0)) * stride +
        c * 8;
    mlt::cp_async16(dst + tile_off<D>(r, c), g, valid);
  }
}

// Shared memory of flash_fwd_tc_kernel: the Q tile, then a ring of
// kTcStages (K, V) tile pairs, and 1024 bytes to align them.
template <int D>
constexpr int fwd_tc_smem_bytes() {
  return (kTcRows + 2 * kTcStages * kTcKeys) * D * 2 + 1024;
}

// Grid: x over (problem, query tile), query tile fastest; kTcWarps warps,
// two warpgroups of 64 rows. scale_log2 = D^-0.5 * log2(e). wgmma takes
// its A operand (Q, then p_hi and p_lo) from registers and reads K and V by
// descriptor from their tiles, whose tile_off swizzle is the hardware's 32-,
// 64- or 128-byte swizzle for rows of 32, 64 or 128 bytes.
template <int D>
__global__ void __launch_bounds__(kTcWarps * 32, D == 64 ? 1 : 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int seq, int heads,
                    int valid_len, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kKV = kTcKeys * D * 2;        // bytes of one K or V tile
  constexpr int kDB = D / 8;                  // 8-column blocks of D
  constexpr int kRow = D * 2;                 // bytes a row = swizzle width
  // Tiles start on 1024-byte boundaries, as the swizzle patterns need.
  const uint32_t raw_s = mlt::smem_u32(smem_raw);
  const uint32_t q_s = (raw_s + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (q_s - raw_s);
  const uint32_t kv_s = q_s + kTcRows * D * 2;

  const int q_tiles = (seq + kTcRows - 1) / kTcRows;
  const int p = blockIdx.x / q_tiles;
  const int i0 = (blockIdx.x % q_tiles) * kTcRows;
  const size_t stride = static_cast<size_t>(heads) * D;
  const size_t base =
      static_cast<size_t>(p / heads) * seq * stride + (p % heads) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_tiles = (valid_len + kTcKeys - 1) / kTcKeys;

  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const uint32_t st = kv_s + (j % kTcStages) * 2 * kKV;
      const int n = min(kTcKeys, valid_len - j * kTcKeys);
      load_tile_async<D, kTcKeys>(st, k, base, stride, j * kTcKeys, n);
      load_tile_async<D, kTcKeys>(st + kKV, v, base, stride, j * kTcKeys, n);
    }
    mlt::cp_async_commit();
  };
  load_tile_async<D, kTcRows>(q_s, q, base, stride, i0, min(kTcRows,
                                                           seq - i0));
  for (int j = 0; j < kTcStages - 1; ++j) load_kv(j);

  uint32_t qf[D / 16][4];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    mlt::cp_async_wait<kTcStages - 2>();
    mlt::fence_proxy_async();   // this thread's tile writes, to wgmma
    __syncthreads();
    load_kv(t + kTcStages - 1);
    // Q's fragments, the A operand of S, are read again for every tile.
    // Held across tiles at D = 64, ptxas (CUDA 12.8) gave two of their four
    // register quads to the softmax and to P's fragments after the S wgmma,
    // though the PTX keeps them live around the loop, so every tile after
    // the first multiplied K by p; fencing them changes no instruction.
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mlt::ldmatrix_x4(qf[kk], q_s + tile_off<D>(warp * 16 + lane % 16,
                                                 2 * kk + lane / 16));
    const uint32_t k_s = kv_s + (t % kTcStages) * 2 * kKV;
    const uint32_t v_s = k_s + kKV;

    // s = q . k: K-major B, 8-row groups 8 rows apart, 16 deep = 32 bytes.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.0f;
      mlt::wgmma_fence_operand(s[i]);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) mlt::wgmma_fence_operand(qf[kk][i]);
    mlt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mlt::wgmma_rs<64, 0>(s, qf[kk],
                           mlt::wgmma_desc(k_s + kk * 32, 16, 8 * kRow, kRow),
                           kk > 0);
    mlt::wgmma_commit();
    mlt::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) mlt::wgmma_fence_operand(s[i]);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) mlt::wgmma_fence_operand(qf[kk][i]);

    if ((t + 1) * kTcKeys > valid_len) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (t * kTcKeys + 8 * (i / 4) + 2 * t4 + (i & 1) >= valid_len)
          s[i] = -INFINITY;
    }
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mx[j] = fmaxf(fmaxf(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]),
                      fmaxf(s[8 * j + 4 + 2 * r], s[8 * j + 5 + 2 * r]));
      float x = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      m_new[r] = fmaxf(m[r], x * scale_log2);
      alpha[r] = mlt::ex2(m[r] - m_new[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    float rs[4][2];
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 8 * kk; i < 8 * kk + 8; ++i)
        s[i] = mlt::ex2(fmaf(s[i], scale_log2, -m_new[(i / 2) % 2]));
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rs[kk][r] = (s[8 * kk + 2 * r] + s[8 * kk + 2 * r + 1]) +
                    (s[8 * kk + 4 + 2 * r] + s[8 * kk + 5 + 2 * r]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* pr = &s[8 * kk + 2 * i];
        hi[kk][i] = mlt::pack_bf16x2(pr[0], pr[1]);
        lo[kk][i] = mlt::pack_bf16x2(pr[0] - mlt::bf16_lo(hi[kk][i]),
                                     pr[1] - mlt::bf16_hi(hi[kk][i]));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * alpha[r] + ((rs[0][r] + rs[1][r]) + (rs[2][r] + rs[3][r]));

    // acc += p . v: MN-major B (V's rows are keys), 16 keys = 16 rows on.
#pragma unroll
    for (int i = 0; i < D / 2; ++i) mlt::wgmma_fence_operand(acc[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mlt::wgmma_fence_operand(hi[kk][i]);
        mlt::wgmma_fence_operand(lo[kk][i]);
      }
    mlt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv =
          mlt::wgmma_desc(v_s + kk * 16 * kRow, kKV, 8 * kRow, kRow);
      mlt::wgmma_rs<D, 1>(acc, hi[kk], dv, 1);
      mlt::wgmma_rs<D, 1>(acc, lo[kk], dv, 1);
    }
    mlt::wgmma_commit();
    mlt::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) mlt::wgmma_fence_operand(acc[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mlt::wgmma_fence_operand(hi[kk][i]);
        mlt::wgmma_fence_operand(lo[kk][i]);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
  for (int db = 0; db < kDB; ++db)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(
          smem + tile_off<D>(warp * 16 + g + 8 * r, db) + 4 * t4) =
          mlt::pack_bf16x2(acc[4 * db + 2 * r] * inv[r],
                           acc[4 * db + 2 * r + 1] * inv[r]);
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * kDB; e += 32) {
    const int r = e / kDB, c = e % kDB;
    const int i = i0 + warp * 16 + r;
    if (i < seq)
      *reinterpret_cast<uint4*>(o + base + static_cast<size_t>(i) * stride +
                                c * 8) =
          *reinterpret_cast<const uint4*>(smem +
                                          tile_off<D>(warp * 16 + r, c));
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + warp * 16 + g + 8 * r;
      if (i < seq)
        lse[static_cast<size_t>(p) * seq + i] =
            (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ------------------------------------------------ CUDA-core kernels

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

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  float* lse, int batch, int seq, int heads, int valid_len,
                  float scale, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * heads *
                           ((seq + kTcRows - 1) / kTcRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = fwd_tc_smem_bytes<D>();
  const int err = mlt::set_smem(flash_fwd_tc_kernel<D>, smem);
  if (err != 0) return err;
  flash_fwd_tc_kernel<D><<<static_cast<unsigned>(blocks), kTcWarps * 32,
                           smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, seq, heads,
      valid_len, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, int seq, int heads, int valid_len,
               float scale, cudaStream_t stream) {
  const int threads = threads_for(seq);
  flash_fwd_kernel<float, D><<<grid_for(batch, heads, seq, threads), threads,
                               0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq, heads,
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
  // bf16 on tensor cores (flash_fwd_tc_kernel); float32 on CUDA cores
  // (flash_fwd_kernel), whose f32 products tensor cores would round.
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define MLT_ARGS q, k, v, o, l, batch, seq, heads, valid_len, scale, s
  if (dtype == 0 && head_dim == 16) return launch_fwd<16>(MLT_ARGS);
  if (dtype == 0 && head_dim == 32) return launch_fwd<32>(MLT_ARGS);
  if (dtype == 0 && head_dim == 64) return launch_fwd<64>(MLT_ARGS);
  if (dtype == 1 && head_dim == 16) return launch_fwd_tc<16>(MLT_ARGS);
  if (dtype == 1 && head_dim == 32) return launch_fwd_tc<32>(MLT_ARGS);
  if (dtype == 1 && head_dim == 64) return launch_fwd_tc<64>(MLT_ARGS);
#undef MLT_ARGS
  return -1;
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
