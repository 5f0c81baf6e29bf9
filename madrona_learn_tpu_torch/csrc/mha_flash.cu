// mha_flash: flash attention over large entity sets, [B, S, H, D] in place.
// Forward (output and per-row logsumexp) and the FlashAttention-2 backward
// as two kernels, dK/dV over query rows and dQ over key rows.
//
// Replaces madrona_learn_tpu/ops/pallas/attention.py:mha_flash (the bf16
// kernel of each pair runs on tensor cores, the float32 one on CUDA cores):
// - flash_fwd_tc_kernel, flash_fwd_kernel: _mha_flash_kernel through
//   _mha_flash_impl;
// - flash_bwd_dkdv_tc_kernel, flash_bwd_dkdv_kernel:
//   _mha_flash_bwd_dkdv_kernel;
// - flash_bwd_dq_tc_kernel, flash_bwd_dq_kernel: _mha_flash_bwd_dq_kernel.
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
//
// The bf16 backward on the same building blocks (flash_bwd_dkdv_tc_kernel,
// flash_bwd_dq_tc_kernel):
// - dK/dV works transposed: a block owns 128 keys (two warpgroups of 64)
//   and streams tiles of 64 queries, each with its lse and delta, through
//   the cp.async ring. S^T = K . Q^T and dP^T = V . dO^T take A (K, V) and
//   B (the Q and dO tiles) K-major from shared memory by descriptor; then
//   P^T and dS^T, as accumulators in place, are the register A operands of
//   dV += P^T . dO and dK += dS^T . Q, with the same Q and dO tiles read
//   MN-major. No tile makes a trip through shared memory.
// - dQ: a block owns 128 query rows, as in the forward, and streams K and V:
//   S = Q . K^T and dP = dO . V^T (A = Q, dO), dQ += dS . K (K MN-major).
// - p = 2^(s scale log2(e) - lse log2(e)): one FFMA and one ex2.approx a
//   score; dS = p (dP - delta) scale in f32. p and dS are f32 A operands
//   split into bf16 hi + lo as the forward splits p, so dV, dK and dQ stay
//   f32 sums of f32 products (~16 mantissa bits a term). The two score
//   products of a tile are committed as two wgmma groups, so that P is
//   computed while dP is still on the tensor cores; the split products of
//   a tile as one group, waited for before the next tile.
// - No register A operand lives across the tile loop: the block's own
//   tiles are read by descriptor, and the split accumulators are waited
//   for within the tile (see flash_fwd_tc_kernel: ptxas reassigned Q's
//   fragments held across its loop at D = 64).
// - Query rows past S are zero rows of Q and dO with lse and delta 0 (p =
//   1 multiplies only zeros); keys at and past valid_len are zero-filled,
//   never read, and their p is set to 0; dK and dV rows of such keys are
//   stored as 0.
// The float32 forward (flash_fwd_kernel) and the float32 backward
// (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel), whose f32 products tensor
// cores would round, keep the first design: one thread owns one row (a
// query row in the forward and in dQ, a key row in dK/dV) and keeps it, its
// other operand row and its f32 accumulators in registers, streaming tiles
// of kTile rows of the other operand through shared memory as f32 (a
// broadcast per four FMAs).
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
// softmax with another's products. The backward has the same 4.29e9
// exponentials (>= 1.1 ms each kernel); its products are 1.1 TFLOP in
// dK/dV and 0.8 in dQ as the contract counts them, 1.6 and 1.1 with p and
// dS split (1.7 and 1.1 ms on tensor cores), and each score takes about
// 12 f32 and conversion instructions in dK/dV and 10 in dQ besides.

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

// -------------------------------------- bf16 kernels on tensor cores: forward

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

// Shared memory of the tensor-core kernels: kOwn [kTcRows][D] tiles of the
// block's own rows, a ring of kTcStages pairs of [kTcKeys][D] streamed
// tiles, kStats floats a stage, and 1024 bytes to align the tiles.
template <int D, int kOwn, int kStats>
constexpr int tc_smem_bytes() {
  return (kOwn * kTcRows + 2 * kTcStages * kTcKeys) * D * 2 +
         kTcStages * kStats * 4 + 1024;
}

// x (an f32 accumulator of 16 rows x 64 columns a warp) as two bf16 A
// operands, x = hi + lo, 16 columns a step: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_hi_lo(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* pr = &x[8 * kk + 2 * i];
      hi[kk][i] = mlt::pack_bf16x2(pr[0], pr[1]);
      lo[kk][i] = mlt::pack_bf16x2(pr[0] - mlt::bf16_lo(hi[kk][i]),
                                   pr[1] - mlt::bf16_hi(hi[kk][i]));
    }
}

// acc += (hi + lo) . B, with B a streamed [kTcKeys][D] tile read MN-major
// (its rows are the 64-deep reduction), two wgmma.m64nDk16 per 16 rows.
// The caller commits them and calls wait_split before it touches acc, hi or
// lo again.
template <int D>
__device__ __forceinline__ void accumulate_split(float (&acc)[D / 2],
                                                 uint32_t (&hi)[4][4],
                                                 uint32_t (&lo)[4][4],
                                                 uint32_t b) {
  constexpr int kRow = D * 2;
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
    const uint64_t db = mlt::wgmma_desc(b + kk * 16 * kRow, kTcKeys * kRow,
                                        8 * kRow, kRow);
    mlt::wgmma_rs<D, 1>(acc, hi[kk], db, 1);
    mlt::wgmma_rs<D, 1>(acc, lo[kk], db, 1);
  }
}

template <int D>
__device__ __forceinline__ void wait_split(float (&acc)[D / 2],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
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

// This warp's 16 rows of an f32 accumulator, rounded once to bf16 (rows
// `live` false as 0), staged through the warp's own rows of a [kTcRows][D]
// tile at smem and stored 16 bytes a thread to rows r0 + 16 warp .. of one
// problem, those below `rows`.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           const bool (&live)[2],
                                           uint8_t* smem, bf16* __restrict__ out,
                                           size_t base, size_t stride, int r0,
                                           int rows) {
  constexpr int kDB = D / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int db = 0; db < kDB; ++db)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(
          smem + tile_off<D>(warp * 16 + g + 8 * r, db) + 4 * t4) =
          live[r] ? mlt::pack_bf16x2(acc[4 * db + 2 * r],
                                     acc[4 * db + 2 * r + 1])
                  : 0u;
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * kDB; e += 32) {
    const int r = e / kDB, c = e % kDB;
    const int i = r0 + warp * 16 + r;
    if (i < rows)
      *reinterpret_cast<uint4*>(out + base + static_cast<size_t>(i) * stride +
                                c * 8) =
          *reinterpret_cast<const uint4*>(smem + tile_off<D>(warp * 16 + r, c));
  }
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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 8 * kk; i < 8 * kk + 8; ++i)
        s[i] = mlt::ex2(fmaf(s[i], scale_log2, -m_new[(i / 2) % 2]));
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rs[kk][r] = (s[8 * kk + 2 * r] + s[8 * kk + 2 * r + 1]) +
                    (s[8 * kk + 4 + 2 * r] + s[8 * kk + 5 + 2 * r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * alpha[r] + ((rs[0][r] + rs[1][r]) + (rs[2][r] + rs[3][r]));

    // acc += p . v, V's rows being keys.
    uint32_t hi[4][4], lo[4][4];
    split_hi_lo(s, hi, lo);
    accumulate_split<D>(acc, hi, lo, v_s);
    mlt::wgmma_commit();
    wait_split<D>(acc, hi, lo);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= inv[(i / 2) % 2];
  const bool all[2] = {true, true};
  store_rows<D>(acc, all, smem, o, base, stride, i0, seq);
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

// -------------------------------------- bf16 kernels on tensor cores: backward

// The two score-shaped products of one streamed tile for this warpgroup's
// 64 rows, both A and B K-major by descriptor: x = A1 . B1^T, y = A2 .
// B2^T, committed as two groups so that x can be used while y runs.
// a1 and a2 point at the warpgroup's first row of the block's own tiles,
// b1 and b2 at the streamed tiles.
template <int D>
__device__ __forceinline__ void score_products(float (&x)[32], float (&y)[32],
                                               uint32_t a1, uint32_t b1,
                                               uint32_t a2, uint32_t b2) {
  constexpr int kRow = D * 2;
  // K-major: 8-row groups 8 rows apart, 16 deep = 32 bytes a step.
  auto desc = [](uint32_t addr) {
    return mlt::wgmma_desc(addr, 16, 8 * kRow, kRow);
  };
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    x[i] = 0.0f;
    y[i] = 0.0f;
    mlt::wgmma_fence_operand(x[i]);
    mlt::wgmma_fence_operand(y[i]);
  }
  mlt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mlt::wgmma_ss_m64n64k16(x, desc(a1 + kk * 32), desc(b1 + kk * 32),
                            kk > 0);
  mlt::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mlt::wgmma_ss_m64n64k16(y, desc(a2 + kk * 32), desc(b2 + kk * 32),
                            kk > 0);
  mlt::wgmma_commit();
}

// dK/dV, transposed: a block owns kTcRows keys of one (b, h) problem (two
// warpgroups of 64) and streams tiles of kTcKeys queries, with each tile's
// lse and delta, through the cp.async ring. Per tile, for this
// warpgroup's keys (rows) and the tile's queries (columns):
//   S^T = K . Q^T, dP^T = V . dO^T      (A = own K / V, B = Q / dO, K-major)
//   P^T = 2^(S^T scale_log2 - lse log2 e), 0 for keys >= valid_len
//   dS^T = P^T (dP^T - delta) scale
//   dV += P^T . dO, dK += dS^T . Q      (A = accumulators split hi + lo,
//                                        B = dO / Q, MN-major)
// Queries past seq are zero rows of Q and dO (lse and delta 0): p = 1 there
// but multiplies only zeros, so they add exactly 0. Grid: x over (problem,
// key tile), key tile fastest. scale_log2 = D^-0.5 * log2(e).
template <int D>
__global__ void __launch_bounds__(kTcWarps * 32, D == 64 ? 1 : 2)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int seq, int heads, int valid_len, float scale,
                         float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kOwn = kTcRows * D * 2;       // bytes of the K or V tile
  constexpr int kT = kTcKeys * D * 2;         // bytes of a Q or dO tile
  constexpr int kRow = D * 2;
  const uint32_t raw_s = mlt::smem_u32(smem_raw);
  const uint32_t k_s = (raw_s + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (k_s - raw_s);
  const uint32_t v_s = k_s + kOwn;
  const uint32_t ring_s = v_s + kOwn;
  const uint32_t stats_s = ring_s + kTcStages * 2 * kT;
  const float* stats =
      reinterpret_cast<const float*>(smem + (stats_s - k_s));

  const int k_tiles = (seq + kTcRows - 1) / kTcRows;
  const int p = blockIdx.x / k_tiles;
  const int j0 = (blockIdx.x % k_tiles) * kTcRows;
  const int b = p / heads, h = p % heads;
  const size_t stride = static_cast<size_t>(heads) * D;
  const size_t base = static_cast<size_t>(b) * seq * stride + h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t wg_row = (warp / 4) * 64 * kRow;
  const int n_keys = valid_len - j0;          // live keys of the block
  const int q_tiles = (seq + kTcKeys - 1) / kTcKeys;
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) live[r] = warp * 16 + g + 8 * r < n_keys;

  auto load_q = [&](int t) {
    if (t < q_tiles) {
      const int st = t % kTcStages;
      const uint32_t q_st = ring_s + st * 2 * kT;
      const int i0 = t * kTcKeys, n = min(kTcKeys, seq - i0);
      load_tile_async<D, kTcKeys>(q_st, q, base, stride, i0, n);
      load_tile_async<D, kTcKeys>(q_st + kT, dout, base, stride, i0, n);
      if (threadIdx.x < 2 * kTcKeys) {
        const int r = threadIdx.x % kTcKeys;
        const bool valid = r < n;
        const size_t i = i0 + (valid ? r : 0);
        const float* src =
            threadIdx.x < kTcKeys
                ? lse + static_cast<size_t>(p) * seq + i
                : delta + (static_cast<size_t>(b) * seq + i) * heads + h;
        mlt::cp_async4(stats_s + (st * 2 * kTcKeys + threadIdx.x) * 4, src,
                       valid);
      }
    }
    mlt::cp_async_commit();
  };

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }
  // A block whose keys are all masked writes zeros only.
  if (n_keys > 0) {
    const int n_own = min(kTcRows, n_keys);
    load_tile_async<D, kTcRows>(k_s, k, base, stride, j0, n_own);
    load_tile_async<D, kTcRows>(v_s, v, base, stride, j0, n_own);
    for (int t = 0; t < kTcStages - 1; ++t) load_q(t);

    for (int t = 0; t < q_tiles; ++t) {
      mlt::cp_async_wait<kTcStages - 2>();
      mlt::fence_proxy_async();   // this thread's tile writes, to wgmma
      __syncthreads();
      load_q(t + kTcStages - 1);
      const int st = t % kTcStages;
      const uint32_t q_st = ring_s + st * 2 * kT;
      const uint32_t do_st = q_st + kT;
      const float* lse_t = stats + st * 2 * kTcKeys;
      const float* delta_t = lse_t + kTcKeys;

      float s[32], dp[32];
      score_products<D>(s, dp, k_s + wg_row, q_st, v_s + wg_row, do_st);
      mlt::wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < 32; ++i) mlt::wgmma_fence_operand(s[i]);
      if (n_keys < kTcRows) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (!live[(i / 2) % 2]) s[i] = -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t4);
        const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e};
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i)
          s[i] = mlt::ex2(fmaf(s[i], scale_log2, nl[i & 1]));
      }
      mlt::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) mlt::wgmma_fence_operand(dp[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d =
            *reinterpret_cast<const float2*>(delta_t + 8 * j + 2 * t4);
        const float dl[2] = {d.x, d.y};
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i)
          dp[i] = s[i] * (dp[i] - dl[i & 1]) * scale;
      }
      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
      split_hi_lo(s, p_hi, p_lo);
      split_hi_lo(dp, ds_hi, ds_lo);
      accumulate_split<D>(dv_acc, p_hi, p_lo, do_st);
      accumulate_split<D>(dk_acc, ds_hi, ds_lo, q_st);
      mlt::wgmma_commit();
      wait_split<D>(dv_acc, p_hi, p_lo);
      wait_split<D>(dk_acc, ds_hi, ds_lo);
    }
  }
  __syncthreads();   // every wgmma has read its own K and V tiles
  store_rows<D>(dk_acc, live, smem, dk, base, stride, j0, seq);
  store_rows<D>(dv_acc, live, smem + kOwn, dv, base, stride, j0, seq);
}

// dQ: a block owns kTcRows query rows of one (b, h) problem (two
// warpgroups of 64), as in the forward, and streams tiles of kTcKeys keys
// (K and V) through the cp.async ring. Per tile:
//   S = Q . K^T, dP = dO . V^T          (A = own Q / dO, B = K / V, K-major)
//   P = 2^(S scale_log2 - lse log2 e), 0 for keys >= valid_len
//   dS = P (dP - delta) scale
//   dQ += dS . K                        (A = dS split hi + lo, B = K,
//                                        MN-major)
// Grid: x over (problem, query tile), query tile fastest.
template <int D>
__global__ void __launch_bounds__(kTcWarps * 32, D == 64 ? 1 : 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, int seq, int heads,
                       int valid_len, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kOwn = kTcRows * D * 2;       // bytes of the Q or dO tile
  constexpr int kT = kTcKeys * D * 2;         // bytes of a K or V tile
  constexpr int kRow = D * 2;
  const uint32_t raw_s = mlt::smem_u32(smem_raw);
  const uint32_t q_s = (raw_s + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (q_s - raw_s);
  const uint32_t do_s = q_s + kOwn;
  const uint32_t ring_s = do_s + kOwn;

  const int q_tiles = (seq + kTcRows - 1) / kTcRows;
  const int p = blockIdx.x / q_tiles;
  const int i0 = (blockIdx.x % q_tiles) * kTcRows;
  const int b = p / heads, h = p % heads;
  const size_t stride = static_cast<size_t>(heads) * D;
  const size_t base = static_cast<size_t>(b) * seq * stride + h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t wg_row = (warp / 4) * 64 * kRow;
  const int n_tiles = (valid_len + kTcKeys - 1) / kTcKeys;

  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const uint32_t st = ring_s + (j % kTcStages) * 2 * kT;
      const int n = min(kTcKeys, valid_len - j * kTcKeys);
      load_tile_async<D, kTcKeys>(st, k, base, stride, j * kTcKeys, n);
      load_tile_async<D, kTcKeys>(st + kT, v, base, stride, j * kTcKeys, n);
    }
    mlt::cp_async_commit();
  };
  const int n_own = min(kTcRows, seq - i0);
  load_tile_async<D, kTcRows>(q_s, q, base, stride, i0, n_own);
  load_tile_async<D, kTcRows>(do_s, dout, base, stride, i0, n_own);
  for (int j = 0; j < kTcStages - 1; ++j) load_kv(j);

  // This thread's two rows: -lse log2(e) and delta (0 past seq, where
  // nothing is stored).
  float nl[2], dl[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + warp * 16 + g + 8 * r;
    live[r] = i < seq;
    nl[r] = live[r] ? -lse[static_cast<size_t>(p) * seq + i] * kLog2e : 0.0f;
    dl[r] = live[r]
                ? delta[(static_cast<size_t>(b) * seq + i) * heads + h]
                : 0.0f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    mlt::cp_async_wait<kTcStages - 2>();
    mlt::fence_proxy_async();   // this thread's tile writes, to wgmma
    __syncthreads();
    load_kv(t + kTcStages - 1);
    const uint32_t k_st = ring_s + (t % kTcStages) * 2 * kT;
    const uint32_t v_st = k_st + kT;

    float s[32], dp[32];
    score_products<D>(s, dp, q_s + wg_row, k_st, do_s + wg_row, v_st);
    mlt::wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < 32; ++i) mlt::wgmma_fence_operand(s[i]);
    if ((t + 1) * kTcKeys > valid_len) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (t * kTcKeys + 8 * (i / 4) + 2 * t4 + (i & 1) >= valid_len)
          s[i] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = mlt::ex2(fmaf(s[i], scale_log2, nl[(i / 2) % 2]));
    mlt::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      mlt::wgmma_fence_operand(dp[i]);
      dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]) * scale;
    }
    uint32_t hi[4][4], lo[4][4];
    split_hi_lo(dp, hi, lo);
    accumulate_split<D>(acc, hi, lo, k_st);
    mlt::wgmma_commit();
    wait_split<D>(acc, hi, lo);
  }
  __syncthreads();   // every wgmma has read its own Q and dO tiles
  store_rows<D>(acc, live, smem, dq, base, stride, i0, seq);
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
  constexpr int smem = tc_smem_bytes<D, 1, 0>();
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

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                int batch, int seq, int heads, int valid_len, float scale,
                cudaStream_t stream) {
  const int threads = threads_for(seq);
  flash_bwd_dkdv_kernel<float, D><<<grid_for(batch, heads, seq, threads),
                                    threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), seq, heads,
      valid_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int batch,
              int seq, int heads, int valid_len, float scale,
              cudaStream_t stream) {
  const int threads = threads_for(seq);
  flash_bwd_dq_kernel<float, D><<<grid_for(batch, heads, seq, threads),
                                  threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), seq, heads, valid_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv_tc(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int batch, int seq, int heads,
                   int valid_len, float scale, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * heads *
                           ((seq + kTcRows - 1) / kTcRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = tc_smem_bytes<D, 2, 2 * kTcKeys>();
  const int err = mlt::set_smem(flash_bwd_dkdv_tc_kernel<D>, smem);
  if (err != 0) return err;
  flash_bwd_dkdv_tc_kernel<D><<<static_cast<unsigned>(blocks), kTcWarps * 32,
                                smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, heads, valid_len,
      scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int batch, int seq, int heads, int valid_len,
                 float scale, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(batch) * heads *
                           ((seq + kTcRows - 1) / kTcRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = tc_smem_bytes<D, 2, 0>();
  const int err = mlt::set_smem(flash_bwd_dq_tc_kernel<D>, smem);
  if (err != 0) return err;
  flash_bwd_dq_tc_kernel<D><<<static_cast<unsigned>(blocks), kTcWarps * 32,
                              smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), seq, heads, valid_len, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point runs bf16 on tensor cores (the *_tc kernels) and float32
// on CUDA cores, whose f32 products tensor cores would round.
#define MLT_FLASH_DISPATCH(LAUNCH)                                           \
  if (dtype == 0 && head_dim == 16) return LAUNCH<16>(MLT_ARGS);             \
  if (dtype == 0 && head_dim == 32) return LAUNCH<32>(MLT_ARGS);             \
  if (dtype == 0 && head_dim == 64) return LAUNCH<64>(MLT_ARGS);             \
  if (dtype == 1 && head_dim == 16) return LAUNCH##_tc<16>(MLT_ARGS);        \
  if (dtype == 1 && head_dim == 32) return LAUNCH##_tc<32>(MLT_ARGS);        \
  if (dtype == 1 && head_dim == 64) return LAUNCH##_tc<64>(MLT_ARGS);        \
  return -1

extern "C" int mlt_mha_flash_fwd(int dtype, int head_dim, const void* q,
                                 const void* k, const void* v, void* o,
                                 void* lse, int batch, int seq, int heads,
                                 int valid_len, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define MLT_ARGS q, k, v, o, l, batch, seq, heads, valid_len, scale, s
  MLT_FLASH_DISPATCH(launch_fwd);
#undef MLT_ARGS
}

extern "C" int mlt_mha_flash_bwd_dkdv(int dtype, int head_dim, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dk, void* dv,
                                      int batch, int seq, int heads,
                                      int valid_len, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
#define MLT_ARGS q, k, v, dout, l, d, dk, dv, batch, seq, heads, valid_len, \
                 scale, s
  MLT_FLASH_DISPATCH(launch_dkdv);
#undef MLT_ARGS
}

extern "C" int mlt_mha_flash_bwd_dq(int dtype, int head_dim, const void* q,
                                    const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dq, int batch,
                                    int seq, int heads, int valid_len,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
#define MLT_ARGS q, k, v, dout, l, d, dq, batch, seq, heads, valid_len, scale, s
  MLT_FLASH_DISPATCH(launch_dq);
#undef MLT_ARGS
}
#undef MLT_FLASH_DISPATCH
