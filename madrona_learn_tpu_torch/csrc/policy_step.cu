// fused_policy_step: one rollout step of the whole policy trunk, the MLP
// stack (Dense, LayerNorm, ReLU per layer) and the packed LSTM cell, in
// one kernel.
//
// Replaces madrona_learn_tpu/ops/pallas/policy_step.py:fused_policy_step
// (_step_kernel with _mlp_layer). There each TPU grid program keeps a
// batch tile's activations in VMEM across the layers and holds every
// weight resident; the rollout's ~30 separate launches of the unfused
// trunk become one, and the [N, H] activations never go to device memory.
//
// Math (the JAX twin's rounding points, ops/pallas/policy_step.py:187):
// - Dense: f32 accumulation, rounded to the storage type T.
// - LayerNorm: mean and E[x^2] - mean^2 in f32, both rounded to T; scale
//   and bias rounded to T; (a - mean) * (rsqrt(var + 1e-6) * scale) + bias
//   in f32 (the association of flax's and the port's LayerNorm), rounded
//   once to T, then ReLU.
// - LSTM: xp = round_T(a . Wi), gates = xp + h . Wr + round_T(b) in f32,
//   c' and h' rounded to T (the precise-gates cell of csrc/lstm.cu).
//
// Both kernels: a block owns a tile of batch rows, whose activations stay
// in shared memory from the input tile through every layer to the LSTM
// cell; only x, c and h are read and feats, c', h' written. x [N, F] is
// read in place with row stride F (F <= 128): no padding of the feature
// axis in device memory. Rows past N are zero-filled in shared memory and
// never written. The weights (1 MiB of Wi + Wr at H = 256 in bf16, more
// than a block's shared memory) are read through L2 every step; a block
// reuses each element for its rows.
//
// The float32 kernel (policy_step_kernel; layout and product in
// common.cuh), at H = 128, 256, 384 and 512: kRows rows a block,
// activations as f32 [kRows][H], the products as f32 FMA loops, which
// bound it. One row group's 64 threads (two warps) own all H units of its
// rows (H / 64 units a thread: 6 at 384, 8 at 512). LayerNorm's row sums
// over those units: warp shuffles, then one exchange of the two warps'
// partials through shared memory.
//
// The bfloat16 kernel (policy_step_tc_kernel), on Hopper's tensor cores:
// the twin's products are bf16 operands with f32 accumulation, which is
// what wgmma computes, with only the order of the sums changed. The
// wrapper's rule (ops/cuda/policy_step.py: uses_tensor_cores) sends bf16
// at every width here; at H = 384 and 512 the units are split over a
// cluster of two blocks (the kernel's comment).
// - R = kStepTcRows batch rows a block (32: 32-34% faster than 16 at the
//   headline_fused step on the H100); warpgroup w
//   owns units 64 w .. 64 w + 63 of every layer and of all four gates. The
//   products run transposed, units as wgmma's M and the block's rows as its
//   N (out^T = W^T . a^T), as in lstm.cu's backward: the gate math is
//   thread-local, and four m64nR accumulators take 2 R of a thread's 128
//   registers at H = 256.
// - A: the weights as they lie in memory. A TMA box [64 k][64 units] of a
//   row-major [K, n] weight is wgmma's MN-major A operand as it stands, so
//   no transposed copy is made per step: 64-deep slices of W_0 .. W_{L-1},
//   Wi and Wr stream through a ring (slice_ring.cuh) in one fixed order;
//   layer 0's rows past F arrive as zeros (TMA's out-of-bounds fill), the
//   x tile's columns past F are zeros.
// - B: the activation tile (K-major, 128-byte swizzle), each layer's
//   output written over its input once every warpgroup's product is done,
//   and the h tile.
// - LayerNorm's row sums over units: a thread's two units, a shuffle over
//   the eight lanes of a row, then each warp's partial through shared
//   memory, summed in warp order (the cluster's warps in unit order) by one
//   thread a row; a row's outputs do not depend on N or on where the row
//   sits.
// - h' and c' go back over h and c in shared memory, then out by 16-byte
//   stores.
//
// The chunk-indexed instance of both kernels (fused_policy_step_chunked)
// is the rollout step of a population in the policy-chunk layout: JAX vmaps
// the fused step's pallas_call over [B, C] chunks of one policy each
// (madrona_learn_tpu/rollouts.py:580, models/actor_critic.py:229). The rows
// are [B][C], a block owns one row tile of one chunk (fwd_rows,
// chunk_rows.cuh: no block straddles two policies, and C need not be a
// multiple of the block's rows), and reads its policy's slice of the
// [P, ...] stacks: the f32 LayerNorm affines and the bias by a pointer
// offset, the weights by a pointer offset on CUDA cores and by the third
// coordinate of one TMA map over each [P, K, n] stack on tensor cores. A
// map bounds each policy's K on its own, so layer 0's rows past F still
// arrive as zeros, never as the next policy's rows. A row's arithmetic is
// the single-policy kernel's, so every row equals fused_policy_step's with
// its policy's weights bitwise; a chunk whose policy lies outside [0, P)
// (custom policies, which the simulator plays) reads no weight and writes
// NaN rows. Bound as the step: at H = 256 the 12 policies' 15 MiB of
// weights stay resident in L2, each block streams its own policy's. At
// H = 512 a policy's W0, W1, Wi and Wr are about 4.5 MiB in bf16, 54 MiB
// for 12, more than the 50 MB of L2: there the stacks no longer stay
// resident, and blocks of other policies evict each other's weights.
//
// Bound on the H100: at [16384, 3 -> 256 -> 256, LSTM 256] bf16 the step
// does 19.35 GFLOP, 89% of it in the two [256, 1024] products, against
// ~43 MB of bytes: bound by operations on the tensor cores (0.020 ms).
// What holds the tensor-core kernel is streaming the weights from L2,
// 1.16 MiB a block: about 0.6 GB a step at R = 32.

#include <cuda.h>   // CUtensorMap

#include "chunk_rows.cuh"
#include "common.cuh"
#include "mma.cuh"
#include "slice_ring.cuh"

namespace {

using namespace mlt;

constexpr int kMaxLayers = 4;
constexpr float kLnEps = 1e-6f;  // flax.linen.LayerNorm's default

template <typename T>
struct StepArgs {
  const T* x;
  int f_in;
  int layers;
  const T* w[kMaxLayers];           // [F_in, H]
  const float* ln_scale[kMaxLayers];  // [H]
  const float* ln_bias[kMaxLayers];   // [H]
  const T* wi;                      // [H, 4H]
  const T* wr;                      // [H, 4H]
  const T* bias;                    // [4H]
  const T* c;                       // [N, H]
  const T* h;                       // [N, H]
  T* feats;
  T* c_out;
  T* h_out;
  int n_rows;
  // The chunk-indexed instance (fwd_rows): null for one policy; else the
  // rows are [num_chunks][chunk], chunk c with policy chunk_policy[c]'s
  // weights of the [num_policies, ...] stacks above.
  const int* chunk_policy;
  int chunk;
  int num_policies;
};

// Chunks of the chunk-indexed instance (0 without chunks).
template <typename T>
int chunk_count(const StepArgs<T>& a) {
  return a.chunk_policy != nullptr ? a.n_rows / a.chunk : 0;
}

// NaN into the block's rows of feats, c' and h': its chunk's policy lies
// outside [0, P).
template <typename T, int H>
__device__ void fill_nan_step(const StepArgs<T>& p, FwdRows rows,
                              int rows_per_block) {
  fill_nan(p.feats, 1, p.n_rows, H, rows, rows_per_block);
  fill_nan(p.c_out, 1, p.n_rows, H, rows, rows_per_block);
  fill_nan(p.h_out, 1, p.n_rows, H, rows, rows_per_block);
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    policy_step_kernel(const StepArgs<T> p) {
  constexpr int UPT = H / kUnitGroups;
  constexpr int RPT = kRowsPerThread;
  constexpr int G4 = 4 * H;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float smem[];
  float* act_s = smem;            // [kRows][H] (the x tile first: [kRows][F])
  float* h_s = smem + kRows * H;  // [kRows][H]
  __shared__ float red_s[kWarps][RPT][2];

  // The block's rows and policy (fwd_rows); the policy's weights at an
  // offset into the stacks (policy 0 without chunks).
  const FwdRows rows = fwd_rows(p.chunk_policy, p.chunk, kRows, p.n_rows);
  if (rows.policy < 0 || rows.policy >= p.num_policies) {
    fill_nan_step<T, H>(p, rows, kRows);
    return;
  }
  const size_t pol = rows.policy;

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = rows.first;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_row_tile<T>(act_s, p.x, block_row, rows.end, p.f_in);
  load_row_tile<T>(h_s, p.h, block_row, rows.end, H);
  __syncthreads();

  int k_in = p.f_in;
  for (int l = 0; l < p.layers; ++l) {
    float acc[RPT][1][UPT];
    row_tile_product<T, 1, RPT, UPT>(act_s, k_in, p.w[l] + pol * k_in * H, H,
                                     0, row_base, u0, acc);
    float s[RPT], sq[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      s[i] = 0.0f;
      sq[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const float a = round_to<T>(acc[i][0][j]);
        acc[i][0][j] = a;
        s[i] += a;
        sq[i] = fmaf(a, a, sq[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
        sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        red_s[warp][i][0] = s[i];
        red_s[warp][i][1] = sq[i];
      }
    }
    __syncthreads();  // partials written; every thread is done with act_s

    float scale[UPT], lbias[UPT];
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      scale[j] = round_to<T>(p.ln_scale[l][pol * H + u0 + j]);
      lbias[j] = round_to<T>(p.ln_bias[l][pol * H + u0 + j]);
    }
    const int w0 = 2 * rg;  // the two warps of this row group
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float mean_f =
          (red_s[w0][i][0] + red_s[w0 + 1][i][0]) * (1.0f / H);
      const float msq = (red_s[w0][i][1] + red_s[w0 + 1][i][1]) * (1.0f / H);
      const float mean = round_to<T>(mean_f);
      const float var = round_to<T>(__fsub_rn(msq, __fmul_rn(mean_f, mean_f)));
      const float inv = rsqrtf(var + kLnEps);
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const float y = __fadd_rn(
            __fmul_rn(__fsub_rn(acc[i][0][j], mean), __fmul_rn(inv, scale[j])),
            lbias[j]);
        act_s[(row_base + i) * H + u0 + j] = fmaxf(round_to<T>(y), 0.0f);
      }
    }
    __syncthreads();  // the layer's output is complete; red_s is free
    k_in = H;
  }

  // LSTM cell: xp = round(a . Wi), then + h . Wr in the same accumulators.
  float acc[RPT][4][UPT];
  row_tile_product<T, 4, RPT, UPT>(act_s, H, p.wi + pol * H * G4, G4, H,
                                   row_base, u0, acc);
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < UPT; ++j) acc[i][g][j] = round_to<T>(acc[i][g][j]);
  row_tile_fma<T, 4, RPT, UPT>(h_s, H, p.wr + pol * H * G4, G4, H, row_base,
                               u0, acc);

  float b[4][UPT];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < UPT; ++j)
      b[g][j] = to_f(p.bias[pol * G4 + g * H + u0 + j]);

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
    if (n >= rows.end) continue;
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const size_t idx = static_cast<size_t>(n) * H + u0 + j;
      const float gi = acc[i][0][j] + b[0][j];
      const float gf = acc[i][1][j] + b[1][j];
      const float gg = acc[i][2][j] + b[2][j];
      const float go = acc[i][3][j] + b[3][j];
      const float new_c =
          sigmoid_f(gf) * to_f(p.c[idx]) + sigmoid_f(gi) * tanhf(gg);
      const float new_h = sigmoid_f(go) * tanhf(new_c);
      const T h_t = from_f<T>(new_h);
      p.feats[idx] = h_t;
      p.h_out[idx] = h_t;
      p.c_out[idx] = from_f<T>(new_c);
    }
  }
}

template <typename T, int H>
int launch_step(const StepArgs<T>& args, cudaStream_t stream) {
  const int smem = kRows * 2 * H * static_cast<int>(sizeof(float));
  if constexpr (H > 256) {   // 48 and 64 KiB: past the default 48 KB
    const int err = set_smem(policy_step_kernel<T, H>, smem);
    if (err != 0) return err;
  }
  const int blocks =
      fwd_blocks(args.chunk_policy, chunk_count(args), args.chunk,
                 args.n_rows, kRows);
  policy_step_kernel<T, H><<<blocks, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
StepArgs<T> make_args(int layers, int f_in, int n_rows, const void* x,
                      const void* const* w, const void* const* s,
                      const void* const* lb, const void* wi, const void* wr,
                      const void* bias, const void* c, const void* h,
                      void* feats, void* c_out, void* h_out,
                      const void* chunk_policy = nullptr, int chunk = 0,
                      int num_policies = 1) {
  StepArgs<T> a{};
  a.x = static_cast<const T*>(x);
  a.f_in = f_in;
  a.layers = layers;
  for (int l = 0; l < kMaxLayers; ++l) {
    a.w[l] = static_cast<const T*>(w[l]);
    a.ln_scale[l] = static_cast<const float*>(s[l]);
    a.ln_bias[l] = static_cast<const float*>(lb[l]);
  }
  a.wi = static_cast<const T*>(wi);
  a.wr = static_cast<const T*>(wr);
  a.bias = static_cast<const T*>(bias);
  a.c = static_cast<const T*>(c);
  a.h = static_cast<const T*>(h);
  a.feats = static_cast<T*>(feats);
  a.c_out = static_cast<T*>(c_out);
  a.h_out = static_cast<T*>(h_out);
  a.n_rows = n_rows;
  a.chunk_policy = static_cast<const int*>(chunk_policy);
  a.chunk = chunk;
  a.num_policies = num_policies;
  return a;
}

// --------------------------------------------- bf16 on tensor cores

using bf16 = __nv_bfloat16;

constexpr int kStepTcRows = 32;   // R, the batch rows a block

// Shared memory of policy_step_tc_kernel, from a 1024-byte aligned base:
// the ring of weight slices (one 64-deep slice of a [K, H] weight, or of
// one gate's H columns of Wi or Wr, the block's U = H / kSplit units of
// it: U / 64 TMA boxes of [64 k][64 units], one a warpgroup), then the
// block's activation tile (x, zero-padded to 64 or 128 columns, then each
// layer's output over all H units: the K-major B operand of the next
// product), its h tile (K-major over all H; h' of its units for the
// copy-out after the products) and its c tile ([R][U], row_off; c' after
// the gate math).
template <int H, int R, int kSplit = 1>
struct StepTc {
  static constexpr int kUnits = H / kSplit;
  static constexpr int kWarpgroups = kUnits / 64;   // 64 units each
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kWarps = 4 * kWarpgroups;
  static constexpr int kSub = R * 128;          // one [R][64] subtile
  static constexpr int kBox = 64 * 64 * 2;      // one [64 k][64 units] box
  static constexpr int kStageBytes = kUnits * 128;
  static constexpr int kTileBytes = R * H * 2;
  static constexpr int kFixed = 2 * kTileBytes + R * kUnits * 2;
  // The row statistics' exchange ([warps of the cluster][R][2] + [R][2]
  // f32) and the barriers are static shared memory.
  static constexpr int kStatic = (kSplit * kWarps + 1) * R * 8 + 256;
  static constexpr int kStages =
      min_c(4, (kSmemLimit - 2048 - kStatic - kFixed) / kStageBytes);
  static constexpr int kSmem = kStages * kStageBytes + kFixed + 1024;
  static_assert(kStages >= 2, "a ring of at least two slices");
};

// One rollout step of the trunk for R batch rows a block (see the
// header). Warpgroup w owns units 64 w .. 64 w + 63 of every layer and of
// all four gates; thread (warp v of its warpgroup, lane l) holds units
// 64 w + 16 v + l / 4 (+ 8) and rows 8 j + 2 (l % 4) (+ 1) of each m64nR
// accumulator: element 4 j + 2 s + e is unit + 8 s, row 8 j + 2 (l % 4) +
// e. The maps are TMA maps of the row-major weights (w_map[l] [F_in, H],
// wi_map and wr_map [H, 4H]) in boxes of [64 k][64 units], the MN-major A
// operand of wgmma as they stand, each over the [P, K, n] stack of the
// chunk-indexed instance (P = 1 without chunks), the block's policy the
// third coordinate; maps past p.layers are never read.
//
// With kSplit = 2 (H = 384, 512) the two blocks of a cluster own the same
// R rows and H / 2 units each (rank r: units r H / 2 ..), so a block keeps
// the H = 192 / 256 instance's warpgroups and registers (H / 64 warpgroups
// in one block would leave 85 or 64 registers a thread, where four m64nR
// accumulators at R = 32 alone take 64). Each block streams its units'
// columns of every weight and holds the whole activation and h tiles (the
// products' K); only its units' c. Per layer, two cluster barriers: after
// the Dense, each warp's LayerNorm partials go into both blocks' red_s
// (distributed shared memory; at [rank * warps + warp], so the cluster's
// warps stand in unit order), and the barrier (also: both blocks' products
// are done) lets each block sum all of them in that fixed order, the same
// sums in both; then each thread writes its normalized units into both
// activation tiles, and the second barrier (release / acquire, then
// fence.proxy.async on both sides) makes the tile whole for the next
// product. The LSTM cell needs no exchange: each block's gates are its
// units'. A block never exits while its peer can still write into it: the
// last remote write is before the last layer's second barrier, and a chunk
// of no policy is skipped by both blocks of its cluster together.
template <int H, int R, int kSplit>
__global__ void __launch_bounds__(StepTc<H, R, kSplit>::kThreads, 1)
    policy_step_tc_kernel(const __grid_constant__ CUtensorMap w0_map,
                          const __grid_constant__ CUtensorMap w1_map,
                          const __grid_constant__ CUtensorMap w2_map,
                          const __grid_constant__ CUtensorMap w3_map,
                          const __grid_constant__ CUtensorMap wi_map,
                          const __grid_constant__ CUtensorMap wr_map,
                          const StepArgs<bf16> p) {
  using L = StepTc<H, R, kSplit>;
  constexpr int S = L::kStages;
  constexpr int U = L::kUnits;
  constexpr int kAcc = R / 2;
  constexpr int kSlices = H / kTcK;   // slices of a [H, H] weight
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];
  // per-warp row sums, the cluster's warps in unit order
  __shared__ float red_s[kSplit * L::kWarps][R][2];
  __shared__ float stat_s[R][2];             // round(mean), rsqrt(var + eps)
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring = (raw_s + 1023) & ~1023u;
  const uint32_t act_s = ring + S * L::kStageBytes;
  const uint32_t h_s = act_s + L::kTileBytes;
  const uint32_t c_s = h_s + L::kTileBytes;
  uint8_t* act_p = smem_raw + (act_s - raw_s);
  uint8_t* h_p = smem_raw + (h_s - raw_s);
  uint8_t* c_p = smem_raw + (c_s - raw_s);

  // The block's rows and policy (fwd_rows: the cluster's row tile); a chunk
  // of no policy is skipped before any barrier, so the whole block (the
  // whole cluster) leaves together.
  const int rank = kSplit == 1 ? 0 : static_cast<int>(cluster_rank());
  const FwdRows rows = fwd_rows(p.chunk_policy, p.chunk, R, p.n_rows,
                                static_cast<int>(blockIdx.x) / kSplit);
  if (rows.policy < 0 || rows.policy >= p.num_policies) {
    if (rank == 0) fill_nan_step<bf16, H>(p, rows, R);
    return;
  }
  const int pol = rows.policy;
  const int row_end = rows.end;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int lt = lane % 4;
  // unit0 counts the block's own units (the ring's columns, the c tile's);
  // unit_base + unit0 is the unit of the layer.
  const int unit_base = rank * U;
  const int unit0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int block_row = rows.first;
  // The tiles' byte offset of unit u + unit_base over unit u's (U is a
  // multiple of 64: whole [R][64] subtiles).
  const uint32_t u_shift = (unit_base / 64) * L::kSub;

  // The weight slices in the order the step consumes them: layer 0 by
  // 64-row slice of its F_in (rows past F_in arrive as zeros), each later
  // layer by slice, then Wi and Wr by (H-chunk, gate), each the block's
  // units' columns.
  const int k0 = (p.f_in + kTcK - 1) / kTcK;
  const int layer_loads = k0 + (p.layers - 1) * kSlices;
  constexpr int gate_loads = 4 * kSlices;
  const CUtensorMap* w0m = &w0_map;
  const CUtensorMap* w1m = &w1_map;
  const CUtensorMap* w2m = &w2_map;
  const CUtensorMap* w3m = &w3_map;
  const CUtensorMap* wim = &wi_map;
  const CUtensorMap* wrm = &wr_map;
  auto issue = [&](int q, uint32_t dst, uint64_t* bar) {
    const CUtensorMap* m = w0m;
    int k = q, col0 = unit_base;
    if (q >= k0 && q < layer_loads) {
      const int l = 1 + (q - k0) / kSlices;
      m = l == 1 ? w1m : l == 2 ? w2m : w3m;
      k = (q - k0) % kSlices;
    } else if (q >= layer_loads) {
      const int r = (q - layer_loads) % gate_loads;
      m = q - layer_loads < gate_loads ? wim : wrm;
      k = r / 4;
      col0 = (r % 4) * H + unit_base;
    }
    for (int w = 0; w < L::kWarpgroups; ++w)
      tma_load_3d(dst + w * L::kBox, m, bar, col0 + w * 64, k * kTcK, pol);
  };
  SliceRing<S> slices{full, empty, ring, L::kStageBytes,
                      layer_loads + 2 * gate_loads, 0};
  if (tid == 0) slices.init(L::kWarps);
  // With a cluster: both blocks have started before any distributed
  // shared-memory store.
  if constexpr (kSplit == 1)
    __syncthreads();
  else
    cluster_sync();
  if (tid == 0) slices.prime(issue);

  // The block's tiles: x into the activation tile (rows past N and columns
  // past F_in as zeros; x's rows need not lie on 16 bytes), h (all H units)
  // and c (the block's) by 16-byte cp.async with zero-fill.
  const int xw = k0 * kTcK;
  for (int e = tid; e < R * xw; e += L::kThreads) {
    const int n = e / xw, k = e % xw;
    const int row = block_row + n;
    *reinterpret_cast<bf16*>(act_p + kmaj_off<R>(n, k)) =
        row < row_end && k < p.f_in
            ? p.x[static_cast<size_t>(row) * p.f_in + k]
            : __float2bfloat16_rn(0.0f);
  }
  for (int e = tid; e < R * (H / 8); e += L::kThreads) {
    const int n = e / (H / 8), c = e % (H / 8);
    const int row = block_row + n;
    const bool live = row < row_end;
    const size_t off = live ? static_cast<size_t>(row) * H + c * 8 : 0;
    cp_async16(h_s + kmaj_off<R>(n, c * 8), p.h + off, live);
    if (c < U / 8)
      cp_async16(c_s + row_off<U>(n, c * 8),
                 p.c + (live ? off + unit_base : 0), live);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // Byte offsets of this thread's elements (rows 2 (l % 4) + e, units
  // unit0 + 8 s) in the K-major tiles (unit_base + unit0: u_shift on) and
  // in the c tile: row 8 j + .. is j * 1024 (j * 16 U) bytes on.
  uint32_t kb[2][2], rb[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      kb[s][e] = kmaj_off<R>(2 * lt + e, unit0 + 8 * s) + u_shift;
      rb[s][e] = row_off<U>(2 * lt + e, unit0 + 8 * s);
    }
  const uint32_t a_off = wg * L::kBox;
  // The peer's activation tile and row sums (kSplit = 2).
  const uint32_t peer_act =
      kSplit == 1 ? 0
                  : map_cluster_rank(act_s, static_cast<uint32_t>(rank ^ 1));
  const uint32_t peer_red =
      kSplit == 1
          ? 0
          : map_cluster_rank(smem_u32(&red_s[0][0][0]),
                             static_cast<uint32_t>(rank ^ 1));
  const int red_warp = rank * L::kWarps + warp;

  // The MLP: Dense (bf16 operands, f32 sums, rounded), LayerNorm, ReLU,
  // each layer's output over its input in the activation tile.
  for (int l = 0; l < p.layers; ++l) {
    float acc[kAcc];
    const int k_slices = l == 0 ? k0 : kSlices;
    for (int kc = 0; kc < k_slices; ++kc)
      ring_product<R, 1>(slices, issue, acc, a_off, act_s + kc * L::kSub,
                         kc == 0);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(acc[i]);

    // Row sums of the rounded Dense output and of its squares: the
    // thread's two units, then the eight lanes of a row within the warp,
    // then the warps (of the cluster) in order through shared memory.
    float sum[R / 8][2], sq[R / 8][2];
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a0 = round_to<bf16>(acc[4 * j + e]);
        const float a1 = round_to<bf16>(acc[4 * j + 2 + e]);
        acc[4 * j + e] = a0;
        acc[4 * j + 2 + e] = a1;
        sum[j][e] = a0 + a1;
        sq[j][e] = fmaf(a1, a1, a0 * a0);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sum[j][e] += __shfl_xor_sync(0xffffffffu, sum[j][e], off);
          sq[j][e] += __shfl_xor_sync(0xffffffffu, sq[j][e], off);
        }
        if (lane < 4) {
          const int n = 8 * j + 2 * lt + e;
          red_s[red_warp][n][0] = sum[j][e];
          red_s[red_warp][n][1] = sq[j][e];
          if constexpr (kSplit > 1) {
            const uint32_t o = ((red_warp * R + n) * 2) * 4;
            st_cluster_f32(peer_red + o, sum[j][e]);
            st_cluster_f32(peer_red + o + 4, sq[j][e]);
          }
        }
      }
    // Partials written, every product of the layer done (with a cluster:
    // the peer's too, so that its activation tile is free to write).
    if constexpr (kSplit == 1)
      __syncthreads();
    else
      cluster_sync();
    if (tid < R) {
      float s_all = 0.0f, sq_all = 0.0f;
      for (int w = 0; w < kSplit * L::kWarps; ++w) {
        s_all += red_s[w][tid][0];
        sq_all += red_s[w][tid][1];
      }
      const float mean_f = s_all * (1.0f / H);
      const float msq = sq_all * (1.0f / H);
      stat_s[tid][0] = round_to<bf16>(mean_f);
      stat_s[tid][1] = rsqrtf(
          round_to<bf16>(__fsub_rn(msq, __fmul_rn(mean_f, mean_f))) +
          kLnEps);
    }
    __syncthreads();
    float scale[2], lbias[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int u = unit_base + unit0 + 8 * s;
      scale[s] = round_to<bf16>(p.ln_scale[l][pol * H + u]);
      lbias[s] = round_to<bf16>(p.ln_bias[l][pol * H + u]);
    }
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * lt + e;
          const float y = __fadd_rn(
              __fmul_rn(__fsub_rn(acc[4 * j + 2 * s + e], stat_s[n][0]),
                        __fmul_rn(stat_s[n][1], scale[s])),
              lbias[s]);
          const bf16 out =
              __float2bfloat16_rn(fmaxf(round_to<bf16>(y), 0.0f));
          const uint32_t o = kb[s][e] + j * 1024;
          *reinterpret_cast<bf16*>(act_p + o) = out;
          if constexpr (kSplit > 1)
            st_cluster_u16(peer_act + o, elem_bits(out));
        }
    // The layer's output is the next product's B (with a cluster: both
    // halves, in both tiles); red_s and stat_s are free.
    if constexpr (kSplit == 1) {
      fence_proxy_async();
      __syncthreads();
    } else {
      fence_proxy_async_all();
      cluster_sync();
      fence_proxy_async_all();
    }
  }

  // LSTM cell, gates as M and rows as N: xp = round(a . Wi), then h . Wr
  // into the same accumulators.
  float acc[4][kAcc];
  for (int kc = 0; kc < kSlices; ++kc)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      ring_product<R, 1>(slices, issue, acc[g], a_off, act_s + kc * L::kSub,
                         kc == 0);
  wgmma_wait<0>();
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      wgmma_fence_operand(acc[g][i]);
      acc[g][i] = round_to<bf16>(acc[g][i]);
    }
  for (int kc = 0; kc < kSlices; ++kc)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      ring_product<R, 1>(slices, issue, acc[g], a_off, h_s + kc * L::kSub,
                         false);
  wgmma_wait<0>();
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(acc[g][i]);
  __syncthreads();   // every warpgroup is done reading the h tile

  // Gate math, thread-local: h' over h in the h tile, c' over c in the c
  // tile (each thread rewrites only the elements it read).
  float b[4][2];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      b[g][s] = __bfloat162float(
          p.bias[(pol * 4 + g) * H + unit_base + unit0 + 8 * s]);
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * s + e;
        bf16* cp = reinterpret_cast<bf16*>(c_p + rb[s][e] + j * 16 * U);
        const float new_c =
            sigmoid_f(acc[1][i] + b[1][s]) * __bfloat162float(*cp) +
            sigmoid_f(acc[0][i] + b[0][s]) * tanhf(acc[2][i] + b[2][s]);
        const float new_h = sigmoid_f(acc[3][i] + b[3][s]) * tanhf(new_c);
        *cp = __float2bfloat16_rn(new_c);
        *reinterpret_cast<bf16*>(h_p + kb[s][e] + j * 1024) =
            __float2bfloat16_rn(new_h);
      }
  __syncthreads();

  // feats = h' and h_out, c_out of the block's units: 16-byte stores of
  // the block's live rows.
  for (int e = tid; e < R * (U / 8); e += L::kThreads) {
    const int n = e / (U / 8), c = e % (U / 8);
    const int row = block_row + n;
    if (row < row_end) {
      const size_t o = static_cast<size_t>(row) * H + unit_base + c * 8;
      const uint4 hv = *reinterpret_cast<const uint4*>(
          h_p + kmaj_off<R>(n, unit_base + c * 8));
      *reinterpret_cast<uint4*>(p.feats + o) = hv;
      *reinterpret_cast<uint4*>(p.h_out + o) = hv;
      *reinterpret_cast<uint4*>(p.c_out + o) =
          *reinterpret_cast<const uint4*>(c_p + row_off<U>(n, c * 8));
    }
  }
}

template <int H>
int launch_step_tc(const StepArgs<bf16>& a, cudaStream_t stream) {
  constexpr int R = kStepTcRows;
  constexpr int kSplit = kTcSplit<H>;
  using L = StepTc<H, R, kSplit>;
  CUtensorMap maps[6];
  // One map over each [P, K, n] stack (P = 1 without chunks), K its own
  // dimension, so that layer 0's rows past F arrive as zeros for every
  // policy. Layers past a.layers get a valid map over Wi that is never
  // read.
  const int P = a.num_policies;
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool used = l < a.layers;
    if (!make_tma_map(&maps[l], used ? a.w[l] : a.wi, used ? H : 4 * H,
                      used ? (l == 0 ? a.f_in : H) : H, P, 64, 64))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!make_tma_map(&maps[4], a.wi, 4 * H, H, P, 64, 64) ||
      !make_tma_map(&maps[5], a.wr, 4 * H, H, P, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = policy_step_tc_kernel<H, R, kSplit>;
  int err = set_smem(kernel, L::kSmem);
  if (err != 0) return err;
  const int tiles =
      fwd_blocks(a.chunk_policy, chunk_count(a), a.chunk, a.n_rows, R);
  // At H = 384 and 512, clusters of two blocks (kTcSplit), launched with
  // their cluster dimension by cudaLaunchKernelEx; a refused launch
  // returns its error.
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
  const cudaError_t launched =
      cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3],
                         maps[4], maps[5], a);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel is built for float32 alone, at
// H = 128, 256, 384 and 512: bfloat16 takes mlt_policy_step_tc); layers
// 1..4, each (w_l, s_l, b_l), the unused ones null. Returns a cudaError_t,
// or -1 for arguments without an instantiation.
extern "C" int mlt_policy_step(
    int dtype, int hidden, int layers, int f_in, int n_rows, const void* x,
    const void* w0, const void* s0, const void* b0, const void* w1,
    const void* s1, const void* b1, const void* w2, const void* s2,
    const void* b2, const void* w3, const void* s3, const void* b3,
    const void* wi, const void* wr, const void* bias, const void* c,
    const void* h, void* feats, void* c_out, void* h_out, void* stream) {
  if (layers < 1 || layers > kMaxLayers || f_in < 1 || f_in > 128 ||
      f_in > hidden)
    return -1;
  const void* w[kMaxLayers] = {w0, w1, w2, w3};
  const void* s[kMaxLayers] = {s0, s1, s2, s3};
  const void* lb[kMaxLayers] = {b0, b1, b2, b3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MLT_STEP(T, H)                                                     \
  launch_step<T, H>(make_args<T>(layers, f_in, n_rows, x, w, s, lb, wi, wr, \
                                 bias, c, h, feats, c_out, h_out),          \
                    st)
  if (dtype == 0 && hidden == 128) return MLT_STEP(float, 128);
  if (dtype == 0 && hidden == 256) return MLT_STEP(float, 256);
  if (dtype == 0 && hidden == 384) return MLT_STEP(float, 384);
  if (dtype == 0 && hidden == 512) return MLT_STEP(float, 512);
#undef MLT_STEP
  return -1;
}

// The bf16 step on tensor cores, at H = 128, 256, 384 and 512 (clusters of
// two blocks at 384 and 512): the arguments of mlt_policy_step but the
// dtype, every pointer but x on a 16-byte boundary. Returns a cudaError_t,
// or -1 for arguments without an instantiation.
extern "C" int mlt_policy_step_tc(
    int hidden, int layers, int f_in, int n_rows, const void* x,
    const void* w0, const void* s0, const void* b0, const void* w1,
    const void* s1, const void* b1, const void* w2, const void* s2,
    const void* b2, const void* w3, const void* s3, const void* b3,
    const void* wi, const void* wr, const void* bias, const void* c,
    const void* h, void* feats, void* c_out, void* h_out, void* stream) {
  if (layers < 1 || layers > kMaxLayers || f_in < 1 || f_in > 128 ||
      f_in > hidden)
    return -1;
  const void* w[kMaxLayers] = {w0, w1, w2, w3};
  const void* s[kMaxLayers] = {s0, s1, s2, s3};
  const void* lb[kMaxLayers] = {b0, b1, b2, b3};
  const StepArgs<__nv_bfloat16> args = make_args<__nv_bfloat16>(
      layers, f_in, n_rows, x, w, s, lb, wi, wr, bias, c, h, feats, c_out,
      h_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hidden == 128) return launch_step_tc<128>(args, st);
  if (hidden == 256) return launch_step_tc<256>(args, st);
  if (hidden == 384) return launch_step_tc<384>(args, st);
  if (hidden == 512) return launch_step_tc<512>(args, st);
  return -1;
}

// fused_policy_step_chunked: the step over [num_chunks * chunk] rows, chunk
// c with the weights of policy chunk_policy[c] of the [num_policies, ...]
// stacks (w_l [P, F_in, H], s_l / b_l [P, H] f32, wi / wr [P, H, 4H], bias
// [P, 4H]); a chunk of no policy is skipped, its rows NaN. tensor_core 1
// takes the bf16 tensor-core kernel (every pointer but x on a 16-byte
// boundary), 0 the float32 CUDA-core one (dtype 0). Returns a
// cudaError_t, or -1 for arguments without an instantiation.
extern "C" int mlt_policy_step_chunked(
    int tensor_core, int dtype, int hidden, int layers, int f_in,
    int num_chunks, int chunk, int num_policies, const void* chunk_policy,
    const void* x, const void* w0, const void* s0, const void* b0,
    const void* w1, const void* s1, const void* b1, const void* w2,
    const void* s2, const void* b2, const void* w3, const void* s3,
    const void* b3, const void* wi, const void* wr, const void* bias,
    const void* c, const void* h, void* feats, void* c_out, void* h_out,
    void* stream) {
  const long long n = static_cast<long long>(num_chunks) * chunk;
  if (layers < 1 || layers > kMaxLayers || f_in < 1 || f_in > 128 ||
      f_in > hidden || num_chunks <= 0 || chunk <= 0 || num_policies <= 0 ||
      n * hidden > 0x7fffffffLL)
    return -1;
  const int n_rows = static_cast<int>(n);
  const void* w[kMaxLayers] = {w0, w1, w2, w3};
  const void* s[kMaxLayers] = {s0, s1, s2, s3};
  const void* lb[kMaxLayers] = {b0, b1, b2, b3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
    if (dtype != 1) return -1;
    const StepArgs<__nv_bfloat16> args = make_args<__nv_bfloat16>(
        layers, f_in, n_rows, x, w, s, lb, wi, wr, bias, c, h, feats, c_out,
        h_out, chunk_policy, chunk, num_policies);
    if (hidden == 128) return launch_step_tc<128>(args, st);
    if (hidden == 256) return launch_step_tc<256>(args, st);
    if (hidden == 384) return launch_step_tc<384>(args, st);
    if (hidden == 512) return launch_step_tc<512>(args, st);
    return -1;
  }
#define MLT_STEP_CHUNKED(T, H)                                             \
  launch_step<T, H>(make_args<T>(layers, f_in, n_rows, x, w, s, lb, wi, wr, \
                                 bias, c, h, feats, c_out, h_out,           \
                                 chunk_policy, chunk, num_policies),        \
                    st)
  if (dtype == 0 && hidden == 128) return MLT_STEP_CHUNKED(float, 128);
  if (dtype == 0 && hidden == 256) return MLT_STEP_CHUNKED(float, 256);
  if (dtype == 0 && hidden == 384) return MLT_STEP_CHUNKED(float, 384);
  if (dtype == 0 && hidden == 512) return MLT_STEP_CHUNKED(float, 512);
#undef MLT_STEP_CHUNKED
  return -1;
}
