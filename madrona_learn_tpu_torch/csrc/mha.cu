// mha: entity self-attention forward, [B, S, H, D] in place.
//
// Replaces madrona_learn_tpu/ops/pallas/attention.py:mha (_mha_kernel,
// through _mha_impl). The TPU kernel transposes q, k, v to [B*H, S, D],
// pads B*H to its 8-row block and computes one whole [S, S] score tile per
// (batch block, head) on the MXU. Both are layout choices for the TPU; here
// the kernels read and write [B, S, H, D] where it lies.
//
// Contract (the plain version is ops/cuda/mha.py:mha_reference): scores in
// f32, (q . k) * D^-0.5; keys at index valid_len or above take no part
// (the plain version gives them a -1e30 score, whose exponential is exactly
// 0 in f32); an f32 softmax over keys; P . V in f32; the output rounded to
// the storage type. Query rows at and past valid_len are computed like any
// other row (the caller slices them off).
//
// Both kernels compute each (b, h) problem by the same instruction sequence
// whatever B is and wherever it falls in a block (the tile depends on S, H,
// D and valid_len alone), so the rollout step (B = worlds) and the update
// pass (B = T x minibatch) agree bit for bit on equal inputs, which PPO's
// importance ratio needs.
//
// bfloat16, on tensor cores (mha_fwd_tc_kernel; ops/cuda/mha.py routes every
// bf16 call here). Bound on the H100: bytes. At the flagship's update
// shape, [131072, 16, 4, 32] with valid_len = 12, the kernel must move q
// and o whole and the 12 valid rows of k and v, 1.88 GB, about 0.56 ms at
// 3.35 TB/s; its products are ~13 GFLOP, ~0.013 ms on tensor cores. So the
// design moves each byte once, coalesced:
// - A block owns tile_b whole batch items with all H heads of each (tile_h
//   heads of one item where a whole item does not fit the block's shared
//   memory budget). Its q, k, v and o are then each one contiguous stretch
//   of [B, S, H, D], read into shared memory as bf16 by 16-byte cp.async in
//   the order they lie; key and value rows at and past valid_len are never
//   read. The staged rows keep their memory order, each (item, position)
//   group of tile_h rows padded by 16 bytes, so that the 8 rows of one
//   problem an ldmatrix reads fall in distinct banks.
// - One warp at a time owns 16 query rows of one (b, h) problem and runs
//   mma.sync.m16n8k16 (bf16 -> f32) with fragments loaded by ldmatrix
//   (.trans for V). S = Q . K^T over key tiles of 16; the softmax is online
//   in registers (row max and sum across each quad by shuffles, on scores
//   pre-scaled by D^-0.5 log2(e), exp2 on the special-function unit), so
//   S = 256 needs no [16, S] tile. A key at or past valid_len gets p = 0;
//   its fragment lanes, and those of query rows past S, read a 16-byte zero
//   chunk instead of memory.
// - P . V keeps p in f32 as the contract does: p = p_hi + p_mid + p_lo,
//   each bf16 (~24 bits together), three products per 16 keys into f32
//   accumulators. mha_flash.cu's two parts (~16 bits) miss the chip
//   check's per-element rule (2^-7 |plain|) at the flagship's 33.5M
//   outputs, where an output that nearly cancels shows their error; three
//   meet it as p in f32 does (tests/test_torch_mha_tc_numerics.py). The
//   extra products cost nothing that shows in a kernel bound by bytes.
//   out = acc / l is rounded once, written over the warp's own q rows in
//   shared memory, and the block stores its output as coalesced 16-byte
//   pieces.
//
// float32, on CUDA cores (mha_fwd_kernel), whose products tensor cores
// would round:
// - A block owns a tile of (batch, head) problems: tile_b batch items by
//   tile_h heads (tile_h == H whenever a whole batch item fits, so the
//   tile's keys are one contiguous stretch of memory). It stages the K and
//   V rows below valid_len of its problems in shared memory as f32, with
//   16-byte coalesced loads, once.
// - One thread owns one query row: the row of q and the D accumulators of
//   its output stay in registers. Consecutive threads own consecutive
//   query rows of one problem, so a warp reads the same key row of shared
//   memory at once (a broadcast); problems are padded apart by 4 floats so
//   that two problems in one warp read different banks.
// - The softmax is taken over chunks of 8 keys with a running maximum
//   (online softmax): each key and value row is read from shared memory
//   once per query row. The result differs from the plain two-pass
//   softmax by rounding only. Every FMA waits on a shared-memory read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kChunk = 8;           // keys per online-softmax step
constexpr int kPad = 4;             // floats between problems in shared memory
constexpr int kDefaultSmem = 48 * 1024;

using mlt::load16;
using mlt::store16;
using mlt::dot_row;

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int batch,
               int seq, int heads, int valid_len, int tile_b, int tile_h,
               float scale) {
  constexpr int kVec = 16 / sizeof(T);      // elements per 16-byte access
  constexpr int kVecPerRow = D / kVec;
  extern __shared__ float smem[];
  const int pstride = valid_len * D + kPad;
  float* ks = smem;
  float* vs = smem + tile_b * tile_h * pstride;

  const int h_tiles = heads / tile_h;
  const int b0 = (blockIdx.x / h_tiles) * tile_b;
  const int h0 = (blockIdx.x % h_tiles) * tile_h;
  const int nb = min(tile_b, batch - b0);

  // Stage the valid key / value rows: e runs over (bl, j, hl, vec) with the
  // vector fastest, the order in which they lie in memory.
  const int n_vec = nb * valid_len * tile_h * kVecPerRow;
  for (int e = threadIdx.x; e < n_vec; e += blockDim.x) {
    const int c = e % kVecPerRow;
    int r = e / kVecPerRow;
    const int hl = r % tile_h;
    r /= tile_h;
    const int j = r % valid_len;
    const int bl = r / valid_len;
    const size_t g =
        ((static_cast<size_t>(b0 + bl) * seq + j) * heads + h0 + hl) * D +
        c * kVec;
    const int s = (bl * tile_h + hl) * pstride + j * D + c * kVec;
    float tmp[kVec];
    load16(k + g, tmp);
#pragma unroll
    for (int i = 0; i < kVec; i += 4) store16(ks + s + i, tmp + i);
    load16(v + g, tmp);
#pragma unroll
    for (int i = 0; i < kVec; i += 4) store16(vs + s + i, tmp + i);
  }
  __syncthreads();

  // One query row per thread: r runs over (bl, hl, i) with i fastest.
  const int rows = nb * tile_h * seq;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int i = r % seq;
    const int p = r / seq;               // bl * tile_h + hl
    const int hl = p % tile_h;
    const int bl = p / tile_h;
    const size_t g =
        ((static_cast<size_t>(b0 + bl) * seq + i) * heads + h0 + hl) * D;

    float qr[D];
#pragma unroll
    for (int c = 0; c < kVecPerRow; ++c)
      load16(q + g + c * kVec, qr + c * kVec);

    const float* kp = ks + p * pstride;
    const float* vp = vs + p * pstride;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.0f;
    float m = -INFINITY;
    float l = 0.0f;

    for (int j0 = 0; j0 < valid_len; j0 += kChunk) {
      float s[kChunk];
      float cm = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = -INFINITY;
        if (j0 + jj < valid_len) {
          s[jj] = dot_row<D>(qr, kp + (j0 + jj) * D) * scale;
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
        if (j0 + jj < valid_len) {
          const float pj = expf(s[jj] - m_new);
          l += pj;
          const float* vr = vp + (j0 + jj) * D;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(vr + d);
            acc[d] = fmaf(pj, vv.x, acc[d]);
            acc[d + 1] = fmaf(pj, vv.y, acc[d + 1]);
            acc[d + 2] = fmaf(pj, vv.z, acc[d + 2]);
            acc[d + 3] = fmaf(pj, vv.w, acc[d + 3]);
          }
        }
      }
      m = m_new;
    }

    float out[D];
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = acc[d] / l;
#pragma unroll
    for (int c = 0; c < kVecPerRow; ++c)
      store16(o + g + c * kVec, out + c * kVec);
  }
}

// Problems per block: about kMaxThreads query rows, within the default 48 KB
// of shared memory unless a single problem needs more.
template <typename T, int D>
int launch_mha(const void* q, const void* k, const void* v, void* o,
               int batch, int seq, int heads, int valid_len, float scale,
               cudaStream_t stream) {
  const size_t per_problem =
      2 * static_cast<size_t>(valid_len * D + kPad) * sizeof(float);
  int problems = kMaxThreads / seq > 1 ? kMaxThreads / seq : 1;
  const int fit = static_cast<int>(kDefaultSmem / per_problem);
  if (fit < problems) problems = fit > 1 ? fit : 1;
  int tile_b = 1, tile_h = 1;
  if (problems >= heads) {
    tile_h = heads;
    tile_b = problems / heads;
  } else {
    for (int t = problems; t >= 1; --t)
      if (heads % t == 0) {
        tile_h = t;
        break;
      }
  }
  const size_t smem = per_problem * tile_b * tile_h;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows = tile_b * tile_h * seq;
  int threads = (rows + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long blocks =
      static_cast<long long>((batch + tile_b - 1) / tile_b) * (heads / tile_h);
  mha_fwd_kernel<T, D><<<static_cast<unsigned>(blocks), threads, smem,
                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), batch, seq, heads,
      valid_len, tile_b, tile_h, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------ bf16 on tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;                // warps a block
constexpr int kTcSmemBudget = 48 * 1024;   // shared memory a block aims at

// Bytes of one (item, position) group of a block's staged q, k or v rows:
// the tile_h heads of that position, D bf16 each, then 16 bytes of padding.
// The group is an odd number of 16-byte chunks, so the 8 rows of one
// problem an ldmatrix reads (a group apart) fall in distinct banks.
__host__ __device__ constexpr int tc_group_bytes(int tile_h, int d) {
  return tile_h * d * 2 + 16;
}

// Shared memory of a block: the staged q (seq groups an item), k and v
// (valid_len groups an item each), then a 16-byte zero chunk.
constexpr int tc_smem_bytes(int tile_b, int tile_h, int d, int seq,
                            int valid_len) {
  return tile_b * tc_group_bytes(tile_h, d) * (seq + 2 * valid_len) + 16;
}

// Two f32 as three bf16 pairs, hi + mid + lo (~24 bits together): hi =
// round(x), mid = round(x - hi), lo = round(x - hi - mid), each difference
// exact in f32.
__device__ __forceinline__ void split3_bf16x2(float a, float b,
                                              uint32_t (&part)[3]) {
  part[0] = mlt::pack_bf16x2(a, b);
  const float ra = a - mlt::bf16_lo(part[0]), rb = b - mlt::bf16_hi(part[0]);
  part[1] = mlt::pack_bf16x2(ra, rb);
  part[2] = mlt::pack_bf16x2(ra - mlt::bf16_lo(part[1]),
                             rb - mlt::bf16_hi(part[1]));
}

// The bf16 forward (see the header). scale_log2 is D^-0.5 log2(e).
template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
    mha_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int batch, int seq, int heads, int valid_len,
                      int tile_b, int tile_h, float scale_log2) {
  constexpr int kChunks = D / 8;   // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t smem_tc[];
  uint8_t* smem = smem_tc;
  const int group = tc_group_bytes(tile_h, D);
  const uint32_t q_s = mlt::smem_u32(smem);
  const uint32_t k_s = q_s + tile_b * seq * group;
  const uint32_t v_s = k_s + tile_b * valid_len * group;
  const uint32_t zero_s = v_s + tile_b * valid_len * group;

  const int h_tiles = heads / tile_h;
  const int b0 = (blockIdx.x / h_tiles) * tile_b;
  const int h0 = (blockIdx.x % h_tiles) * tile_h;
  const int nb = min(tile_b, batch - b0);
  const int tid = threadIdx.x;

  // The e-th 16-byte chunk of the block's rows j < rows of each item, in
  // the order they lie in memory (chunk, then head, position, item): its
  // element offset in [B, S, H, D] and its byte offset in a staged tile.
  auto chunk = [&](int e, int rows, size_t& g, uint32_t& s) {
    const int c = e % kChunks;
    const int r = e / kChunks;
    const int hl = r % tile_h;
    const int grp = r / tile_h;   // item * rows + position
    const int j = grp % rows, bl = grp / rows;
    g = ((static_cast<size_t>(b0 + bl) * seq + j) * heads + h0 + hl) * D +
        c * 8;
    s = grp * group + hl * D * 2 + c * 16;
  };
  size_t g;
  uint32_t s;
  for (int e = tid; e < nb * seq * tile_h * kChunks; e += kTcWarps * 32) {
    chunk(e, seq, g, s);
    mlt::cp_async16(q_s + s, q + g, true);
  }
  for (int e = tid; e < nb * valid_len * tile_h * kChunks;
       e += kTcWarps * 32) {
    chunk(e, valid_len, g, s);
    mlt::cp_async16(k_s + s, k + g, true);
    mlt::cp_async16(v_s + s, v + g, true);
  }
  if (tid == 0)
    *reinterpret_cast<uint4*>(smem + (zero_s - q_s)) = make_uint4(0, 0, 0, 0);
  mlt::cp_async_commit();
  mlt::cp_async_wait<0>();
  __syncthreads();

  // Work item w: query tile w % q_tiles of problem w / q_tiles (item-major,
  // then head), one warp each in turn.
  const int warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int q_tiles = (seq + 15) / 16;
  const int k_tiles = (valid_len + 15) / 16;
  for (int w = warp; w < nb * tile_h * q_tiles; w += kTcWarps) {
    const int qt = w % q_tiles, p = w / q_tiles;
    const int hl = p % tile_h, bl = p / tile_h;
    // Row r of this problem's q (k, v) is r groups on from q_p (k_p, v_p).
    const uint32_t q_p = q_s + bl * seq * group + hl * D * 2;
    const uint32_t k_p = k_s + bl * valid_len * group + hl * D * 2;
    const uint32_t v_p = v_s + bl * valid_len * group + hl * D * 2;

    // Q's A fragments, by k16 step; rows past S read the zero chunk.
    uint32_t qf[D / 16][4];
    const int qr = qt * 16 + lane % 16;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mlt::ldmatrix_x4(qf[kk], qr < seq ? q_p + qr * group +
                                              (2 * kk + lane / 16) * 16
                                        : zero_s);

    // Rows g8 (e = 0) and g8 + 8 (e = 1): running max m (scaled by
    // log2(e)), this lane's part of the sum l, and acc[n] the output's
    // columns 8 n + 2 t4 (+ 1) in the C layout.
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;

    for (int kt = 0; kt < k_tiles; ++kt) {
      // S = Q . K^T over 16 keys: sc[n] holds keys 8 n + 2 t4 (+ 1).
      float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const int kr = kt * 16 + lane % 8 + (lane / 16) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4];
        mlt::ldmatrix_x4(kf, kr < valid_len ? k_p + kr * group +
                                                  (2 * kk + (lane / 8) % 2) *
                                                      16
                                            : zero_s);
        mlt::mma_m16n8k16(sc[0], qf[kk], kf[0], kf[1]);
        mlt::mma_m16n8k16(sc[1], qf[kk], kf[2], kf[3]);
      }
      // The online softmax; p = 2^(s scale log2(e) - m), 0 past valid_len.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[n][2 * e + c];
            x = kt * 16 + 8 * n + 2 * t4 + c < valid_len ? x * scale_log2
                                                          : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[e], mx);
        const float alpha = mlt::ex2(m[e] - m_new);   // 0 on the first tile
        m[e] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[n][2 * e + c];
            x = mlt::ex2(x - m_new);
            sum += x;
          }
        l[e] = l[e] * alpha + sum;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][2 * e] *= alpha;
          acc[n][2 * e + 1] *= alpha;
        }
      }
      // acc += P . V in f32: P as three bf16 A fragments (hi, mid, lo:
      // A element (row, key) of the C layout's pair), V's B fragments by
      // ldmatrix.trans (keys past valid_len read zeros).
      uint32_t pf[3][4], part[3];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        split3_bf16x2(sc[a / 2][2 * (a % 2)], sc[a / 2][2 * (a % 2) + 1],
                      part);
#pragma unroll
        for (int h = 0; h < 3; ++h) pf[h][a] = part[h];
      }
      const int vr = kt * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t vf[4];
        mlt::ldmatrix_x4_trans(
            vf, vr < valid_len ? v_p + vr * group + (2 * nd + lane / 16) * 16
                               : zero_s);
#pragma unroll
        for (int h = 0; h < 3; ++h) {
          mlt::mma_m16n8k16(acc[2 * nd], pf[h], vf[0], vf[1]);
          mlt::mma_m16n8k16(acc[2 * nd + 1], pf[h], vf[2], vf[3]);
        }
      }
    }

    // out = acc / l, rounded once, over this warp's own q rows.
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
      const int row = qt * 16 + g8 + 8 * e;
      if (row >= seq) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(smem + (q_p - q_s) + row * group +
                                     n * 16 + t4 * 4) =
            mlt::pack_bf16x2(acc[n][2 * e] / l[e], acc[n][2 * e + 1] / l[e]);
    }
  }
  __syncthreads();

  // The output leaves in the order it lies in memory, 16 bytes a thread.
  for (int e = tid; e < nb * seq * tile_h * kChunks; e += kTcWarps * 32) {
    chunk(e, seq, g, s);
    *reinterpret_cast<uint4*>(o + g) =
        *reinterpret_cast<const uint4*>(smem + s);
  }
}

// The tile: whole items (tile_h = H) as many as the budget holds, else one
// item's heads in the largest group of them that fits (at least one head:
// at S = valid_len = 256, D = 64 that is 110 KB). It depends on S, H, D and
// valid_len alone, never on B.
template <int D>
int launch_mha_tc(const void* q, const void* k, const void* v, void* o,
                  int batch, int seq, int heads, int valid_len,
                  float scale_log2, cudaStream_t stream) {
  int tile_b = 1, tile_h = heads;
  const int item = tc_smem_bytes(1, heads, D, seq, valid_len) - 16;
  if (item + 16 <= kTcSmemBudget) {
    tile_b = (kTcSmemBudget - 16) / item;
  } else {
    tile_h = 1;
    for (int t = heads; t > 1; --t)
      if (heads % t == 0 &&
          tc_smem_bytes(1, t, D, seq, valid_len) <= kTcSmemBudget) {
        tile_h = t;
        break;
      }
  }
  const int smem = tc_smem_bytes(tile_b, tile_h, D, seq, valid_len);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks =
      static_cast<long long>((batch + tile_b - 1) / tile_b) *
      (heads / tile_h);
  mha_fwd_tc_kernel<D><<<static_cast<unsigned>(blocks), kTcWarps * 32, smem,
                         stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), batch, seq, heads,
      valid_len, tile_b, tile_h, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel is built for float32 alone:
// bfloat16 takes mlt_mha_fwd_tc). Returns a cudaError_t, or -1 for
// arguments without an instantiation.
extern "C" int mlt_mha_fwd(int dtype, int head_dim, const void* q,
                           const void* k, const void* v, void* o, int batch,
                           int seq, int heads, int valid_len, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_MHA(T, D)                                                       \
  return launch_mha<T, D>(q, k, v, o, batch, seq, heads, valid_len, scale, s)
  if (dtype == 0 && head_dim == 16) MLT_MHA(float, 16);
  if (dtype == 0 && head_dim == 32) MLT_MHA(float, 32);
  if (dtype == 0 && head_dim == 64) MLT_MHA(float, 64);
#undef MLT_MHA
  return -1;
}

// The bf16 tensor-core forward; scale_log2 is D^-0.5 log2(e). Returns a
// cudaError_t, or -1 for arguments without an instantiation.
extern "C" int mlt_mha_fwd_tc(int head_dim, const void* q, const void* k,
                              const void* v, void* o, int batch, int seq,
                              int heads, int valid_len, float scale_log2,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_MHA_TC(D)                                                     \
  return launch_mha_tc<D>(q, k, v, o, batch, seq, heads, valid_len,       \
                          scale_log2, s)
  if (head_dim == 16) MLT_MHA_TC(16);
  if (head_dim == 32) MLT_MHA_TC(32);
  if (head_dim == 64) MLT_MHA_TC(64);
#undef MLT_MHA_TC
  return -1;
}
