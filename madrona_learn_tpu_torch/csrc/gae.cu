// gae: GAE reverse recurrence over the [T, N] trajectory store.
//
// Replaces madrona_learn_tpu/ops/pallas/gae.py:gae_pallas (_gae_kernel).
// The TPU kernel keeps a whole [T, 512] tile in VMEM and runs the
// recurrence per lane over its sequential grid. Nothing of that layout
// carries over: Hopper's blocks run side by side, and what a block holds is
// bounded by its shared memory.
//
// Bound on the H100: bytes. Each element is read once (rewards, values,
// dones) and written once (advantages): 13 bytes per element and a handful
// of flops, far below the card's flop/byte balance. The floor in practice
// is a launch and one device-memory round trip, so the design aims at
// keeping every SM busy and all loads in flight at once:
//
// - A block owns kCols agent columns (one thread each), so N = 16384 gives
//   16384 / kCols blocks, enough for all 132 SMs.
// - Time is taken in chunks of kTc steps from the end (the last chunk in
//   order, the first in time, may be partial), so any T works. A chunk's
//   [kTc, kCols] tiles of rewards, values and dones are staged in shared
//   memory by cp.async, the whole block loading 16-byte pieces with
//   neighbouring threads on neighbouring columns; the next chunk's loads
//   are issued before the current chunk's recurrence runs (two buffers).
//   Where a block's tile is ragged or not 16-byte aligned (N % 16 != 0),
//   the block copies element by element instead (cp.async of 4 bytes, the
//   dones bytes by plain loads).
// - Each thread runs its column's recurrence from shared memory and writes
//   its advantage directly: a warp's 32 stores of one step are one 128-byte
//   line.
//
// The recurrence is the parent's, step for step: t = T-1 .. 0 in order, no
// scan over T. Done masking uses select (`dones[t] ? 0 : x`), as the
// reference twin does (ops/pallas/gae.py:92-93); the TPU kernel multiplies
// by notdones, which agrees for finite inputs. Every multiply and add is an
// explicit round-to-nearest intrinsic, so nvcc cannot contract them into
// FMAs: the result is bitwise the same sequence of roundings as the plain
// PyTorch version's separate elementwise ops, whatever kTc and kCols are.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace mlt;

// Shared memory of one block: rewards and values [2][kTc][kCols] f32, then
// dones [2][kTc][kCols] bytes.
template <int kTc, int kCols>
constexpr int gae_smem_bytes() {
  return 2 * kTc * kCols * (4 + 4 + 1);
}

template <int kTc, int kCols>
__global__ void __launch_bounds__(kCols) gae_kernel(
    const float* __restrict__ rewards, const float* __restrict__ values,
    const uint8_t* __restrict__ dones, const float* __restrict__ bootstrap,
    float* __restrict__ advantages, int steps, int n_agents, float gamma,
    float gamma_lambda, bool aligned) {
  static_assert(kCols % 32 == 0 && kTc % 4 == 0, "tile shape");
  constexpr int kTile = kTc * kCols;
  extern __shared__ __align__(16) uint8_t smem[];
  float* r_s = reinterpret_cast<float*>(smem);
  float* v_s = r_s + 2 * kTile;
  uint8_t* d_s = reinterpret_cast<uint8_t*>(v_s + 2 * kTile);

  const int c = threadIdx.x;
  const int n0 = blockIdx.x * kCols;
  const int n = n0 + c;
  const bool in = n < n_agents;
  const bool vec = aligned && n0 + kCols <= n_agents;
  const int chunks = (steps + kTc - 1) / kTc;

  // Chunk k holds times t0 + row, row < kTc, t0 = T - (k + 1) kTc; rows
  // with t < 0 (in the last chunk only) are zeros and never read.
  auto stage = [&](int k) {
    const int t0 = steps - (k + 1) * kTc;
    float* r_b = r_s + (k & 1) * kTile;
    float* v_b = v_s + (k & 1) * kTile;
    uint8_t* d_b = d_s + (k & 1) * kTile;
    if (vec) {
      for (int e = c; e < kTile / 4; e += kCols) {
        const int row = e / (kCols / 4);
        const int col = 4 * (e % (kCols / 4));
        const int t = t0 + row;
        const size_t g = static_cast<size_t>(max(t, 0)) * n_agents + n0 + col;
        cp_async16(smem_u32(r_b + row * kCols + col), rewards + g, t >= 0);
        cp_async16(smem_u32(v_b + row * kCols + col), values + g, t >= 0);
      }
      for (int e = c; e < kTile / 16; e += kCols) {
        const int row = e / (kCols / 16);
        const int col = 16 * (e % (kCols / 16));
        const int t = t0 + row;
        const size_t g = static_cast<size_t>(max(t, 0)) * n_agents + n0 + col;
        cp_async16(smem_u32(d_b + row * kCols + col), dones + g, t >= 0);
      }
    } else {
      uint8_t d[kTc];
#pragma unroll
      for (int row = 0; row < kTc; ++row) {
        const int t = t0 + row;
        const bool ok = in && t >= 0;
        const size_t g = ok ? static_cast<size_t>(t) * n_agents + n : 0;
        cp_async4(smem_u32(r_b + row * kCols + c), rewards + g, ok);
        cp_async4(smem_u32(v_b + row * kCols + c), values + g, ok);
        d[row] = ok ? dones[g] : 0;
      }
#pragma unroll
      for (int row = 0; row < kTc; ++row) d_b[row * kCols + c] = d[row];
    }
    cp_async_commit();
  };

  float next_adv = 0.0f;
  float next_val = in ? bootstrap[n] : 0.0f;
  stage(0);
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      stage(k + 1);
    } else {
      cp_async_commit();  // an empty group keeps the wait below uniform
    }
    cp_async_wait<1>();
    __syncthreads();
    const int t0 = steps - (k + 1) * kTc;
    const float* r_b = r_s + (k & 1) * kTile;
    const float* v_b = v_s + (k & 1) * kTile;
    const uint8_t* d_b = d_s + (k & 1) * kTile;
#pragma unroll
    for (int row = kTc - 1; row >= 0; --row) {
      if (t0 + row >= 0) {
        const float r = r_b[row * kCols + c];
        const float v = v_b[row * kCols + c];
        const bool done = d_b[row * kCols + c] != 0;
        const float nv = done ? 0.0f : next_val;
        const float na = done ? 0.0f : next_adv;
        const float td = __fsub_rn(__fadd_rn(r, __fmul_rn(gamma, nv)), v);
        const float adv = __fadd_rn(td, __fmul_rn(gamma_lambda, na));
        if (in) {
          advantages[static_cast<size_t>(t0 + row) * n_agents + n] = adv;
        }
        next_adv = adv;
        next_val = v;
      }
    }
    __syncthreads();  // the buffer is refilled by the next iteration's stage
  }
}

template <int kTc, int kCols>
int launch(const void* rewards, const void* values, const void* dones,
           const void* bootstrap, void* advantages, int steps, int n_agents,
           float gamma, float gamma_lambda, cudaStream_t stream) {
  constexpr int smem = gae_smem_bytes<kTc, kCols>();
  if (smem > 48 * 1024) {
    const int err = set_smem(gae_kernel<kTc, kCols>, smem);
    if (err != 0) return err;
  }
  const auto on16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool aligned = n_agents % 16 == 0 && on16(rewards) &&
                       on16(values) && on16(dones);
  const int blocks = (n_agents + kCols - 1) / kCols;
  gae_kernel<kTc, kCols><<<blocks, kCols, smem, stream>>>(
      static_cast<const float*>(rewards), static_cast<const float*>(values),
      static_cast<const uint8_t*>(dones),
      static_cast<const float*>(bootstrap), static_cast<float*>(advantages),
      steps, n_agents, gamma, gamma_lambda, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// steps_per_chunk in {8, 16, 32} and columns in {32, 64, 128} (the sweep
// of chip_smoke.py; ops/cuda/gae.py hands the kept pair). Returns a
// cudaError_t, or -1 for a pair that is not built.
extern "C" int mlt_gae(const void* rewards, const void* values,
                       const void* dones, const void* bootstrap,
                       void* advantages, int steps, int n_agents,
                       float gamma, float gamma_lambda, int steps_per_chunk,
                       int columns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLT_GAE(TC, COLS)                                                  \
  if (steps_per_chunk == TC && columns == COLS)                            \
    return launch<TC, COLS>(rewards, values, dones, bootstrap, advantages, \
                            steps, n_agents, gamma, gamma_lambda, s)
  MLT_GAE(8, 32);
  MLT_GAE(8, 64);
  MLT_GAE(8, 128);
  MLT_GAE(16, 32);
  MLT_GAE(16, 64);
  MLT_GAE(16, 128);
  MLT_GAE(32, 32);
  MLT_GAE(32, 64);
  MLT_GAE(32, 128);
#undef MLT_GAE
  return -1;
}
