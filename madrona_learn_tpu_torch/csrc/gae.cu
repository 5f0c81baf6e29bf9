// K1: GAE reverse recurrence over the [T, N] trajectory store.
//
// Replaces madrona_learn_tpu/ops/pallas/gae.py:gae_pallas (_gae_kernel).
// The TPU kernel keeps a [T, 512] tile in VMEM and runs the recurrence per
// lane. Here one thread owns one agent column and walks t = T-1 .. 0 in
// registers; neighbouring threads own neighbouring agents, so every [T, N]
// row-major load and store coalesces. The ragged edge is masked (n < N)
// instead of padding N to a tile multiple.
//
// Bound on the H100: bytes. Each element is read once (rewards, values,
// dones) and written once (advantages): 13 bytes per element and a handful
// of flops, far below the card's flop/byte balance, so the kernel can only
// aim at one pass over device memory, which this layout gives.
//
// Done masking uses select (`dones[t] ? 0 : x`), as the reference twin does
// (ops/pallas/gae.py:92-93); the TPU kernel multiplies by notdones, which
// agrees for finite inputs. Every multiply and add is an explicit
// round-to-nearest intrinsic, so nvcc cannot contract them into FMAs: the
// result is then bitwise the same sequence of roundings as the plain
// PyTorch version's separate elementwise ops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gae_kernel(const float* __restrict__ rewards,
                           const float* __restrict__ values,
                           const uint8_t* __restrict__ dones,
                           const float* __restrict__ bootstrap,
                           float* __restrict__ advantages,
                           int steps, int n_agents, float gamma,
                           float gamma_lambda) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_agents) return;

  float next_adv = 0.0f;
  float next_val = bootstrap[n];
  for (int t = steps - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * n_agents + n;
    const float r = rewards[i];
    const float v = values[i];
    const bool done = dones[i] != 0;
    const float nv = done ? 0.0f : next_val;
    const float na = done ? 0.0f : next_adv;
    const float td = __fsub_rn(__fadd_rn(r, __fmul_rn(gamma, nv)), v);
    const float adv = __fadd_rn(td, __fmul_rn(gamma_lambda, na));
    advantages[i] = adv;
    next_adv = adv;
    next_val = v;
  }
}

}  // namespace

extern "C" int mlt_gae(const void* rewards, const void* values,
                       const void* dones, const void* bootstrap,
                       void* advantages, int steps, int n_agents,
                       float gamma, float gamma_lambda, void* stream) {
  constexpr int kThreads = 256;
  const int blocks = (n_agents + kThreads - 1) / kThreads;
  gae_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const float*>(values),
      static_cast<const uint8_t*>(dones),
      static_cast<const float*>(bootstrap), static_cast<float*>(advantages),
      steps, n_agents, gamma, gamma_lambda);
  return static_cast<int>(cudaGetLastError());
}
