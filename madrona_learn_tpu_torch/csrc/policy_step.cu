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
// Design here (layout and product in common.cuh):
// - A block owns kRows batch rows. Their activations stay in shared memory
//   (f32, [kRows][H]) from the input tile through every layer to the LSTM
//   cell; only x, c and h are read and feats, c', h' written.
// - x [N, F] is read in place with row stride F (F <= 128): no padding of
//   the feature axis in device memory. Rows past N are zero-filled in
//   shared memory and never written.
// - The weights (1 MiB of Wi + Wr at H = 256 in bf16, more than a block's
//   shared memory) are read through L2 every step, as csrc/lstm.cu reads
//   Wr; a block reuses each element for its kRows rows.
// - Products are f32 FMA loops over storage-type operands converted
//   exactly to f32 (bf16 operands, f32 accumulation).
// - LayerNorm needs row sums over all H units, which one row group's 64
//   threads (two warps) own: warp shuffles, then one exchange of the two
//   warps' partials through shared memory.
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
// Bound on the H100: at [16384, 3 -> 256 -> 256, LSTM 256] bf16 the step
// does 19.35 GFLOP, 89% of it in the two [256, 1024] products, against
// ~43 MB of bytes: bound by operations on the tensor cores (0.020 ms).
// This first version runs the products on CUDA cores, so it is bound by
// FMA issue; mma.sync / wgmma tiles are the later step.

#include "common.cuh"

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
};

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

  const int ug = threadIdx.x % kUnitGroups;
  const int rg = threadIdx.x / kUnitGroups;
  const int u0 = ug * UPT;
  const int row_base = rg * RPT;
  const int block_row = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_row_tile<T>(act_s, p.x, block_row, p.n_rows, p.f_in);
  load_row_tile<T>(h_s, p.h, block_row, p.n_rows, H);
  __syncthreads();

  int k_in = p.f_in;
  for (int l = 0; l < p.layers; ++l) {
    float acc[RPT][1][UPT];
    row_tile_product<T, 1, RPT, UPT>(act_s, k_in, p.w[l], H, 0, row_base, u0,
                                     acc);
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
      scale[j] = round_to<T>(p.ln_scale[l][u0 + j]);
      lbias[j] = round_to<T>(p.ln_bias[l][u0 + j]);
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
  row_tile_product<T, 4, RPT, UPT>(act_s, H, p.wi, G4, H, row_base, u0, acc);
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < UPT; ++j) acc[i][g][j] = round_to<T>(acc[i][g][j]);
  row_tile_fma<T, 4, RPT, UPT>(h_s, H, p.wr, G4, H, row_base, u0, acc);

  float b[4][UPT];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < UPT; ++j) b[g][j] = to_f(p.bias[g * H + u0 + j]);

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int n = block_row + row_base + i;
    if (n >= p.n_rows) continue;
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
  const int blocks = (args.n_rows + kRows - 1) / kRows;
  policy_step_kernel<T, H><<<blocks, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
StepArgs<T> make_args(int layers, int f_in, int n_rows, const void* x,
                      const void* const* w, const void* const* s,
                      const void* const* lb, const void* wi, const void* wr,
                      const void* bias, const void* c, const void* h,
                      void* feats, void* c_out, void* h_out) {
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
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; layers 1..4, each (w_l, s_l, b_l), the
// unused ones null. Returns a cudaError_t, or -1 for arguments without an
// instantiation.
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
  if (dtype == 1 && hidden == 128) return MLT_STEP(__nv_bfloat16, 128);
  if (dtype == 1 && hidden == 256) return MLT_STEP(__nv_bfloat16, 256);
#undef MLT_STEP
  return -1;
}
