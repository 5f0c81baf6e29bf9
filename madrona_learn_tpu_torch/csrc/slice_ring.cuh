// The weight-slice ring and the operand-tile layouts shared by the bf16 (and
// f16) tensor-core kernels that stream their weights from L2 every step:
// lstm.cu's and gru.cu's backward recurrences and policy_step.cu's rollout
// step.
//
// A weight larger than a block's shared memory (Wr [H, 4H] is 512 KiB in
// bf16 at H = 256) streams through a ring of S stages, one 64-deep slice
// of it a stage, in a fixed order that the kernel's issue function gives.
// Thread 0 fills a stage by TMA (the stage's `full` mbarrier completes on
// the bytes); every warpgroup runs its wgmma on the stage; once a warp's
// wgmma has retired the stage, the warp arrives on its `empty` barrier, and
// thread 0 refills the stage when every warp has. The order is the same in
// every phase and step, so the ring prefetches across them.
//
// The block's own operands are wgmma B tiles: K-major [R][K] bf16 in
// [K / 64] subtiles of [R][64] with the 128-byte swizzle (kmaj_off), so a
// subtile is R * 128 bytes and every subtile starts on a 1024-byte
// boundary.
//
// As in mma.cuh, everything is `static` inside `mlt`: nvcc names each
// kernel's launch stub from the global scope.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace mlt {

constexpr int kTcK = 64;             // depth of a weight slice: 128 bytes
constexpr int kSmemLimit = 232448;   // shared memory a block can use

constexpr int min_c(int a, int b) { return a < b ? a : b; }

// Blocks of a cluster that split the units of the tensor-core recurrences
// (kSplit), lstm.cu's and gru.cu's forwards and backwards: one at
// H = 128 and 256; two at H = 384 and 512 (lstm.cu, "Wider layers", at
// its dispatch), each owning H / 2 units of the same rows.
template <int H>
constexpr int kTcSplit = H > 256 ? 2 : 1;

// The bits of an element of E (__nv_bfloat16 or __half), for a store into
// another block's shared memory.
template <typename E>
static __device__ __forceinline__ uint16_t elem_bits(E v) {
  return *reinterpret_cast<const uint16_t*>(&v);
}

// Byte offset of element (n, k) of a K-major [R][K] operand tile.
template <int R>
static __device__ __forceinline__ uint32_t kmaj_off(int n, int k) {
  return (k / 64) * (R * 128) + n * 128 + ((((k % 64) / 8) ^ (n % 8)) * 16) +
         (k % 8) * 2;
}

// Byte offset of element (n, u) of a [R][H] tile, 16-byte chunks swizzled
// by row so that a warp's reads of four rows hit distinct banks.
template <int H>
static __device__ __forceinline__ uint32_t row_off(int n, int u) {
  return n * H * 2 + (((u / 8) ^ (n % 8)) * 16) + (u % 8) * 2;
}

// The element of type E (__nv_bfloat16 or __half) at p, in f32.
template <typename E>
static __device__ __forceinline__ float ld_elem(const uint8_t* p) {
  return to_f(*reinterpret_cast<const E*>(p));
}

// S stages of stage_bytes each from `base` (1024-byte aligned); `total`
// slices over the kernel, `q` the next one to consume. The barriers are the
// kernel's __shared__ arrays.
template <int S>
struct SliceRing {
  uint64_t* full;
  uint64_t* empty;
  uint32_t base;
  uint32_t stage_bytes;
  int total;
  int q;

  // Thread 0, before the block's first __syncthreads: the barriers, each
  // `empty` completing when all `warps` warps have arrived.
  __device__ __forceinline__ void init(int warps) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], warps);
    }
    mbar_fence_init();
  }

  // Thread 0: slice p into its stage. issue(p, dst, bar) issues the TMA
  // loads of slice p, stage_bytes in all, completing on bar.
  template <class Issue>
  __device__ __forceinline__ void fill(int p, Issue& issue) {
    const int s = p % S;
    mbar_arrive_expect_tx(&full[s], stage_bytes);
    issue(p, base + s * stage_bytes, &full[s]);
  }

  // Thread 0, after the barriers are initialised: the first S slices.
  template <class Issue>
  __device__ __forceinline__ void prime(Issue& issue) {
    for (int p = 0; p < min(S, total); ++p) fill(p, issue);
  }

  // Wait until slice q has arrived; the address of its stage.
  __device__ __forceinline__ uint32_t acquire() const {
    const int s = q % S;
    mbar_wait(&full[s], (q / S) & 1);
    return base + s * stage_bytes;
  }

  // Slice q's wgmma is committed and slice q - 1's has retired
  // (wgmma_wait<1>): each warp releases q - 1's stage, thread 0 refills it
  // with slice q - 1 + S once every warp has, and q moves on.
  template <class Issue>
  __device__ __forceinline__ void release(Issue& issue) {
    if (q > 0) {
      const int sp = (q - 1) % S;
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(&empty[sp]);
      if (threadIdx.x == 0 && q - 1 + S < total) {
        mbar_wait(&empty[sp], ((q - 1) / S) & 1);
        fill(q - 1 + S, issue);
      }
      __syncwarp();
    }
    ++q;
  }
};

// acc (+)= A . B over the ring's next slice (64 deep), then the slice's
// release: A is this warpgroup's 64 rows of the stage, a_off bytes into it,
// K-major [64][64] (kTransA 0: the k16 steps 32 bytes apart) or MN-major
// [64 k][64 rows] as a TMA box of a row-major weight lands (kTransA 1: 2048
// bytes apart); B the K-major [R][64] subtile at b; both of element type E
// (bf16 or f16). Every warpgroup issues every product: one skipped by some
// makes ptxas serialize all wgmmas.
template <int R, int kTransA, typename E = __nv_bfloat16, int S, class Issue>
static __device__ __forceinline__ void ring_product(SliceRing<S>& ring,
                                                    Issue& issue,
                                                    float (&acc)[R / 2],
                                                    uint32_t a_off,
                                                    uint32_t b, bool fresh) {
  const uint32_t a = ring.acquire() + a_off;
#pragma unroll
  for (int i = 0; i < R / 2; ++i) wgmma_fence_operand(acc[i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTcK / 16; ++kk)
    wgmma_ss<R, kTransA, E>(
        acc,
        wgmma_desc(a + kk * (kTransA ? 2048 : 32), kTransA ? 8192 : 16, 1024,
                   128),
        wgmma_desc(b + kk * 32, 16, 1024, 128), fresh && kk == 0 ? 0 : 1);
  wgmma_commit();
  wgmma_wait<1>();
#pragma unroll
  for (int i = 0; i < R / 2; ++i) wgmma_fence_operand(acc[i]);
  ring.release(issue);
}

}  // namespace mlt
