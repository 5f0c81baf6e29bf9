// Tensor-core helpers shared by the bf16 kernels (and the f16 instances of
// grouped_matmul and the LSTM backward): Hopper's warpgroup wgmma (A from
// shared memory or from registers, B from shared memory by descriptor), TMA
// loads completing on mbarriers and the host encoding of their tensor maps,
// ldmatrix and cp.async with zero-fill, bf16 / f16 pair packing, and the
// cluster barrier and distributed shared-memory stores of a cluster of
// blocks.
//
// Everything here is `static` inside `mlt` rather than in an unnamed
// namespace: nvcc names each kernel's launch stub from the global scope, so
// a header included by a .cu file with its own unnamed namespace must not
// open another (see weight_grad.cuh).
//
// Register layouts, for lane l of a warp, g = l / 4, t = l % 4 (the
// mma.m16n8k16 layouts, which wgmma keeps for each warp's 16 rows):
// - A (16 x 16, row-major): a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1],
//   a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9];
// - C (16 x 8 j): c[4j .. 4j+1] = C[g][8j + 2t, +1], c[4j+2 ..] = C[g+8][..].
// Each 32-bit A register holds two bf16, the lower column in the low half.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mlt {

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two f32 rounded to bf16 (round to nearest even), lo in the low half.
static __device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The same for f16.
static __device__ __forceinline__ uint32_t pack_f16x2(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 of a packed pair as f32 (exact).
static __device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
static __device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// 2^x on the special-function unit (ex2.approx, 2 ulp; subnormal results
// flush to 0).
static __device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------ ldmatrix, cp.async

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, and r[i] receives its fragment:
// lane l holds row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1.
static __device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                                   uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same four matrices transposed: r[i] receives lane l's fragment of
// matrix i's transpose, rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4 (a
// row-major [k][n] tile read as mma.sync's "col" B operand).
static __device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                         uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b on one warp's tensor cores, mma.sync m16n8k16, bf16 -> f32:
// a the 16 x 16 A fragment, b0 / b1 the 16 x 8 B fragment (B[2t .. 2t + 1]
// and B[2t + 8 .. 2t + 9] of column l / 4), d in the C layout above.
static __device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                                    const uint32_t (&a)[4],
                                                    uint32_t b0,
                                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; zeros instead when !valid
// (the source is then not read).
static __device__ __forceinline__ void cp_async16(uint32_t dst,
                                                  const void* src,
                                                  bool valid) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
      "l"(src), "r"(valid ? 16 : 0)
      : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros instead when !valid.
static __device__ __forceinline__ void cp_async4(uint32_t dst,
                                                 const void* src,
                                                 bool valid) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
      "l"(src), "r"(valid ? 4 : 0)
      : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- mbarrier

static __device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the initialized barriers visible to the async (TMA) proxy.
static __device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more bytes of transactions this phase.
static __device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                             uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Arrive once (no transactions).
static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Block until the phase of this parity has completed.
static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------- TMA

// One box of a 3-D tensor map into shared memory (1024-byte aligned for the
// 128-byte swizzle), completing `bar`'s transactions. Coordinates are
// innermost first; out-of-bounds elements arrive as zeros.
static __device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c0,
                                                   int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (each stored in 16-byte units) and the swizzle of the tile, 128,
// 64 or 32 bytes (layout types 1, 2, 3). The tile starts on a multiple of 8
// rows of the swizzle width (base offset 0).
static __device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr,
                                                      uint32_t lbo,
                                                      uint32_t sbo,
                                                      int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2
                                                                          : 3;
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) | (layout << 62);
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
static __device__ __forceinline__ void wgmma_fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d = A . B + (accumulate ? d : 0), m64n128k16, bf16 -> f32; A K-major
// (kTransA 0) or MN-major (kTransA 1) and B MN-major (tnspB 1), both read
// from shared memory through their descriptors. Thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4)
// (+ 1) in d[4 j .. 4 j + 3] (the mma.sync C layout).
#define MLT_WGMMA_M64N128K16(TYPES)                                        \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %66, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPES " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                          \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                          \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                          \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                          \
      "%56, %57, %58, %59, %60, %61, %62, %63"                            \
      "}, %64, %65, p, 1, 1, %67, 1;\n"                                   \
      "}\n"                                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                \
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA))

template <int kTransA>
static __device__ __forceinline__ void wgmma_m64n128k16_xn(float (&d)[64],
                                                           uint64_t da,
                                                           uint64_t db,
                                                           int accumulate) {
  MLT_WGMMA_M64N128K16("bf16.bf16");
}

// The same product with f16 operands (f32 accumulators).
template <int kTransA>
static __device__ __forceinline__ void wgmma_m64n128k16_xn_f16(
    float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  MLT_WGMMA_M64N128K16("f16.f16");
}

#undef MLT_WGMMA_M64N128K16

// d = A . B + (accumulate ? d : 0), m64n64k16, bf16 -> f32; A and B both
// K-major (tnspA 0, tnspB 0), both read from shared memory through their
// descriptors; d in the C layout of wgmma_rs below.
static __device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                          uint64_t da,
                                                          uint64_t db,
                                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A . B + (accumulate ? d : 0), m64nNk16 (N = 16 or 32), E -> f32 (E
// __nv_bfloat16 or __half); A K-major (kTransA 0) or MN-major (kTransA 1)
// and B K-major, both read from shared memory through their descriptors; d
// in the C layout of wgmma_rs below.
#define MLT_WGMMA_SS16(TYPES)                                              \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %10, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TYPES " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                    \
      "}, %8, %9, p, 1, 1, %11, 0;\n"                                     \
      "}\n"                                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                \
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA))
#define MLT_WGMMA_SS32(TYPES)                                              \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %18, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPES " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
      "%8, %9, %10, %11, %12, %13, %14, %15"                              \
      "}, %16, %17, p, 1, 1, %19, 0;\n"                                   \
      "}\n"                                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15])                                                       \
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA))

template <int N, int kTransA = 0, typename E = __nv_bfloat16>
static __device__ __forceinline__ void wgmma_ss(float (&d)[N / 2],
                                                uint64_t da, uint64_t db,
                                                int accumulate) {
  static_assert(N == 16 || N == 32, "wgmma width");
  constexpr bool kHalf = std::is_same<E, __half>::value;
  static_assert(kHalf || std::is_same<E, __nv_bfloat16>::value,
                "bf16 or f16 operands");
  if constexpr (N == 16 && kHalf) {
    MLT_WGMMA_SS16("f16.f16");
  } else if constexpr (N == 16) {
    MLT_WGMMA_SS16("bf16.bf16");
  } else if constexpr (kHalf) {
    MLT_WGMMA_SS32("f16.f16");
  } else {
    MLT_WGMMA_SS32("bf16.bf16");
  }
}

#undef MLT_WGMMA_SS16
#undef MLT_WGMMA_SS32

// d = A . B + (accumulate ? d : 0), m64nNk16 (N = 16, 32 or 64), bf16 ->
// f32, A from registers and B from shared memory through its descriptor,
// K-major (kTransB 0) or MN-major (kTransB 1). Warp w of the warpgroup
// gives rows 16 w .. 16 w + 15 of A in the mma.sync A layout (so an f32
// accumulator, rounded and packed pairwise, is an A operand as it stands)
// and holds the same rows of d in the C layout: d[4 j .. 4 j + 3] are
// columns 8 j + 2 (l % 4) (+ 1) of rows (l / 4) (+ 8).
template <int N, int kTransB>
static __device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t db,
                                                int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 16) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kTransB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kTransB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kTransB));
  }
}

static __device__ __forceinline__ void wgmma_fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Make this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy that wgmma reads through.
static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- cluster

// This block's rank in its cluster.
static __device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits for all
// (release on arrival, acquire on the wait: a thread's earlier writes to
// any block's shared memory are visible to every thread after it).
static __device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The shared::cluster address of shared address `addr` (a __cvta_generic_
// to_shared value) in the block of cluster rank `rank`.
static __device__ __forceinline__ uint32_t map_cluster_rank(uint32_t addr,
                                                            uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// Two bytes into another block's shared memory (distributed shared memory).
static __device__ __forceinline__ void st_cluster_u16(uint32_t addr,
                                                      uint16_t v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;\n" ::"r"(addr), "h"(v)
               : "memory");
}

// Four bytes into another block's shared memory.
static __device__ __forceinline__ void st_cluster_f32(uint32_t addr,
                                                      float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// fence_proxy_async for every state space: generic-proxy writes into this
// block's or another block's shared memory before the async proxy reads
// them.
static __device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// ---------------------------------------------------------------- host

// cuTensorMapEncodeTiled, from the driver the runtime already loaded (so
// the library needs no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor-map element type of E (__nv_bfloat16 or __half).
template <typename E>
static constexpr CUtensorMapDataType tma_dtype() {
  return std::is_same<E, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A 3-D tensor map of 2-byte elements (bf16, or f16 with
// tma_dtype<__half>()) over [d2][d1][d0] (d0 innermost), boxes
// of [1][b1][b0] (b0 = 64: 128 bytes), 128-byte swizzle, out-of-bounds
// elements read as zeros.
static bool make_tma_map(
    CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
    uint32_t b0, uint32_t b1,
    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, dtype, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace mlt
