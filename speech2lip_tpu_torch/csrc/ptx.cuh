// Inline-PTX building blocks for sm_80+ warp-level tensor-core kernels:
// 16-byte asynchronous global->shared copies (cp.async.cg, zero-fill by
// src-size 0), ldmatrix fragment loads and the bf16 m16n8k16 mma.sync with
// float32 accumulate.  Fragment layouts are the PTX ISA's (mma.m16n8k16,
// .row.col): A row-major 16x16 in four .b32 registers, B 16x8 in two,
// C 16x8 float32 in four (rows lane/4 and lane/4 + 8, columns
// 2 * (lane % 4) + {0, 1}).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace s2l {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; fill == false writes 16 zeros
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for every cp.async group this thread committed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in
// flight (a ring of kPending + 2 stages waits for the oldest).
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8, and gets register i from matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// As ldsm_x4, each matrix transposed: a row-major [k][n] tile in shared
// memory comes out as mma B ("col") fragments.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16 bf16) * b (16x8 bf16), float32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one .b32 of two bf16 (the first at the lower address).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The warp tile of the conv kernels (double_conv.cu, fused_block.cu): four
// m16 fragments (64 pixels) x eight n8 fragments (64 channels), 128
// float32 accumulators a thread.
constexpr int kTileFrags = 4;
constexpr int kTileWRow = 128;  // bytes of a [k][64] bf16 weight row

__device__ __forceinline__ void zero_tile(float (&acc)[kTileFrags][8][4]) {
#pragma unroll
  for (int f = 0; f < kTileFrags; ++f)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;
}

// One 16-channel step of the warp tile: acc[f][n8] += A_f * B, B from the
// [16][64] weight rows at shared address w, 16-byte unit u of row k stored
// at unit u ^ (k % 8) (ldmatrix.trans of eight k rows is conflict-free).
__device__ __forceinline__ void mma_tile(float (&acc)[kTileFrags][8][4],
                                         const uint32_t (&af)[kTileFrags][4], uint32_t w,
                                         int lane) {
  const uint32_t row = w + (lane & 15) * kTileWRow;
  const int s = (lane >> 4) ^ (lane & 7);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t bfr[4];
    ldsm_x4_trans(bfr, row + (((2 * j) ^ s) << 4));
#pragma unroll
    for (int f = 0; f < kTileFrags; ++f) {
      mma_bf16_16816(acc[f][2 * j], af[f], bfr[0], bfr[1]);
      mma_bf16_16816(acc[f][2 * j + 1], af[f], bfr[2], bfr[3]);
    }
  }
}

// ---- int8 (mma.m16n8k32 .s8, .row.col, s32 accumulate) ------------------
// A is 16 rows x 32 bytes in four .b32 registers, B 32 (k) x 8 (n) in two,
// C as the bf16 MMA's but int32.  In bytes the fragments are the bf16
// ones: ldsm_x4 gives A from a row-major tile of 32-byte k steps, and B
// from a tile stored [n][k] (each B register is four k of one n column).
// No transposed load exists for 8-bit elements, so B must be k-contiguous
// in shared memory.

// c += a (16x32 s8) * b (32x8 s8), int32 accumulate (wraps; no saturation).
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void zero_tile(int (&acc)[kTileFrags][8][4]) {
#pragma unroll
  for (int f = 0; f < kTileFrags; ++f)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0;
}

}  // namespace s2l
