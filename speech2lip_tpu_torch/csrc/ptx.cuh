// Inline-PTX building blocks of the port's tensor-core kernels.
//
// sm_80+ warp level (K5): 16-byte asynchronous global->shared copies
// (cp.async.cg, zero-fill by src-size 0), ldmatrix fragment loads and the
// bf16 m16n8k16 mma.sync with float32 accumulate.  Fragment layouts are
// the PTX ISA's (mma.m16n8k16, .row.col): A row-major 16x16 in four .b32
// registers, B 16x8 in two, C 16x8 float32 in four (rows lane/4 and
// lane/4 + 8, columns 2 * (lane % 4) + {0, 1}).
//
// sm_90a warpgroup level (the bf16 bodies of K1 and K3, K8): mbarriers,
// TMA tile loads and the tensor maps they read, wgmma shared-memory
// descriptors (128- and 32-byte-swizzled operands), the wgmma
// products with their fences, and transposing stmatrix stores.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// The warp tile of the conv kernel double_conv.cu: four
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

// ---- Hopper (sm_90a): mbarriers, TMA, wgmma ------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// a 2-D box at (c0 innermost, c1) of the tensor map into shared memory at
// dst, its bytes counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// The threads' own shared-memory writes become visible to the async proxy
// (wgmma, TMA) that reads them next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// Named barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at addr,
// with its leading and stride byte offsets, swizzle mode 1.  The swizzle
// puts 16-byte unit u of a 128-byte row r at u ^ (r % 8); the pattern
// repeats every 1 KB, so operand bases are 1 KB aligned.
// - K-major (rows of 128 bytes of k): stride = 1024, the distance of
//   8-row groups; lead unused (16).  A k step of 16 bf16 adds 32 bytes.
// - MN-major (rows of 64 n, 128 bytes, one per k; transpose bit set in
//   wgmma): lead = the distance of 64-column boxes, stride = 1024, the
//   distance of 8-k groups.  A k step of 16 adds 2 KB.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous MMAs (empty asm that reads and writes the register)
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(int& r) { asm volatile("" : "+r"(r)::"memory"); }

#define S2L_REGS128                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "  \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "  \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "    \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "   \
  "%123, %124, %125, %126, %127}"
#define S2L_D4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define S2L_D16(C, i) S2L_D4(C, i), S2L_D4(C, i + 4), S2L_D4(C, i + 8), S2L_D4(C, i + 12)
#define S2L_D128(C)                                                                          \
  S2L_D16(C, 0), S2L_D16(C, 16), S2L_D16(C, 32), S2L_D16(C, 48), S2L_D16(C, 64),            \
      S2L_D16(C, 80), S2L_D16(C, 96), S2L_D16(C, 112)

// Accumulator fragments of m64nNk*: d[4j], d[4j + 1] are row 16 * warp +
// lane / 4 of the warpgroup's 64, columns 8j + 2 (lane % 4) and one more;
// d[4j + 2], d[4j + 3] the same columns of that row + 8.

// d (+)= A . B over 64 rows x 256 columns x 16 bf16 of k; scale_d 0 starts
// the sums afresh.  A K-major, B MN-major (transpose bit set)
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " S2L_REGS128
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : S2L_D128("+f")
      : "l"(da), "l"(db), "r"(scale_d));
}
// s8 over 64 rows x 256 columns x 32 bytes of k: both operands K-major
__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " S2L_REGS128
      ", %128, %129, p;\n}\n"
      : S2L_D128("+r")
      : "l"(da), "l"(db), "r"(scale_d));
}
// bf16 over 64 rows x 8 columns x 16 of k: both operands K-major
__device__ __forceinline__ void wgmma(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

#define S2L_REGS40                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39}"
#define S2L_REGS64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define S2L_D40(C) S2L_D16(C, 0), S2L_D16(C, 16), S2L_D4(C, 32), S2L_D4(C, 36)
#define S2L_D64(C) S2L_D16(C, 0), S2L_D16(C, 16), S2L_D16(C, 32), S2L_D16(C, 48)

// bf16 over 64 rows x 128 (or 80) columns x 16 of k with A MN-major
// (transpose bit set) and B K-major: the conv's [k][64 cout] weights as A,
// pixels as the columns of B
__device__ __forceinline__ void wgmma_ta(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " S2L_REGS64
      ", %64, %65, p, 1, 1, 1, 0;\n}\n"
      : S2L_D64("+f")
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ta(float (&d)[40], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " S2L_REGS40
      ", %40, %41, p, 1, 1, 1, 0;\n}\n"
      : S2L_D40("+f")
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma descriptor of a K-major operand with the 32-byte swizzle of TMA's
// CU_TENSOR_MAP_SWIZZLE_32B: rows of 32 bytes (16 bf16 of k, one k step),
// the two 16-byte halves of a row swapped where address bit 7 is set;
// stride = the distance of 8-row groups.  The swizzle follows the absolute
// address, so a start at any row (32 bytes) reads the rows TMA wrote there
// (base offset 0; measured on the H100: the start's bits 7-9 there read
// other rows).
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(stride >> 4) << 32) |
         (3ull << 62);
}

// Four 8x8 b16 matrices from registers to shared memory, each transposed:
// register i holds matrix i in the mma fragment layout (row lane / 4,
// columns 2 (lane % 4) and one more); lane l gives the address of stored
// row l % 8 of matrix l / 8, which is that matrix's column l % 8.
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                              uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
// The same for two matrices (lanes 0-15 give the addresses).
__device__ __forceinline__ void stsm_x2_trans(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(r0), "r"(r1)
               : "memory");
}

// 3-D and 4-D boxes at coordinates (c0 innermost, ...) of a tensor map, as
// tma_load; coordinates may lie outside the tensor, whose elements there
// read as zeros (and still count on bar)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

#undef S2L_REGS128
#undef S2L_REGS64
#undef S2L_REGS40
#undef S2L_D4
#undef S2L_D16
#undef S2L_D64
#undef S2L_D40
#undef S2L_D128

// ---- host: tensor maps -----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA low-level API, looked up through the
// runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of `rank` dimensions of `type` (dims[0] innermost, contiguous;
// strides in bytes of dimensions 1..rank-1), boxes of box[0] x ...;
// elements of a box outside the tensor read as zeros.  Returns a
// cudaError_t.
inline int make_map_nd(CUtensorMapDataType type, CUtensorMap* map, const void* base, int rank,
                       const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInitializationError;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    elem[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = encode(map, type, (cuuint32_t)rank, const_cast<void*>(base), d, s, b, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 2-D map over rows of `inner` elements (`rows` of them, `pitch` bytes
// apart), boxes of box_inner x box_rows, 128-byte swizzle; a box reaching
// past the rows reads zeros there.  Returns a cudaError_t.
inline int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, uint64_t inner,
                    uint64_t rows, uint64_t pitch, uint32_t box_inner, uint32_t box_rows) {
  const uint64_t dims[2] = {inner, rows};
  const uint32_t box[2] = {box_inner, box_rows};
  return make_map_nd(type, map, base, 2, dims, &pitch, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace s2l
