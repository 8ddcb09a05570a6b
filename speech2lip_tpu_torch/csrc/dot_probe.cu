// K8: the kernel-shaped dot probe.  Replaces the Pallas kernel of
// tools/bench_int8_dot.py (make, the pallas_call at :44), which times T
// programs that each compute
//
//   out[t] = sum_g lhs . rhs[g]     lhs [M, K], rhs [G, K, N], out [T, M, N]
//
// in bfloat16 with float32 sums and in int8 with int32 sums: the dot of the
// HCW conv kernels, with its operands resident in fast memory.  The
// programs' operands are all the same; each program still computes its
// tile from them, and so does each block here: the work is
// 2 * M * K * N * G * T operations, nothing is reused across t.
//
// One design for both types, Hopper's: a TMA + mbarrier ring feeding wgmma.
// - Tiles: a block owns a 128 x 256 output tile of one program.  Blocks
//   are persistent, one per SM, and walk the tiles blockIdx.x, +
//   gridDim.x, ...; the ring runs on across tiles, so the loads of a
//   tile's first chunks overlap the previous tile's epilogue.
// - Roles (one if / else on the warpgroup, never rejoined, so setmaxnreg
//   holds): warpgroup 2 is the producer, one thread of it issuing the TMA
//   loads, at 56 registers; warpgroups 0 and 1 are the consumers, each a
//   64 x 256 half of the tile, at 224 registers: 128 float32 or int32
//   accumulators a thread.  The block starts at 168 registers a thread
//   (384 threads); the producer's 128 x 112 registers given back are what
//   the consumers take (a block of 288 threads starts with too few, and
//   its consumers wait for registers that never come).
// - K loop: over G * K in chunks of 128 bytes of k (64 bf16, 128 int8), one
//   chunk a stage of a four-stage ring (48 KB: lhs [128 m][128 B] and rhs
//   32 KB).  768 is a multiple of both chunk depths, so a chunk never
//   straddles two g: chunk c reads lhs at k (c % (K / kc)) * kc and rhs[c /
//   (K / kc)].  TMA writes every box with the 128-byte swizzle (16-byte
//   unit u of row r at u ^ (r % 8)), and the wgmma descriptors read it
//   with the same swizzle.  A full barrier per stage counts the TMA bytes;
//   an empty barrier per stage counts the eight consumer warps' releases.
// - Consumers: per chunk four wgmma (m64n256k16 bf16, m64n256k32 s8), 32
//   bytes of k each, committed as one group; the group of the chunk before
//   is waited for (one group stays in flight) and its stage released.
// - bf16: rhs [G, K, N] is N-contiguous, which bf16 wgmma takes as an
//   MN-major B (the transpose bit): four TMA boxes of [64 k][64 n] per
//   chunk, 8 KB apart (the descriptor's leading offset), 8-row k groups
//   1 KB apart (its stride offset).
// - int8: s8 wgmma takes only a K-major B, so a first launch re-lays rhs
//   [G, K, N] as [G, N, K] (3.1 MB read and written at the probe's shape,
//   inside the call: in the conv this probe models rhs is the activation
//   side and changes every call); one TMA box of [256 n][128 k] a chunk.
// - Epilogue: straight from the accumulators, two 8-byte streaming stores
//   per n8 column block (rows r and r + 8; a warp's stores fill whole
//   32-byte sectors).  Swapping halves between lanes for 16-byte stores
//   held a second set of values live beside the accumulators and spilled.
//   The output, 67 MB at the probe's shape, should not push the operands
//   out of L2.
// What bounds it: the tensor cores (0.21 ms bf16, 0.10 ms int8 at the
// probe's shape); the operands come from L2, 48 KB a chunk for 4.2 M bf16
// or 8.4 M int8 operations, ~85 / ~170 operations a byte per SM.
// The mbarrier, TMA, descriptor and wgmma helpers and the tensor-map
// lookup are ptx.cuh's, shared with K1's bf16 body (fused_mlp.cu).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

using namespace s2l;

constexpr int kConsumers = 2;                    // warpgroups on the MMAs
constexpr int kThreads = 128 * (kConsumers + 1); // + the producer warpgroup
constexpr int kBm = 128, kBn = 256;              // block tile
constexpr int kRow = 128;                        // bytes of k a chunk
constexpr int kStages = 4;
constexpr int kABytes = kBm * kRow;              // lhs chunk, 16 KB
constexpr int kBBytes = kBn * kRow;              // rhs chunk, 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kRingBytes = kStages * kStageBytes;
// the ring, 1 KB of slack to align it to the swizzle's 1 KB pattern, and
// the full and empty barriers
constexpr int kBytes = kRingBytes + 1024 + 2 * kStages * 8;
static_assert(kBytes <= 232448, "shared memory");
static_assert(kConsumers * 64 == kBm, "a consumer warpgroup per 64 rows");

__device__ __forceinline__ void store2(float* p, float x, float y) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(x, y));
}
__device__ __forceinline__ void store2(int* p, int x, int y) {
  __stcs(reinterpret_cast<int2*>(p), make_int2(x, y));
}

struct Shape {
  int m, k, n, g, t;
};

// tile q: column tiles fastest, then row tiles, then programs
__device__ __forceinline__ void tile_at(const Shape& a, int q, int& t, int& m0, int& n0) {
  const int tiles_n = a.n / kBn, tiles_m = a.m / kBm;
  n0 = (q % tiles_n) * kBn;
  q /= tiles_n;
  m0 = (q % tiles_m) * kBm;
  t = q / tiles_m;
}

template <bool kS8>
__global__ void __launch_bounds__(kThreads, 1)
    dot_probe_kernel(const __grid_constant__ CUtensorMap lhs_map,
                     const __grid_constant__ CUtensorMap rhs_map, void* out, const Shape a) {
  using Acc = std::conditional_t<kS8, int, float>;
  constexpr int kKc = kS8 ? kRow : kRow / 2;  // k per chunk
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + kRingBytes, empty = full + 8 * kStages;
  const int tiles = (a.n / kBn) * (a.m / kBm) * a.t;
  const int chunks = a.g * (a.k / kKc);  // chunks a tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, uniform across each warp (setmaxnreg is .sync.aligned)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;
      for (int q = blockIdx.x; q < tiles; q += gridDim.x) {
        int t, m0, n0;
        tile_at(a, q, t, m0, n0);
        // chunk c reads lhs at k0 and rhs[gi] at k0, k0 wrapping at K
        for (int c = 0, gi = 0, k0 = 0; c < chunks; ++c, ++it) {
          const int s = it % kStages;
          const uint32_t st = ring + s * kStageBytes, bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(bar, kStageBytes);
          tma_load(st, &lhs_map, k0, m0, bar);
          if constexpr (kS8) {
            tma_load(st + kABytes, &rhs_map, k0, gi * a.n + n0, bar);
          } else {
#pragma unroll
            for (int j = 0; j < kBn / 64; ++j)
              tma_load(st + kABytes + j * 8192, &rhs_map, n0 + 64 * j, gi * a.k + k0, bar);
          }
          if ((k0 += kKc) == a.k) {
            k0 = 0;
            ++gi;
          }
        }
      }
    }
  } else {
    // ---- consumers: rows 64 wg .. of the tile ------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    Acc d[128];  // each tile's first MMA starts the sums (scale_d 0)
    int it = 0;
    for (int q = blockIdx.x; q < tiles; q += gridDim.x) {
      int prev = 0;
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = it % kStages;
        const uint32_t st = ring + s * kStageBytes;
        mbar_wait(full + 8 * s, (it / kStages) & 1);
        const uint32_t sa = st + wg * 64 * kRow, sb = st + kABytes;
#pragma unroll
        for (int i = 0; i < 128; ++i) pin(d[i]);
        wgmma_fence();  // the accumulators' registers are settled
#pragma unroll
        for (int kk = 0; kk < kRow / 32; ++kk) {
          // A: 8-row groups 1 KB apart, 32 bytes of k further per step.
          // B: bf16 16 k rows (2 KB) further per step, the four 64-column
          // boxes 8 KB apart; s8 as A, 256 rows
          const uint64_t da = sw128_desc(sa + 32 * kk, 16, 1024);
          const uint64_t db = kS8 ? sw128_desc(sb + 32 * kk, 16, 1024)
                                  : sw128_desc(sb + 2048 * kk, 8192, 1024);
          wgmma(d, da, db, (c | kk) != 0);
        }
        wgmma_commit();
        // the chunk before is done: release its stage (no code but the
        // MMAs touches the accumulators until the wait for all below)
        wgmma_wait<1>();
        if (c > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) pin(d[i]);
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      // epilogue: d[4j..4j+1] are row lane / 4, columns 8j + 2 (lane % 4)
      // and one more; d[4j+2..4j+3] the same columns of row lane / 4 + 8
      int t, m0, n0;
      tile_at(a, q, t, m0, n0);
      Acc* const o = static_cast<Acc*>(out) +
                     ((size_t)t * a.m + m0 + 64 * wg + 16 * warp + lane / 4) * a.n + n0 +
                     2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        store2(o + 8 * j, d[4 * j], d[4 * j + 1]);
        store2(o + (size_t)8 * a.n + 8 * j, d[4 * j + 2], d[4 * j + 3]);
      }
    }
  }
}

// rhs [G, K, N] int8 -> [G, N, K]: a block transposes one 64 x 64-byte
// tile through shared memory, with 16-byte loads and stores.
__global__ void __launch_bounds__(256) relayout_nk_kernel(const unsigned char* src,
                                                          unsigned char* dst, int k, int n) {
  __shared__ uint32_t tile[64][17];  // [k][n / 4], one word of padding
  const int g = blockIdx.z, k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;
  const uint4 v = *reinterpret_cast<const uint4*>(src + ((size_t)g * k + k0 + r) * n + n0 + 16 * q);
  tile[r][4 * q] = v.x;
  tile[r][4 * q + 1] = v.y;
  tile[r][4 * q + 2] = v.z;
  tile[r][4 * q + 3] = v.w;
  __syncthreads();
  // row n0 + r of the output, k0 + 16 q ..: byte r % 4 of word r / 4 of
  // sixteen k rows
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t x = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x |= ((tile[16 * q + 4 * i + e][r / 4] >> (8 * (r % 4))) & 0xffu) << (8 * e);
    w[i] = x;
  }
  *reinterpret_cast<uint4*>(dst + ((size_t)g * n + n0 + r) * k + k0 + 16 * q) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kS8>
const void* probe_fn() {
  return reinterpret_cast<const void*>(dot_probe_kernel<kS8>);
}

// ---- host: launches ------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// M a multiple of 128, N of 256, K of 256; every count fits an int
int check_shape(const void* lhs, const void* rhs, const void* out, int m, int k, int n, int g,
                int t) {
  if (m <= 0 || k <= 0 || n <= 0 || g <= 0 || t <= 0 || m % kBm || n % kBn || k % 256 ||
      !aligned16(lhs) || !aligned16(rhs) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)(m / kBm) * (n / kBn) * t;
  if (tiles * g * (k / 64) > 0x7fffffffLL || (long long)g * k > 0x7fffffffLL ||
      (long long)g * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// rhs: bf16 [G, K, N]; int8 the re-laid [G, N, K]
template <bool kS8>
int launch(const void* lhs, const void* rhs, void* out, int m, int k, int n, int g, int t,
           cudaStream_t stream) {
  constexpr CUtensorMapDataType kType =
      kS8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap lhs_map, rhs_map;
  int err = kS8 ? make_map(&lhs_map, lhs, kType, k, m, k, kRow, kBm)
                : make_map(&lhs_map, lhs, kType, k, m, 2ull * k, kRow / 2, kBm);
  if (err) return err;
  err = kS8 ? make_map(&rhs_map, rhs, kType, k, (uint64_t)g * n, k, kRow, kBn)
            : make_map(&rhs_map, rhs, kType, n, (uint64_t)g * k, 2ull * n, 64, kRow / 2);
  if (err) return err;
  cudaError_t e =
      cudaFuncSetAttribute(probe_fn<kS8>(), cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int tiles = (m / kBm) * (n / kBn) * t;
  const Shape a{m, k, n, g, t};
  dot_probe_kernel<kS8><<<tiles < sms ? tiles : sms, kThreads, kBytes, stream>>>(lhs_map, rhs_map,
                                                                                 out, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dot_probe_bf16(const void* lhs, const void* rhs, void* out, int m, int k, int n,
                              int g, int t, void* stream) {
  if (const int err = check_shape(lhs, rhs, out, m, k, n, g, t)) return err;
  return launch<false>(lhs, rhs, out, m, k, n, g, t, static_cast<cudaStream_t>(stream));
}

// rhs_nk: scratch of G * N * K bytes for the re-laid rhs
extern "C" int dot_probe_s8(const void* lhs, const void* rhs, void* rhs_nk, void* out, int m,
                            int k, int n, int g, int t, void* stream) {
  if (const int err = check_shape(lhs, rhs, out, m, k, n, g, t)) return err;
  if (!aligned16(rhs_nk) || g > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  relayout_nk_kernel<<<dim3(n / 64, k / 64, g), 256, 0, s>>>(
      static_cast<const unsigned char*>(rhs), static_cast<unsigned char*>(rhs_nk), k, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch<true>(lhs, rhs_nk, out, m, k, n, g, t, s);
}

// Registers per thread, local-memory bytes per thread and shared-memory
// bytes per block (static + the launch's dynamic bytes) of the bf16 (s8 0)
// or int8 (s8 1) dot kernel.
extern "C" int dot_probe_attrs(int s8, int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, s8 ? probe_fn<true>() : probe_fn<false>());
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)(attr.sharedSizeBytes + kBytes);
  return 0;
}
