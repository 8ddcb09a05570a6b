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
// One design for both types, the port's conv mainloop (csrc/ptx.cuh), so
// that the int8 / bf16 ratio measures the instruction and not the tuning:
// - Tiles: a block owns a 128 x 256 output tile of one program; eight
//   warps, 2 (m) x 4 (n), each a 64 x 64 warp tile (four m16 x eight n8
//   fragments, 128 float32 or int32 accumulators a thread).  Blocks are
//   persistent, one per SM, and walk the tiles blockIdx.x, + gridDim.x, ...
// - K loop: over G * K in chunks of 128 bytes of k (64 bf16, 128 int8),
//   two chunks a stage of a two-stage ring: one barrier per eight 32-byte
//   k steps (one per four, from a four-stage ring of single chunks, ran
//   at 0.75-0.8x the rate; PERF.md).  A chunk holds the lhs chunk
//   [128 m][128 B] and the rhs chunk [256 rows][128 B] (16 + 32 KB), the
//   16-byte units of row r stored at unit u ^ (r % 8), so ldmatrix of
//   eight rows is conflict-free.  The next stage's 16-byte cp.async.cg
//   copies go out in four parts between the first four k steps' MMAs; the
//   ring runs on across tiles, so the next tile's loads overlap an
//   epilogue.
// - Warp loop, software-pipelined by hand (the PTX helpers are asm
//   volatile, so the compiler keeps their written order): the B fragments
//   of the next n8 pair load before this pair's MMAs, A fragment f of the
//   next k step right after its last MMA of this step.
// - bf16: the rhs chunk is four [64 k][64 n] slabs, one per warp column;
//   A by ldmatrix, B by ldmatrix.trans (s2l::mma_tile's addressing),
//   mma.sync m16n8k16.
// - int8: mma.sync m16n8k32 takes 8-bit B only as .col (k-contiguous), and
//   ldmatrix transposes only 16-bit elements.  So a first launch re-lays
//   rhs [G, K, N] as [G, N, K] (3.1 MB read and written at the probe's
//   shape, inside the call: in the conv this probe models rhs is the
//   activation side and changes every call).  The chunk is then
//   [256 n][128 k] and both operands load by plain ldmatrix.
// - Epilogue: lanes 2i and 2i + 1 swap half their accumulators, so each
//   holds four consecutive columns of one row, then one 16-byte streaming
//   store per fragment (the output, 67 MB at the probe's shape, should
//   not push the operands out of L2).
// What bounds it: both types take the same time per ring stage (int8 runs
// at ~2x bf16's rate, PERF.md), so the limit is the instruction stream of
// eight warps per SM (ldmatrix, mma.sync, the copies, the barrier), not
// the tensor cores' type; operands come from L2 at ~85 (bf16) / ~170
// (int8) operations a byte per block.
// Next step: wgmma with a TMA ring (ROADMAP B4), for which this kernel's
// rate is the mma.sync yardstick.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kFrags = s2l::kTileFrags;    // m16 fragments per warp
constexpr int kBm = 128, kBn = 256;        // block tile
constexpr int kRow = s2l::kTileWRow;       // 128-byte shared rows: one chunk of k
constexpr int kSub = 2;                    // chunks per ring stage
constexpr int kStages = 2;
constexpr int kSteps = 4 * kSub;           // 32-byte k steps per stage
constexpr int kParts = 4;                  // parts a stage's copies go out in
constexpr int kABytes = kBm * kRow;        // lhs chunk
constexpr int kBBytes = kBn * kRow;        // rhs chunk: 4 x [64 k][64 n] bf16 or [256 n][128 k] s8
constexpr int kChunkBytes = kABytes + kBBytes;
constexpr int kStageBytes = kSub * kChunkBytes;
constexpr int kBytes = kStages * kStageBytes;
static_assert(kWarps * kFrags * 16 * 64 == kBm * kBn, "the warp tiles cover the block tile");
static_assert(kBytes <= 232448, "shared memory");
static_assert(kStages == 2 && kParts <= kSteps && kParts % kSub == 0, "one stage in flight");

// byte offset of 16-byte unit u of shared row r
__device__ __forceinline__ uint32_t sw(int r, int u) { return r * kRow + ((u ^ (r & 7)) << 4); }

struct ProbeArgs {
  const unsigned char* lhs;  // [M, K]
  const unsigned char* rhs;  // bf16: [G, K, N]; int8: re-laid [G, N, K]
  void* out;                 // [T, M, N] float32 / int32
  int m, k, n, g, t;
};

__device__ __forceinline__ void store4(float* p, float x, float y, float z, float w) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x, y, z, w));
}
__device__ __forceinline__ void store4(int* p, int x, int y, int z, int w) {
  __stcs(reinterpret_cast<int4*>(p), make_int4(x, y, z, w));
}

// B fragments: bf16 B is stored [k][n] and loads transposed, int8 B is
// stored [n][k] and loads as it is
template <bool kS8>
__device__ __forceinline__ void ld_b(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (kS8)
    s2l::ldsm_x4(r, addr);
  else
    s2l::ldsm_x4_trans(r, addr);
}
__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  s2l::mma_bf16_16816(c, a, b0, b1);
}
__device__ __forceinline__ void mma_step(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  s2l::mma_s8_16832(c, a, b0, b1);
}

template <bool kS8>
__global__ void __launch_bounds__(kThreads, 1) dot_probe_kernel(ProbeArgs a) {
  using Acc = std::conditional_t<kS8, int, float>;
  constexpr int kElt = kS8 ? 1 : 2;  // bytes of an element
  constexpr int kKc = kRow / kElt;   // k per chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring_s = s2l::smem_addr(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 2, wn = warp / 2;
  const int ns = a.g * (a.k / (kSub * kKc));  // ring stages per tile
  const int tiles_n = a.n / kBn, tiles_m = a.m / kBm;
  const int tiles = tiles_n * tiles_m * a.t;
  // tiles blockIdx.x, + gridDim.x, ... (the launch keeps gridDim.x <= tiles)
  const int items = ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * ns;  // stage fastest

  // tile q: column tiles fastest, then row tiles, then programs
  auto tile_at = [&](int q, int& t, int& m0, int& n0) {
    n0 = (q % tiles_n) * kBn;
    q /= tiles_n;
    m0 = (q % tiles_m) * kBm;
    t = q / tiles_m;
  };

  // load cursor: the next stage to fill holds chunks k0, k0 + kKc, ... of
  // lhs[m0.., :] and rhs[g][:, n0..] (the operands do not depend on t).
  // A stage fills in kParts parts, each thread's 16-byte copies split
  // evenly; the last part moves the cursor on.
  int lq = blockIdx.x, lg = 0, lk = 0, lt, lm, ln;
  tile_at(lq, lt, lm, ln);
  auto load_part = [&](uint32_t st, int p) {
    const int c = p / (kParts / kSub), h = p % (kParts / kSub);
    constexpr int kA = kBm * 8 / kThreads / (kParts / kSub);  // copies a part
    constexpr int kB = kBn * 8 / kThreads / (kParts / kSub);
    const uint32_t sa = st + c * kChunkBytes, sb = sa + kABytes;
    const int k0 = lk + c * kKc;
#pragma unroll
    for (int j = 0; j < kA; ++j) {
      const int i = threadIdx.x + (h * kA + j) * kThreads, r = i / 8, u = i % 8;
      s2l::cp_async16(sa + sw(r, u), a.lhs + ((size_t)(lm + r) * a.k + k0) * kElt + 16 * u, true);
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = threadIdx.x + (h * kB + j) * kThreads;
      if constexpr (kS8) {
        const int r = i / 8, u = i % 8;  // row r = column n0 + r
        s2l::cp_async16(sb + sw(r, u), a.rhs + ((size_t)lg * a.n + ln + r) * a.k + k0 + 16 * u,
                        true);
      } else {
        const int kr = i / 32, s = (i / 8) % 4, u = i % 8;  // slab s, k row kr
        s2l::cp_async16(sb + sw(64 * s + kr, u),
                        a.rhs + (((size_t)lg * a.k + k0 + kr) * a.n + ln + 64 * s + 8 * u) * 2,
                        true);
      }
    }
    if (p == kParts - 1) {
      lk += kSub * kKc;
      if (lk == a.k) {
        lk = 0;
        if (++lg == a.g) {
          lg = 0;
          lq += gridDim.x;
          tile_at(lq, lt, lm, ln);
        }
      }
    }
  };

  // shared addresses of step s (chunk s / 4, k step s % 4) of a stage at
  // st: A fragment f, and the B fragments of n8 pair j, ldmatrix matrix
  // lane / 8 (bf16: k rows (lane / 8) % 2 * 8.., ldmatrix.trans, as
  // s2l::mma_tile; int8: n rows lane / 16 * 8.., k unit (lane / 8) % 2)
  auto a_addr = [&](uint32_t st, int s, int f) {
    return st + (s / 4) * kChunkBytes + sw(64 * wm + 16 * f + lane % 16, 2 * (s % 4) + lane / 16);
  };
  auto b_addr = [&](uint32_t st, int s, int j) -> uint32_t {
    const uint32_t sb = st + (s / 4) * kChunkBytes + kABytes;
    if constexpr (kS8)
      return sb + (64 * wn + 16 * j + (lane & 7) + ((lane >> 4) << 3)) * kRow +
             (((2 * (s % 4) + ((lane >> 3) & 1)) ^ (lane & 7)) << 4);
    else
      return sb + (64 * wn + 16 * (s % 4) + (lane & 15)) * kRow +
             (((2 * j) ^ ((lane >> 4) ^ (lane & 7))) << 4);
  };

  Acc acc[kFrags][8][4];
  s2l::zero_tile(acc);
#pragma unroll
  for (int p = 0; p < kParts; ++p) load_part(ring_s, p);
  s2l::cp_async_commit();
  for (int it = 0; it < items; ++it) {
    s2l::cp_async_wait<0>();
    __syncthreads();  // stage it landed; every warp is done with stage it - 1
    const uint32_t st = ring_s + (it % kStages) * kStageBytes;
    const uint32_t nxt = ring_s + ((it + 1) % kStages) * kStageBytes;
    const bool more = it + 1 < items;
    // software pipeline over the stage's kSteps steps: the B fragments of
    // the next n8 pair load before this pair's MMAs, A fragment f of the
    // next step right after its last MMA of this step; the next stage's
    // copies go out in parts over the first kParts steps
    uint32_t af[kFrags][4], bfr[2][4];
#pragma unroll
    for (int f = 0; f < kFrags; ++f) s2l::ldsm_x4(af[f], a_addr(st, 0, f));
    ld_b<kS8>(bfr[0], b_addr(st, 0, 0));
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (s < kParts && more) load_part(nxt, s);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = (s * 4 + j) & 1;
        if (j < 3)
          ld_b<kS8>(bfr[q ^ 1], b_addr(st, s, j + 1));
        else if (s + 1 < kSteps)
          ld_b<kS8>(bfr[q ^ 1], b_addr(st, s + 1, 0));
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          mma_step(acc[f][2 * j], af[f], bfr[q][0], bfr[q][1]);
          mma_step(acc[f][2 * j + 1], af[f], bfr[q][2], bfr[q][3]);
          if (j == 3 && s + 1 < kSteps) s2l::ldsm_x4(af[f], a_addr(st, s + 1, f));
        }
      }
    }
    s2l::cp_async_commit();
    if (it % ns != ns - 1) continue;

    // epilogue: an even lane gets its partner's columns of row lane / 4,
    // an odd lane its partner's of row lane / 4 + 8
    int t, m0, n0;
    tile_at(blockIdx.x + (it / ns) * gridDim.x, t, m0, n0);
    const bool odd = lane & 1;
    Acc* const out = static_cast<Acc*>(a.out) + ((size_t)t * a.m + m0 + 64 * wm) * a.n + n0 + 64 * wn;
    const int row = lane / 4 + (odd ? 8 : 0), col = 2 * (lane % 4) - (odd ? 2 : 0);
#pragma unroll
    for (int f = 0; f < kFrags; ++f)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const Acc s0 = odd ? acc[f][j][0] : acc[f][j][2];
        const Acc s1 = odd ? acc[f][j][1] : acc[f][j][3];
        const Acc r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const Acc r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        Acc* const p = out + (size_t)(16 * f + row) * a.n + 8 * j + col;
        if (odd)
          store4(p, r0, r1, acc[f][j][2], acc[f][j][3]);
        else
          store4(p, acc[f][j][0], acc[f][j][1], r0, r1);
      }
    s2l::zero_tile(acc);
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// M a multiple of 128, N of 256, K of 256; every count fits an int
int check_shape(const void* lhs, const void* rhs, const void* out, int m, int k, int n, int g,
                int t) {
  if (m <= 0 || k <= 0 || n <= 0 || g <= 0 || t <= 0 || m % kBm || n % kBn || k % (kSub * kRow) ||
      !aligned16(lhs) || !aligned16(rhs) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)(m / kBm) * (n / kBn) * t;
  if (tiles * g * (k / 64) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool kS8>
int launch(const void* lhs, const void* rhs, void* out, int m, int k, int n, int g, int t,
           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(probe_fn<kS8>(), cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tiles = (m / kBm) * (n / kBn) * t;
  ProbeArgs a;
  a.lhs = static_cast<const unsigned char*>(lhs);
  a.rhs = static_cast<const unsigned char*>(rhs);
  a.out = out;
  a.m = m;
  a.k = k;
  a.n = n;
  a.g = g;
  a.t = t;
  dot_probe_kernel<kS8><<<tiles < sms ? tiles : sms, kThreads, kBytes, stream>>>(a);
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
