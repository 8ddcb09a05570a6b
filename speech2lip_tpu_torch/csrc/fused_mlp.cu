// K1: fused MLP-v2 trunk of the lip renderer, B frames over N shared uv
// embeddings.  Replaces the Pallas kernels speech2lip_tpu/ops/pallas/
// fused_mlp.py fused_mlp_batched (K1) and fused_mlp (K1b, one frame).
//
//   h   = uv @ W_uv + b0[f]                      (b0 = b_uv + base[f])
//   h   = relu(h @ W_i + b_i),  i = 0..skip      (256 x 256)
//   h   = [uv @ W_skip + bs[f] | h]              (skip half first)
//   h   = relu(h @ W_i + b_i),  i = skip+1..     (512 x 256, then 256 x 256)
//   out = h @ W_out + b_out                      (256 x 3, float32 out)
//
// Activations are rounded to T between layers, as the plain PyTorch
// version does; sums are float32.  Device memory sees only uv, the biases,
// the weights (L2-resident, ~1.2 MB in bf16) and the [B, N, 3] output.
// What bounds it on the H100: the tensor cores (91 GFLOP for K1 at May
// geometry, batch 8: 0.092 ms).  Every row tile reads the weights from
// L2 once; on the card one wave of tiles takes as long on 33 SMs as on
// 132, so that stream is not what holds the bf16 body at twice the bound
// (tools/bench_fused_mlp.py).
//
// bfloat16 body (the serving type), Hopper's: a TMA + mbarrier ring feeding
// wgmma, as K8 (dot_probe.cu; the helpers are ptx.cuh's).
// - Tiles and roles: a tile is 128 rows of one frame; blocks are
//   persistent, one per SM, and walk the frames x ceil(N / 128) tiles.
//   Warpgroup 2 is the producer, one thread of it issuing the TMA loads,
//   at 56 registers; warpgroups 0 and 1 are the consumers, 64 rows each,
//   at 224 registers: a 64 x 256 float32 accumulator, 128 a thread.
// - The activations stay in shared memory in the layout wgmma reads as A:
//   64-column panels of 128 rows x 128 bytes, 128-byte swizzled (16-byte
//   unit u of row r at u ^ (r % 8)).  Panels 0-3 hold the skip half of
//   the concat, 4-7 h; one more panel holds uv, its 42 columns zero-padded
//   to 64.  uv's 84-byte rows are no TMA pitch, so the consumers load it
//   and write the padding and the rows past N as zeros.
// - The weights stream: the producer walks W_uv, trunk 0..skip, W_skip,
//   trunk skip+1 (512 deep), the rest of the trunk, tile after tile, as one
//   ring of 32-row chunks (four [32 k][64 n] TMA boxes, 16 KB) that does
//   not stop at layer or tile boundaries, so the next layer's first chunks
//   land during this layer's epilogue.  The weights [K, 256] are
//   N-contiguous, an MN-major B (the transpose bit); TMA zero-fills W_uv's
//   and W_skip's rows past 42.  Both consumers read every stage; its
//   empty barrier counts their eight warps.
// - Epilogue per consumer warpgroup, never block-wide: wait for its MMAs,
//   add the bias (shared memory; b0[f] and bs[f] are loaded per tile),
//   ReLU, round to bf16 and write its own 64 rows of the panels in place
//   over the layer's input, then fence.proxy.async (wgmma reads through
//   the async proxy what the threads wrote) and a named barrier over the
//   warpgroup's four warps.
// - Head: one m64n8k16 wgmma chain over h with W_out^T zero-padded to 8
//   columns (written into shared memory once a block); float32 stores of
//   the 3 columns, masked past N.
//
// float32 body: 3xTF32 WMMA (mma.cuh), one block = 64 rows of one frame,
// the activations in shared memory across all layers, each layer's
// weights streamed through a K-chunk buffer, 16 bytes a thread.
#include <cuda.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "ptx.cuh"

namespace {

using s2l::Mma;

constexpr int kWidth = 256;
constexpr int kRows = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUvDim = 42;
constexpr int kUvK = 48;  // kUvDim padded with zeros to a multiple of 16
constexpr int kMaxDepth = 8;
constexpr int kOutCh = 3;

template <typename T>
struct MlpArgs {
  const T* uv;         // [n, 42]
  const float* b0;     // [frames, 256]
  const float* bs;     // [frames, 256]
  const T* w_uv;       // [42, 256]
  const T* w_skip;     // [42, 256]
  const T* w[kMaxDepth];      // trunk i: [256 or 512, 256]
  const float* b[kMaxDepth];  // trunk i: [256]
  const T* w_out;      // [256, 3]
  const float* b_out;  // [3]
  float* out;          // [frames, n, 3]
  int n, depth, skip;
};

template <typename T>
struct Layout {
  static constexpr int kPad = s2l::kRowPad<T>;
  static constexpr int kChunk = 64 / sizeof(T);  // weight rows per chunk
  static constexpr int kLdAct = 2 * kWidth + kPad;
  static constexpr int kLdUv = kUvK + kPad;
  static constexpr int kLdW = kWidth + kPad;
  static constexpr size_t kActBytes = sizeof(T) * kRows * kLdAct;
  static constexpr size_t kUvBytes = sizeof(T) * kRows * kLdUv;
  static constexpr size_t kWBytes = sizeof(T) * kChunk * kLdW;
  static constexpr size_t kScratchBytes = sizeof(float) * kWarps * 256;
  static constexpr size_t kBytes = kActBytes + kUvBytes + kWBytes + kScratchBytes;
};

// out[r, n] = act(in[r, :k_pad] @ W[:k_pad, n] + bias[n]) for the block's
// rows.  W is [k_valid, 256] in device memory (rows >= k_valid read as 0).
// ``out`` may alias ``in``: every warp finishes reading before any writes.
template <typename T>
__device__ void dense256(const T* in, int ld_in, int k_pad, const T* __restrict__ w,
                         int k_valid, const float* __restrict__ bias, bool relu,
                         T* out, int ld_out, T* wsm, float* scratch) {
  using M = Mma<T>;
  using L = Layout<T>;
  constexpr int kRowFrags = kRows / 16;            // 4
  constexpr int kColGroups = kWarps / kRowFrags;   // 2
  constexpr int kFrags = kWidth / 16 / kColGroups;  // 8 column tiles per warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mf = warp % kRowFrags, n0 = (warp / kRowFrags) * kFrags * 16;

  typename M::C acc[kFrags];
#pragma unroll
  for (int j = 0; j < kFrags; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < k_pad; k0 += L::kChunk) {
    const int kc = min(L::kChunk, k_pad - k0);
    constexpr int kVec = 16 / sizeof(T);  // 16-byte loads
    for (int i = threadIdx.x; i < kc * (kWidth / kVec); i += kThreads) {
      const int r = i / (kWidth / kVec), c = (i % (kWidth / kVec)) * kVec, k = k0 + r;
      *reinterpret_cast<uint4*>(wsm + r * L::kLdW + c) =
          k < k_valid ? *reinterpret_cast<const uint4*>(w + (size_t)k * kWidth + c)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    for (int kk = 0; kk < kc; kk += M::K) {
      typename M::A a;
      M::load_a(a, in + mf * 16 * ld_in + k0 + kk, ld_in);
#pragma unroll
      for (int j = 0; j < kFrags; ++j)
        M::mma(acc[j], a, wsm + kk * L::kLdW + n0 + j * 16, L::kLdW);
    }
    __syncthreads();
  }

  float* s = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < kFrags; ++j) {
    wmma::store_matrix_sync(s, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, n = n0 + j * 16 + e % 16;
      float v = s[e] + bias[n];
      if (relu) v = fmaxf(v, 0.f);
      out[(mf * 16 + r) * ld_out + n] = M::from_float(v);
    }
    __syncwarp();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(MlpArgs<T> a) {
  using M = Mma<T>;
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* act = reinterpret_cast<T*>(smem);  // [rows][skip half | h half]
  T* uv = reinterpret_cast<T*>(smem + L::kActBytes);
  T* wsm = reinterpret_cast<T*>(smem + L::kActBytes + L::kUvBytes);
  float* scratch = reinterpret_cast<float*>(smem + L::kActBytes + L::kUvBytes + L::kWBytes);

  const int f = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kRows * kUvK; i += kThreads) {
    const int r = i / kUvK, c = i % kUvK, row = r0 + r;
    uv[r * L::kLdUv + c] = (row < a.n && c < kUvDim)
                               ? a.uv[(size_t)row * kUvDim + c]
                               : M::from_float(0.f);
  }
  __syncthreads();

  T* h = act + kWidth;
  dense256<T>(uv, L::kLdUv, kUvK, a.w_uv, kUvDim, a.b0 + (size_t)f * kWidth, false,
              h, L::kLdAct, wsm, scratch);
  for (int i = 0; i < a.depth; ++i) {
    const bool concat = i == a.skip + 1;
    const int k = concat ? 2 * kWidth : kWidth;
    dense256<T>(concat ? act : h, L::kLdAct, k, a.w[i], k, a.b[i], true, h, L::kLdAct,
                wsm, scratch);
    if (i == a.skip)
      dense256<T>(uv, L::kLdUv, kUvK, a.w_skip, kUvDim, a.bs + (size_t)f * kWidth,
                  false, act, L::kLdAct, wsm, scratch);
  }

  // head: [rows, 256] @ [256, 3 -> 16 zero-padded]; warps 0..3 one row tile each
  constexpr int kLdH = 16;
  for (int i = threadIdx.x; i < kWidth * kLdH; i += kThreads) {
    const int k = i / kLdH, c = i % kLdH;
    wsm[i] = c < kOutCh ? a.w_out[k * kOutCh + c] : M::from_float(0.f);
  }
  __syncthreads();
  if (warp < kRows / 16) {
    typename M::C acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < kWidth; kk += M::K) {
      typename M::A af;
      M::load_a(af, h + warp * 16 * L::kLdAct + kk, L::kLdAct);
      M::mma(acc, af, wsm + kk * kLdH, kLdH);
    }
    float* s = scratch + warp * 256;
    wmma::store_matrix_sync(s, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * kOutCh; e += 32) {
      const int r = e / kOutCh, c = e % kOutCh, row = r0 + warp * 16 + r;
      if (row < a.n)
        a.out[((size_t)f * a.n + row) * kOutCh + c] = s[r * 16 + c] + a.b_out[c];
    }
  }
}

// ---- bfloat16 body: TMA ring + wgmma, warp-specialised, persistent ------

namespace hopper {

using namespace s2l;

constexpr int kRows = 128;                     // rows a tile
constexpr int kConsumers = 2;                  // warpgroups on the MMAs
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kChunk = 32;                     // weight rows a ring stage
constexpr int kStages = 4;
constexpr int kBox = kChunk * 128;             // one [32 k][64 n] TMA box
constexpr int kStageBytes = 4 * kBox;          // 16 KB: 32 rows x 256
constexpr int kPanel = kRows * 128;            // 64 columns x 128 rows
constexpr int kHalf = 64 * 128;                // a consumer's 64 rows of it
constexpr int kHeadPanel = 8 * 128;            // [8 n][64 k] of W_out^T
// shared memory, from a 1 KB aligned base: the ring, the eight activation
// panels, the uv panel, W_out^T, the trunk biases, each consumer's b0[f]
// and bs[f], and the full and empty barriers
constexpr int kActOff = kStages * kStageBytes;
constexpr int kUvOff = kActOff + 8 * kPanel;
constexpr int kHeadOff = kUvOff + kPanel;
constexpr int kTrunkBiasOff = kHeadOff + 4 * kHeadPanel;
constexpr int kFrameBiasOff = kTrunkBiasOff + kMaxDepth * kWidth * 4;
constexpr int kBarOff = kFrameBiasOff + kConsumers * 2 * kWidth * 4;
constexpr int kBytes = kBarOff + 2 * kStages * 8 + 1024;  // + alignment slack
static_assert(kBytes <= 232448, "shared memory");
static_assert(kConsumers * 64 == kRows, "a consumer warpgroup per 64 rows");

struct Args {
  CUtensorMap maps[kMaxDepth + 2];  // W_uv, W_skip, trunk 0..depth-1
  const __nv_bfloat16* uv;          // [n, 42]
  const float* b0;                  // [frames, 256]
  const float* bs;                  // [frames, 256]
  const float* b[kMaxDepth];        // trunk i: [256]
  const __nv_bfloat16* w_out;       // [256, 3]
  const float* b_out;               // [3]
  float* out;                       // [frames, n, 3]
  int n, frames, depth, skip, tiles_n;
};

// Layer l of a tile, in the producer's order: the entry (uv), trunk
// 0..skip, the skip projection (uv), trunk skip+1.. .  in: the first
// activation panel of A (-1: the uv panel); out: the first panel written;
// bias: a trunk index, -1 b0[f], -2 bs[f].
struct Layer {
  int map, chunks, in, out, bias;
  bool relu;
};

__device__ __forceinline__ Layer layer_at(int l, int skip) {
  if (l == 0) return {0, 2, -1, 4, -1, false};
  if (l == skip + 2) return {1, 2, -1, 0, -2, false};
  const int i = l <= skip + 1 ? l - 1 : l - 2;
  const bool concat = i == skip + 1;
  return {2 + i, concat ? 16 : 8, concat ? 0 : 4, 4, i, true};
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_kernel_bf16(const __grid_constant__ Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);  // the same, generic
  const uint32_t ring = base, act = base + kActOff, uvp = base + kUvOff,
                 head = base + kHeadOff;
  const uint32_t full = base + kBarOff, empty = full + 8 * kStages;
  float* const tbias = reinterpret_cast<float*>(sm + kTrunkBiasOff);
  const int tiles = a.tiles_n * a.frames;
  const int layers = a.depth + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < a.depth * kWidth; i += kThreads)
    tbias[i] = a.b[i / kWidth][i % kWidth];
  // W_out^T [8 n][256 k], zero past n = 3: panel p holds k 64p.., 16-byte
  // unit u of row n (k 64p + 8u ..) at u ^ n
  const uint16_t* w_out = reinterpret_cast<const uint16_t*>(a.w_out);
  for (int i = threadIdx.x; i < 4 * 8 * 8; i += kThreads) {
    const int p = i / 64, n = (i / 8) % 8, u = i % 8, k = 64 * p + 8 * u;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (n < kOutCh) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = (uint32_t)w_out[(k + 2 * e) * kOutCh + n] |
               ((uint32_t)w_out[(k + 2 * e + 1) * kOutCh + n] << 16);
    }
    *reinterpret_cast<uint4*>(sm + kHeadOff + p * kHeadPanel + n * 128 + ((u ^ n) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  fence_proxy_async();
  __syncthreads();

  // the warpgroup, uniform across each warp (setmaxnreg is .sync.aligned)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;
      for (int q = blockIdx.x; q < tiles; q += gridDim.x) {
        for (int l = 0; l < layers; ++l) {
          const Layer ly = layer_at(l, a.skip);
          const CUtensorMap* map = &a.maps[ly.map];
          for (int c = 0; c < ly.chunks; ++c, ++it) {
            const int s = it % kStages;
            const uint32_t st = ring + s * kStageBytes, bar = full + 8 * s;
            mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(bar, kStageBytes);
#pragma unroll
            for (int j = 0; j < 4; ++j) tma_load(st + j * kBox, map, 64 * j, kChunk * c, bar);
          }
        }
      }
    }
  } else {
    // ---- consumers: rows 64 wg .. of each tile -----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float* const fbias = reinterpret_cast<float*>(sm + kFrameBiasOff) + wg * 2 * kWidth;
    // the thread's accumulator rows in the tile: r and r + 8 (r % 8 ==
    // lane / 4 for both, the swizzle's row phase)
    const int r = 64 * wg + 16 * warp + lane / 4;
    const uint32_t* const uv = reinterpret_cast<const uint32_t*>(a.uv);
    float d[128];
    int it = 0;
    for (int q = blockIdx.x; q < tiles; q += gridDim.x) {
      const int f = q / a.tiles_n, r0 = (q % a.tiles_n) * kRows;
      // the warpgroup's 64 uv rows, zero past column 42 and row n: unit u
      // of a row is columns 8u .. 8u + 7, words 4u .. 4u + 3 of its 21
      for (int i = tid; i < 64 * 8; i += 128) {
        const int row = 64 * wg + i / 8, u = i % 8, g = r0 + row;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (g < a.n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * u + e < kUvDim / 2) w[e] = __ldg(uv + (size_t)g * (kUvDim / 2) + 4 * u + e);
        }
        *reinterpret_cast<uint4*>(sm + kUvOff + row * 128 + ((u ^ (row % 8)) << 4)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
      for (int i = tid; i < kWidth; i += 128) {
        fbias[i] = a.b0[(size_t)f * kWidth + i];
        fbias[kWidth + i] = a.bs[(size_t)f * kWidth + i];
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);

      for (int l = 0; l < layers; ++l) {
        const Layer ly = layer_at(l, a.skip);
        // A: chunk c is k 32c .. 32c + 31, in panel c / 2 at byte 64 (c % 2)
        const uint32_t in = (ly.in < 0 ? uvp : act + ly.in * kPanel) + wg * kHalf;
        int prev = 0;
        for (int c = 0; c < ly.chunks; ++c, ++it) {
          const int s = it % kStages;
          mbar_wait(full + 8 * s, (it / kStages) & 1);
          const uint32_t sa = in + (c / 2) * kPanel + 64 * (c % 2);
          const uint32_t sb = ring + s * kStageBytes;
#pragma unroll
          for (int i = 0; i < 128; ++i) pin(d[i]);
          wgmma_fence();  // the accumulators' registers are settled
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk)
            wgmma(d, sw128_desc(sa + 32 * kk, 16, 1024), sw128_desc(sb + 2048 * kk, kBox, 1024),
                  (c | kk) != 0);
          wgmma_commit();
          // the chunk before is done: release its stage
          wgmma_wait<1>();
          if (c > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
          prev = s;
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 128; ++i) pin(d[i]);
        if (lane == 0) mbar_arrive(empty + 8 * prev);

        // epilogue: column 8j + 2 (lane % 4) (+1) of rows r and r + 8, in
        // panel out + j / 8, unit (j % 8) ^ (r % 8)
        const float* const bias =
            ly.bias == -1 ? fbias : ly.bias == -2 ? fbias + kWidth : tbias + ly.bias * kWidth;
        unsigned char* const o = sm + kActOff + ly.out * kPanel + r * 128 + 4 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * (lane % 4));
          float v0 = d[4 * j] + bb.x, v1 = d[4 * j + 1] + bb.y;
          float v2 = d[4 * j + 2] + bb.x, v3 = d[4 * j + 3] + bb.y;
          if (ly.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
            v2 = fmaxf(v2, 0.f);
            v3 = fmaxf(v3, 0.f);
          }
          unsigned char* const p = o + (j / 8) * kPanel + (((j % 8) ^ (lane / 4)) << 4);
          *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v0, v1);
          *reinterpret_cast<uint32_t*>(p + 8 * 128) = pack_bf16x2(v2, v3);
        }
        fence_proxy_async();
        bar_sync(1 + wg, 128);
      }

      // head: h (panels 4-7) @ W_out^T, 16 k steps of m64n8k16
      float o4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pin(o4[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWidth / 16; ++kk)
        wgmma(o4,
              sw128_desc(act + (4 + kk / 4) * kPanel + wg * kHalf + 32 * (kk % 4), 16, 1024),
              sw128_desc(head + (kk / 4) * kHeadPanel + 32 * (kk % 4), 16, 1024), kk != 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 4; ++i) pin(o4[i]);
      // o4[0..1]: columns 2 (lane % 4) and one more of row r, o4[2..3] of r + 8
      const int c0 = 2 * (lane % 4);
      if (c0 < kOutCh) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int g = r0 + r + 8 * h;
          if (g < a.n) {
            float* const dst = a.out + ((size_t)f * a.n + g) * kOutCh + c0;
            dst[0] = o4[2 * h] + a.b_out[c0];
            if (c0 + 1 < kOutCh) dst[1] = o4[2 * h + 1] + a.b_out[c0 + 1];
          }
        }
      }
    }
  }
}

int launch(const void* uv, const void* b0, const void* bs, const void* const* w_ptrs,
           const void* const* b_ptrs, const void* w_out, const void* b_out, void* out, int n,
           int frames, int depth, int skip, cudaStream_t stream) {
  if (depth < 2 || depth > kMaxDepth || skip < 0 || skip + 1 >= depth || n <= 0 ||
      frames <= 0 || (reinterpret_cast<uintptr_t>(uv) & 3u) != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  // W_uv and W_skip have 42 rows: the boxes past them read zeros
  for (int i = 0; i < depth + 2; ++i) {
    const uint64_t rows = i < 2 ? kUvDim : (i == skip + 3 ? 2 * kWidth : kWidth);
    const int err = make_map(&a.maps[i], w_ptrs[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kWidth,
                             rows, 2 * kWidth, 64, kChunk);
    if (err) return err;
  }
  a.uv = static_cast<const __nv_bfloat16*>(uv);
  a.b0 = static_cast<const float*>(b0);
  a.bs = static_cast<const float*>(bs);
  for (int i = 0; i < kMaxDepth; ++i)
    a.b[i] = i < depth ? static_cast<const float*>(b_ptrs[i]) : nullptr;
  a.w_out = static_cast<const __nv_bfloat16*>(w_out);
  a.b_out = static_cast<const float*>(b_out);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.frames = frames;
  a.depth = depth;
  a.skip = skip;
  a.tiles_n = (n + kRows - 1) / kRows;
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_kernel_bf16,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const long long tiles = (long long)a.tiles_n * frames;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_mlp_kernel_bf16<<<tiles < sms ? (int)tiles : sms, kThreads, kBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace hopper

template <typename T>
int launch(const void* uv, const void* b0, const void* bs, const void* const* w_ptrs,
           const void* const* b_ptrs, const void* w_out, const void* b_out, void* out,
           int n, int frames, int depth, int skip, void* stream) {
  if (depth < 2 || depth > kMaxDepth || skip < 0 || skip + 1 >= depth || n <= 0 ||
      frames <= 0 || frames > 65535)
    return (int)cudaErrorInvalidValue;
  MlpArgs<T> a;
  a.uv = static_cast<const T*>(uv);
  a.b0 = static_cast<const float*>(b0);
  a.bs = static_cast<const float*>(bs);
  a.w_uv = static_cast<const T*>(w_ptrs[0]);
  a.w_skip = static_cast<const T*>(w_ptrs[1]);
  for (int i = 0; i < kMaxDepth; ++i) {
    a.w[i] = i < depth ? static_cast<const T*>(w_ptrs[2 + i]) : nullptr;
    a.b[i] = i < depth ? static_cast<const float*>(b_ptrs[i]) : nullptr;
  }
  a.w_out = static_cast<const T*>(w_out);
  a.b_out = static_cast<const float*>(b_out);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.depth = depth;
  a.skip = skip;
  const size_t smem = Layout<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRows - 1) / kRows, frames);
  fused_mlp_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_mlp_bf16(const void* uv, const void* b0, const void* bs,
                              const void* const* w_ptrs, const void* const* b_ptrs,
                              const void* w_out, const void* b_out, void* out, int n,
                              int frames, int depth, int skip, void* stream) {
  return hopper::launch(uv, b0, bs, w_ptrs, b_ptrs, w_out, b_out, out, n, frames, depth, skip,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int fused_mlp_f32(const void* uv, const void* b0, const void* bs,
                             const void* const* w_ptrs, const void* const* b_ptrs,
                             const void* w_out, const void* b_out, void* out, int n,
                             int frames, int depth, int skip, void* stream) {
  return launch<float>(uv, b0, bs, w_ptrs, b_ptrs, w_out, b_out, out, n, frames, depth,
                       skip, stream);
}

// Registers per thread, local-memory bytes per thread and shared-memory
// bytes per block (static + the launch's dynamic bytes) of the bf16 (bf16
// 1) or float32 (bf16 0) kernel.
extern "C" int fused_mlp_attrs(int bf16, int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, bf16 ? reinterpret_cast<const void*>(hopper::fused_mlp_kernel_bf16)
                  : reinterpret_cast<const void*>(fused_mlp_kernel<float>));
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)(attr.sharedSizeBytes + (bf16 ? hopper::kBytes : Layout<float>::kBytes));
  return 0;
}
