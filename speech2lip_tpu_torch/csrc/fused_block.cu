// K3: one conv3x3 + folded BatchNorm + ReLU of a post-fusion U-Net block,
// with the block's input fusions.  Replaces the Pallas kernel
// speech2lip_tpu/ops/pallas/conv_hcw.py (fused_block_hcw ->
// _fused_block_impl -> _make_fused_kernel); a block is two launches of
// this kernel (ops/kernels/fused_block.py).  The same kernel with no
// upsample source and no pool is the plain conv3x3 + scale/bias [+ ReLU]
// of K4 (conv_hcw.py:conv3x3_hcw) and K6 (conv_block.py:conv3x3_infer),
// entered through conv3x3_affine_* (ops/kernels/conv_hcw.py and
// conv_block.py); their TPU layouts (haloed HCW, 128-lane and 16-channel
// padding, row-shifted input views) are not carried over.
//
//   in  = concat(x [B,H,W,c0], upsample_align_corners(lo [B,hl,wl,c1]))
//   out = relu?(conv3x3(in, w) * scale + bias)         [B,H,W,cout], NHWC
//   pool (optional) = maxpool2x2(out)                  [B,H/2,W/2,cout]
//
// The upsample and the concat happen while the input tile is loaded, so
// neither tensor exists in device memory; BN and ReLU run in the epilogue,
// and the 2x2 max pool of the post-ReLU tile is a second output.  The mid
// activation between a block's two convs goes through device memory
// (csrc/double_conv.cu keeps it on chip for K5, at the price of a
// recomputed halo).
//
// bfloat16 body (the serving type), for the H100, on K5's mainloop
// (ptx.cuh):
// - Tile: a block computes 16 x 32 output pixels x 64 output channels.
//   Eight warps each own two tile rows, four m16 fragments x eight n8
//   fragments (128 float32 accumulators a thread, s2l::mma_tile).  Cout
//   128 and 256 are two and four such tiles next to each other in the
//   tile order, not passes inside a block: tiles of one input patch run
//   at the same time on neighbouring SMs and read it from L2, and down2
//   (125 x 125) has 512 tiles to spread over 132 SMs instead of 256.
// - Persistent blocks: one per SM (the accumulators leave registers for
//   no second one), walking tiles blockIdx.x, + gridDim.x, ...  The load
//   ring runs on from one tile into the next, so a tile's epilogue
//   overlaps the next tile's first loads.
// - Loads: a four-stage ring of 16-channel chunks, each the 18 x 34 input
//   patch (two planes of 16-byte rows, channels 0-7 and 8-15, so a tap's
//   (dy, dx) shift is a constant offset) and 9 taps x 16 x 64 weights
//   (128-byte rows, 16-byte units XOR-ed by k % 8), 38 KB; filled three
//   chunks ahead by 16-byte cp.async.cg, one barrier a chunk.  Pixels
//   outside the image and channels past cin are copied with src-size 0,
//   which zero-fills: the conv's zero padding costs nothing.  Chunks of
//   the upsampled source cannot be copied: the threads compute them from
//   lo with the align-corners taps (ac_pos / upsampled, as the float32
//   body), round them to bf16 and store them into the stage being filled,
//   synchronously.  Concat widths that are no multiple of 8 (inc's cin 3)
//   fill element by element.
// - MMAs: per tap and chunk a warp loads four A fragments (ldmatrix.x4,
//   one pixel row address per lane) and four pairs of B fragments
//   (ldmatrix.x4.trans), then issues 32 mma.sync m16n8k16 bf16 with
//   float32 sums.
// - Epilogue in registers: BN scale/bias and the ReLU; the 2x2 pool is a
//   max over the thread's two tile rows and one shuffle; out goes through
//   2 KB of shared memory a warp (16 pixels x 64 channels, swizzled) and
//   leaves as 128-byte pixel rows of 16-byte stores.  Pixels outside the
//   image are never stored.
// - 256 threads, 168 KB of shared memory, no local memory (conv3x3_attrs
//   reports it; the smoke run requires 0 bytes).
// What bounds it (H100 80GB HBM3, 700 W, the U-Net's ten convs at 500 x
// 500, batch 8): mma.sync issue at eight warps per SM, 264-313 TFLOP/s a
// conv except inc's Cin 3.  The upsampled chunks cost up1 and up2 about
// 0.3 ms each, though their loads are synchronous: L1 serves most taps.
// A window of lo per stage, copied by cp.async and blended into the patch
// one chunk ahead, measured 3% slower over the five blocks (31 KB more
// shared memory, so a smaller L1) and was dropped.
// Next step: wgmma (B from shared memory by descriptor), which is where
// cuDNN still wins, at Cout 128 (1.13-1.54x this kernel's time).
//
// float32 body: the first design, 3xTF32 WMMA (mma.cuh).  A block computes
// an 8x16-pixel tile for all cout channels (one warp per tile row, M = 16
// pixels), looping over input channels in chunks; per chunk the haloed
// input tile and the 9 taps' weights sit in shared memory, loaded 16 bytes
// a thread, not pipelined.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "ptx.cuh"

namespace {

using s2l::Mma;
using bf16 = __nv_bfloat16;

constexpr int kTileH = 8, kTileW = 16;  // float32 output tile; kTileW = one M fragment

template <typename T>
struct ConvArgs {
  const T* x;        // [B, h, wd, c0]
  const T* lo;       // [B, hl, wl, c1] or null (c1 = 0)
  const T* w;        // [3, 3, c0 + c1, cout]
  const float* scale;
  const float* bias;
  T* out;            // [B, h, wd, cout]
  T* pool;           // [B, h/2, wd/2, cout] or null
  int c0, c1, hl, wl, h, wd, b;
  int relu;          // apply the ReLU in the epilogue
};

template <typename T, int kCout>
struct ConvLayout {
  static constexpr int kThreads = 32 * kTileH;
  static constexpr int kPatchH = kTileH + 2, kPatchW = kTileW + 2;
  static constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte load
  static constexpr int kChunk = 64 / sizeof(T);  // input channels per chunk
  static constexpr int kLdP = kChunk + s2l::kRowPad<T>;
  static constexpr int kLdW = kCout + s2l::kRowPad<T>;
  static constexpr int kLdS = kCout + 4;
  static constexpr size_t kPatchBytes = sizeof(T) * kPatchH * kPatchW * kLdP;
  static constexpr size_t kWBytes = sizeof(T) * 9 * kChunk * kLdW;
  static constexpr size_t kStageBytes = sizeof(float) * kTileH * kTileW * kLdS;
  static constexpr size_t kBytes =
      kPatchBytes + kWBytes > kStageBytes ? kPatchBytes + kWBytes : kStageBytes;
};

// Align-corners bilinear position of output index i along an axis of n
// outputs from m inputs (ops/nn._align_corners_matrix): lower tap, weight.
__device__ __forceinline__ void ac_pos(int i, int n, int m, int& lo, float& t) {
  const float p = (float)i * (float)(m - 1) / (float)(n - 1);
  lo = min(max((int)floorf(p), 0), m - 2);
  t = p - (float)lo;
}

// Channels [ch, ch + cnt) of the upsampled source at full-res (y, x), into
// dst.  cnt is 1, or kVec with ch a multiple of kVec (16-byte loads).
template <typename T, int kVec>
__device__ void upsampled(const ConvArgs<T>& a, int b, int y, int x, int ch, int cnt, T* dst) {
  using M = Mma<T>;
  int y0, x0;
  float ty, tx;
  ac_pos(y, a.h, a.hl, y0, ty);
  ac_pos(x, a.wd, a.wl, x0, tx);
  const T* l = a.lo + (((size_t)b * a.hl + y0) * a.wl + x0) * a.c1 + ch;
  const size_t row = (size_t)a.wl * a.c1;
  const T* taps[4] = {l, l + a.c1, l + row, l + row + a.c1};
  if (cnt == 1) {
    const float top = (1.f - tx) * M::to_float(*taps[0]) + tx * M::to_float(*taps[1]);
    const float bot = (1.f - tx) * M::to_float(*taps[2]) + tx * M::to_float(*taps[3]);
    *dst = M::from_float((1.f - ty) * top + ty * bot);
    return;
  }
  uint4 raw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) raw[k] = *reinterpret_cast<const uint4*>(taps[k]);
  uint4 res;
  T* r = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float v00 = M::to_float(reinterpret_cast<const T*>(&raw[0])[e]);
    const float v01 = M::to_float(reinterpret_cast<const T*>(&raw[1])[e]);
    const float v10 = M::to_float(reinterpret_cast<const T*>(&raw[2])[e]);
    const float v11 = M::to_float(reinterpret_cast<const T*>(&raw[3])[e]);
    const float top = (1.f - tx) * v00 + tx * v01;
    const float bot = (1.f - tx) * v10 + tx * v11;
    r[e] = M::from_float((1.f - ty) * top + ty * bot);
  }
  *reinterpret_cast<uint4*>(dst) = res;
}

template <typename T, int kCout>
__global__ void __launch_bounds__(32 * kTileH) conv3x3_kernel(ConvArgs<T> a) {
  using M = Mma<T>;
  using L = ConvLayout<T, kCout>;
  constexpr int kFrags = kCout / 16;
  constexpr int kVec = L::kVec, kChunk = L::kChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  T* patch = reinterpret_cast<T*>(smem);               // [patch pixels][kLdP]
  T* wsm = reinterpret_cast<T*>(smem + L::kPatchBytes);  // [9*chunk][kLdW]
  float* stage = reinterpret_cast<float*>(smem);        // epilogue, aliases both

  const int b = blockIdx.z, ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int warp = threadIdx.x / 32;
  const int cin = a.c0 + a.c1;

  typename M::C acc[kFrags];
#pragma unroll
  for (int j = 0; j < kFrags; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int ci0 = 0; ci0 < cin; ci0 += kChunk) {
    // input tile: conv zero padding at the image edge, zeros past cin
    const bool direct = ci0 + kChunk <= a.c0 && a.c0 % kVec == 0;
    const bool up = ci0 >= a.c0 && ci0 + kChunk <= cin && a.c1 % kVec == 0;
    if (direct || up) {
      for (int i = threadIdx.x; i < L::kPatchH * L::kPatchW * (kChunk / kVec); i += L::kThreads) {
        const int k = (i % (kChunk / kVec)) * kVec, pix = i / (kChunk / kVec);
        const int y = ty0 + pix / L::kPatchW - 1, x = tx0 + pix % L::kPatchW - 1;
        T* dst = patch + pix * L::kLdP + k;
        if (y < 0 || y >= a.h || x < 0 || x >= a.wd) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        } else if (direct) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
              a.x + (((size_t)b * a.h + y) * a.wd + x) * a.c0 + ci0 + k);
        } else {
          upsampled<T, kVec>(a, b, y, x, ci0 + k - a.c0, kVec, dst);
        }
      }
    } else {
      for (int i = threadIdx.x; i < L::kPatchH * L::kPatchW * kChunk; i += L::kThreads) {
        const int k = i % kChunk, pix = i / kChunk;
        const int y = ty0 + pix / L::kPatchW - 1, x = tx0 + pix % L::kPatchW - 1, ch = ci0 + k;
        T* dst = patch + pix * L::kLdP + k;
        if (y < 0 || y >= a.h || x < 0 || x >= a.wd || ch >= cin)
          *dst = M::from_float(0.f);
        else if (ch < a.c0)
          *dst = a.x[(((size_t)b * a.h + y) * a.wd + x) * a.c0 + ch];
        else
          upsampled<T, kVec>(a, b, y, x, ch - a.c0, 1, dst);
      }
    }
    // weights of the chunk's channels, all 9 taps
    for (int i = threadIdx.x; i < 9 * kChunk * (kCout / kVec); i += L::kThreads) {
      const int n = (i % (kCout / kVec)) * kVec, r = i / (kCout / kVec);
      const int ch = ci0 + r % kChunk, tap = r / kChunk;
      *reinterpret_cast<uint4*>(wsm + r * L::kLdW + n) =
          ch < cin ? *reinterpret_cast<const uint4*>(a.w + ((size_t)tap * cin + ch) * kCout + n)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    const int kend = min(kChunk, cin - ci0);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      for (int kk = 0; kk < kend; kk += M::K) {
        typename M::A af;
        M::load_a(af, patch + ((warp + dy) * L::kPatchW + dx) * L::kLdP + kk, L::kLdP);
#pragma unroll
        for (int j = 0; j < kFrags; ++j)
          M::mma(acc[j], af, wsm + (tap * kChunk + kk) * L::kLdW + j * 16, L::kLdW);
      }
    }
    __syncthreads();
  }

  // epilogue: accumulators -> shared stage -> BN scale/bias [+ ReLU] -> out
#pragma unroll
  for (int j = 0; j < kFrags; ++j)
    wmma::store_matrix_sync(stage + warp * 16 * L::kLdS + j * 16, acc[j], L::kLdS,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW * kCout; i += L::kThreads) {
    const int n = i % kCout, pix = i / kCout;
    const int y = ty0 + pix / kTileW, x = tx0 + pix % kTileW;
    float v = stage[pix * L::kLdS + n] * a.scale[n] + a.bias[n];
    if (a.relu) v = fmaxf(v, 0.f);
    stage[pix * L::kLdS + n] = v;
    if (y < a.h && x < a.wd) a.out[(((size_t)b * a.h + y) * a.wd + x) * kCout + n] = M::from_float(v);
  }
  if (a.pool != nullptr) {
    __syncthreads();
    const int hp = a.h / 2, wp = a.wd / 2;
    for (int i = threadIdx.x; i < (kTileH / 2) * (kTileW / 2) * kCout; i += L::kThreads) {
      const int n = i % kCout, q = i / kCout;
      const int qy = q / (kTileW / 2), qx = q % (kTileW / 2);
      const int y2 = ty0 / 2 + qy, x2 = tx0 / 2 + qx;
      if (y2 < hp && x2 < wp) {
        const float* s = stage + ((2 * qy) * kTileW + 2 * qx) * L::kLdS + n;
        const float m = fmaxf(fmaxf(s[0], s[L::kLdS]),
                              fmaxf(s[kTileW * L::kLdS], s[(kTileW + 1) * L::kLdS]));
        a.pool[(((size_t)b * hp + y2) * wp + x2) * kCout + n] = M::from_float(m);
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 --

namespace hb {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kFrags = s2l::kTileFrags;           // m16 fragments per warp
constexpr int kTh = 16, kTw = 32;                 // output tile, 512 pixels
constexpr int kNp = 64;                           // output channels per tile
constexpr int kKc = 16;                           // input channels per stage
constexpr int kStages = 4;
constexpr int kPatchH = kTh + 2, kPatchW = kTw + 2;
constexpr int kPlaneBytes = kPatchH * kPatchW * 16;  // one 8-channel half
constexpr int kPatchBytes = 2 * kPlaneBytes;
constexpr int kWRow = s2l::kTileWRow;
constexpr int kWBytes = 9 * kKc * kWRow;
constexpr int kStageBytes = kPatchBytes + kWBytes;
constexpr int kScratchBytes = 16 * kWRow;          // a warp's 16 pixels x 64 channels
constexpr int kBytes = kStages * kStageBytes + kWarps * kScratchBytes;
static_assert(kWarps * kFrags * 16 == kTh * kTw, "a warp owns two tile rows");
static_assert(kBytes <= 232448, "shared memory");

// byte offset of 8-channel half `half` of patch pixel p / of 16-byte unit
// u of weight row r (and of scratch pixel row r)
__device__ __forceinline__ uint32_t patch_off(int p, int half) {
  return half * kPlaneBytes + p * 16;
}
__device__ __forceinline__ uint32_t w_off(int r, int u) { return r * kWRow + ((u ^ (r & 7)) << 4); }

struct TileAt {
  int b, y0, x0, n0;  // image, first row / column, first output channel
};

template <int kCout>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel_bf16(ConvArgs<bf16> a) {
  constexpr int kN = kCout / kNp;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring_s = s2l::smem_addr(smem);
  unsigned char* const scratch = smem + kStages * kStageBytes + (threadIdx.x / 32) * kScratchBytes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cin = a.c0 + a.c1, nc = (cin + kKc - 1) / kKc;
  const bool vec = a.c0 % 8 == 0 && a.c1 % 8 == 0;  // 16-byte channel runs
  const int tiles_x = (a.wd + kTw - 1) / kTw, tiles_y = (a.h + kTh - 1) / kTh;
  const int tiles = tiles_x * tiles_y * kN * a.b;
  // tiles blockIdx.x, + gridDim.x, ... (the launch keeps gridDim.x <= tiles)
  const int items = ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * nc;  // chunk fastest

  // tile of item it; output channels fastest, then columns, rows, images
  auto tile_of = [&](int it) {
    int t = blockIdx.x + (it / nc) * gridDim.x;
    TileAt tl;
    tl.n0 = (t % kN) * kNp;
    t /= kN;
    tl.x0 = (t % tiles_x) * kTw;
    t /= tiles_x;
    tl.y0 = (t % tiles_y) * kTh;
    tl.b = t / tiles_y;
    return tl;
  };

  // fill ring stage it % kStages with item it
  auto load = [&](int it) {
    const TileAt tl = tile_of(it);
    const int ci0 = (it % nc) * kKc;
    const uint32_t st = ring_s + (it % kStages) * kStageBytes, ws = st + kPatchBytes;
    unsigned char* const stp = smem + (it % kStages) * kStageBytes;
    // input patch, rows y0-1.., columns x0-1..
    for (int i = threadIdx.x; i < kPatchH * kPatchW * 2; i += kThreads) {
      const int p = i / 2, half = i % 2, ch = ci0 + 8 * half;
      const int y = tl.y0 - 1 + p / kPatchW, x = tl.x0 - 1 + p % kPatchW;
      const bool in = y >= 0 && y < a.h && x >= 0 && x < a.wd;
      const size_t pix = ((size_t)tl.b * a.h + y) * a.wd + x;
      if (vec && (!in || ch < a.c0 || ch >= cin)) {
        const bool ok = in && ch < a.c0;
        s2l::cp_async16(st + patch_off(p, half), ok ? a.x + pix * a.c0 + ch : a.x, ok);
      } else if (vec) {
        upsampled<bf16, 8>(a, tl.b, y, x, ch - a.c0, 8,
                           reinterpret_cast<bf16*>(stp + patch_off(p, half)));
      } else {
        bf16* dst = reinterpret_cast<bf16*>(stp + patch_off(p, half));
#pragma unroll 1
        for (int e = 0; e < 8; ++e) {
          const int c = ch + e;
          if (!in || c >= cin)
            dst[e] = __float2bfloat16(0.f);
          else if (c < a.c0)
            dst[e] = a.x[pix * a.c0 + c];
          else
            upsampled<bf16, 8>(a, tl.b, y, x, c - a.c0, 1, dst + e);
        }
      }
    }
    // the chunk's weights, all 9 taps, output channels n0..n0+63
    for (int i = threadIdx.x; i < 9 * kKc * 8; i += kThreads) {
      const int u = i % 8, r = i / 8, ch = ci0 + r % kKc, tap = r / kKc;
      const bool ok = ch < cin;
      s2l::cp_async16(ws + w_off(r, u),
                      ok ? a.w + ((size_t)tap * cin + ch) * kCout + tl.n0 + 8 * u : a.w, ok);
    }
  };

  float acc[kFrags][8][4];
  s2l::zero_tile(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) load(s);
    s2l::cp_async_commit();
  }
  const int kh = lane / 16;  // the k half this lane addresses
  for (int it = 0; it < items; ++it) {
    s2l::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it landed; every warp is done with stage it - 1
    if (it + kStages - 1 < items) load(it + kStages - 1);
    s2l::cp_async_commit();
    const uint32_t st = ring_s + (it % kStages) * kStageBytes, ws = st + kPatchBytes;
    // fragment g = warp * 4 + f: tile row g / 2, columns (g % 2) * 16..
    uint32_t a0[kFrags];
#pragma unroll
    for (int f = 0; f < kFrags; ++f) {
      const int g = warp * kFrags + f;
      a0[f] = st + patch_off((g / 2) * kPatchW + (g % 2) * 16 + lane % 16, kh);
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t af[kFrags][4];
#pragma unroll
      for (int f = 0; f < kFrags; ++f)
        s2l::ldsm_x4(af[f], a0[f] + ((tap / 3) * kPatchW + tap % 3) * 16);
      s2l::mma_tile(acc, af, ws + tap * kKc * kWRow, lane);
    }
    if (it % nc != nc - 1) continue;

    // epilogue: BN scale/bias [+ ReLU] in registers
    const TileAt tl = tile_of(it);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tl.n0 + 8 * j + 2 * (lane % 4);
      const float sa = a.scale[n], sb = a.scale[n + 1], ba = a.bias[n], bb = a.bias[n + 1];
#pragma unroll
      for (int f = 0; f < kFrags; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[f][j][2 * h] * sa + ba, v1 = acc[f][j][2 * h + 1] * sb + bb;
          if (a.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          acc[f][j][2 * h] = v0;
          acc[f][j][2 * h + 1] = v1;
        }
    }
    // 2x2 max pool: fragments f and f + 2 are tile rows 2 * warp and
    // 2 * warp + 1; lane ^ 4 holds the neighbouring column
    if (a.pool != nullptr) {
      const int hp = a.h / 2, wp = a.wd / 2, y2 = tl.y0 / 2 + warp;
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float m0 = fmaxf(acc[f][j][2 * h], acc[f + 2][j][2 * h]);
            float m1 = fmaxf(acc[f][j][2 * h + 1], acc[f + 2][j][2 * h + 1]);
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
            const int x2 = tl.x0 / 2 + f * 8 + lane / 8 + 4 * h;
            if ((lane & 4) == 0 && y2 < hp && x2 < wp)
              *reinterpret_cast<uint32_t*>(
                  a.pool + (((size_t)tl.b * hp + y2) * wp + x2) * kCout + tl.n0 + 8 * j +
                  2 * (lane % 4)) = s2l::pack_bf16x2(m0, m1);
          }
    }
    // out: each fragment through the warp's scratch, 16 pixels x 64
    // channels, then 16-byte stores of whole 128-byte pixel rows
#pragma unroll
    for (int f = 0; f < kFrags; ++f) {
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = lane / 4 + 8 * h;
          *reinterpret_cast<uint32_t*>(scratch + w_off(p, j) + 4 * (lane % 4)) =
              s2l::pack_bf16x2(acc[f][j][2 * h], acc[f][j][2 * h + 1]);
        }
      __syncwarp();
      const int g = warp * kFrags + f, y = tl.y0 + g / 2;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = lane / 8 + 4 * k, u = lane % 8, x = tl.x0 + (g % 2) * 16 + p;
        if (y < a.h && x < a.wd)
          *reinterpret_cast<uint4*>(a.out + (((size_t)tl.b * a.h + y) * a.wd + x) * kCout +
                                    tl.n0 + 8 * u) =
              *reinterpret_cast<const uint4*>(scratch + w_off(p, u));
      }
    }
    s2l::zero_tile(acc);
  }
}

}  // namespace hb

// One (dtype, cout) instance: its kernel, shared memory and launch.
template <typename T, int kCout>
struct Inst {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static const void* fn() {
    if constexpr (kBf16)
      return reinterpret_cast<const void*>(hb::conv3x3_kernel_bf16<kCout>);
    else
      return reinterpret_cast<const void*>(conv3x3_kernel<T, kCout>);
  }
  static size_t smem() {
    if constexpr (kBf16)
      return hb::kBytes;
    else
      return ConvLayout<T, kCout>::kBytes;
  }
  static int launch(const ConvArgs<T>& a, cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem());
    if (err != cudaSuccess) return (int)err;
    if constexpr (kBf16) {
      int dev = 0, sms = 0;
      if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
      const long long tiles = (long long)((a.wd + hb::kTw - 1) / hb::kTw) *
                              ((a.h + hb::kTh - 1) / hb::kTh) * (kCout / hb::kNp) * a.b;
      if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
      const int grid = (int)(tiles < sms ? tiles : sms);
      hb::conv3x3_kernel_bf16<kCout><<<grid, hb::kThreads, smem(), stream>>>(a);
    } else {
      dim3 grid((a.wd + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH, a.b);
      conv3x3_kernel<T, kCout><<<grid, ConvLayout<T, kCout>::kThreads, smem(), stream>>>(a);
    }
    return (int)cudaGetLastError();
  }
};

// f(Inst<T, cout>{}) for the instantiated widths, 64, 128 and 256
template <typename T, class F>
int by_cout(int cout, F&& f) {
  switch (cout) {
    case 64: return f(Inst<T, 64>{});
    case 128: return f(Inst<T, 128>{});
    case 256: return f(Inst<T, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int launch(const void* x, int c0, const void* lo, int c1, int hl, int wl, const void* w,
           const void* scale, const void* bias, void* out, void* pool, int b, int h, int wd,
           int cout, int relu, void* stream) {
  // the upsample needs two taps a side; a plain conv takes any size
  if (b <= 0 || b > 65535 || h < 1 || wd < 1 || c0 <= 0 || c1 < 0 ||
      (c1 > 0 && (lo == nullptr || hl < 2 || wl < 2 || h < 2 || wd < 2)) || !aligned16(x) ||
      !aligned16(w) || (lo != nullptr && !aligned16(lo)))
    return (int)cudaErrorInvalidValue;
  ConvArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.lo = static_cast<const T*>(lo);
  a.w = static_cast<const T*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<T*>(out);
  a.pool = static_cast<T*>(pool);
  a.c0 = c0;
  a.c1 = c1;
  a.hl = hl;
  a.wl = wl;
  a.h = h;
  a.wd = wd;
  a.b = b;
  a.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_cout<T>(cout, [&](auto inst) { return decltype(inst)::launch(a, s); });
}

}  // namespace

extern "C" int conv3x3_bn_relu_bf16(const void* x, int c0, const void* lo, int c1, int hl,
                                    int wl, const void* w, const void* scale, const void* bias,
                                    void* out, void* pool, int b, int h, int wd, int cout,
                                    void* stream) {
  return launch<bf16>(x, c0, lo, c1, hl, wl, w, scale, bias, out, pool, b, h, wd, cout, 1,
                      stream);
}

extern "C" int conv3x3_bn_relu_f32(const void* x, int c0, const void* lo, int c1, int hl,
                                   int wl, const void* w, const void* scale, const void* bias,
                                   void* out, void* pool, int b, int h, int wd, int cout,
                                   void* stream) {
  return launch<float>(x, c0, lo, c1, hl, wl, w, scale, bias, out, pool, b, h, wd, cout, 1,
                       stream);
}

// out = relu?(conv3x3(x, w, pad 1) * scale + bias): K4 and K6
extern "C" int conv3x3_affine_bf16(const void* x, const void* w, const void* scale,
                                   const void* bias, void* out, int b, int h, int wd, int cin,
                                   int cout, int relu, void* stream) {
  return launch<bf16>(x, cin, nullptr, 0, 0, 0, w, scale, bias, out, nullptr, b, h, wd, cout,
                      relu, stream);
}

extern "C" int conv3x3_affine_f32(const void* x, const void* w, const void* scale,
                                  const void* bias, void* out, int b, int h, int wd, int cin,
                                  int cout, int relu, void* stream) {
  return launch<float>(x, cin, nullptr, 0, 0, 0, w, scale, bias, out, nullptr, b, h, wd, cout,
                       relu, stream);
}

// Registers per thread, local-memory bytes per thread and shared-memory
// bytes per block (static + the launch's dynamic bytes) of one instance.
extern "C" int conv3x3_attrs(int bf16_type, int cout, int* regs, int* local_bytes,
                             int* smem_bytes) {
  auto get = [&](auto inst) {
    using I = decltype(inst);
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, I::fn());
    if (err != cudaSuccess) return (int)err;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *smem_bytes = (int)(attr.sharedSizeBytes + I::smem());
    return 0;
  };
  return bf16_type ? by_cout<bf16>(cout, get) : by_cout<float>(cout, get);
}
