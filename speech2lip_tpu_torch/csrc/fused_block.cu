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
// bfloat16 body (the serving type), Hopper's: a TMA + mbarrier ring feeding
// wgmma, warp-specialised and persistent, as K1 (fused_mlp.cu; the helpers
// are ptx.cuh's).  The conv is an implicit GEMM with the output channels as
// M and the pixels as N: per tap, D[64 cout][kTw px] += W_tap[64][16 k] .
// patch[16 k][kTw px shifted by the tap].
// - Tiles: kTh = 4 output rows x kTw pixels x 64 output channels; kTw is
//   128, or 80 where that leaves fewer columns idle (the avatar crop's 320,
//   160 and 80: none).  Cout 128 and 256 are two and four tiles next to
//   each other in the tile order, so tiles of one input patch run at the
//   same time on neighbouring SMs and read it from L2.  One block per SM
//   walks the tiles blockIdx.x, + gridDim.x, ...; the ring runs on from one
//   tile into the next, so a tile's epilogue overlaps the next one's loads.
// - Roles: warpgroup 2 is the producer (104 registers), warpgroups 0 and 1
//   the consumers (200), two tile rows each: a m64nNk16 accumulator per
//   row, N = kTw, 2 x kTw / 2 float32 a thread.
// - A stage is 16 input channels: the weights of all 9 taps, one TMA box of
//   w viewed as [9][cin][cout] (64 x 16 x 9, 128-byte swizzled; rows past
//   cin read as zeros), read as an MN-major A (transpose bit), a tap 2 KB
//   further; and the (kTh + 2) x (kTw + 2) input patch, 32 bytes a pixel,
//   one 4-D TMA box of x viewed as [b][h][wd][c0] with the 32-byte swizzle
//   (the 16-byte halves of pixels 4..7 of every 8 swapped).  Boxes reaching
//   past the image read zeros: the conv's zero padding costs nothing.  The
//   patch is a K-major B with that swizzle: a pixel is one 32-byte row,
//   8-pixel groups 256 bytes apart, and the swizzle follows the absolute
//   address, so a tap's (dy, dx) shift is only a start-address offset (dy
//   patch rows, dx x 32 bytes).  9 taps x 2 rows = 18 wgmma a consumer and
//   stage.  (Two unswizzled planes of 16-byte pixels, a box each, read 3.6%
//   slower over the dubbing convs: TMA fetched them 16 bytes at a time.)
// - Chunks TMA cannot give (channels of lo, or of a concat width that is
//   no multiple of 8) are computed into the stage's swizzled halves by the
//   producer's 128 threads while the consumers multiply the stages before
//   it, and each producer warp arrives on the stage's full barrier beside
//   the TMA bytes, after fencing its stores to the async proxy.  The
//   upsampled source:
//   where its align-corners taps under a tile fit a window of kLw x kLh
//   pixels of lo (ratios up to about 0.5, the U-Net's), a 4-D TMA box of lo
//   a plane, loaded one lo chunk ahead into one of two slots, and a blend
//   table a tile (each patch column's and row's lower tap in the window and
//   its weight, ac_pos as the float32 body's) make each pixel four 16-byte
//   shared loads and upsampled's blend, rounded to bf16 as it is stored;
//   other ratios blend from device memory (upsampled).  Channels of a concat
//   width that is no multiple of 8 (inc's cin 3) are copied element by
//   element; zeros past cin.
// - Epilogue per consumer warpgroup: BN scale/bias and the ReLU in
//   registers (a thread's accumulator rows are two output channels); each
//   tile row leaves through 16 KB of staging, written by transposing
//   stmatrix (a pixel's 64 channels a 128-byte row, 16-byte units XOR-ed by
//   pixel % 8) and stored as 16-byte pieces of whole pixel rows; the 2x2 max
//   pool of the two rows is in-thread (both columns of a pair are one
//   thread's) and leaves the same way.  Pixels outside the image are never
//   stored.  (TMA stores of the staging rows measured slower: they share
//   the TMA unit with the loads.)
// - 384 threads; 205 KB (kTw 128, 4 stages) or 225 KB (kTw 80, 6 stages)
//   of shared memory, with the window slots 191 KB (3 stages) or 210 KB (5);
//   no local memory (conv3x3_attrs reports it; the smoke run requires 0
//   bytes).  An instance's kTw and window are the launch's choice from
//   the shapes it is given: no argument selects them.
// What bounds it (H100 80GB HBM3, 700 W; tools/bench_fused_block.py): the
// tensor cores by count, 157.5 GFLOP a 500 x 500 frame (0.16 ms at 989
// TFLOP/s); in practice the memory side.  Per conv at batch 32 on 500 x 500
// the body runs at 455-723 TFLOP/s (inc's cin 3 at 39), the ten at 50% of
// the peak; the first body, mma.sync fed by cp.async, ran at 250-317
// (26%), limited by issue rate at eight warps per SM.  Taking away the
// patch's loads sped the ten up 13%, the epilogue 11% (its stores 6%):
// the L2 traffic of the loads and stores, not the MMAs' issue, holds it.
// Upsampling convs (up1's and up2's first) run at 455-472: there the
// producer's blend is the slower side.  Staggering the two consumers by a
// stage, so that one's epilogue overlaps the other's MMAs, gained nothing.
//
// float32 body: the first design, 3xTF32 WMMA (mma.cuh).  A block computes
// an 8x16-pixel tile for all cout channels (one warp per tile row, M = 16
// pixels), looping over input channels in chunks; per chunk the haloed
// input tile and the 9 taps' weights sit in shared memory, loaded 16 bytes
// a thread, not pipelined.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

constexpr int kConsumers = 2;                     // warpgroups on the MMAs
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kRows = 2;                          // output rows a consumer
constexpr int kTh = kConsumers * kRows;           // output rows a tile
constexpr int kNp = 64;                           // output channels a tile (wgmma M)
constexpr int kKc = 16;                           // input channels a stage (a k step)
constexpr int kWBytes = 9 * kKc * 128;            // [9 taps][16 k][64 n], 128-byte swizzled
constexpr int kFullArrivals = 1 + 4;              // the TMA's expect_tx + each producer warp
// registers a thread after setmaxnreg: the block holds what the launch gave
// (65536 / kThreads, rounded down to 8) and setmaxnreg.inc waits for what
// the decrease freed, so the split must not ask for more
constexpr int kProducerRegs = 104, kConsumerRegs = 200;
static_assert(128 * (kConsumers * kConsumerRegs + kProducerRegs) <= 65536 / kThreads / 8 * 8 * kThreads,
              "register split");
constexpr int kSmemMax = 232448;

// Shared memory of the body whose tiles are kTw pixels wide (the wgmma N),
// from a 1 KB aligned base: the ring of stages (the weights, then the
// 32-byte-swizzled input patch), each consumer's staging row; with
// kWin, two slots of the upsample source's window (two planes each) and two
// tiles' blend tables; the full and empty barriers (and the windows').
template <int kTw, bool kWin>
struct Smem {
  static constexpr int kPw = kTw + 2, kPh = kTh + 2;  // patch pixels
  static constexpr int kPatch = kPh * kPw * 32;       // 16 channels, a TMA box
  static constexpr int kStage = (kWBytes + kPatch + 1023) / 1024 * 1024;
  static constexpr int kOut = kTw * 128;              // a tile row x 64 channels
  static constexpr int kLw = kTw / 2 + 8, kLh = kTh / 2 + 4;  // window pixels
  static constexpr int kWinPlane = kLh * kLw * 16;
  static constexpr int kWinBytes = kWin ? 2 * 2 * kWinPlane : 0;
  static constexpr int kTabBytes = kWin ? 2 * (kPw + kPh) * 8 : 0;
  static constexpr int kFixed = kConsumers * kOut + kWinBytes + kTabBytes + 8 * (2 * 8 + 2) + 1024;
  static constexpr int kFit = (kSmemMax - kFixed) / kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kOutOff = kStages * kStage;
  static constexpr int kWinOff = kOutOff + kConsumers * kOut;
  static constexpr int kTabOff = kWinOff + kWinBytes;
  static constexpr int kBarOff = kTabOff + kTabBytes;
  static constexpr int kBytes = kBarOff + 8 * (2 * kStages + 2) + 1024;  // + alignment slack
  static_assert(kStages >= 3 && kBytes <= kSmemMax, "shared memory");
};

struct Args {
  CUtensorMap map_x;   // x as [b][h][wd][c0] (c0 % 8 == 0): boxes 16 x (kTw + 2) x kTh + 2 x 1
  CUtensorMap map_w;   // w as [9][cin][cout]: boxes 64 x 16 x 9, 128-byte swizzled
  CUtensorMap map_lo;  // with kWin, lo as [b][hl][wl][c1]: boxes 8 x kLw x kLh x 1
  ConvArgs<bf16> a;
  int cout, tiles_x, tiles_y, tiles, chunks;
};

struct Tile {
  int b, y0, x0, n0;  // image, first row / column, first output channel
};

// Byte offset of the 16-byte half h (channels 8h..) of patch pixel i: the
// 32-byte swizzle, halves swapped in pixels 4..7 of every 8.
__device__ __forceinline__ int pix_off(int i, int h) { return 32 * i + (((i >> 2) ^ h) & 1) * 16; }

// tile t: output channels fastest, then columns, rows, images
__device__ __forceinline__ Tile tile_at(const Args& p, int t, int tw) {
  const int kn = p.cout / kNp;
  Tile tl;
  tl.n0 = (t % kn) * kNp;
  t /= kn;
  tl.x0 = (t % p.tiles_x) * tw;
  t /= p.tiles_x;
  tl.y0 = (t % p.tiles_y) * kTh;
  tl.b = t / p.tiles_y;
  return tl;
}

// Channels ch .. ch + 7 of tile tl's input patch into their halves of the
// stage's patch, by the producer's 128 threads: x's 16 bytes, the upsampled
// source, or element by element where a concat width is no multiple of 8
// (inc's cin 3); zeros past cin and outside the image (the conv's padding).
template <int kTw>
__device__ void fill_half(const ConvArgs<bf16>& a, const Tile& tl, int ch, unsigned char* patch,
                          int tid) {
  using S = Smem<kTw, false>;
  const int cin = a.c0 + a.c1;
  const bool vec = a.c0 % 8 == 0 && a.c1 % 8 == 0;
  for (int i = tid; i < S::kPh * S::kPw; i += 128) {
    const int y = tl.y0 - 1 + i / S::kPw, x = tl.x0 - 1 + i % S::kPw;
    bf16* const dst = reinterpret_cast<bf16*>(patch + pix_off(i, (ch / 8) & 1));
    const size_t pix = ((size_t)tl.b * a.h + y) * a.wd + x;
    if (y < 0 || y >= a.h || x < 0 || x >= a.wd || ch >= cin) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else if (a.c0 % 8 == 0 && ch + 8 <= a.c0) {  // x's, in a chunk TMA does not give
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(a.x + pix * a.c0 + ch);
    } else if (vec) {
      upsampled<bf16, 8>(a, tl.b, y, x, ch - a.c0, 8, dst);
    } else {
      // x's channels as independent loads and one 16-byte store (2-byte
      // stores at the patch's 32-byte pixel pitch conflict 8 ways), then
      // lo's one by one
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const uint32_t lo = ch + e < a.c0 ? __bfloat16_as_ushort(a.x[pix * a.c0 + ch + e]) : 0u;
        const uint32_t hi =
            ch + e + 1 < a.c0 ? __bfloat16_as_ushort(a.x[pix * a.c0 + ch + e + 1]) : 0u;
        w[e / 2] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
#pragma unroll 1
      for (int c = ch > a.c0 ? ch : a.c0; c < ch + 8 && c < cin; ++c)
        upsampled<bf16, 8>(a, tl.b, y, x, c - a.c0, 1, dst + (c - ch));
    }
  }
}

// The window of lo that tile tl's upsampled pixels read (kWin): its first
// row and column, the lower taps of the first rows and columns inside the
// image.
__device__ __forceinline__ void window_at(const ConvArgs<bf16>& a, const Tile& tl, int& yl0,
                                          int& xl0) {
  float t;
  ac_pos(max(tl.y0 - 1, 0), a.h, a.hl, yl0, t);
  ac_pos(max(tl.x0 - 1, 0), a.wd, a.wl, xl0, t);
}

// Load the window planes of chunk c of tile tl (those of lo's channels)
// into slot, counted on bar; one thread.
template <int kTw>
__device__ void load_window(const Args& p, const Tile& tl, int c, uint32_t slot, uint32_t bar) {
  using S = Smem<kTw, true>;
  const ConvArgs<bf16>& a = p.a;
  int yl0, xl0, n = 0;
  window_at(a, tl, yl0, xl0);
  for (int h = 0; h < 2; ++h) {
    const int ch = c * kKc + 8 * h;
    n += ch >= a.c0 && ch < a.c0 + a.c1;
  }
  s2l::mbar_expect_tx(bar, n * S::kWinPlane);
  for (int h = 0; h < 2; ++h) {
    const int ch = c * kKc + 8 * h;
    if (ch >= a.c0 && ch < a.c0 + a.c1)
      s2l::tma_load(slot + h * S::kWinPlane, &p.map_lo, ch - a.c0, xl0, yl0, tl.b, bar);
  }
}

// Tile tl's blend table (kWin): for each patch column, then each patch
// row, the lower tap's offset in the window and its weight (ac_pos, as
// upsampled), offset -1 outside the image.
template <int kTw>
__device__ void blend_table(const ConvArgs<bf16>& a, const Tile& tl, int2* tab, int tid) {
  using S = Smem<kTw, true>;
  int yl0, xl0;
  window_at(a, tl, yl0, xl0);
  for (int i = tid; i < S::kPw + S::kPh; i += 128) {
    const bool col = i < S::kPw;
    const int v = col ? tl.x0 - 1 + i : tl.y0 - 1 + (i - S::kPw), n = col ? a.wd : a.h;
    int l = -1;
    float t = 0.f;
    if (v >= 0 && v < n) {
      ac_pos(v, n, col ? a.wl : a.hl, l, t);
      l -= col ? xl0 : yl0;
    }
    tab[i] = make_int2(l, __float_as_int(t));
  }
}

// Two channels of the align-corners blend (as upsampled) from the packed
// bf16 pairs of the four taps, packed again.
__device__ __forceinline__ uint32_t blend2(uint32_t w00, uint32_t w01, uint32_t w10,
                                           uint32_t w11, float tx, float ty) {
  float o[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int sh = 16 * (1 - e);  // bf16 -> float: the value in the high half
    const float v00 = __uint_as_float((w00 << sh) & 0xffff0000u);
    const float v01 = __uint_as_float((w01 << sh) & 0xffff0000u);
    const float v10 = __uint_as_float((w10 << sh) & 0xffff0000u);
    const float v11 = __uint_as_float((w11 << sh) & 0xffff0000u);
    const float top = (1.f - tx) * v00 + tx * v01;
    const float bot = (1.f - tx) * v10 + tx * v11;
    o[e] = (1.f - ty) * top + ty * bot;
  }
  return s2l::pack_bf16x2(o[0], o[1]);
}

// The halves of the patch in mask (bit h: channels 8h..) from the window's
// planes by the blend table tab: the upsampled source, from shared memory;
// a pixel's eight window loads are issued before its blends.
template <int kTw>
__device__ void blend_planes(const int2* tab, const unsigned char* win, unsigned char* patch,
                             unsigned mask, int tid) {
  using S = Smem<kTw, true>;
  for (int i = tid; i < S::kPh * S::kPw; i += 128) {
    const int2 cx = tab[i % S::kPw], cy = tab[S::kPw + i / S::kPw];
    const bool in = cx.x >= 0 && cy.x >= 0;
    const float tx = __int_as_float(cx.y), ty = __int_as_float(cy.y);
    const int off = in ? (cy.x * S::kLw + cx.x) * 16 : 0;
    uint4 v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* const t = win + h * S::kWinPlane + off;
      if (in && (mask >> h & 1)) {
        v[h][0] = *reinterpret_cast<const uint4*>(t);
        v[h][1] = *reinterpret_cast<const uint4*>(t + 16);
        v[h][2] = *reinterpret_cast<const uint4*>(t + S::kLw * 16);
        v[h][3] = *reinterpret_cast<const uint4*>(t + S::kLw * 16 + 16);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!(mask >> h & 1)) continue;
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        r.x = blend2(v[h][0].x, v[h][1].x, v[h][2].x, v[h][3].x, tx, ty);
        r.y = blend2(v[h][0].y, v[h][1].y, v[h][2].y, v[h][3].y, tx, ty);
        r.z = blend2(v[h][0].z, v[h][1].z, v[h][2].z, v[h][3].z, tx, ty);
        r.w = blend2(v[h][0].w, v[h][1].w, v[h][2].w, v[h][3].w, tx, ty);
      }
      *reinterpret_cast<uint4*>(patch + pix_off(i, h)) = r;
    }
  }
}

template <int kTw, bool kWin>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel_bf16(const __grid_constant__ Args p) {
  using S = Smem<kTw, kWin>;
  constexpr int kAcc = kTw / 2;  // accumulators a thread for one tile row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = s2l::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);  // the same, generic
  const uint32_t full = base + S::kBarOff, empty = full + 8 * S::kStages;
  const uint32_t win_full = empty + 8 * S::kStages;  // kWin: the two window slots'
  const ConvArgs<bf16>& a = p.a;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      s2l::mbar_init(full + 8 * s, kFullArrivals);
      s2l::mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    s2l::mbar_init(win_full, 1);
    s2l::mbar_init(win_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, uniform across each warp (setmaxnreg is .sync.aligned)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, lane = tid % 32;
  if (wg == kConsumers) {
    // ---- producer: the TMA loads, and the halves the threads compute ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const bool xmap = a.c0 % 8 == 0;
    // kWin: chunks c_up.. of a tile hold lo's channels; window u of them
    // (in the block's order) lands in slot u % 2, loaded one ahead
    const int c_up = a.c0 / kKc;
    const uint32_t win = base + S::kWinOff;
    int it = 0, u = 0;
    if (kWin && tid == 0) load_window<kTw>(p, tile_at(p, blockIdx.x, kTw), c_up, win, win_full);
    for (int t = blockIdx.x, k = 0; t < p.tiles; t += gridDim.x, ++k) {
      const Tile tl = tile_at(p, t, kTw);
      for (int c = 0; c < p.chunks; ++c, ++it) {
        const int s = it % S::kStages, ci0 = c * kKc;
        const uint32_t st = base + s * S::kStage, bar = full + 8 * s;
        unsigned char* const pl = sm + s * S::kStage + kWBytes;
        const bool tma = xmap && ci0 + kKc <= a.c0;  // the chunk's 16 channels all x's
        s2l::mbar_wait(empty + 8 * s, ((it / S::kStages) & 1) ^ 1);
        if (tid == 0) {
          s2l::mbar_expect_tx(bar, kWBytes + (tma ? S::kPatch : 0));
          s2l::tma_load(st, &p.map_w, tl.n0, ci0, 0, bar);
          if (tma) s2l::tma_load(st + kWBytes, &p.map_x, ci0, tl.x0 - 1, tl.y0 - 1, tl.b, bar);
        }
        if (kWin && c >= c_up) {
          int2* const tab = reinterpret_cast<int2*>(sm + S::kTabOff) + (k & 1) * (S::kPw + S::kPh);
          if (c == c_up) blend_table<kTw>(a, tl, tab, tid);
          // every thread is done with window u - 1: its slot takes window u + 1
          s2l::bar_sync(3, 128);
          if (tid == 0) {
            if (c + 1 < p.chunks)
              load_window<kTw>(p, tl, c + 1, win + ((u + 1) & 1) * 2 * S::kWinPlane,
                               win_full + 8 * ((u + 1) & 1));
            else if (t + (int)gridDim.x < p.tiles)
              load_window<kTw>(p, tile_at(p, t + gridDim.x, kTw), c_up,
                               win + ((u + 1) & 1) * 2 * S::kWinPlane,
                               win_full + 8 * ((u + 1) & 1));
          }
          s2l::mbar_wait(win_full + 8 * (u & 1), (u >> 1) & 1);
          unsigned mask = 0;
          for (int h = 0; h < 2; ++h) {
            const int ch = ci0 + 8 * h;
            if (ch >= a.c0 && ch < a.c0 + a.c1)
              mask |= 1u << h;
            else
              fill_half<kTw>(a, tl, ch, pl, tid);  // x's (c0 % 16 == 8) or zeros
          }
          blend_planes<kTw>(tab, sm + S::kWinOff + (u & 1) * 2 * S::kWinPlane, pl, mask, tid);
          ++u;
        } else if (!tma) {
          fill_half<kTw>(a, tl, ci0, pl, tid);
          fill_half<kTw>(a, tl, ci0 + 8, pl, tid);
        }
        s2l::fence_proxy_async();
        __syncwarp();
        if (lane == 0) s2l::mbar_arrive(bar);
      }
    }
  } else {
    // ---- consumers: tile rows kRows * wg .. of each tile ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int warp = tid / 32;
    unsigned char* const stg = sm + S::kOutOff + wg * S::kOut;
    const uint32_t stg_s = base + S::kOutOff + wg * S::kOut;
    float d[kRows][kAcc];
    int it = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int prev = 0;
      for (int c = 0; c < p.chunks; ++c, ++it) {
        const int s = it % S::kStages;
        const uint32_t st = base + s * S::kStage;
        s2l::mbar_wait(full + 8 * s, (it / S::kStages) & 1);
        // B of tile row kRows * wg + r and tap (dy, dx): pixels from patch
        // pixel (kRows * wg + r + dy, dx) on, a 32-byte row each, 8-pixel
        // groups 256 bytes apart
        const uint32_t pb = st + kWBytes + kRows * wg * S::kPw * 32;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int i = 0; i < kAcc; ++i) s2l::pin(d[r][i]);
        s2l::wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint64_t da = s2l::sw128_desc(st + tap * kKc * 128, 1024, 1024);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            s2l::wgmma_ta(d[r], da,
                          s2l::sw32_desc(pb + ((r + tap / 3) * S::kPw + tap % 3) * 32, 256),
                          (c | tap) != 0);
        }
        s2l::wgmma_commit();
        // the chunk before is done: release its stage
        s2l::wgmma_wait<1>();
        if (c > 0 && lane == 0) s2l::mbar_arrive(empty + 8 * prev);
        prev = s;
      }
      s2l::wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < kAcc; ++i) s2l::pin(d[r][i]);
      if (lane == 0) s2l::mbar_arrive(empty + 8 * prev);

      // epilogue: accumulator rows 16 warp + lane / 4 and + 8 are output
      // channels n and n + 8; d[r][4j + e] is column 8j + 2 (lane % 4) +
      // e % 2 of tile row kRows * wg + r
      const Tile tl = tile_at(p, t, kTw);
      const int n = tl.n0 + 16 * warp + lane / 4;
      const float sa = a.scale[n], ba = a.bias[n], sb = a.scale[n + 8], bb = a.bias[n + 8];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const float v = (i & 2) ? d[r][i] * sb + bb : d[r][i] * sa + ba;
          d[r][i] = a.relu ? fmaxf(v, 0.f) : v;
        }
      // out, a tile row at a time through the staging row: the 64 channels
      // of pixel q in 128 bytes, 16-byte unit u (channels 8u..) at u ^ (q %
      // 8).  stsm matrix m of step jj is columns 8 (2 jj + m / 2) .. of
      // channel unit 2 warp + m % 2, stored transposed: a pixel a row.
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s2l::bar_sync(1 + wg, 128);  // the staging row is free
#pragma unroll
        for (int jj = 0; jj < kTw / 16; ++jj) {
          const int m = lane / 8, q = 8 * (2 * jj + m / 2) + lane % 8, u = 2 * warp + m % 2;
          s2l::stsm_x4_trans(stg_s + q * 128 + ((u ^ (lane % 8)) << 4),
                             s2l::pack_bf16x2(d[r][8 * jj], d[r][8 * jj + 1]),
                             s2l::pack_bf16x2(d[r][8 * jj + 2], d[r][8 * jj + 3]),
                             s2l::pack_bf16x2(d[r][8 * jj + 4], d[r][8 * jj + 5]),
                             s2l::pack_bf16x2(d[r][8 * jj + 6], d[r][8 * jj + 7]));
        }
        s2l::bar_sync(1 + wg, 128);
        const int y = tl.y0 + kRows * wg + r;
        for (int i = tid; i < kTw * 8; i += 128) {
          const int q = i / 8, u = i % 8, x = tl.x0 + q;
          if (y < a.h && x < a.wd)
            *reinterpret_cast<uint4*>(a.out + (((size_t)tl.b * a.h + y) * a.wd + x) * p.cout +
                                      tl.n0 + 8 * u) =
                *reinterpret_cast<const uint4*>(stg + q * 128 + ((u ^ (q % 8)) << 4));
        }
      }
      // 2x2 max pool of the two rows: columns 2i, 2i + 1 are d[.][4j + e]
      // and d[.][4j + e + 1], pooled column 4j + lane % 4, kept in d[0][4j]
      // (channel n) and d[0][4j + 2] (n + 8).  stsm matrix m of step jj is
      // pooled columns 8 jj + lane % 4 (register low half) and + 4 (high),
      // channel unit 2 warp + m: stored row k is pooled column 8 jj + k / 2
      // + 4 (k % 2).
      if (a.pool != nullptr) {
#pragma unroll
        for (int i = 0; i < kAcc; i += 2)
          d[0][i] = fmaxf(fmaxf(d[0][i], d[0][i + 1]), fmaxf(d[1][i], d[1][i + 1]));
        s2l::bar_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < kTw / 16; ++jj) {
          const int k = lane % 8, q = 8 * jj + k / 2 + 4 * (k % 2), u = 2 * warp + (lane / 8) % 2;
          s2l::stsm_x2_trans(stg_s + q * 128 + ((u ^ (q % 8)) << 4),
                             s2l::pack_bf16x2(d[0][8 * jj], d[0][8 * jj + 4]),
                             s2l::pack_bf16x2(d[0][8 * jj + 2], d[0][8 * jj + 6]));
        }
        s2l::bar_sync(1 + wg, 128);
        const int hp = a.h / 2, wp = a.wd / 2, y2 = tl.y0 / 2 + wg;
        for (int i = tid; i < kTw * 4; i += 128) {
          const int q = i / 8, u = i % 8, x2 = tl.x0 / 2 + q;
          if (y2 < hp && x2 < wp)
            *reinterpret_cast<uint4*>(a.pool + (((size_t)tl.b * hp + y2) * wp + x2) * p.cout +
                                      tl.n0 + 8 * u) =
                *reinterpret_cast<const uint4*>(stg + q * 128 + ((u ^ (q % 8)) << 4));
        }
      }
    }
  }
}

// Tiles of an image wd pixels wide: 128 pixels, or 80 where that leaves
// fewer columns idle (the avatar crop's 320, 160 and 80).
inline int tile_width(int wd) {
  return (wd + 79) / 80 * 80 < (wd + 127) / 128 * 128 ? 80 : 128;
}

// Whether tile rows of kTw pixels read their upsampled pixels from a
// window of lo of Smem's size: 16-byte channel runs, and at most kLw x kLh
// lower taps under kTw + 1 columns and kTh + 1 rows (ceil(n r) + 2, one
// more for ac_pos's float rounding; the U-Net's ratio is about 0.5).
template <int kTw>
bool window_fits(const ConvArgs<bf16>& a) {
  using S = Smem<kTw, true>;
  if (a.c1 == 0 || a.c0 % 8 != 0 || a.c1 % 8 != 0) return false;
  const double rx = (double)(a.wl - 1) / (a.wd - 1), ry = (double)(a.hl - 1) / (a.h - 1);
  return ceil((kTw + 1) * rx) + 3 <= S::kLw && ceil((kTh + 1) * ry) + 3 <= S::kLh;
}

template <int kTw, bool kWin>
int launch_tw(Args& p, cudaStream_t stream) {
  using S = Smem<kTw, kWin>;
  const ConvArgs<bf16>& a = p.a;
  if (a.c0 % 8 == 0) {
    const uint64_t dims[4] = {(uint64_t)a.c0, (uint64_t)a.wd, (uint64_t)a.h, (uint64_t)a.b};
    const uint64_t strides[3] = {2ull * a.c0, 2ull * a.c0 * a.wd, 2ull * a.c0 * a.wd * a.h};
    const uint32_t box[4] = {kKc, kTw + 2, kTh + 2, 1};
    const int err = s2l::make_map_nd(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, &p.map_x, a.x, 4, dims, strides, box,
                                       CU_TENSOR_MAP_SWIZZLE_32B);
    if (err) return err;
  }
  if (kWin) {
    const uint64_t dims[4] = {(uint64_t)a.c1, (uint64_t)a.wl, (uint64_t)a.hl, (uint64_t)a.b};
    const uint64_t strides[3] = {2ull * a.c1, 2ull * a.c1 * a.wl, 2ull * a.c1 * a.wl * a.hl};
    const uint32_t box[4] = {8, (uint32_t)S::kLw, (uint32_t)S::kLh, 1};
    const int err = s2l::make_map_nd(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, &p.map_lo, a.lo, 4, dims, strides, box,
                                       CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
  }
  p.tiles_x = (a.wd + kTw - 1) / kTw;
  p.tiles_y = (a.h + kTh - 1) / kTh;
  const long long tiles = (long long)p.tiles_x * p.tiles_y * (p.cout / kNp) * a.b;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel_bf16<kTw, kWin>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  conv3x3_kernel_bf16<kTw, kWin>
      <<<p.tiles < sms ? p.tiles : sms, kThreads, S::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch(const ConvArgs<bf16>& a, int cout, cudaStream_t stream) {
  if (cout != 64 && cout != 128 && cout != 256) return (int)cudaErrorInvalidValue;
  Args p;
  memset(&p, 0, sizeof(p));
  p.a = a;
  p.cout = cout;
  const int cin = a.c0 + a.c1;
  p.chunks = (cin + kKc - 1) / kKc;
  const uint64_t dims[3] = {(uint64_t)cout, (uint64_t)cin, 9};
  const uint64_t strides[2] = {2ull * cout, 2ull * cout * cin};
  const uint32_t box[3] = {kNp, kKc, 9};
  const int err = s2l::make_map_nd(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, &p.map_w, a.w, 3, dims, strides, box,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  if (tile_width(a.wd) == 80)
    return window_fits<80>(a) ? launch_tw<80, true>(p, stream) : launch_tw<80, false>(p, stream);
  return window_fits<128>(a) ? launch_tw<128, true>(p, stream)
                             : launch_tw<128, false>(p, stream);
}

// The largest registers, local memory and shared memory of the instances.
int attrs(int* regs, int* local_bytes, int* smem_bytes) {
  const void* fns[4] = {reinterpret_cast<const void*>(conv3x3_kernel_bf16<128, false>),
                        reinterpret_cast<const void*>(conv3x3_kernel_bf16<128, true>),
                        reinterpret_cast<const void*>(conv3x3_kernel_bf16<80, false>),
                        reinterpret_cast<const void*>(conv3x3_kernel_bf16<80, true>)};
  const int bytes[4] = {Smem<128, false>::kBytes, Smem<128, true>::kBytes,
                        Smem<80, false>::kBytes, Smem<80, true>::kBytes};
  *regs = *local_bytes = *smem_bytes = 0;
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, fns[i]);
    if (err != cudaSuccess) return (int)err;
    *regs = attr.numRegs > *regs ? attr.numRegs : *regs;
    *local_bytes = (int)attr.localSizeBytes > *local_bytes ? (int)attr.localSizeBytes : *local_bytes;
    const int sb = (int)attr.sharedSizeBytes + bytes[i];
    *smem_bytes = sb > *smem_bytes ? sb : *smem_bytes;
  }
  return 0;
}

}  // namespace hb

// One float32 instance: its kernel, shared memory and launch.
template <typename T, int kCout>
struct Inst {
  static const void* fn() { return reinterpret_cast<const void*>(conv3x3_kernel<T, kCout>); }
  static size_t smem() { return ConvLayout<T, kCout>::kBytes; }
  static int launch(const ConvArgs<T>& a, cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem());
    if (err != cudaSuccess) return (int)err;
    dim3 grid((a.wd + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH, a.b);
    conv3x3_kernel<T, kCout><<<grid, ConvLayout<T, kCout>::kThreads, smem(), stream>>>(a);
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
  if constexpr (sizeof(T) == 2)
    return hb::launch(a, cout, s);
  else
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
// bytes per block (static + the launch's dynamic bytes) of one instance:
// float32 the one for cout, bf16 the largest of the tile widths' (one body
// for every cout).
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
  if (!bf16_type) return by_cout<float>(cout, get);
  return cout == 64 || cout == 128 || cout == 256 ? hb::attrs(regs, local_bytes, smem_bytes)
                                                  : (int)cudaErrorInvalidValue;
}
