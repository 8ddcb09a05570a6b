// K5: a U-Net DoubleConv, (conv3x3 + folded BatchNorm + ReLU) twice, in
// one launch with the conv1 output kept in shared memory.  Replaces the
// Pallas kernel speech2lip_tpu/ops/pallas/conv_hcw.py:double_conv_hcw
// (_dconv_kernel), which keeps conv1's output in VMEM and recomputes a
// one-row halo of it per row tile; its haloed HCW layout, 128-lane padding
// and packed weights are TPU choices and are not carried over
// (ops/kernels/conv_hcw.py holds the wrapper).
//
//   mid = round_T(relu(conv3x3(x, w1) * scale1 + bias1)), 0 outside the image
//   out = relu(conv3x3(mid, w2) * scale2 + bias2)        NHWC, pad 1 both
//
// Both convs are implicit GEMMs over a block's tile; the two traps of the
// TPU kernel hold in both bodies: mid positions outside the image are 0,
// not relu(bias1) (conv2's zero padding at the image edge), and the mid is
// rounded to the working type before conv2.
//
// bfloat16 body (the serving type), for the H100:
// - Tile: a block owns a kTh x 30 output tile and computes the
//   (kTh + 2) x 32 mid region around it into shared memory, all cmid
//   channels (row stride cmid + 8 elements: an odd number of 16-byte units,
//   so ldmatrix rows of consecutive pixels hit distinct bank groups).
//   cmid 128: 14 x 30 outputs from a 16 x 32 mid tile (139 KB); cmid 64:
//   30 x 30 from 32 x 32 (147 KB).  Against the first K5 (14 x 14 tiles)
//   the recomputed halo falls from +31% conv1 / +14% conv2 MACs to +22% /
//   +22% at cmid 128 and +14% / +14% at cmid 64 (conv2's last M fragments
//   are partly empty).  A block streams conv1's weights from L2 once per
//   conv1 M pass and conv2's once per conv2 M pass: per output pixel 2.1x
//   (cmid 128) and 2.3x (cmid 64) less weight traffic than 14 x 14 tiles.
// - Work: eight warps; a pass is 512 pixels x 64 channels, each warp 64
//   pixels (four m16 fragments) x 64 channels (eight n8 fragments), 128
//   float32 accumulators a thread.  Per tap and 16-channel step a warp
//   loads four A fragments (ldmatrix.x4, one row address per lane, so a
//   tap's (dy, dx) shift is an address offset and no im2col exists) and
//   four pairs of B fragments (ldmatrix.x4.trans of [tap][k][n] weights),
//   then issues 32 mma.sync m16n8k16: each B fragment feeds four MMAs,
//   each A fragment eight (the first K5's WMMA fed each B fragment once).
//   Conv1 runs (kTh + 2) / 16 x cmid / 64 passes over cin, conv2
//   ceil(outputs / 512) x cout / 64 passes over cmid.
// - Loads: a two-stage ring of 16-channel chunks filled by 16-byte
//   cp.async.cg (conv1: the 18 x 34 input patch and 9 taps x 16 x 64
//   weights, 38 KB; conv2: the weights), issued for chunk i + 1 before
//   chunk i's MMAs, one barrier a chunk; the ring runs on across passes and
//   from conv1 into conv2.  Pixels outside the image and channels past cin
//   are copied with src-size 0, which zero-fills: the conv's zero padding
//   costs nothing.  A cin that is no multiple of 8 (inc, cin 3) loads its
//   patch with plain loads instead.  The patch is two planes of 16-byte
//   rows (channels 0-7 and 8-15 of the chunk), so a tap's shift is a
//   constant offset; weight rows are 128 bytes with the 16-byte units
//   XOR-ed by k % 8.  ldmatrix reads of eight consecutive pixels or eight
//   k rows are free of bank conflicts.
// - 256 threads, one block per SM (215-224 KB of shared memory), no local
//   memory (double_conv_attrs reports it; the smoke run requires 0 bytes).
// What bounds it now: mma.sync issue at eight warps per SM with ldmatrix
// traffic of 128 bytes per MMA, the recomputed share above, and one
// un-overlapped ring fill per block; weight traffic from L2 falls to
// 3.1 GB over the U-Net's five DoubleConvs at May shapes, batch 8 (6.5 GB
// with 14 x 14 tiles; chip_smoke.py:k5_weight_bytes).
// Next step: wgmma, with B read once per warpgroup from shared memory by
// descriptor and A still from registers through ldmatrix (so the tap shift
// keeps working), freeing the issue slots and register file that mma.sync
// spends; TMA with an mbarrier ring in place of per-thread cp.async; and
// clusters of 2-4 blocks sharing one multicast weight load, against the
// weight traffic.
//
// float32 body: the first K5 design, 3xTF32 WMMA (mma.cuh).  A block owns
// a 14x14 output tile; conv1 computes the 16x16 mid region (one warp per
// mid row, M = 16 pixels), streaming the 18x18 input patch and the 9 taps'
// weights by channel chunk; conv2 runs from the mid tile, one warp per
// output row (2 junk columns per 16-pixel fragment, never stored).  Loads
// are not pipelined.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "ptx.cuh"

namespace {

using s2l::Mma;
using bf16 = __nv_bfloat16;

template <typename T>
struct DcArgs {
  const T* x;        // [B, h, wd, cin]
  const T* w1;       // [3, 3, cin, cmid]
  const T* w2;       // [3, 3, cmid, cout]
  const float *s1, *b1, *s2, *b2;
  T* out;            // [B, h, wd, cout]
  int cin, h, wd;
};

// ---------------------------------------------------------------- bf16 --

namespace hb {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kFrags = s2l::kTileFrags;          // m16 fragments per warp
constexpr int kPassPix = kWarps * kFrags * 16;   // 512 pixels per pass
constexpr int kNp = 64;                          // channels per pass
constexpr int kKc = 16;                          // channels per ring stage
constexpr int kMidW = 32, kTw = kMidW - 2;       // mid / output tile columns
constexpr int kPassRows = kPassPix / kMidW;      // mid rows per conv1 pass
constexpr int kPatchH = kPassRows + 2, kPatchW = kMidW + 2;
constexpr int kPlaneBytes = kPatchH * kPatchW * 16;  // one 8-channel half
constexpr int kPatchBytes = 2 * kPlaneBytes;
constexpr int kWRow = s2l::kTileWRow;                     // 128-byte rows
constexpr int kWBytes = 9 * kKc * kWRow;
constexpr int kStageBytes = kPatchBytes + kWBytes;

template <int kCmid>
struct Tile {
  static constexpr int kMidH = kCmid == 128 ? 16 : 32;
  static constexpr int kTh = kMidH - 2;
  static constexpr int kLdm = kCmid + 8;  // mid row stride, elements
  static constexpr int kMidBytes = kMidH * kMidW * kLdm * 2;
  static constexpr int kBytes = kMidBytes + 2 * kStageBytes;
  static constexpr int kOutPix = kTh * kTw;
  static constexpr int kPass1M = kMidH / kPassRows;
  static constexpr int kPass2M = (kOutPix + kPassPix - 1) / kPassPix;
  static_assert(kBytes <= 232448, "shared memory");
};

// byte offset of 8-channel half `half` of patch pixel p (two planes of
// 16-byte rows) / of 16-byte unit u of weight row r
__device__ __forceinline__ uint32_t patch_off(int p, int half) {
  return half * kPlaneBytes + p * 16;
}
__device__ __forceinline__ uint32_t w_off(int r, int u) { return r * kWRow + ((u ^ (r & 7)) << 4); }

template <int kCmid, int kCout>
__global__ void __launch_bounds__(kThreads, 1) double_conv_kernel_bf16(DcArgs<bf16> a) {
  using L = Tile<kCmid>;
  constexpr int kN1 = kCmid / kNp, kN2 = kCout / kNp, kC2 = kCmid / kKc;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t mid_s = s2l::smem_addr(smem);
  const uint32_t ring_s = mid_s + L::kMidBytes;

  const int b = blockIdx.z, ty0 = blockIdx.y * L::kTh, tx0 = blockIdx.x * kTw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cin = a.cin, c1 = (cin + kKc - 1) / kKc;
  const int items1 = L::kPass1M * kN1 * c1;  // conv1 chunks, then conv2's
  const int items = items1 + L::kPass2M * kN2 * kC2;

  // fill ring stage (it & 1) with item it
  auto load = [&](int it) {
    const uint32_t st = ring_s + (it & 1) * kStageBytes, ws = st + kPatchBytes;
    if (it < items1) {
      const int ci0 = (it % c1) * kKc, pass = it / c1;
      const int np = pass % kN1, y0 = ty0 - 2 + (pass / kN1) * kPassRows, x0 = tx0 - 2;
      if (cin % 8 == 0) {
        for (int i = threadIdx.x; i < kPatchH * kPatchW * 2; i += kThreads) {
          const int p = i / 2, half = i % 2, ch = ci0 + 8 * half;
          const int y = y0 + p / kPatchW, x = x0 + p % kPatchW;
          const bool ok = y >= 0 && y < a.h && x >= 0 && x < a.wd && ch < cin;
          s2l::cp_async16(st + patch_off(p, half),
                          ok ? a.x + (((size_t)b * a.h + y) * a.wd + x) * cin + ch : a.x, ok);
        }
      } else {
        for (int p = threadIdx.x; p < kPatchH * kPatchW; p += kThreads) {
          const int y = y0 + p / kPatchW, x = x0 + p % kPatchW;
          const bool in = y >= 0 && y < a.h && x >= 0 && x < a.wd;
          const unsigned short* src = reinterpret_cast<const unsigned short*>(
              a.x + (((size_t)b * a.h + (in ? y : 0)) * a.wd + (in ? x : 0)) * cin);
          uint32_t v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int ch = ci0 + 2 * k;
            const uint32_t lo = in && ch < cin ? src[ch] : 0u;
            const uint32_t hi = in && ch + 1 < cin ? src[ch + 1] : 0u;
            v[k] = lo | (hi << 16);
          }
          unsigned char* dst = smem + (st - mid_s);
          *reinterpret_cast<uint4*>(dst + patch_off(p, 0)) = make_uint4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<uint4*>(dst + patch_off(p, 1)) = make_uint4(v[4], v[5], v[6], v[7]);
        }
      }
      for (int i = threadIdx.x; i < 9 * kKc * 8; i += kThreads) {
        const int u = i % 8, r = i / 8, ch = ci0 + r % kKc, tap = r / kKc;
        const bool ok = ch < cin;
        s2l::cp_async16(ws + w_off(r, u),
                        ok ? a.w1 + ((size_t)tap * cin + ch) * kCmid + np * kNp + 8 * u : a.w1, ok);
      }
    } else {
      const int j = it - items1, c0 = (j % kC2) * kKc, np = (j / kC2) % kN2;
      for (int i = threadIdx.x; i < 9 * kKc * 8; i += kThreads) {
        const int u = i % 8, r = i / 8, ch = c0 + r % kKc, tap = r / kKc;
        s2l::cp_async16(ws + w_off(r, u),
                        a.w2 + ((size_t)tap * kCmid + ch) * kCout + np * kNp + 8 * u, true);
      }
    }
  };

  float acc[kFrags][8][4];
  s2l::zero_tile(acc);
  load(0);
  s2l::cp_async_commit();
  for (int it = 0; it < items; ++it) {
    s2l::cp_async_wait_all();
    __syncthreads();  // stage it landed; every warp is done with stage it - 1
    if (it + 1 < items) load(it + 1);
    s2l::cp_async_commit();
    const uint32_t st = ring_s + (it & 1) * kStageBytes, ws = st + kPatchBytes;
    const int kh = lane / 16;  // the k half this lane addresses
    if (it < items1) {
      // conv1 pass (mp, np): mid rows mp*16.., all 32 columns; fragment g
      // = mid row g / 2, columns (g % 2) * 16..
      const int pass = it / c1, mp = pass / kN1, np = pass % kN1;
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
      if (it % c1 == c1 - 1) {
        // BN1 + ReLU, 0 outside the image, rounded to bf16, into the mid tile
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = np * kNp + 8 * j + 2 * (lane % 4);
          const float sa = a.s1[n], sb = a.s1[n + 1], ba = a.b1[n], bb = a.b1[n + 1];
#pragma unroll
          for (int f = 0; f < kFrags; ++f) {
            const int g = warp * kFrags + f, r = mp * kPassRows + g / 2;
            const int iy = ty0 - 1 + r;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = (g % 2) * 16 + lane / 4 + 8 * h, ix = tx0 - 1 + c;
              const bool in = iy >= 0 && iy < a.h && ix >= 0 && ix < a.wd;
              const float v0 = in ? fmaxf(acc[f][j][2 * h] * sa + ba, 0.f) : 0.f;
              const float v1 = in ? fmaxf(acc[f][j][2 * h + 1] * sb + bb, 0.f) : 0.f;
              *reinterpret_cast<uint32_t*>(smem + ((r * kMidW + c) * L::kLdm + n) * 2) =
                  s2l::pack_bf16x2(v0, v1);
            }
          }
        }
        s2l::zero_tile(acc);
      }
    } else {
      // conv2 pass (mp, np): output pixels o = mp*512 + g*16 + lane row,
      // o = oy * 30 + ox; fragment rows past the tile read a valid pixel
      // and are not stored
      const int j2 = it - items1, chunk = j2 % kC2, pass = j2 / kC2;
      const int mp = pass / kN2, np = pass % kN2;
      uint32_t a0[kFrags];
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
        const int o = min(mp * kPassPix + (warp * kFrags + f) * 16 + lane % 16, L::kOutPix - 1);
        a0[f] = mid_s + (((o / kTw) * kMidW + o % kTw) * L::kLdm + chunk * kKc + 8 * kh) * 2;
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint32_t af[kFrags][4];
#pragma unroll
        for (int f = 0; f < kFrags; ++f)
          s2l::ldsm_x4(af[f], a0[f] + ((tap / 3) * kMidW + tap % 3) * L::kLdm * 2);
        s2l::mma_tile(acc, af, ws + tap * kKc * kWRow, lane);
      }
      if (chunk == kC2 - 1) {
        // BN2 + ReLU -> out
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = np * kNp + 8 * j + 2 * (lane % 4);
          const float sa = a.s2[n], sb = a.s2[n + 1], ba = a.b2[n], bb = a.b2[n + 1];
#pragma unroll
          for (int f = 0; f < kFrags; ++f) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = mp * kPassPix + (warp * kFrags + f) * 16 + lane / 4 + 8 * h;
              const int oy = ty0 + o / kTw, ox = tx0 + o % kTw;
              if (o < L::kOutPix && oy < a.h && ox < a.wd)
                *reinterpret_cast<uint32_t*>(
                    a.out + (((size_t)b * a.h + oy) * a.wd + ox) * kCout + n) =
                    s2l::pack_bf16x2(fmaxf(acc[f][j][2 * h] * sa + ba, 0.f),
                                     fmaxf(acc[f][j][2 * h + 1] * sb + bb, 0.f));
            }
          }
        }
        s2l::zero_tile(acc);
      }
    }
  }
}

}  // namespace hb

// ------------------------------------------------------------- float32 --

namespace hf {

constexpr int kTh = 14;                      // output tile rows
constexpr int kMidH = kTh + 2, kMidW = 16;   // mid region; a mid row = one M fragment
constexpr int kTw = kMidW - 2;               // output tile cols
constexpr int kInH = kMidH + 2, kInW = kMidW + 2;
constexpr int kWarps = kMidH;                // one per mid row
constexpr int kThreads = 32 * kWarps;
constexpr int kMidPix = kMidH * kMidW + 16;  // + the pixels conv2's junk columns read

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

using T = float;

template <int kCmid, int kCout>
struct DcLayout {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int kChunk = 8;             // channels per chunk
  static constexpr int kLdM = kCmid + s2l::kRowPad<T>;
  static constexpr int kLdP = kChunk + s2l::kRowPad<T>;
  static constexpr int kLdW1 = kCmid + s2l::kRowPad<T>;
  static constexpr int kLdW2 = kCout + s2l::kRowPad<T>;
  static constexpr size_t kMidBytes = sizeof(T) * kMidPix * kLdM;
  static constexpr size_t kPatchBytes = sizeof(T) * kInH * kInW * kLdP;
  static constexpr size_t kW1Bytes = sizeof(T) * 9 * kChunk * kLdW1;
  static constexpr size_t kW2Bytes = sizeof(T) * 9 * kChunk * kLdW2;
  static constexpr size_t kScratchBytes = sizeof(float) * kWarps * 256;
  // conv1's patch + weights, conv2's weights and the epilogue scratch share
  // one region after the mid tile
  static constexpr size_t kWorkBytes =
      cmax(cmax(kPatchBytes + kW1Bytes, kW2Bytes), kScratchBytes);
  static constexpr size_t kBytes = kMidBytes + kWorkBytes;
};

template <int kCmid, int kCout>
__global__ void __launch_bounds__(kThreads, 1) double_conv_kernel_f32(DcArgs<T> a) {
  using M = Mma<T>;
  using L = DcLayout<kCmid, kCout>;
  constexpr int kVec = L::kVec, kChunk = L::kChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  T* mid = reinterpret_cast<T*>(smem);                      // [kMidPix][kLdM]
  unsigned char* work = smem + L::kMidBytes;
  T* patch = reinterpret_cast<T*>(work);                    // [18*18][kLdP]
  T* w1s = reinterpret_cast<T*>(work + L::kPatchBytes);     // [9*chunk][kLdW1]
  T* w2s = reinterpret_cast<T*>(work);                      // [9*chunk][kLdW2]

  const int b = blockIdx.z, ty0 = blockIdx.y * kTh, tx0 = blockIdx.x * kTw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(work) + warp * 256;  // epilogues
  const int cin = a.cin;

  // -- conv1 over the mid region: rows ty0-1.., cols tx0-1.. --------------
  {
    typename M::C acc[kCmid / 16];
#pragma unroll
    for (int j = 0; j < kCmid / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int ci0 = 0; ci0 < cin; ci0 += kChunk) {
      // input patch: rows ty0-2.., cols tx0-2..; zeros outside the image
      // and past cin
      if (ci0 + kChunk <= cin && cin % kVec == 0) {
        for (int i = threadIdx.x; i < kInH * kInW * (kChunk / kVec); i += kThreads) {
          const int k = (i % (kChunk / kVec)) * kVec, pix = i / (kChunk / kVec);
          const int y = ty0 - 2 + pix / kInW, x = tx0 - 2 + pix % kInW;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (y >= 0 && y < a.h && x >= 0 && x < a.wd)
            v = *reinterpret_cast<const uint4*>(a.x + (((size_t)b * a.h + y) * a.wd + x) * cin +
                                                ci0 + k);
          *reinterpret_cast<uint4*>(patch + pix * L::kLdP + k) = v;
        }
      } else {
        for (int i = threadIdx.x; i < kInH * kInW * kChunk; i += kThreads) {
          const int k = i % kChunk, pix = i / kChunk, ch = ci0 + k;
          const int y = ty0 - 2 + pix / kInW, x = tx0 - 2 + pix % kInW;
          patch[pix * L::kLdP + k] =
              (y < 0 || y >= a.h || x < 0 || x >= a.wd || ch >= cin)
                  ? M::from_float(0.f)
                  : a.x[(((size_t)b * a.h + y) * a.wd + x) * cin + ch];
        }
      }
      for (int i = threadIdx.x; i < 9 * kChunk * (kCmid / kVec); i += kThreads) {
        const int n = (i % (kCmid / kVec)) * kVec, r = i / (kCmid / kVec);
        const int ch = ci0 + r % kChunk, tap = r / kChunk;
        *reinterpret_cast<uint4*>(w1s + r * L::kLdW1 + n) =
            ch < cin ? *reinterpret_cast<const uint4*>(a.w1 + ((size_t)tap * cin + ch) * kCmid + n)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
      const int kend = min(kChunk, cin - ci0);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        for (int kk = 0; kk < kend; kk += M::K) {
          typename M::A af;
          M::load_a(af, patch + ((warp + dy) * kInW + dx) * L::kLdP + kk, L::kLdP);
#pragma unroll
          for (int j = 0; j < kCmid / 16; ++j)
            M::mma(acc[j], af, w1s + (tap * kChunk + kk) * L::kLdW1 + j * 16, L::kLdW1);
        }
      }
      __syncthreads();
    }
    // BN1 + ReLU, 0 outside the image, rounded to T, into the mid tile
    const int my = ty0 - 1 + warp;
#pragma unroll
    for (int j = 0; j < kCmid / 16; ++j) {
      wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int c = e / 16, n = j * 16 + e % 16, mx = tx0 - 1 + c;
        float v = fmaxf(scratch[e] * a.s1[n] + a.b1[n], 0.f);
        if (my < 0 || my >= a.h || mx < 0 || mx >= a.wd) v = 0.f;
        mid[(warp * kMidW + c) * L::kLdM + n] = M::from_float(v);
      }
      __syncwarp();
    }
  }
  for (int i = threadIdx.x; i < (kMidPix - kMidH * kMidW) * L::kLdM; i += kThreads)
    mid[kMidH * kMidW * L::kLdM + i] = M::from_float(0.f);
  __syncthreads();

  // -- conv2 from the mid tile, weights streamed by chunk of cmid ----------
  typename M::C acc[kCout / 16];
#pragma unroll
  for (int j = 0; j < kCout / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  for (int c0 = 0; c0 < kCmid; c0 += kChunk) {
    for (int i = threadIdx.x; i < 9 * kChunk * (kCout / kVec); i += kThreads) {
      const int n = (i % (kCout / kVec)) * kVec, r = i / (kCout / kVec);
      const int ch = c0 + r % kChunk, tap = r / kChunk;
      *reinterpret_cast<uint4*>(w2s + r * L::kLdW2 + n) =
          *reinterpret_cast<const uint4*>(a.w2 + ((size_t)tap * kCmid + ch) * kCout + n);
    }
    __syncthreads();
    if (warp < kTh) {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        for (int kk = 0; kk < kChunk; kk += M::K) {
          typename M::A af;
          M::load_a(af, mid + ((warp + dy) * kMidW + dx) * L::kLdM + c0 + kk, L::kLdM);
#pragma unroll
          for (int j = 0; j < kCout / 16; ++j)
            M::mma(acc[j], af, w2s + (tap * kChunk + kk) * L::kLdW2 + j * 16, L::kLdW2);
        }
      }
    }
    __syncthreads();
  }

  // BN2 + ReLU -> out; columns kTw.. of a fragment are junk
  if (warp < kTh) {
    const int oy = ty0 + warp;
#pragma unroll
    for (int j = 0; j < kCout / 16; ++j) {
      wmma::store_matrix_sync(scratch, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int c = e / 16, n = j * 16 + e % 16, ox = tx0 + c;
        if (c < kTw && oy < a.h && ox < a.wd)
          a.out[(((size_t)b * a.h + oy) * a.wd + ox) * kCout + n] =
              M::from_float(fmaxf(scratch[e] * a.s2[n] + a.b2[n], 0.f));
      }
      __syncwarp();
    }
  }
}

}  // namespace hf

// One (dtype, cmid, cout) instance: its kernel, shared memory and launch.
template <typename T, int kCmid, int kCout>
struct Inst {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static const void* fn() {
    if constexpr (kBf16)
      return reinterpret_cast<const void*>(hb::double_conv_kernel_bf16<kCmid, kCout>);
    else
      return reinterpret_cast<const void*>(hf::double_conv_kernel_f32<kCmid, kCout>);
  }
  static size_t smem() {
    if constexpr (kBf16)
      return hb::Tile<kCmid>::kBytes;
    else
      return hf::DcLayout<kCmid, kCout>::kBytes;
  }
  static int launch(const DcArgs<T>& a, int b, cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem());
    if (err != cudaSuccess) return (int)err;
    if constexpr (kBf16) {
      using L = hb::Tile<kCmid>;
      dim3 grid((a.wd + hb::kTw - 1) / hb::kTw, (a.h + L::kTh - 1) / L::kTh, b);
      hb::double_conv_kernel_bf16<kCmid, kCout><<<grid, hb::kThreads, smem(), stream>>>(a);
    } else {
      dim3 grid((a.wd + hf::kTw - 1) / hf::kTw, (a.h + hf::kTh - 1) / hf::kTh, b);
      hf::double_conv_kernel_f32<kCmid, kCout><<<grid, hf::kThreads, smem(), stream>>>(a);
    }
    return (int)cudaGetLastError();
  }
};

// f(Inst<T, cmid, cout>{}) for the instantiated widths, {64, 128}^2
template <typename T, class F>
int by_shape(int cmid, int cout, F&& f) {
  if (cmid == 64 && cout == 64) return f(Inst<T, 64, 64>{});
  if (cmid == 64 && cout == 128) return f(Inst<T, 64, 128>{});
  if (cmid == 128 && cout == 64) return f(Inst<T, 128, 64>{});
  if (cmid == 128 && cout == 128) return f(Inst<T, 128, 128>{});
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int launch(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
           const void* s2, const void* b2, void* out, int b, int h, int wd, int cin, int cmid,
           int cout, void* stream) {
  if (b <= 0 || b > 65535 || h < 1 || wd < 1 || cin <= 0 || !aligned16(x) ||
      !aligned16(w1) || !aligned16(w2))
    return (int)cudaErrorInvalidValue;
  DcArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.w1 = static_cast<const T*>(w1);
  a.w2 = static_cast<const T*>(w2);
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.out = static_cast<T*>(out);
  a.cin = cin;
  a.h = h;
  a.wd = wd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_shape<T>(cmid, cout, [&](auto inst) { return decltype(inst)::launch(a, b, s); });
}

}  // namespace

extern "C" int double_conv_bf16(const void* x, const void* w1, const void* s1, const void* b1,
                                const void* w2, const void* s2, const void* b2, void* out,
                                int b, int h, int wd, int cin, int cmid, int cout,
                                void* stream) {
  return launch<bf16>(x, w1, s1, b1, w2, s2, b2, out, b, h, wd, cin, cmid, cout, stream);
}

extern "C" int double_conv_f32(const void* x, const void* w1, const void* s1, const void* b1,
                               const void* w2, const void* s2, const void* b2, void* out, int b,
                               int h, int wd, int cin, int cmid, int cout, void* stream) {
  return launch<float>(x, w1, s1, b1, w2, s2, b2, out, b, h, wd, cin, cmid, cout, stream);
}

// Registers per thread, local-memory bytes per thread and shared-memory
// bytes per block (static + the launch's dynamic bytes) of one instance.
extern "C" int double_conv_attrs(int bf16_type, int cmid, int cout, int* regs, int* local_bytes,
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
  return bf16_type ? by_shape<bf16>(cmid, cout, get) : by_shape<float>(cmid, cout, get);
}
