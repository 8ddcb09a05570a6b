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
// A block owns a 14x14 output tile.  Conv1 computes the 16x16 mid region
// around it (one warp per mid row, M = 16 pixels, all cmid channels) from
// an 18x18 input patch streamed by channel chunks, applies scale1/bias1 and
// the ReLU, zeroes the mid positions outside the image (conv2's zero
// padding at the edge: they are 0, not relu(bias1)), rounds to the working
// type as the TPU kernel's mid scratch does, and stores the tile in shared
// memory.  Conv2 then runs from that tile with its weights streamed by
// chunk of cmid, one warp per output row; each warp's 16-pixel M fragment
// covers 14 output columns and 2 junk columns that read past the mid row
// and are never stored.  Implicit GEMM on the tensor cores through mma.cuh
// (bf16 WMMA, 3xTF32 for float32), as K3.
//
// Trade on the H100: the mid activation never goes to device memory (a
// [B,H,W,cmid] write and read saved per DoubleConv), paid with recomputed
// halo work: conv1 computes 256 mid pixels and conv2 224 output pixels per
// 196 useful ones (+31% and +14% MACs).  16x16 mid tiles make each mid row
// one M fragment and keep the mid tile (bf16 cmid 128: 78 KB) beside a
// chunk of conv1 weights (83 KB) and the input patch (31 KB) in one
// block's 227 KB, at one block of 16 warps per SM.  Bound, like K3, by
// un-pipelined chunk loads (each tile streams both convs' weights from L2)
// and tensor-core issue at small tiles.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using s2l::Mma;

constexpr int kTh = 14;                      // output tile rows
constexpr int kMidH = kTh + 2, kMidW = 16;   // mid region; a mid row = one M fragment
constexpr int kTw = kMidW - 2;               // output tile cols
constexpr int kInH = kMidH + 2, kInW = kMidW + 2;
constexpr int kWarps = kMidH;                // one per mid row
constexpr int kThreads = 32 * kWarps;
constexpr int kMidPix = kMidH * kMidW + 16;  // + the pixels conv2's junk columns read

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

template <typename T>
struct DcArgs {
  const T* x;        // [B, h, wd, cin]
  const T* w1;       // [3, 3, cin, cmid]
  const T* w2;       // [3, 3, cmid, cout]
  const float *s1, *b1, *s2, *b2;
  T* out;            // [B, h, wd, cout]
  int cin, h, wd;
};

template <typename T, int kCmid, int kCout>
struct DcLayout {
  static constexpr int kVec = 16 / sizeof(T);             // elements per 16-byte load
  static constexpr int kChunk = sizeof(T) == 2 ? 32 : 8;  // channels per chunk
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

template <typename T, int kCmid, int kCout>
__global__ void __launch_bounds__(kThreads, 1) double_conv_kernel(DcArgs<T> a) {
  using M = Mma<T>;
  using L = DcLayout<T, kCmid, kCout>;
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

template <typename T, int kCmid, int kCout>
int launch_shape(const DcArgs<T>& a, int b, cudaStream_t stream) {
  using L = DcLayout<T, kCmid, kCout>;
  cudaError_t err = cudaFuncSetAttribute(double_conv_kernel<T, kCmid, kCout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.wd + kTw - 1) / kTw, (a.h + kTh - 1) / kTh, b);
  double_conv_kernel<T, kCmid, kCout><<<grid, kThreads, L::kBytes, stream>>>(a);
  return (int)cudaGetLastError();
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
  if (cmid == 64 && cout == 64) return launch_shape<T, 64, 64>(a, b, s);
  if (cmid == 64 && cout == 128) return launch_shape<T, 64, 128>(a, b, s);
  if (cmid == 128 && cout == 64) return launch_shape<T, 128, 64>(a, b, s);
  if (cmid == 128 && cout == 128) return launch_shape<T, 128, 128>(a, b, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int double_conv_bf16(const void* x, const void* w1, const void* s1, const void* b1,
                                const void* w2, const void* s2, const void* b2, void* out,
                                int b, int h, int wd, int cin, int cmid, int cout,
                                void* stream) {
  return launch<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, out, b, h, wd, cin, cmid, cout,
                               stream);
}

extern "C" int double_conv_f32(const void* x, const void* w1, const void* s1, const void* b1,
                               const void* w2, const void* s2, const void* b2, void* out, int b,
                               int h, int wd, int cin, int cmid, int cout, void* stream) {
  return launch<float>(x, w1, s1, b1, w2, s2, b2, out, b, h, wd, cin, cmid, cout, stream);
}
