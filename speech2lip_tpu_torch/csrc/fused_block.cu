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
// and the 2x2 max pool of the post-ReLU tile is a second output.  The conv
// is an implicit GEMM on the tensor cores (mma.cuh): a block computes an
// 8x16-pixel tile for all cout channels (one warp per tile row, M = 16
// pixels), looping over input channels in chunks; per chunk the haloed
// input tile and the 9 taps' weights sit in shared memory, loaded 16 bytes
// a thread.  Bound on the H100: the un-pipelined chunk loads (the whole
// conv weight streams from L2 once per tile) and tensor-core issue at
// small tiles; 16x16 tiles measured slower.  The mid activation between a
// block's two convs goes through device memory: its traffic is a few
// percent of the block's time at May geometry, while keeping it on chip
// would recompute the mid tile's 1-pixel halo (+41% conv1 work at 8x16;
// csrc/double_conv.cu is that design, for K5).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using s2l::Mma;

constexpr int kTileH = 8, kTileW = 16;  // output tile; kTileW = one M fragment

template <typename T>
struct ConvArgs {
  const T* x;        // [B, h, wd, c0]
  const T* lo;       // [B, hl, wl, c1] or null (c1 = 0)
  const T* w;        // [3, 3, c0 + c1, cout]
  const float* scale;
  const float* bias;
  T* out;            // [B, h, wd, cout]
  T* pool;           // [B, h/2, wd/2, cout] or null
  int c0, c1, hl, wl, h, wd;
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

template <typename T, int kCout>
int launch_cout(const ConvArgs<T>& a, int b, cudaStream_t stream) {
  using L = ConvLayout<T, kCout>;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<T, kCout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.wd + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH, b);
  conv3x3_kernel<T, kCout><<<grid, L::kThreads, L::kBytes, stream>>>(a);
  return (int)cudaGetLastError();
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
  a.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 64: return launch_cout<T, 64>(a, b, s);
    case 128: return launch_cout<T, 128>(a, b, s);
    case 256: return launch_cout<T, 256>(a, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int conv3x3_bn_relu_bf16(const void* x, int c0, const void* lo, int c1, int hl,
                                    int wl, const void* w, const void* scale, const void* bias,
                                    void* out, void* pool, int b, int h, int wd, int cout,
                                    void* stream) {
  return launch<__nv_bfloat16>(x, c0, lo, c1, hl, wl, w, scale, bias, out, pool, b, h, wd,
                               cout, 1, stream);
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
  return launch<__nv_bfloat16>(x, cin, nullptr, 0, 0, 0, w, scale, bias, out, nullptr, b, h,
                               wd, cout, relu, stream);
}

extern "C" int conv3x3_affine_f32(const void* x, const void* w, const void* scale,
                                  const void* bias, void* out, int b, int h, int wd, int cin,
                                  int cout, int relu, void* stream) {
  return launch<float>(x, cin, nullptr, 0, 0, 0, w, scale, bias, out, nullptr, b, h, wd, cout,
                       relu, stream);
}
