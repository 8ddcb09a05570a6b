// K2: bilinear sample of a source crop at P grid points.  Replaces the
// Pallas kernel speech2lip_tpu/ops/pallas/window_sample.py (window_sample
// -> _kernel_bf16 / _kernel).
//
// src [B, Hs, Ws, C] is image[y_off:, x_off:]; grid [B, P, 2] holds (x, y)
// in [-1, 1] normalised to the full (height, width) image, align_corners
// False.  The crop-local coordinate is ix = (gx + 1) * width/2 - (0.5 +
// x_off), likewise iy, and the weights are hat functions max(0, 1 - |ix -
// col|): a bilinear footprint that leaves the crop reads zeros there.
//
// Both inputs are read in place.  src may be a view of a larger frame:
// pixels C elements apart, channels adjacent, any row and batch stride.
// The grid may be a window of a larger [B, H, W, 2] grid: its P points are
// rows of gw points, each point two adjacent floats, any point, row and
// batch stride (a grid made by broadcasting one frame's grid over the
// batch may hold the batch innermost).  So the composite passes the
// frame's crop and the coord grid's window as they are, with no copy
// before the launch.
//
// The TPU kernel built the hat weights as one-hot matmuls because a TPU
// gathers slowly.  Here a thread gathers the four taps of each of four
// consecutive points directly: float32 weights and sums, output in src's
// dtype.  At May geometry (B 8, 3.5e5 points, a 154x170x3 crop) the work
// is ~6 MB moved, ~1.8 us at the HBM rate: the kernel is bound by the
// latency of its dependent loads (grid, then taps) and by the launch.  Four
// points a thread put a thread's 8 grid loads, then its 48 tap loads, in
// flight together (read-only path; the crop is ~1.3 MB and stays in L2).
// With C = 3 a thread's 12 outputs are contiguous and leave as three
// 16-byte (float32) or 8-byte (bf16) stores.  Blocks of 128 threads, 675
// of them at May geometry: one wave on 132 SMs.  A grid that holds the
// batch innermost has its points 2B floats apart, so a warp's grid loads
// touch B / 2 times the sectors (at B 8, 7.3 us against 4.8; PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kPts = 4;  // consecutive points a thread
constexpr int kThreads = 128;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// what the host passes, one block of 64-bit words (a single ctypes argument:
// converting a dozen separate arguments cost more host time than the launch)
struct Args {
  int64_t src, grid, out;    // device pointers
  int64_t src_b, src_r;      // src batch and row strides, elements
  int64_t grid_b, grid_r;    // grid batch and row strides, floats
  int64_t grid_p;            // grid point stride, floats
  int64_t b, hs, ws, c, p;   // p points a batch, in rows of gw
  int64_t gw, y_off, x_off, height, width;
};
constexpr int kArgWords = sizeof(Args) / sizeof(int64_t);

struct Params {
  const void* src;
  const float* grid;
  void* out;
  int64_t src_b, src_r, grid_b, grid_r, grid_p;
  int b, hs, ws, c, p, gw;
  float sx, ox, sy, oy;  // ix = (gx + 1) * sx - ox, likewise iy
};

// the four taps of one point: row pointers and hat weights
template <typename T>
struct Taps {
  const T* r0;
  const T* r1;
  float wx0, wx1, wy0, wy1;
  bool in_x0, in_x1, in_y0, in_y1;

  __device__ __forceinline__ Taps(const T* s, const Params& a, int cs, float gx, float gy) {
    // rounded op by op (no FMA contraction), as the plain version computes
    // it: a one-ulp shift of a ~400 px coordinate moves the sample by ~3e-5
    const float ix = __fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), a.sx), a.ox);
    const float iy = __fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), a.sy), a.oy);
    const float fx = floorf(ix), fy = floorf(iy);
    wx1 = ix - fx;
    wy1 = iy - fy;
    wx0 = 1.f - wx1;
    wy0 = 1.f - wy1;
    // taps outside the crop weigh zero (the hat weight of a missing column)
    in_x0 = fx >= 0.f && fx <= (float)(a.ws - 1);
    in_x1 = fx >= -1.f && fx <= (float)(a.ws - 2);
    in_y0 = fy >= 0.f && fy <= (float)(a.hs - 1);
    in_y1 = fy >= -1.f && fy <= (float)(a.hs - 2);
    const int x0 = in_x0 || in_x1 ? (int)fx : 0;
    const int y0 = in_y0 || in_y1 ? (int)fy : 0;
    r0 = s + (int64_t)y0 * a.src_r + (int64_t)x0 * cs;
    r1 = r0 + a.src_r;
  }

  // channel k of the sample; cs is the pixel stride (C)
  __device__ __forceinline__ float value(int k, int cs) const {
    float top = 0.f, bot = 0.f;
    if (in_y0) {
      if (in_x0) top += wx0 * load(r0 + k);
      if (in_x1) top += wx1 * load(r0 + cs + k);
    }
    if (in_y1) {
      if (in_x0) bot += wx0 * load(r1 + k);
      if (in_x1) bot += wx1 * load(r1 + cs + k);
    }
    return wy0 * top + wy1 * bot;
  }
};

__device__ __forceinline__ void store3x4(float* o, const float (&v)[kPts * 3]) {
  float4* q = reinterpret_cast<float4*>(o);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
  q[2] = make_float4(v[8], v[9], v[10], v[11]);
}
__device__ __forceinline__ void store3x4(__nv_bfloat16* o, const float (&v)[kPts * 3]) {
  uint32_t w[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    memcpy(&w[i], &h, 4);
  }
  uint2* q = reinterpret_cast<uint2*>(o);
  q[0] = make_uint2(w[0], w[1]);
  q[1] = make_uint2(w[2], w[3]);
  q[2] = make_uint2(w[4], w[5]);
}

__device__ __forceinline__ float to_out(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16*) {
  return __float2bfloat16(v);
}

// kC 3: the compile-time channel count of the port's images, with wide
// stores; kC 0: any C, scalar stores
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads) window_sample_kernel(const Params a) {
  const int cs = kC ? kC : a.c;
  const int64_t total = (int64_t)a.b * a.p;
  const int64_t first = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kPts;
  if (first >= total) return;
  int bb = (int)(first / a.p);
  const int q = (int)(first - (int64_t)bb * a.p);
  int row = q / a.gw, col = q - row * a.gw;
  // the grid coordinates of the thread's points first, all loads in flight
  float gx[kPts], gy[kPts];
  int bs[kPts];
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    bs[i] = bb;
    if (first + i < total) {
      const float* g = a.grid + bb * a.grid_b + row * a.grid_r + col * a.grid_p;
      gx[i] = __ldg(g);
      gy[i] = __ldg(g + 1);
    } else {
      gx[i] = gy[i] = 0.f;
    }
    if (++col == a.gw) {  // the next grid row, or the next batch's first
      col = 0;
      if (++row * a.gw == a.p) {
        row = 0;
        ++bb;
      }
    }
  }
  const T* src = static_cast<const T*>(a.src);
  T* out = static_cast<T*>(a.out) + first * cs;
  if (kC == 3 && first + kPts <= total) {
    float v[kPts * 3];
#pragma unroll
    for (int i = 0; i < kPts; ++i) {
      const Taps<T> t(src + bs[i] * a.src_b, a, 3, gx[i], gy[i]);
#pragma unroll
      for (int k = 0; k < 3; ++k) v[3 * i + k] = t.value(k, 3);
    }
    store3x4(out, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < kPts; ++i) {
    if (first + i >= total) break;
    const Taps<T> t(src + bs[i] * a.src_b, a, cs, gx[i], gy[i]);
    for (int k = 0; k < cs; ++k) out[i * cs + k] = to_out(t.value(k, cs), out);
  }
}

template <typename T>
int launch(const Args& h, cudaStream_t stream) {
  // every count fits an int; the pointers and strides are checked by the
  // wrapper (16-byte aligned output, C = pixel stride, channel stride 1)
  if (h.b <= 0 || h.p <= 0 || h.hs <= 0 || h.ws <= 0 || h.c <= 0 || h.gw <= 0 || h.p % h.gw ||
      h.b * h.p > 0x7fffffffLL || h.p > 0x7fffffffLL || h.hs >= (1 << 24) || h.ws >= (1 << 24))
    return (int)cudaErrorInvalidValue;
  Params a;
  a.src = reinterpret_cast<const void*>(h.src);
  a.grid = reinterpret_cast<const float*>(h.grid);
  a.out = reinterpret_cast<void*>(h.out);
  a.src_b = h.src_b;
  a.src_r = h.src_r;
  a.grid_b = h.grid_b;
  a.grid_r = h.grid_r;
  a.grid_p = h.grid_p;
  a.b = (int)h.b;
  a.hs = (int)h.hs;
  a.ws = (int)h.ws;
  a.c = (int)h.c;
  a.p = (int)h.p;
  a.gw = (int)h.gw;
  a.sx = 0.5f * (float)h.width;
  a.ox = 0.5f + (float)h.x_off;
  a.sy = 0.5f * (float)h.height;
  a.oy = 0.5f + (float)h.y_off;
  const int64_t per_block = (int64_t)kThreads * kPts;
  const unsigned blocks = (unsigned)((h.b * h.p + per_block - 1) / per_block);
  if (h.c == 3)
    window_sample_kernel<T, 3><<<blocks, kThreads, 0, stream>>>(a);
  else
    window_sample_kernel<T, 0><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int entry(const void* args, int n_words, void* stream, bool bf16) {
  if (n_words != kArgWords) return (int)cudaErrorInvalidValue;
  Args h;
  memcpy(&h, args, sizeof(Args));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(h, s) : launch<float>(h, s);
}

}  // namespace

// args: the words of Args, n_words of them (checked against the struct)
extern "C" int window_sample_bf16(const void* args, int n_words, void* stream) {
  return entry(args, n_words, stream, true);
}

extern "C" int window_sample_f32(const void* args, int n_words, void* stream) {
  return entry(args, n_words, stream, false);
}
