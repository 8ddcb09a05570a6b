// K7: the backward of the differentiable bilinear crop sampler hat_sample.
// Replaces the Pallas kernels of speech2lip_tpu/ops/pallas/hat_sample.py:
// _dsrc (_dsrc_kernel) and _dgrid (_dgrid_kernel).  The forward is K2
// (window_sample.cu).
//
// src [B, Hs, Ws, C] is image[y_off:, x_off:]; grid [B, P, 2] holds (x, y)
// in [-1, 1] of the full (height, width) image, align_corners False; the
// crop-local coordinate is ix = (gx + 1) * width/2 - (0.5 + x_off), likewise
// iy, and the sample is sum over taps of hat(ix - col) * hat(iy - row) *
// src[row, col] with hat(u) = max(0, 1 - |u|).  Taps outside the crop do not
// exist: they read as 0 and receive no gradient.
//
// dsrc: the TPU kernel wrote the scatter as one dense [Hs, T] x [T, Ws]
// matmul per channel, accumulated over point tiles in a VMEM block that
// stayed resident because a TPU grid runs in order.  Here one thread per
// point adds (hat_y * g) * hat_x into its four taps of a zeroed float32
// [B, Hs, Ws, C] buffer with atomicAdd, since blocks run in any order; the
// wrapper casts the buffer to src's dtype.  The order of the sums changes
// from run to run.  Bound on the H100: atomic throughput into L2, a few
// points per tap at May geometry (P ~ 43k window points or ~8k depth-loss
// points per frame against a 500x500 source).
//
// dgrid: one thread per point reads the same four taps and forms
// d/d(ix, iy) with hat'(u) = -sign(u) on |u| < 1 and 0 elsewhere, so a
// coordinate that is exactly an integer gets 0 for that component (the
// JAX convention; a floor-based autograd would give s[x0+1] - s[x0]).  The
// width/2 and height/2 chain to the normalised grid happens here too.
// Bound: gather latency, like K2.
//
// Weights and sums are float32 in both dtypes (the TPU kernel quantised the
// bf16 hat weights at 2^-9 before its matmuls).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Taps {
  int x0, y0;
  float wx0, wx1, wy0, wy1;
  bool in_x0, in_x1, in_y0, in_y1;
};

// The crop coordinate, rounded op by op (no FMA contraction) exactly as K2
// and the plain versions compute it, so the floors and the integer test
// agree with them.
__device__ __forceinline__ Taps taps(const float* grid, long idx, int hs, int ws, float sx,
                                     float ox, float sy, float oy) {
  const float ix = __fsub_rn(__fmul_rn(__fadd_rn(grid[2 * idx], 1.f), sx), ox);
  const float iy = __fsub_rn(__fmul_rn(__fadd_rn(grid[2 * idx + 1], 1.f), sy), oy);
  const float fx = floorf(ix), fy = floorf(iy);
  Taps t;
  t.wx1 = ix - fx;
  t.wy1 = iy - fy;
  t.wx0 = 1.f - t.wx1;
  t.wy0 = 1.f - t.wy1;
  t.in_x0 = fx >= 0.f && fx <= (float)(ws - 1);
  t.in_x1 = fx >= -1.f && fx <= (float)(ws - 2);
  t.in_y0 = fy >= 0.f && fy <= (float)(hs - 1);
  t.in_y1 = fy >= -1.f && fy <= (float)(hs - 2);
  t.x0 = t.in_x0 || t.in_x1 ? (int)fx : 0;
  t.y0 = t.in_y0 || t.in_y1 ? (int)fy : 0;
  return t;
}

template <typename T>
__global__ void hat_dsrc_kernel(const float* __restrict__ grid, const T* __restrict__ g,
                                float* __restrict__ dsrc, int b, int hs, int ws, int c, int p,
                                float sx, float ox, float sy, float oy) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)b * p) return;
  const int bb = (int)(idx / p);
  const Taps t = taps(grid, idx, hs, ws, sx, ox, sy, oy);
  float* d = dsrc + (size_t)bb * hs * ws * c;
  const size_t r0 = (size_t)t.y0 * ws, r1 = r0 + ws;
  for (int ch = 0; ch < c; ++ch) {
    const float gv = to_float(g[idx * c + ch]);
    if (gv == 0.f) continue;
    if (t.in_y0) {
      const float gy = t.wy0 * gv;
      if (t.in_x0) atomicAdd(&d[(r0 + t.x0) * c + ch], gy * t.wx0);
      if (t.in_x1) atomicAdd(&d[(r0 + t.x0 + 1) * c + ch], gy * t.wx1);
    }
    if (t.in_y1) {
      const float gy = t.wy1 * gv;
      if (t.in_x0) atomicAdd(&d[(r1 + t.x0) * c + ch], gy * t.wx0);
      if (t.in_x1) atomicAdd(&d[(r1 + t.x0 + 1) * c + ch], gy * t.wx1);
    }
  }
}

template <typename T>
__global__ void hat_dgrid_kernel(const T* __restrict__ src, const float* __restrict__ grid,
                                 const T* __restrict__ g, float* __restrict__ dgrid, int b,
                                 int hs, int ws, int c, int p, float sx, float ox, float sy,
                                 float oy) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)b * p) return;
  const int bb = (int)(idx / p);
  const Taps t = taps(grid, idx, hs, ws, sx, ox, sy, oy);
  // hat' of the two columns (rows) around the point: -1 on the left tap,
  // +1 on the right one, both 0 when the coordinate is an integer
  const float dx = t.wx1 != 0.f ? 1.f : 0.f;
  const float dy = t.wy1 != 0.f ? 1.f : 0.f;
  const T* s = src + (size_t)bb * hs * ws * c;
  const size_t r0 = (size_t)t.y0 * ws, r1 = r0 + ws;
  float dix = 0.f, diy = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    const float gv = to_float(g[idx * c + ch]);
    const float v00 = t.in_y0 && t.in_x0 ? to_float(s[(r0 + t.x0) * c + ch]) : 0.f;
    const float v01 = t.in_y0 && t.in_x1 ? to_float(s[(r0 + t.x0 + 1) * c + ch]) : 0.f;
    const float v10 = t.in_y1 && t.in_x0 ? to_float(s[(r1 + t.x0) * c + ch]) : 0.f;
    const float v11 = t.in_y1 && t.in_x1 ? to_float(s[(r1 + t.x0 + 1) * c + ch]) : 0.f;
    dix += gv * (t.wy0 * (dx * (v01 - v00)) + t.wy1 * (dx * (v11 - v10)));
    diy += gv * (dy * ((t.wx0 * v10 + t.wx1 * v11) - (t.wx0 * v00 + t.wx1 * v01)));
  }
  dgrid[2 * idx] = dix * sx;
  dgrid[2 * idx + 1] = diy * sy;
}

constexpr int kThreads = 256;

int blocks_for(int b, int p) { return (int)(((long)b * p + kThreads - 1) / kThreads); }

template <typename T>
int launch_dsrc(const void* grid, const void* g, void* dsrc, int b, int hs, int ws, int c, int p,
                int y_off, int x_off, int height, int width, void* stream) {
  if (b <= 0 || p <= 0 || hs <= 0 || ws <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  hat_dsrc_kernel<T><<<blocks_for(b, p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<const T*>(g), static_cast<float*>(dsrc), b,
      hs, ws, c, p, 0.5f * (float)width, 0.5f + (float)x_off, 0.5f * (float)height,
      0.5f + (float)y_off);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dgrid(const void* src, const void* grid, const void* g, void* dgrid, int b, int hs,
                 int ws, int c, int p, int y_off, int x_off, int height, int width,
                 void* stream) {
  if (b <= 0 || p <= 0 || hs <= 0 || ws <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  hat_dgrid_kernel<T><<<blocks_for(b, p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const float*>(grid), static_cast<const T*>(g),
      static_cast<float*>(dgrid), b, hs, ws, c, p, 0.5f * (float)width, 0.5f + (float)x_off,
      0.5f * (float)height, 0.5f + (float)y_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hat_sample_dsrc_bf16(const void* grid, const void* g, void* dsrc, int b, int hs,
                                    int ws, int c, int p, int y_off, int x_off, int height,
                                    int width, void* stream) {
  return launch_dsrc<__nv_bfloat16>(grid, g, dsrc, b, hs, ws, c, p, y_off, x_off, height, width,
                                    stream);
}

extern "C" int hat_sample_dsrc_f32(const void* grid, const void* g, void* dsrc, int b, int hs,
                                   int ws, int c, int p, int y_off, int x_off, int height,
                                   int width, void* stream) {
  return launch_dsrc<float>(grid, g, dsrc, b, hs, ws, c, p, y_off, x_off, height, width, stream);
}

extern "C" int hat_sample_dgrid_bf16(const void* src, const void* grid, const void* g,
                                     void* dgrid, int b, int hs, int ws, int c, int p, int y_off,
                                     int x_off, int height, int width, void* stream) {
  return launch_dgrid<__nv_bfloat16>(src, grid, g, dgrid, b, hs, ws, c, p, y_off, x_off, height,
                                     width, stream);
}

extern "C" int hat_sample_dgrid_f32(const void* src, const void* grid, const void* g, void* dgrid,
                                    int b, int hs, int ws, int c, int p, int y_off, int x_off,
                                    int height, int width, void* stream) {
  return launch_dgrid<float>(src, grid, g, dgrid, b, hs, ws, c, p, y_off, x_off, height, width,
                             stream);
}
