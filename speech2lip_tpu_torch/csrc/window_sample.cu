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
// The TPU kernel built the hat weights as one-hot matmuls because a TPU
// gathers slowly.  Here each thread owns one point and gathers its four
// taps directly (through L1; the ~154x170x3 crop of a frame is ~150 KB in
// bf16), float32 weights and sums, output in src's dtype.  Bound on the
// H100: memory latency of the gathers; the work is ~P*B*C*4 loads, a few
// microseconds at May geometry.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void window_sample_kernel(const T* __restrict__ src, const float* __restrict__ grid,
                                     T* __restrict__ out, int b, int hs, int ws, int c, int p,
                                     float sx, float ox, float sy, float oy) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)b * p) return;
  const int bb = (int)(idx / p);
  // rounded op by op (no FMA contraction), as the plain version computes
  // it: a one-ulp shift of a ~400 px coordinate moves the sample by ~3e-5
  const float ix = __fsub_rn(__fmul_rn(__fadd_rn(grid[2 * idx], 1.f), sx), ox);
  const float iy = __fsub_rn(__fmul_rn(__fadd_rn(grid[2 * idx + 1], 1.f), sy), oy);
  const float fx = floorf(ix), fy = floorf(iy);
  const float wx1 = ix - fx, wy1 = iy - fy;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  // taps outside the crop weigh zero (the hat weight of a missing column)
  const bool in_x0 = fx >= 0.f && fx <= (float)(ws - 1);
  const bool in_x1 = fx >= -1.f && fx <= (float)(ws - 2);
  const bool in_y0 = fy >= 0.f && fy <= (float)(hs - 1);
  const bool in_y1 = fy >= -1.f && fy <= (float)(hs - 2);
  const int x0 = in_x0 || in_x1 ? (int)fx : 0;
  const int y0 = in_y0 || in_y1 ? (int)fy : 0;
  const T* s = src + (size_t)bb * hs * ws * c;
  const size_t r0 = (size_t)y0 * ws, r1 = r0 + ws;
  for (int ch = 0; ch < c; ++ch) {
    float top = 0.f, bot = 0.f;
    if (in_y0) {
      if (in_x0) top += wx0 * to_float(s[(r0 + x0) * c + ch]);
      if (in_x1) top += wx1 * to_float(s[(r0 + x0 + 1) * c + ch]);
    }
    if (in_y1) {
      if (in_x0) bot += wx0 * to_float(s[(r1 + x0) * c + ch]);
      if (in_x1) bot += wx1 * to_float(s[(r1 + x0 + 1) * c + ch]);
    }
    out[idx * c + ch] = from_float<T>(wy0 * top + wy1 * bot);
  }
}

template <typename T>
int launch(const void* src, const void* grid, void* out, int b, int hs, int ws, int c, int p,
           int y_off, int x_off, int height, int width, void* stream) {
  if (b <= 0 || p <= 0 || hs <= 0 || ws <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long blocks = ((long)b * p + threads - 1) / threads;
  window_sample_kernel<T><<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const float*>(grid), static_cast<T*>(out), b, hs,
      ws, c, p, 0.5f * (float)width, 0.5f + (float)x_off, 0.5f * (float)height,
      0.5f + (float)y_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_sample_bf16(const void* src, const void* grid, void* out, int b, int hs,
                                  int ws, int c, int p, int y_off, int x_off, int height,
                                  int width, void* stream) {
  return launch<__nv_bfloat16>(src, grid, out, b, hs, ws, c, p, y_off, x_off, height, width,
                               stream);
}

extern "C" int window_sample_f32(const void* src, const void* grid, void* out, int b, int hs,
                                 int ws, int c, int p, int y_off, int x_off, int height,
                                 int width, void* stream) {
  return launch<float>(src, grid, out, b, hs, ws, c, p, y_off, x_off, height, width, stream);
}
