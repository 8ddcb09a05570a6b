// K7: the backward of the differentiable bilinear crop sampler hat_sample.
// Replaces the Pallas kernels of speech2lip_tpu/ops/pallas/hat_sample.py:
// _dsrc (_dsrc_kernel) and _dgrid (_dgrid_kernel).  The forward is K2
// (window_sample.cu).
//
// src [B, Hs, Ws, C] is image[y_off:, x_off:]; the grid holds (x, y) in
// [-1, 1] of the full (height, width) image, align_corners False; the
// crop-local coordinate is ix = (gx + 1) * width/2 - (0.5 + x_off), likewise
// iy, and the sample is sum over taps of hat(ix - col) * hat(iy - row) *
// src[row, col] with hat(u) = max(0, 1 - |u|).  Taps outside the crop do not
// exist: they read as 0 and receive no gradient.
//
// The grid and the cotangent g [B, P, C] are read in place, as K2 reads the
// grid: P points in rows of gw, each point two adjacent floats, any point,
// row and batch stride ([B, P, 2] or a [B, wh, ww, 2] window of a larger
// grid); g with any batch, point and channel stride.  dgrid reads src as
// K2 does (channels adjacent, pixels C apart, any row and batch stride).
//
// dsrc: the TPU kernel wrote the scatter as one dense [Hs, T] x [T, Ws]
// matmul per channel, accumulated over point tiles in a VMEM block that
// stayed resident because a TPU grid runs in order.  Here one thread per
// point adds (hat_y * g) * hat_x into its four taps of a zeroed float32
// [B, Hs, Ws, C] buffer with atomicAdd, since blocks run in any order; the
// wrapper zeroes the buffer and casts it to src's dtype (three device
// launches in bf16, two in float32).  The order of the sums changes from
// run to run.  At May geometry (B 8, ~3.5e5 window points, a 500x500x3
// bf16 source) the zero-fill (24 MB) and the cast (36 MB) move more bytes
// than the scatter itself.  A redesign that binned the points by source
// tile and summed each tile in shared memory, writing it once in src's
// dtype, ran slower (PERF.md §6), both on a dense contiguous window and on
// the train step's own inputs (the coord grid's window view, the
// cotangent zero off the lip box, where it skipped 40% of the points):
// shared memory has no float add on this card (atomicAdd there is a
// compare-and-swap loop) and its three passes cost more than they saved.
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
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// what the host passes, one block of 64-bit words (K2's host path: a single
// ctypes argument costs less host time than two dozen)
struct Args {
  int64_t src, grid, g, out;       // device pointers (src: dgrid only)
  int64_t src_b, src_r;            // src batch and row strides, elements
  int64_t grid_b, grid_r, grid_p;  // grid batch, row and point strides
  int64_t g_b, g_p, g_c;           // g batch, point and channel strides
  int64_t b, hs, ws, c, p, gw;     // p points a batch, in rows of gw
  int64_t y_off, x_off, height, width;
};
constexpr int kArgWords = sizeof(Args) / sizeof(int64_t);

struct Params {
  const void* src;
  const float* grid;
  const void* g;
  void* out;  // dsrc: the float32 sums; dgrid: [B, P, 2] float32
  int64_t src_b, src_r, grid_b, grid_r, grid_p, g_b, g_p, g_c;
  int b, hs, ws, c, p, gw, total;
  float sx, ox, sy, oy;  // ix = (gx + 1) * sx - ox, likewise iy
};

// the grid coordinates of point q of batch bb
__device__ __forceinline__ const float* grid_at(const Params& a, int bb, int q) {
  const int row = q / a.gw, col = q - row * a.gw;
  return a.grid + bb * a.grid_b + row * a.grid_r + col * a.grid_p;
}

template <typename T>
__device__ __forceinline__ const T* g_at(const Params& a, int bb, int q) {
  return static_cast<const T*>(a.g) + bb * a.g_b + q * a.g_p;
}

struct Taps {
  int x0, y0;
  float wx0, wx1, wy0, wy1;
  bool in_x0, in_x1, in_y0, in_y1;

  // The crop coordinate, rounded op by op (no FMA contraction) exactly as
  // K2 and the plain versions compute it, so the floors and the integer
  // test agree with them.
  __device__ __forceinline__ Taps(float gx, float gy, const Params& a) {
    const float ix = __fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), a.sx), a.ox);
    const float iy = __fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), a.sy), a.oy);
    const float fx = floorf(ix), fy = floorf(iy);
    wx1 = ix - fx;
    wy1 = iy - fy;
    wx0 = 1.f - wx1;
    wy0 = 1.f - wy1;
    in_x0 = fx >= 0.f && fx <= (float)(a.ws - 1);
    in_x1 = fx >= -1.f && fx <= (float)(a.ws - 2);
    in_y0 = fy >= 0.f && fy <= (float)(a.hs - 1);
    in_y1 = fy >= -1.f && fy <= (float)(a.hs - 2);
    x0 = in_x0 || in_x1 ? (int)fx : 0;
    y0 = in_y0 || in_y1 ? (int)fy : 0;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) dsrc_kernel(const Params a) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= a.total) return;
  const int bb = idx / a.p, q = idx - bb * a.p;
  const float* gr = grid_at(a, bb, q);
  const Taps t(__ldg(gr), __ldg(gr + 1), a);
  float* d = static_cast<float*>(a.out) + (int64_t)bb * a.hs * a.ws * a.c;
  float* r0 = d + ((int64_t)t.y0 * a.ws + t.x0) * a.c;
  float* r1 = r0 + (int64_t)a.ws * a.c;
  const T* gp = g_at<T>(a, bb, q);
  for (int ch = 0; ch < a.c; ++ch) {
    const float gv = load(gp + ch * a.g_c);
    if (gv == 0.f) continue;
    if (t.in_y0) {
      const float gy = t.wy0 * gv;
      if (t.in_x0) atomicAdd(r0 + ch, gy * t.wx0);
      if (t.in_x1) atomicAdd(r0 + a.c + ch, gy * t.wx1);
    }
    if (t.in_y1) {
      const float gy = t.wy1 * gv;
      if (t.in_x0) atomicAdd(r1 + ch, gy * t.wx0);
      if (t.in_x1) atomicAdd(r1 + a.c + ch, gy * t.wx1);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dgrid_kernel(const Params a) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= a.total) return;
  const int bb = idx / a.p, q = idx - bb * a.p;
  const float* gr = grid_at(a, bb, q);
  const Taps t(__ldg(gr), __ldg(gr + 1), a);
  // hat' of the two columns (rows) around the point: -1 on the left tap,
  // +1 on the right one, both 0 when the coordinate is an integer
  const float dx = t.wx1 != 0.f ? 1.f : 0.f;
  const float dy = t.wy1 != 0.f ? 1.f : 0.f;
  const T* r0 = static_cast<const T*>(a.src) + bb * a.src_b + t.y0 * a.src_r + t.x0 * a.c;
  const T* r1 = r0 + a.src_r;
  const T* gp = g_at<T>(a, bb, q);
  float dix = 0.f, diy = 0.f;
  for (int ch = 0; ch < a.c; ++ch) {
    const float gv = load(gp + ch * a.g_c);
    const float v00 = t.in_y0 && t.in_x0 ? load(r0 + ch) : 0.f;
    const float v01 = t.in_y0 && t.in_x1 ? load(r0 + a.c + ch) : 0.f;
    const float v10 = t.in_y1 && t.in_x0 ? load(r1 + ch) : 0.f;
    const float v11 = t.in_y1 && t.in_x1 ? load(r1 + a.c + ch) : 0.f;
    dix += gv * (t.wy0 * (dx * (v01 - v00)) + t.wy1 * (dx * (v11 - v10)));
    diy += gv * (dy * ((t.wx0 * v10 + t.wx1 * v11) - (t.wx0 * v00 + t.wx1 * v01)));
  }
  float* o = static_cast<float*>(a.out) + 2 * (int64_t)idx;
  o[0] = dix * a.sx;
  o[1] = diy * a.sy;
}

// Params from the host's words; false when the sizes are out of range
bool params(const void* args, int n_words, Params& a) {
  if (n_words != kArgWords) return false;
  Args h;
  memcpy(&h, args, sizeof(Args));
  // every point index fits an int
  if (h.b <= 0 || h.p <= 0 || h.hs <= 0 || h.ws <= 0 || h.c <= 0 || h.gw <= 0 || h.p % h.gw ||
      h.b * h.p > 0x7fffffffLL || h.hs >= (1 << 24) || h.ws >= (1 << 24))
    return false;
  a.src = reinterpret_cast<const void*>(h.src);
  a.grid = reinterpret_cast<const float*>(h.grid);
  a.g = reinterpret_cast<const void*>(h.g);
  a.out = reinterpret_cast<void*>(h.out);
  a.src_b = h.src_b;
  a.src_r = h.src_r;
  a.grid_b = h.grid_b;
  a.grid_r = h.grid_r;
  a.grid_p = h.grid_p;
  a.g_b = h.g_b;
  a.g_p = h.g_p;
  a.g_c = h.g_c;
  a.b = (int)h.b;
  a.hs = (int)h.hs;
  a.ws = (int)h.ws;
  a.c = (int)h.c;
  a.p = (int)h.p;
  a.gw = (int)h.gw;
  a.total = (int)(h.b * h.p);
  a.sx = 0.5f * (float)h.width;
  a.ox = 0.5f + (float)h.x_off;
  a.sy = 0.5f * (float)h.height;
  a.oy = 0.5f + (float)h.y_off;
  return true;
}

int entry(const void* args, int n_words, void* stream, bool bf16, bool dsrc) {
  Params a{};
  if (!params(args, n_words, a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((a.total + kThreads - 1) / kThreads);
  if (dsrc && bf16)
    dsrc_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(a);
  else if (dsrc)
    dsrc_kernel<float><<<blocks, kThreads, 0, s>>>(a);
  else if (bf16)
    dgrid_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(a);
  else
    dgrid_kernel<float><<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// args: the words of Args, n_words of them (checked against the struct).
// dsrc adds into the float32 sums at out, which the caller zeroes.
extern "C" int hat_sample_dsrc_bf16(const void* args, int n_words, void* stream) {
  return entry(args, n_words, stream, true, true);
}

extern "C" int hat_sample_dsrc_f32(const void* args, int n_words, void* stream) {
  return entry(args, n_words, stream, false, true);
}

extern "C" int hat_sample_dgrid_bf16(const void* args, int n_words, void* stream) {
  return entry(args, n_words, stream, true, false);
}

extern "C" int hat_sample_dgrid_f32(const void* args, int n_words, void* stream) {
  return entry(args, n_words, stream, false, false);
}

// registers, local-memory bytes per thread and static shared bytes per
// block of one instance: which 0 dsrc, 1 dgrid
extern "C" int hat_sample_attrs(int which, int bf16, int* regs, int* local_bytes,
                                int* smem_bytes) {
  const void* fn = nullptr;
  if (which == 0)
    fn = bf16 ? reinterpret_cast<const void*>(dsrc_kernel<__nv_bfloat16>)
              : reinterpret_cast<const void*>(dsrc_kernel<float>);
  else if (which == 1)
    fn = bf16 ? reinterpret_cast<const void*>(dgrid_kernel<__nv_bfloat16>)
              : reinterpret_cast<const void*>(dgrid_kernel<float>);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return 0;
}
