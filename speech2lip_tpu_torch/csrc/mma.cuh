// Warp-level 16x16 tensor-core tile products shared by the MLP (K1) and
// conv (K3) kernels, for the two compute types of the port.
//
// bfloat16: one m16n16k16 bf16 WMMA product per step, float32 accumulate.
// float32:  TF32 keeps 10 mantissa bits, too few for the float32 path's
//           tolerance, so each operand is split into hi = tf32(x) and
//           lo = tf32(x - hi) and a step is three m16n16k8 products
//           (lo*hi + hi*lo + hi*hi), close to float32 accuracy at 3x the
//           cost of one TF32 product.
//
// Pointer rules of WMMA: every tile start 32-byte aligned, leading
// dimensions a multiple of 16 bytes.  Callers keep row strides a multiple
// of 32 bytes (``kRowPad`` elements of padding).
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace wmma = nvcuda::wmma;

namespace s2l {

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;
  using C = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  struct A {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> f;
  };

  __device__ static void load_a(A& a, const __nv_bfloat16* p, int ld) {
    wmma::load_matrix_sync(a.f, p, ld);
  }
  // c += a * B, B a row-major 16x16 tile at b.
  __device__ static void mma(C& c, const A& a, const __nv_bfloat16* b, int ld) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
    wmma::load_matrix_sync(bf, b, ld);
    wmma::mma_sync(c, a.f, bf, c);
  }
  __device__ static __nv_bfloat16 from_float(float v) { return __float2bfloat16(v); }
  __device__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
};

template <>
struct Mma<float> {
  static constexpr int K = 8;
  using C = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  using FA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using FB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  struct A {
    FA hi, lo;
  };

  template <class Frag>
  __device__ static void split(Frag& hi, Frag& lo) {
#pragma unroll
    for (int i = 0; i < hi.num_elements; ++i) {
      const float v = hi.x[i];
      const float h = wmma::__float_to_tf32(v);
      hi.x[i] = h;
      lo.x[i] = wmma::__float_to_tf32(v - h);
    }
  }
  __device__ static void load_a(A& a, const float* p, int ld) {
    wmma::load_matrix_sync(a.hi, p, ld);
    split(a.hi, a.lo);
  }
  __device__ static void mma(C& c, const A& a, const float* b, int ld) {
    FB bh, bl;
    wmma::load_matrix_sync(bh, b, ld);
    split(bh, bl);
    wmma::mma_sync(c, a.lo, bh, c);
    wmma::mma_sync(c, a.hi, bl, c);
    wmma::mma_sync(c, a.hi, bh, c);
  }
  __device__ static float from_float(float v) { return v; }
  __device__ static float to_float(float v) { return v; }
};

// Elements of padding that keep a row of T a multiple of 32 bytes longer.
template <typename T>
constexpr int kRowPad = 32 / sizeof(T);

}  // namespace s2l
