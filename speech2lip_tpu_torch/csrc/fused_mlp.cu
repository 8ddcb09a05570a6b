// K1: fused MLP-v2 trunk of the lip renderer, B frames over N shared uv
// embeddings.  Replaces the Pallas kernel speech2lip_tpu/ops/pallas/
// fused_mlp.py (fused_mlp_batched -> _kernel).
//
//   h   = uv @ W_uv + b0[f]                      (b0 = b_uv + base[f])
//   h   = relu(h @ W_i + b_i),  i = 0..skip      (256 x 256)
//   h   = [uv @ W_skip + bs[f] | h]              (skip half first)
//   h   = relu(h @ W_i + b_i),  i = skip+1..     (512 x 256, then 256 x 256)
//   out = h @ W_out + b_out                      (256 x 3, float32 out)
//
// One block = 64 rows of one frame; the rows' activations stay in shared
// memory across all layers, so device memory sees only uv, the biases, the
// weights (L2-resident, ~1.2 MB in bf16) and the [B, N, 3] output.  The
// weights do not fit in shared memory, so each layer streams them through
// a K-chunk buffer, 16 bytes a thread.  Bound on the H100: tensor-core
// issue and the weight stream from L2 (every block reads the whole weight
// set once); nothing is double-buffered yet.  Activations are rounded to T between layers, as
// the plain PyTorch version does; sums are float32.
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

using s2l::Mma;

constexpr int kWidth = 256;
constexpr int kRows = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUvDim = 42;
constexpr int kUvK = 48;  // kUvDim padded with zeros to a multiple of 16
constexpr int kMaxDepth = 8;
constexpr int kOutCh = 3;

template <typename T>
struct MlpArgs {
  const T* uv;         // [n, 42]
  const float* b0;     // [frames, 256]
  const float* bs;     // [frames, 256]
  const T* w_uv;       // [42, 256]
  const T* w_skip;     // [42, 256]
  const T* w[kMaxDepth];      // trunk i: [256 or 512, 256]
  const float* b[kMaxDepth];  // trunk i: [256]
  const T* w_out;      // [256, 3]
  const float* b_out;  // [3]
  float* out;          // [frames, n, 3]
  int n, depth, skip;
};

template <typename T>
struct Layout {
  static constexpr int kPad = s2l::kRowPad<T>;
  static constexpr int kChunk = 64 / sizeof(T);  // weight rows per chunk
  static constexpr int kLdAct = 2 * kWidth + kPad;
  static constexpr int kLdUv = kUvK + kPad;
  static constexpr int kLdW = kWidth + kPad;
  static constexpr size_t kActBytes = sizeof(T) * kRows * kLdAct;
  static constexpr size_t kUvBytes = sizeof(T) * kRows * kLdUv;
  static constexpr size_t kWBytes = sizeof(T) * kChunk * kLdW;
  static constexpr size_t kScratchBytes = sizeof(float) * kWarps * 256;
  static constexpr size_t kBytes = kActBytes + kUvBytes + kWBytes + kScratchBytes;
};

// out[r, n] = act(in[r, :k_pad] @ W[:k_pad, n] + bias[n]) for the block's
// rows.  W is [k_valid, 256] in device memory (rows >= k_valid read as 0).
// ``out`` may alias ``in``: every warp finishes reading before any writes.
template <typename T>
__device__ void dense256(const T* in, int ld_in, int k_pad, const T* __restrict__ w,
                         int k_valid, const float* __restrict__ bias, bool relu,
                         T* out, int ld_out, T* wsm, float* scratch) {
  using M = Mma<T>;
  using L = Layout<T>;
  constexpr int kRowFrags = kRows / 16;            // 4
  constexpr int kColGroups = kWarps / kRowFrags;   // 2
  constexpr int kFrags = kWidth / 16 / kColGroups;  // 8 column tiles per warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mf = warp % kRowFrags, n0 = (warp / kRowFrags) * kFrags * 16;

  typename M::C acc[kFrags];
#pragma unroll
  for (int j = 0; j < kFrags; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < k_pad; k0 += L::kChunk) {
    const int kc = min(L::kChunk, k_pad - k0);
    constexpr int kVec = 16 / sizeof(T);  // 16-byte loads
    for (int i = threadIdx.x; i < kc * (kWidth / kVec); i += kThreads) {
      const int r = i / (kWidth / kVec), c = (i % (kWidth / kVec)) * kVec, k = k0 + r;
      *reinterpret_cast<uint4*>(wsm + r * L::kLdW + c) =
          k < k_valid ? *reinterpret_cast<const uint4*>(w + (size_t)k * kWidth + c)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    for (int kk = 0; kk < kc; kk += M::K) {
      typename M::A a;
      M::load_a(a, in + mf * 16 * ld_in + k0 + kk, ld_in);
#pragma unroll
      for (int j = 0; j < kFrags; ++j)
        M::mma(acc[j], a, wsm + kk * L::kLdW + n0 + j * 16, L::kLdW);
    }
    __syncthreads();
  }

  float* s = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < kFrags; ++j) {
    wmma::store_matrix_sync(s, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, n = n0 + j * 16 + e % 16;
      float v = s[e] + bias[n];
      if (relu) v = fmaxf(v, 0.f);
      out[(mf * 16 + r) * ld_out + n] = M::from_float(v);
    }
    __syncwarp();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(MlpArgs<T> a) {
  using M = Mma<T>;
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* act = reinterpret_cast<T*>(smem);  // [rows][skip half | h half]
  T* uv = reinterpret_cast<T*>(smem + L::kActBytes);
  T* wsm = reinterpret_cast<T*>(smem + L::kActBytes + L::kUvBytes);
  float* scratch = reinterpret_cast<float*>(smem + L::kActBytes + L::kUvBytes + L::kWBytes);

  const int f = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kRows * kUvK; i += kThreads) {
    const int r = i / kUvK, c = i % kUvK, row = r0 + r;
    uv[r * L::kLdUv + c] = (row < a.n && c < kUvDim)
                               ? a.uv[(size_t)row * kUvDim + c]
                               : M::from_float(0.f);
  }
  __syncthreads();

  T* h = act + kWidth;
  dense256<T>(uv, L::kLdUv, kUvK, a.w_uv, kUvDim, a.b0 + (size_t)f * kWidth, false,
              h, L::kLdAct, wsm, scratch);
  for (int i = 0; i < a.depth; ++i) {
    const bool concat = i == a.skip + 1;
    const int k = concat ? 2 * kWidth : kWidth;
    dense256<T>(concat ? act : h, L::kLdAct, k, a.w[i], k, a.b[i], true, h, L::kLdAct,
                wsm, scratch);
    if (i == a.skip)
      dense256<T>(uv, L::kLdUv, kUvK, a.w_skip, kUvDim, a.bs + (size_t)f * kWidth,
                  false, act, L::kLdAct, wsm, scratch);
  }

  // head: [rows, 256] @ [256, 3 -> 16 zero-padded]; warps 0..3 one row tile each
  constexpr int kLdH = 16;
  for (int i = threadIdx.x; i < kWidth * kLdH; i += kThreads) {
    const int k = i / kLdH, c = i % kLdH;
    wsm[i] = c < kOutCh ? a.w_out[k * kOutCh + c] : M::from_float(0.f);
  }
  __syncthreads();
  if (warp < kRows / 16) {
    typename M::C acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < kWidth; kk += M::K) {
      typename M::A af;
      M::load_a(af, h + warp * 16 * L::kLdAct + kk, L::kLdAct);
      M::mma(acc, af, wsm + kk * kLdH, kLdH);
    }
    float* s = scratch + warp * 256;
    wmma::store_matrix_sync(s, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * kOutCh; e += 32) {
      const int r = e / kOutCh, c = e % kOutCh, row = r0 + warp * 16 + r;
      if (row < a.n)
        a.out[((size_t)f * a.n + row) * kOutCh + c] = s[r * 16 + c] + a.b_out[c];
    }
  }
}

template <typename T>
int launch(const void* uv, const void* b0, const void* bs, const void* const* w_ptrs,
           const void* const* b_ptrs, const void* w_out, const void* b_out, void* out,
           int n, int frames, int depth, int skip, void* stream) {
  if (depth < 2 || depth > kMaxDepth || skip < 0 || skip + 1 >= depth || n <= 0 ||
      frames <= 0 || frames > 65535)
    return (int)cudaErrorInvalidValue;
  MlpArgs<T> a;
  a.uv = static_cast<const T*>(uv);
  a.b0 = static_cast<const float*>(b0);
  a.bs = static_cast<const float*>(bs);
  a.w_uv = static_cast<const T*>(w_ptrs[0]);
  a.w_skip = static_cast<const T*>(w_ptrs[1]);
  for (int i = 0; i < kMaxDepth; ++i) {
    a.w[i] = i < depth ? static_cast<const T*>(w_ptrs[2 + i]) : nullptr;
    a.b[i] = i < depth ? static_cast<const float*>(b_ptrs[i]) : nullptr;
  }
  a.w_out = static_cast<const T*>(w_out);
  a.b_out = static_cast<const float*>(b_out);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.depth = depth;
  a.skip = skip;
  const size_t smem = Layout<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRows - 1) / kRows, frames);
  fused_mlp_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_mlp_bf16(const void* uv, const void* b0, const void* bs,
                              const void* const* w_ptrs, const void* const* b_ptrs,
                              const void* w_out, const void* b_out, void* out, int n,
                              int frames, int depth, int skip, void* stream) {
  return launch<__nv_bfloat16>(uv, b0, bs, w_ptrs, b_ptrs, w_out, b_out, out, n, frames,
                               depth, skip, stream);
}

extern "C" int fused_mlp_f32(const void* uv, const void* b0, const void* bs,
                             const void* const* w_ptrs, const void* const* b_ptrs,
                             const void* w_out, const void* b_out, void* out, int n,
                             int frames, int depth, int skip, void* stream) {
  return launch<float>(uv, b0, bs, w_ptrs, b_ptrs, w_out, b_out, out, n, frames, depth,
                       skip, stream);
}
