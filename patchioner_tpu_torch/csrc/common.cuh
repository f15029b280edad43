// Shared helpers for the port's Hopper kernels.
//
// Every kernel is templated on the working element type T (float or
// __nv_bfloat16). Loads widen T to float, stores round float to T, and all
// statistics and accumulators are float. `round_t` applies T's rounding to
// a float without leaving float, which is how the kernels reproduce the
// reference's cast points (a value cast to T and read back).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace pt {

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm statistics of one row of length d, computed by one warp with the
// reference's two-pass formula: mean, then mean((x - mean)^2).
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int d, float eps,
                                          float* mean_out, float* rstd_out) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s += to_f(row[k]);
  const float mu = warp_sum(s) / d;
  float v = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float c = to_f(row[k]) - mu;
    v += c * c;
  }
  const float var = warp_sum(v) / d;
  if (lane == 0) {
    *mean_out = mu;
    *rstd_out = rsqrtf(var + eps);
  }
}

// LN(x) of rows m0 .. m0 + rows - 1 into Ys [rows][DP] as Y (T to round to
// the element type, float to keep f32); zero rows past M. One warp per row,
// the block's warps taking turns.
template <typename T, typename Y>
__device__ void ln_rows_to_smem(const T* x, const T* g, const T* bg, Y* Ys,
                                float* mean_s, float* rstd_s, int m0, int rows,
                                int M, int D, int DP, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += blockDim.x >> 5) {
    const int m = m0 + r;
    if (m < M) row_stats(x + (size_t)m * D, D, eps, &mean_s[r], &rstd_s[r]);
    __syncwarp();
    for (int k = lane; k < D; k += 32) {
      float v = 0.f;
      if (m < M) {
        const float t = (to_f(x[(size_t)m * D + k]) - mean_s[r]) * rstd_s[r];
        v = t * to_f(g[k]) + to_f(bg[k]);
      }
      Ys[r * DP + k] = from_f<Y>(v);
    }
  }
}

// Exact erf GELU, or with `approx` the tanh form of
// jax.nn.gelu(approximate=True): 0.5 h (1 + tanh(sqrt(2/pi) (h + 0.044715 h^3))),
// each written in the order of torch's own CUDA GELU, so that the plain
// versions on the card round as the kernels do.
__device__ __forceinline__ float gelu(float h, bool approx) {
  if (approx) {
    const float cube = h * h * h;
    return h * 0.5f * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * cube)));
  }
  return h * 0.5f * (1.f + erff(h * 0.70710678118654752f));
}

// Element strides of a (batch, head, token) row of 64 values: how the
// attention kernels address q, k, v and their output in either layout.
struct RowLayout {
  long long batch, head, row;
};

}  // namespace pt

// Host side: let a kernel take `bytes` of dynamic shared memory. Without
// the opt-in a block gets 48 KiB in all, its static shared memory
// included (the f32 projection at D = 512: 48 KiB dynamic and 608 bytes
// static), so every size is opted in. The driver is asked once for each
// device, kernel and larger size; later launches find it granted.
template <typename K>
static cudaError_t pt_allow_smem(K kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> granted;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const auto key = std::make_pair(device, reinterpret_cast<const void*>(kernel));
  std::lock_guard<std::mutex> lock(mu);
  const auto it = granted.find(key);
  if (it != granted.end() && it->second >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) granted[key] = bytes;
  return err;
}
