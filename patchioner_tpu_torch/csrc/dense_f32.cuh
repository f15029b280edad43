// The float32 dense products on the SIMT pipes, so that their sums stay
// exact f32: kernel A's LN(x) @ W + b (ln_dense.cu), and the
// r + ls * (x @ W + b) of kernel E (ln_dense.cu) and of kernel F's
// out-projection (qkv_attention_proj.cu). bf16 runs tensor-core kernels
// instead.
//
// A 64 x 64 output tile a block of 256 threads, 4 x 4 outputs a thread,
// 32-deep slices of x (normalised on the way into shared memory for A) and
// of W. A's block first takes the two-pass f32 LN statistics of its 64
// rows (the reference's mean((x - mean)^2), ops/mlp.py:_ln_rows). Any D and
// O: the ragged edges are masked by bounds.
#pragma once

#include "common.cuh"

namespace pt {
namespace {  // internal linkage: each source that includes this has its own copy

constexpr int DF_THREADS = 256, DF_BM = 64, DF_BN = 64, DF_BK = 32;

// kRes: x copied, out = r + (acc + b) * ls; otherwise LN(x), out = acc + b.
template <bool kRes>
__global__ void __launch_bounds__(DF_THREADS)
dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ bg, const float* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ r,
                 const float* __restrict__ ls, float* __restrict__ out, int M,
                 int D, int O, float eps) {
  __shared__ float mean_s[DF_BM], rstd_s[DF_BM];
  __shared__ float As[DF_BK][DF_BM + 1];  // (normalised) x, [k][row]
  __shared__ float Bs[DF_BK][DF_BN + 4];  // W slice, [k][col]
  const int m0 = blockIdx.y * DF_BM, n0 = blockIdx.x * DF_BN;
  const int tid = threadIdx.x, warp = tid >> 5;

  for (int i = warp; i < DF_BM && !kRes; i += DF_THREADS / 32) {
    const int m = m0 + i;
    if (m < M) {
      row_stats(x + (size_t)m * D, D, eps, &mean_s[i], &rstd_s[i]);
    } else if ((tid & 31) == 0) {
      mean_s[i] = 0.f;
      rstd_s[i] = 0.f;
    }
  }
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += DF_BK) {
    for (int e = tid; e < DF_BM * DF_BK; e += DF_THREADS) {
      const int i = e / DF_BK, k = e % DF_BK;
      const int m = m0 + i, kk = k0 + k;
      float v = 0.f;
      if (m < M && kk < D) {
        v = x[(size_t)m * D + kk];
        if (!kRes) v = (v - mean_s[i]) * rstd_s[i] * g[kk] + bg[kk];
      }
      As[k][i] = v;
    }
    for (int e = tid; e < DF_BK * DF_BN; e += DF_THREADS) {
      const int k = e / DF_BN, n = e % DF_BN;
      const int kk = k0 + k, nn = n0 + n;
      Bs[k][n] = (kk < D && nn < O) ? w[(size_t)kk * O + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < DF_BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= O) continue;
      const size_t o = (size_t)m * O + n;
      out[o] = kRes ? r[o] + (acc[i][j] + bias[n]) * ls[n] : acc[i][j] + bias[n];
    }
  }
}

template <bool kRes>
cudaError_t launch_dense_f32(const float* x, const float* g, const float* bg,
                             const float* w, const float* b, const float* r,
                             const float* ls, float* out, int M, int D, int O,
                             float eps, cudaStream_t s) {
  dim3 grid((O + DF_BN - 1) / DF_BN, (M + DF_BM - 1) / DF_BM);
  dense_f32_kernel<kRes><<<grid, DF_THREADS, 0, s>>>(x, g, bg, w, b, r, ls, out, M, D,
                                                     O, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pt
