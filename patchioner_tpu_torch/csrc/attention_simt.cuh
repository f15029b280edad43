// Online-softmax attention in float32 on the SIMT pipes, for head dim 64,
// over q, k and v rows addressed by strides: kernels B and F run it on the
// fused qkv activation, kernel K on (B, H, N, hd) tensors. bf16 runs the
// wgmma kernel of attention_sm90.cuh instead.
//
// One block owns 64 queries of one (batch, head) and streams 64-key tiles
// through shared memory with an online softmax: running row max and sum,
// the f32 accumulator rescaled when the max moves, one division by the sum
// at the end. Keys at or beyond num_real_k get the logit -1e30, as in the
// reference; the ragged query and key tails are masked by bounds, not by
// padding. Every sum is exact f32.
#pragma once

#include "common.cuh"

namespace pt {
namespace {  // internal linkage: each source that includes this has its own copy

constexpr int ATT_BQ = 64, ATT_BKEYS = 64, ATT_HD = 64, ATT_THREADS = 256,
              ATT_LD = ATT_HD + 1;

// grid (ceil(N / 64), heads, batch)
__global__ void __launch_bounds__(ATT_THREADS)
attention_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      RowLayout in, RowLayout ol, int N, int num_real_k,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = (float*)smem_raw;       // [BQ][LD]
  float* Ks = Qs + ATT_BQ * ATT_LD;   // [BKEYS][LD]
  float* Vs = Ks + ATT_BKEYS * ATT_LD;  // [BKEYS][LD]
  float* Ps = Vs + ATT_BKEYS * ATT_LD;  // [BQ][LD] probabilities

  const int q0 = blockIdx.x * ATT_BQ;
  const long long off = blockIdx.z * in.batch + blockIdx.y * in.head;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < ATT_BQ * ATT_HD; e += ATT_THREADS) {
    const int r = e / ATT_HD, d = e % ATT_HD, qi = q0 + r;
    float val = 0.f;
    if (qi < N) val = q[off + qi * in.row + d] * scale;
    Qs[r * ATT_LD + d] = val;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += ATT_BKEYS) {
    __syncthreads();
    for (int e = tid; e < ATT_BKEYS * ATT_HD; e += ATT_THREADS) {
      const int r = e / ATT_HD, d = e % ATT_HD, key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < N) {
        kv = k[off + key * in.row + d];
        vv = v[off + key * in.row + d];
      }
      Ks[r * ATT_LD + d] = kv;
      Vs[r * ATT_LD + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < ATT_HD; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * ATT_LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * ATT_LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key >= N || key >= num_real_k) s[i][j] = -1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float rescale = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty * 4 + i) * ATT_LD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * rescale + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= rescale;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < ATT_BKEYS; ++kk) {
      float pa[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty * 4 + i) * ATT_LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) va[j] = Vs[kk * ATT_LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }

  const long long ooff = blockIdx.z * ol.batch + blockIdx.y * ol.head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[ooff + qi * ol.row + tx + 16 * j] = acc[i][j] / l[i];
  }
}

int launch_attention_simt(const float* q, const float* k, const float* v,
                          float* out, RowLayout in, RowLayout ol, int batch,
                          int heads, int N, int num_real_k, float scale,
                          cudaStream_t s) {
  const size_t smem = (size_t)(2 * ATT_BQ + 2 * ATT_BKEYS) * ATT_LD * sizeof(float);
  cudaError_t err = pt_allow_smem(attention_simt_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + ATT_BQ - 1) / ATT_BQ, heads, batch);
  attention_simt_kernel<<<grid, ATT_THREADS, smem, s>>>(q, k, v, out, in, ol, N,
                                                        num_real_k, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace pt
