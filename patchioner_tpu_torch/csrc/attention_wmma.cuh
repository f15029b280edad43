// The warp-level step of online-softmax attention on the bf16 WMMA tensor
// cores, for head dim 64: kernel F runs it per head of a pair. (Kernels B,
// J and K run the warpgroup kernel of attention_sm90.cuh.)
//
// The warp step, for each 64-key tile: the warp's (16, 64) logits on WMMA
// 16x16x16 tiles (bf16 in, f32 accumulators); keys at or beyond
// num_real_k masked to -1e30; the softmax step on the SIMT pipes, two
// lanes to a row: the new max, the rescale exp(m_prev - m_new), p =
// exp(s - m_new) summed in f32 and rounded to bf16 into shared memory, as
// the reference rounds p before PV. PV runs on WMMA too; since an
// accumulator fragment's layout is opaque, the tile's f32 PV goes through
// shared memory and is added to the rescaled accumulator that the two
// lanes of a row hold in registers (32 columns each).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace pt {
namespace {  // internal linkage: each source that includes this has its own copy

using bf16_t = __nv_bfloat16;

constexpr int WA_HD = 64, WA_BKEYS = 64;
constexpr int WA_LDB = WA_HD + 8;  // bf16 tiles: rows of 144 bytes
constexpr int WA_LDS = 64 + 4;     // f32 tiles

// Shared-memory elements one warp needs beside the tiles: its p (bf16) and
// its logits / PV (f32), each 16 rows.
constexpr int WA_WARP_BF16 = 16 * WA_LDB, WA_WARP_F32 = 16 * WA_LDS;

// The running state of the 16 queries of one warp. Lane l holds row l / 2,
// columns (l % 2) * 32 .. + 31 of the accumulator.
struct WarpAttention {
  float m, l, acc[32];
};

__device__ __forceinline__ void wa_init(WarpAttention& st) {
  st.m = -1e30f;
  st.l = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) st.acc[c] = 0.f;
}

// Copy rows [row0, row0 + 64) of a (rows, 64) bf16 matrix with row stride
// `stride` elements into a [64][WA_LDB] tile, 16 bytes a copy, zeros past
// `rows`; `scale` (when not 1) multiplies each value, rounded to bf16.
__device__ __forceinline__ void wa_load_tile(bf16_t* dst, const bf16_t* src,
                                             long long stride, int row0, int rows,
                                             int tid, int nthreads, float scale = 1.f) {
  for (int e = tid; e < 64 * WA_HD / 8; e += nthreads) {
    const int r = e / (WA_HD / 8), d = (e % (WA_HD / 8)) * 8, row = row0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) raw = *(const uint4*)(src + row * stride + d);
    if (scale != 1.f) {
      bf16_t* vals = (bf16_t*)&raw;
#pragma unroll
      for (int t = 0; t < 8; ++t) vals[t] = from_f<bf16_t>(to_f(vals[t]) * scale);
    }
    *(uint4*)(dst + r * WA_LDB + d) = raw;
  }
}

// One 64-key tile: Qw the warp's 16 rows of q * scale, Ks and Vs the tile,
// Pw and Sw the warp's own scratch; keys k0 .. k0 + 63.
__device__ __forceinline__ void wa_tile(WarpAttention& st, const bf16_t* Qw,
                                        const bf16_t* Ks, const bf16_t* Vs,
                                        bf16_t* Pw, float* Sw, int k0,
                                        int num_real_k) {
  namespace wmma = nvcuda::wmma;
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 32;
  {  // S = Q_w K^T: 16 queries x 64 keys
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(sf[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < WA_HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16_t, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qw + kk, WA_LDB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16_t, wmma::col_major> b;
        wmma::load_matrix_sync(b, Ks + j * 16 * WA_LDB + kk, WA_LDB);
        wmma::mma_sync(sf[j], a, b, sf[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Sw + j * 16, sf[j], WA_LDS, wmma::mem_row_major);
  }
  __syncwarp();

  float mx = -1e30f;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (k0 + c0 + c < num_real_k) mx = fmaxf(mx, Sw[r * WA_LDS + c0 + c]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_new = fmaxf(st.m, mx);
  const float rescale = expf(st.m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float s = k0 + c0 + c < num_real_k ? Sw[r * WA_LDS + c0 + c] : -1e30f;
    const float p = expf(s - m_new);
    sum += p;
    Pw[r * WA_LDB + c0 + c] = from_f<bf16_t>(p);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  st.l = st.l * rescale + sum;
  st.m = m_new;
  __syncwarp();

  {  // this tile's PV: 16 queries x 64 columns, through Sw
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(of[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < WA_BKEYS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16_t, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + kk, WA_LDB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16_t, wmma::row_major> b;
        wmma::load_matrix_sync(b, Vs + kk * WA_LDB + j * 16, WA_LDB);
        wmma::mma_sync(of[j], a, b, of[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Sw + j * 16, of[j], WA_LDS, wmma::mem_row_major);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 32; ++c)
    st.acc[c] = fmaf(st.acc[c], rescale, Sw[r * WA_LDS + c0 + c]);
  __syncwarp();  // Sw is free for the next tile
}

}  // namespace
}  // namespace pt
