// Kernel A: out = LN(x) @ W + b, without writing LN(x) to device memory.
// Kernel E: out = r + ls * (x @ W + b), the attention out-projection with
// its layerscale and residual add folded into the product's epilogue.
//
// Replace patchioner_tpu/ops/mlp.py:fused_ln_dense (the attention half's
// LN + qkv projection of every encoder block) and fused_dense_residual
// (its out-projection, under proj_fused). One template serves both: A
// normalises its rows on the way into shared memory, E copies them, and
// the epilogues differ.
//
// Bound on the H100: at the flagship shape (B*N = 8*1374 rows, D = 768,
// O = 2304) A's product is 39 GFLOP against ~57 MB of bf16 traffic, far
// above the card's ~295 FLOP/byte ridge, so it is bound by arithmetic.
// E's (O = 768) is 13 GFLOP against 52 MB (x, r and out, 17 MB each, and
// W): about 250 FLOP/byte, just under the ridge, so bound by bytes.
// bf16 runs the products on the tensor cores through warp-level mma.sync
// tiles (WMMA 16x16x16, f32 accumulators; wgmma/TMA is later work); f32
// runs on the SIMT float pipes, so its sums stay exact f32. What A saves
// over the plain version is the (B, N, D) LN output's write and read; E
// saves the product's and the scaled product's.
//
// Design: A's block first computes the two-pass f32 LN statistics of its
// rows (the reference's mean((x - mean)^2), ops/mlp.py:_ln_rows) and
// normalises them into shared memory, rounded to the element type (the
// reference's cast before the product). The bf16 kernel does this once
// for 32 rows and sweeps all output columns in 128-wide tiles, streaming W
// in 64-row slices with 16-byte copies; the f32 kernel normalises 32-wide
// slices of 64 rows beside the matching W slice of a 64x64 output tile.
// The f32 sum is rounded to the element type before the bias is added, as
// in the reference. E's epilogue (ops/mlp.py:_dense_res_kernel) then
// rounds after + b, after * ls and after + r, each to the element type.
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int THREADS = 256;

// ---- f32: SIMT, 64x64 output tile, each thread 4x4 outputs
constexpr int BM = 64, BN = 64, BK = 32;

// kRes: E (x copied, r + ls * (acc + b)); otherwise A (LN(x), acc + b).
template <bool kRes>
__global__ void __launch_bounds__(THREADS)
dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ bg, const float* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ r,
                 const float* __restrict__ ls, float* __restrict__ out, int M,
                 int D, int O, float eps) {
  __shared__ float mean_s[BM], rstd_s[BM];
  __shared__ float As[BK][BM + 1];  // normalised x, [k][row]
  __shared__ float Bs[BK][BN + 4];  // W slice, [k][col]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5;

  for (int i = warp; i < BM && !kRes; i += THREADS / 32) {
    const int m = m0 + i;
    if (m < M) {
      pt::row_stats(x + (size_t)m * D, D, eps, &mean_s[i], &rstd_s[i]);
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

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int i = e / BK, k = e % BK;
      const int m = m0 + i, kk = k0 + k;
      float v = 0.f;
      if (m < M && kk < D) {
        v = x[(size_t)m * D + kk];
        if (!kRes) v = (v - mean_s[i]) * rstd_s[i] * g[kk] + bg[kk];
      }
      As[k][i] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, n = e % BN;
      const int kk = k0 + k, nn = n0 + n;
      Bs[k][n] = (kk < D && nn < O) ? w[(size_t)kk * O + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
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

// ---- bf16: tensor cores. 8 warps as 2 row groups x 4 column groups, each
// owning a 16x32 sub-tile (2 fragments) of a 32x128 output tile; a tile's
// f32 sums go through Cs to the rounding epilogue. Needs D % 64 == 0 and
// O % 128 == 0 (the wrapper checks).
constexpr int WBM = 32, WBN = 128, WKS = 64, BLD = WBN + 8, CLD = WBN + 4;

template <bool kRes>
__global__ void __launch_bounds__(THREADS)
dense_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  const bf16* __restrict__ bg, const bf16* __restrict__ w,
                  const bf16* __restrict__ bias, const bf16* __restrict__ r,
                  const bf16* __restrict__ ls, bf16* __restrict__ out, int M,
                  int D, int O, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = D + 8;
  bf16* Ys = (bf16*)smem_raw;                  // [WBM][DP] LN(x)
  bf16* Bs = Ys + WBM * DP;                    // [WKS][BLD] W slice
  float* Cs = (float*)(Bs + WKS * BLD);        // [WBM][CLD] f32 sums
  __shared__ float mean_s[WBM], rstd_s[WBM];
  const int m0 = blockIdx.x * WBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (kRes) {  // 16-byte copies of the rows, zeros past M
    for (int e = tid; e < WBM * D / 8; e += THREADS) {
      const int i = e / (D / 8), k = (e % (D / 8)) * 8, m = m0 + i;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) v = *(const uint4*)(x + (size_t)m * D + k);
      *(uint4*)(Ys + i * DP + k) = v;
    }
  }
  for (int i = warp; i < WBM && !kRes; i += THREADS / 32) {
    const int m = m0 + i;
    if (m < M) pt::row_stats(x + (size_t)m * D, D, eps, &mean_s[i], &rstd_s[i]);
    __syncwarp();
    for (int k = lane; k < D; k += 32) {
      float v = 0.f;
      if (m < M) {
        const float t = (pt::to_f(x[(size_t)m * D + k]) - mean_s[i]) * rstd_s[i];
        v = t * pt::to_f(g[k]) + pt::to_f(bg[k]);
      }
      Ys[i * DP + k] = pt::from_f<bf16>(v);
    }
  }

  const int rg = warp >> 2, cg = warp & 3;
  for (int n0 = 0; n0 < O; n0 += WBN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int k0 = 0; k0 < D; k0 += WKS) {
      __syncthreads();
      for (int e = tid; e < WKS * WBN / 8; e += THREADS) {  // 16-byte copies
        const int k = e / (WBN / 8), n = (e % (WBN / 8)) * 8;
        *(uint4*)(Bs + k * BLD + n) = *(const uint4*)(w + (size_t)(k0 + k) * O + n0 + n);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WKS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ys + rg * 16 * DP + k0 + kk, DP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Bs + kk * BLD + cg * 32 + j * 16, BLD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + rg * 16 * CLD + cg * 32 + j * 16, acc[j], CLD,
                              wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < WBM * WBN; e += THREADS) {
      const int i = e / WBN, n = e % WBN, m = m0 + i;
      if (m >= M) continue;
      const size_t o = (size_t)m * O + n0 + n;
      float v = pt::round_t<bf16>(pt::round_t<bf16>(Cs[i * CLD + n]) + pt::to_f(bias[n0 + n]));
      if (kRes) v = pt::to_f(r[o]) + pt::round_t<bf16>(v * pt::to_f(ls[n0 + n]));
      out[o] = pt::from_f<bf16>(v);
    }
  }
}

template <bool kRes>
int launch(const void* x, const void* g, const void* bg, const void* w,
           const void* b, const void* r, const void* ls, void* out, int M,
           int D, int O, float eps, int dtype, cudaStream_t s) {
  if (dtype == pt::kBF16) {
    const size_t smem = (size_t)(WBM * (D + 8) + WKS * BLD) * sizeof(bf16) +
                        (size_t)WBM * CLD * sizeof(float);
    cudaError_t err = pt_allow_smem(dense_bf16_kernel<kRes>, smem);
    if (err != cudaSuccess) return (int)err;
    dense_bf16_kernel<kRes><<<(M + WBM - 1) / WBM, THREADS, smem, s>>>(
        (const bf16*)x, (const bf16*)g, (const bf16*)bg, (const bf16*)w,
        (const bf16*)b, (const bf16*)r, (const bf16*)ls, (bf16*)out, M, D, O, eps);
  } else {
    dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
    dense_f32_kernel<kRes><<<grid, THREADS, 0, s>>>(
        (const float*)x, (const float*)g, (const float*)bg, (const float*)w,
        (const float*)b, (const float*)r, (const float*)ls, (float*)out, M, D,
        O, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 needs D % 64 == 0 and O % 128 == 0 (the wrappers check).
extern "C" int pt_ln_dense(const void* x, const void* g, const void* bg,
                           const void* w, const void* b, void* out, int M,
                           int D, int O, float eps, int dtype, void* stream) {
  return launch<false>(x, g, bg, w, b, nullptr, nullptr, out, M, D, O, eps,
                       dtype, (cudaStream_t)stream);
}

extern "C" int pt_dense_residual(const void* x, const void* r, const void* w,
                                 const void* b, const void* ls, void* out,
                                 int M, int D, int O, int dtype, void* stream) {
  return launch<true>(x, nullptr, nullptr, w, b, r, ls, out, M, D, O, 0.f,
                      dtype, (cudaStream_t)stream);
}
