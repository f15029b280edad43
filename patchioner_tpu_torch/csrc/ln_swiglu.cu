// Kernel G: out = x + ls * ((silu(x1) * x2) @ W3 + b3) with
// [x1 | x2] = LN(x) @ W12 + b12, the SwiGLU FFN half of a DINOv2-giant
// block, with the (rows, 2H) hidden activation never written out.
//
// Replaces patchioner_tpu/ops/mlp.py:fused_ln_swiglu (body _ln_swiglu_kernel).
//
// Bound on the H100: at the giant shape (8*1374 rows, D = 1536, H = 4096)
// the two products are 415 GFLOP against ~105 MB of weights and
// activations, so the kernel is bound by arithmetic (0.42 ms at 989
// TFLOP/s); the plain version additionally writes and reads the 360 MB f32
// hidden tensor. bf16 runs the products on the tensor cores through WMMA
// 16x16x16 tiles with f32 accumulators (wgmma/TMA is later work); f32 runs
// them on the SIMT float pipes, so its sums stay exact f32.
//
// Design: the TPU kernel carries the (rows, D) f32 W3 sum across its
// hidden grid axis in VMEM. Hopper blocks carry nothing across a grid axis,
// so one block owns 16 rows and walks the whole hidden dimension itself:
// the 16-row f32 output tile at D = 1536 is 96 registers a thread (bf16:
// 12 accumulator fragments a warp; f32: 2 rows x 48 columns), where 32
// rows would not fit, and splitting the output columns over blocks would
// recompute the W12 product. The block writes LN(x) of its rows to shared
// memory once, then for each hidden chunk streams the chunk's gate and
// linear column tiles of W12 (columns h0.. and H + h0.., two tiles of one
// array as the TPU kernel addresses them), forms g = silu(h1) * h2, and
// streams the chunk's rows of W3 into the output sum. Rounding points of
// _ln_swiglu_kernel: LN(x) rounds to T; h1 and h2 are f32 sums with the
// bias added in f32 (not rounded, unlike kernel C's fc1); g is f32,
// h1 * (1 / (1 + exp(-h1))) * h2, rounded to T before W3; the W3 sum stays
// f32 over all chunks and + b3 is f32; o * ls rounds to T, then x + it.
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int THREADS = 256, BM = 16;

__device__ __forceinline__ float swiglu(float h1, float h2) {
  return h1 * (1.f / (1.f + expf(-h1))) * h2;
}

// ---- f32: SIMT. Needs D % 32 == 0, D <= 1536, H % 32 == 0.
// Shared memory: Ys [16][D+8] LN(x), W12s [32][64] (32 gate then 32 linear
// columns of a K slice), Gs [16][32], W3s [8][D]; 158 KB at D = 1536.
constexpr int FHC = 32, FCK = 32, FW3R = 8, MAX_COLS = 48;

__global__ void __launch_bounds__(THREADS)
ln_swiglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ bg, const float* __restrict__ w12,
                     const float* __restrict__ b12, const float* __restrict__ w3,
                     const float* __restrict__ b3, const float* __restrict__ ls,
                     float* __restrict__ out, int M, int D, int H, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = D + 8;
  float* Ys = (float*)smem_raw;
  float* W12s = Ys + BM * DP;
  float* Gs = W12s + FCK * 2 * FHC;
  float* W3s = Gs + BM * FHC;
  __shared__ float mean_s[BM], rstd_s[BM];
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid & 31;
  pt::ln_rows_to_smem(x, g, bg, Ys, mean_s, rstd_s, m0, BM, M, D, DP, eps);

  // h: row r1, chunk columns c1, c1 + 1 of both halves
  const int r1 = tid / 16, c1 = (tid % 16) * 2;
  // W3: rows rg*2, rg*2 + 1, output columns lane + 32 * j
  const int rg = tid / 32, ncols = D / 32;
  const size_t H2 = 2 * (size_t)H;
  float acc[2][MAX_COLS];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) acc[i][j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += FHC) {
    float hacc[4] = {0.f, 0.f, 0.f, 0.f};  // gate c1, c1+1; linear c1, c1+1
    for (int k0 = 0; k0 < D; k0 += FCK) {
      __syncthreads();
      for (int e = tid; e < FCK * 2 * FHC; e += THREADS) {
        const int k = e / (2 * FHC), c = e % (2 * FHC);
        const int col = c < FHC ? h0 + c : H + h0 + c - FHC;
        W12s[e] = w12[(size_t)(k0 + k) * H2 + col];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < FCK; ++k) {
        const float y = Ys[r1 * DP + k0 + k];
        const float* wr = W12s + k * 2 * FHC;
        hacc[0] = fmaf(y, wr[c1], hacc[0]);
        hacc[1] = fmaf(y, wr[c1 + 1], hacc[1]);
        hacc[2] = fmaf(y, wr[FHC + c1], hacc[2]);
        hacc[3] = fmaf(y, wr[FHC + c1 + 1], hacc[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = h0 + c1 + j;
      Gs[r1 * FHC + c1 + j] = swiglu(hacc[j] + b12[c], hacc[2 + j] + b12[H + c]);
    }
    for (int s0 = 0; s0 < FHC; s0 += FW3R) {
      __syncthreads();  // Gs written; W3s free
      for (int e = tid; e < FW3R * D; e += THREADS)
        W3s[e] = w3[(size_t)(h0 + s0 + e / D) * D + e % D];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FW3R; ++k) {
        const float g0 = Gs[(rg * 2) * FHC + s0 + k], g1 = Gs[(rg * 2 + 1) * FHC + s0 + k];
#pragma unroll
        for (int j = 0; j < MAX_COLS; ++j) {
          if (j < ncols) {
            const float wv = W3s[k * D + lane + 32 * j];
            acc[0][j] = fmaf(g0, wv, acc[0][j]);
            acc[1][j] = fmaf(g1, wv, acc[1][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + rg * 2 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) {
      if (j >= ncols) continue;
      const int n = lane + 32 * j;
      out[(size_t)m * D + n] = x[(size_t)m * D + n] + (acc[i][j] + b3[n]) * ls[n];
    }
  }
}

// ---- bf16: tensor cores. Needs D % 128 == 0, D <= 1536, H % 64 == 0.
// Warp w computes the 16-column fragment w of [h1 | h2] for a 64-wide
// hidden chunk (warps 0-3 gate, 4-7 linear) over all of K, and owns the
// output columns [w * D/8, (w + 1) * D/8) as D/128 fragments.
// Shared memory: Ys [16][D+8] LN(x), W12s [64][136] a K slice of the
// chunk's two column tiles, Hf [16][132] f32 h sums (and each warp's
// epilogue tile), Gs [16][72] g rounded to bf16, W3s [32][D+8] rows of W3;
// 176 KB at D = 1536, one block per SM.
constexpr int HC = 64, CK = 64, W3R = 32, WLD = 2 * HC + 8, HLD = 2 * HC + 4,
              GLD = HC + 8, MAX_FRAGS = 12;

__global__ void __launch_bounds__(THREADS)
ln_swiglu_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                      const bf16* __restrict__ bg, const bf16* __restrict__ w12,
                      const bf16* __restrict__ b12, const bf16* __restrict__ w3,
                      const bf16* __restrict__ b3, const bf16* __restrict__ ls,
                      bf16* __restrict__ out, int M, int D, int H, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = D + 8;
  bf16* Ys = (bf16*)smem_raw;
  bf16* W12s = Ys + BM * DP;
  float* Hf = (float*)(W12s + CK * WLD);
  bf16* Gs = (bf16*)(Hf + BM * HLD);
  bf16* W3s = Gs + BM * GLD;
  __shared__ float mean_s[BM], rstd_s[BM];
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  pt::ln_rows_to_smem(x, g, bg, Ys, mean_s, rstd_s, m0, BM, M, D, DP, eps);

  const int nf = D / 128, cw = D / 8;
  const size_t H2 = 2 * (size_t)H;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_FRAGS];
#pragma unroll
  for (int j = 0; j < MAX_FRAGS; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int h0 = 0; h0 < H; h0 += HC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
    wmma::fill_fragment(hacc, 0.f);
    for (int k0 = 0; k0 < D; k0 += CK) {
      __syncthreads();
      for (int e = tid; e < CK * 2 * HC / 8; e += THREADS) {  // 16-byte copies
        const int k = e / (2 * HC / 8), c = (e % (2 * HC / 8)) * 8;
        const size_t col = c < HC ? h0 + c : H + h0 + c - HC;
        *(uint4*)(W12s + k * WLD + c) = *(const uint4*)(w12 + (size_t)(k0 + k) * H2 + col);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ys + k0 + kk, DP);
        wmma::load_matrix_sync(b, W12s + kk * WLD + warp * 16, WLD);
        wmma::mma_sync(hacc, a, b, hacc);
      }
    }
    wmma::store_matrix_sync(Hf + warp * 16, hacc, HLD, wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < BM * HC; e += THREADS) {
      const int r = e / HC, c = e % HC;
      const float h1 = Hf[r * HLD + c] + pt::to_f(b12[h0 + c]);
      const float h2 = Hf[r * HLD + HC + c] + pt::to_f(b12[H + h0 + c]);
      Gs[r * GLD + c] = pt::from_f<bf16>(swiglu(h1, h2));
    }
    for (int s0 = 0; s0 < HC; s0 += W3R) {
      __syncthreads();  // Gs written; W3s free
      for (int e = tid; e < W3R * D / 8; e += THREADS) {
        const int k = e / (D / 8), n = (e % (D / 8)) * 8;
        *(uint4*)(W3s + k * DP + n) = *(const uint4*)(w3 + (size_t)(h0 + s0 + k) * D + n);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < W3R; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Gs + s0 + kk, GLD);
#pragma unroll
        for (int j = 0; j < MAX_FRAGS; ++j) {
          if (j < nf) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(b, W3s + kk * DP + warp * cw + j * 16, DP);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
      }
    }
  }

  __syncthreads();  // Hf becomes one 16x16 f32 epilogue tile per warp
  float* Es = Hf + warp * 256;
#pragma unroll
  for (int j = 0; j < MAX_FRAGS; ++j) {
    if (j >= nf) continue;
    wmma::store_matrix_sync(Es, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, m = m0 + r, n = warp * cw + j * 16 + e % 16;
      if (m >= M) continue;
      const float o = Es[e] + pt::to_f(b3[n]);
      const float os = pt::round_t<bf16>(o * pt::to_f(ls[n]));
      out[(size_t)m * D + n] = pt::from_f<bf16>(pt::to_f(x[(size_t)m * D + n]) + os);
    }
    __syncwarp();
  }
}

}  // namespace

// Shapes as each kernel states; the wrapper checks them.
extern "C" int pt_ln_swiglu(const void* x, const void* g, const void* bg,
                            const void* w12, const void* b12, const void* w3,
                            const void* b3, const void* ls, void* out, int M,
                            int D, int H, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (M + BM - 1) / BM;
  cudaError_t err;
  if (dtype == pt::kBF16) {
    const size_t smem = (size_t)(BM * (D + 8) + CK * WLD + BM * GLD + W3R * (D + 8)) *
                            sizeof(bf16) + (size_t)BM * HLD * sizeof(float);
    err = pt_allow_smem(ln_swiglu_bf16_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    ln_swiglu_bf16_kernel<<<blocks, THREADS, smem, s>>>(
        (const bf16*)x, (const bf16*)g, (const bf16*)bg, (const bf16*)w12,
        (const bf16*)b12, (const bf16*)w3, (const bf16*)b3, (const bf16*)ls,
        (bf16*)out, M, D, H, eps);
  } else {
    const size_t smem =
        (size_t)(BM * (D + 8) + FCK * 2 * FHC + BM * FHC + FW3R * D) * sizeof(float);
    err = pt_allow_smem(ln_swiglu_f32_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    ln_swiglu_f32_kernel<<<blocks, THREADS, smem, s>>>(
        (const float*)x, (const float*)g, (const float*)bg, (const float*)w12,
        (const float*)b12, (const float*)w3, (const float*)b3, (const float*)ls,
        (float*)out, M, D, H, eps);
  }
  return (int)cudaGetLastError();
}
