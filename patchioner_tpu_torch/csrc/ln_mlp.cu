// Kernel C: out = x + ls * fc2(GELU(fc1(LN(x)))), the MLP half of an
// encoder block, with the (rows, 4D) hidden activation never written out.
//
// Replaces patchioner_tpu/ops/mlp.py:fused_ln_mlp.
//
// Bound on the H100: at the flagship shape (8*1374 rows, D = 768,
// H = 3072) the two products are 104 GFLOP against ~40 MB of weights and
// activations, so the kernel is bound by arithmetic; the plain version
// additionally writes and reads a 68 MB bf16 hidden tensor. bf16 runs the
// products on the tensor cores through warp-level mma.sync tiles (WMMA
// 16x16x16, f32 accumulators; wgmma/TMA is later work); f32 runs them on
// the SIMT float pipes, so its sums stay exact f32.
//
// Design: neither the 3072-wide hidden of a row block nor the two 4.7 MB
// weight matrices fit in an SM's shared memory, so one block owns 32 rows
// and streams the hidden dimension in 32-wide chunks. The block first
// writes LN(x) of its rows to shared memory (two-pass f32 statistics,
// rounded to the element type T). For each hidden chunk it computes fc1 +
// bias + GELU (exact erf, or tanh with gelu_approx) into shared memory,
// then adds that chunk's fc2 contribution to an f32 output tile (f32: 4
// rows x 24 columns of registers per thread; bf16: 12 16x16 accumulator
// fragments per warp, with fc1's K split across two warp halves and the
// halves summed in f32, and weights copied 16 bytes at a time). Because
// the fc2 sum stays f32
// across all chunks, the reference's rounding points (ops/mlp.py:_kernel)
// are kept exactly: fc1's sum rounds to T before + b1, GELU runs in f32
// and rounds to T, fc2's full sum rounds to T before + b2, and
// x + o * ls rounds to T after each operation.
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int THREADS = 256, BM = 32, HC = 32, MAX_COLS = 24;

// ---- f32: SIMT. Needs D % 32 == 0, D <= 768, H % 32 == 0.
// Shared memory: Ys [32][D+8], W2s [32][D], W1s [32][32], Hs [32][32].
__global__ void __launch_bounds__(THREADS)
ln_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ bg, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ ls,
                  float* __restrict__ out, int M, int D, int H, float eps,
                  bool approx) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = D + 8;  // padded rows: the 4 rows a warp reads hit 4 banks
  float* Ys = (float*)smem_raw;
  float* W2s = Ys + BM * DP;
  float* W1s = W2s + HC * D;
  float* Hs = W1s + 32 * HC;
  __shared__ float mean_s[BM], rstd_s[BM];
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid & 31;
  pt::ln_rows_to_smem(x, g, bg, Ys, mean_s, rstd_s, m0, BM, M, D, DP, eps);

  // fc1: row r1, hidden columns c1 .. c1 + 3 of the chunk
  const int r1 = tid / 8, c1 = (tid % 8) * 4;
  // fc2: rows rg*4 .. rg*4 + 3, output columns lane + 32 * j
  const int rg = tid / 32, ncols = D / 32;
  float acc[4][MAX_COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) acc[i][j] = 0.f;

  for (int h0 = 0; h0 < H; h0 += HC) {
    float hacc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < D; k0 += 32) {
      __syncthreads();
      for (int e = tid; e < 32 * HC; e += THREADS)
        W1s[e] = w1[(size_t)(k0 + e / HC) * H + h0 + e % HC];
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const float y = Ys[r1 * DP + k0 + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) hacc[j] = fmaf(y, W1s[k * HC + c1 + j], hacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) Hs[r1 * HC + c1 + j] = pt::gelu(hacc[j] + b1[h0 + c1 + j], approx);
    for (int e = tid; e < HC * D; e += THREADS) W2s[e] = w2[(size_t)(h0 + e / D) * D + e % D];
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < HC; ++k) {
      float hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = Hs[(rg * 4 + i) * HC + k];
#pragma unroll
      for (int j = 0; j < MAX_COLS; ++j) {
        if (j < ncols) {
          const float wv = W2s[k * D + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(hv[i], wv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + rg * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) {
      if (j >= ncols) continue;
      const int n = lane + 32 * j;
      out[(size_t)m * D + n] = x[(size_t)m * D + n] + (acc[i][j] + b2[n]) * ls[n];
    }
  }
}

// ---- bf16: tensor cores. Needs D % 128 == 0, D <= 768, H % 32 == 0.
// Shared memory: Ys [32][D+8] LN(x), W2s [32][D+8] fc2 rows of a chunk,
// W1s [128][40] fc1 slices (64 rows for each K half; reused for the two
// f32 fc1 partials Hp [2][32][36]), Hb [32][40] GELU output; 110 KB at
// D = 768, so two blocks share an SM. The epilogue reuses Ys + W2s as the
// f32 output tile [32][D].
constexpr int CKS = 64, HLD = HC + 8, PLD = HC + 4;

__global__ void __launch_bounds__(THREADS)
ln_mlp_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   const bf16* __restrict__ bg, const bf16* __restrict__ w1,
                   const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ b2, const bf16* __restrict__ ls,
                   bf16* __restrict__ out, int M, int D, int H, float eps,
                   bool approx) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = D + 8;
  bf16* Ys = (bf16*)smem_raw;
  bf16* W2s = Ys + BM * DP;
  bf16* W1s = W2s + HC * DP;
  float* Hp = (float*)W1s;
  bf16* Hb = W1s + 2 * CKS * HLD;
  float* Cs = (float*)smem_raw;
  __shared__ float mean_s[BM], rstd_s[BM];
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5;
  pt::ln_rows_to_smem(x, g, bg, Ys, mean_s, rstd_s, m0, BM, M, D, DP, eps);

  // fc1: warp = (K half, row group, 16-column group)
  const int half = warp >> 2, hrg = (warp >> 1) & 1, hcg = warp & 1;
  const int Dh = D / 2;
  // fc2: warp = (row group, D/4-column group) owning nf fragments
  const int frg = warp >> 2, fcg = warp & 3, nf = D / 64, cw = D / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_COLS / 2];
#pragma unroll
  for (int j = 0; j < MAX_COLS / 2; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int h0 = 0; h0 < H; h0 += HC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
    wmma::fill_fragment(hacc, 0.f);
    for (int s0 = 0; s0 < Dh; s0 += CKS) {
      __syncthreads();
      for (int e = tid; e < 2 * CKS * HC / 8; e += THREADS) {  // 16-byte copies
        const int r = e / (HC / 8), c = (e % (HC / 8)) * 8;
        const int k = (r / CKS) * Dh + s0 + r % CKS;
        *(uint4*)(W1s + r * HLD + c) = *(const uint4*)(w1 + (size_t)k * H + h0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < CKS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ys + hrg * 16 * DP + half * Dh + s0 + kk, DP);
        wmma::load_matrix_sync(b, W1s + (half * CKS + kk) * HLD + hcg * 16, HLD);
        wmma::mma_sync(hacc, a, b, hacc);
      }
    }
    __syncthreads();  // W1s is about to hold the f32 partials
    wmma::store_matrix_sync(Hp + half * BM * PLD + hrg * 16 * PLD + hcg * 16, hacc,
                            PLD, wmma::mem_row_major);
    for (int e = tid; e < HC * D / 8; e += THREADS) {
      const int k = e / (D / 8), n = (e % (D / 8)) * 8;
      *(uint4*)(W2s + k * DP + n) = *(const uint4*)(w2 + (size_t)(h0 + k) * D + n);
    }
    __syncthreads();
    for (int e = tid; e < BM * HC; e += THREADS) {
      const int r = e / HC, c = e % HC;
      const float sum = Hp[r * PLD + c] + Hp[BM * PLD + r * PLD + c];
      const float h = pt::round_t<bf16>(pt::round_t<bf16>(sum) + pt::to_f(b1[h0 + c]));
      Hb[r * HLD + c] = pt::from_f<bf16>(pt::gelu(h, approx));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Hb + frg * 16 * HLD + kk, HLD);
#pragma unroll
      for (int j = 0; j < MAX_COLS / 2; ++j) {
        if (j < nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, W2s + kk * DP + fcg * cw + j * 16, DP);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }

  __syncthreads();  // Ys and W2s become the f32 output tile
#pragma unroll
  for (int j = 0; j < MAX_COLS / 2; ++j)
    if (j < nf)
      wmma::store_matrix_sync(Cs + frg * 16 * D + fcg * cw + j * 16, acc[j], D,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * D; e += THREADS) {
    const int r = e / D, n = e % D, m = m0 + r;
    if (m >= M) continue;
    const float o = pt::round_t<bf16>(pt::round_t<bf16>(Cs[e]) + pt::to_f(b2[n]));
    const float os = pt::round_t<bf16>(o * pt::to_f(ls[n]));
    out[(size_t)m * D + n] = pt::from_f<bf16>(pt::to_f(x[(size_t)m * D + n]) + os);
  }
}

}  // namespace

// Shapes as each kernel states; the wrapper checks them.
extern "C" int pt_ln_mlp(const void* x, const void* g, const void* bg,
                         const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* ls, void* out, int M,
                         int D, int H, float eps, int gelu_approx, int dtype,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (M + BM - 1) / BM;
  cudaError_t err;
  if (dtype == pt::kBF16) {
    const size_t smem = (size_t)(2 * BM * (D + 8) + 2 * CKS * HLD + BM * HLD) * sizeof(bf16);
    err = pt_allow_smem(ln_mlp_bf16_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    ln_mlp_bf16_kernel<<<blocks, THREADS, smem, s>>>(
        (const bf16*)x, (const bf16*)g, (const bf16*)bg, (const bf16*)w1,
        (const bf16*)b1, (const bf16*)w2, (const bf16*)b2, (const bf16*)ls,
        (bf16*)out, M, D, H, eps, gelu_approx != 0);
  } else {
    const size_t smem = (size_t)(BM * (D + 8) + HC * D + 32 * HC + BM * HC) * sizeof(float);
    err = pt_allow_smem(ln_mlp_f32_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    ln_mlp_f32_kernel<<<blocks, THREADS, smem, s>>>(
        (const float*)x, (const float*)g, (const float*)bg, (const float*)w1,
        (const float*)b1, (const float*)w2, (const float*)b2, (const float*)ls,
        (float*)out, M, D, H, eps, gelu_approx != 0);
  }
  return (int)cudaGetLastError();
}
