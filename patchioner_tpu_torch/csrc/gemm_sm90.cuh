// The bf16 pieces of kernels A and E (ln_dense.cu), C (ln_mlp.cu), F
// (qkv_attention_proj.cu) and G (ln_swiglu.cu) on Hopper: LN(x) of every
// row, and one wgmma GEMM template whose epilogue each kernel supplies.
//
// - ln_rows_bf16_kernel: y = LN(x) rounded to bf16, one warp a row, f32
//   two-pass statistics; grid ceil(M / 8) of 256 threads.
// - gemm_bf16_kernel: epi(A @ W) for A (M, K) and W (K, ...) row-major bf16,
//   K % 64 == 0. A block owns 128 rows of A and two 64-column tiles of W
//   (`WTiles`): 128 adjacent columns for a dense product (A's qkv, E, C's fc1
//   and fc2, F's out-projection, G's fc2), or G's gate tile and its linear partner H columns away in one
//   w12, so the weight is split nowhere. 256 threads, each warpgroup 64
//   rows; per 64-deep stage 4 wgmma.m64n128k16 (f32 accumulators: 64
//   registers a thread), A K-major and W MN-major (the transpose bit), both
//   read from 128-byte-swizzled shared memory; a ring of 3 stages (32 KB
//   each) filled by the block's own 16-byte cp.async copies runs two stages
//   ahead of the tensor cores; 97 KB of shared memory a block, two blocks an
//   SM. Ragged rows are zero-filled on load and never stored.
// - The epilogue: in the m64n128 accumulator a thread holds column c of the
//   first tile in group j and column c of the second tile in group j + 8
//   (sm90.cuh), so the template hands both to the epilogue at once:
//   epi(m, n0, n1, a0, a1, b0, b1) gets row m's f32 sums at columns n0,
//   n0 + 1 of W (first tile) and n1, n1 + 1 (second tile). A dense product
//   treats the two pairs alike (DenseEpilogue); G's fc1 multiplies the gate
//   by its partner.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace pt {
namespace {  // internal linkage: each source that includes this has its own copy

using bf16_t = __nv_bfloat16;

constexpr int GM = 128, GK = 64, GSTAGES = 3, GTHREADS = 256;
constexpr int GTILE = 64 * 128;  // bytes of one swizzled 64 x 64 bf16 tile
// a stage: A 128 x 64 (two tiles), B 64 x 128 (two 64-column tiles)
constexpr size_t GSMEM = 1024 + GSTAGES * 4 * GTILE;

// y = LN(x) rounded to bf16: one warp a row, f32 two-pass statistics.
__global__ void __launch_bounds__(256)
ln_rows_bf16_kernel(const bf16_t* __restrict__ x, const bf16_t* __restrict__ g,
                    const bf16_t* __restrict__ bg, bf16_t* __restrict__ y, int M, int D,
                    float eps) {
  __shared__ float mean_s[8], rstd_s[8];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, m = blockIdx.x * 8 + w;
  if (m >= M) return;
  const bf16_t* xr = x + (size_t)m * D;
  row_stats(xr, D, eps, &mean_s[w], &rstd_s[w]);
  __syncwarp();
  for (int k = lane; k < D; k += 32) {
    const float t = (to_f(xr[k]) - mean_s[w]) * rstd_s[w];
    y[(size_t)m * D + k] = from_f<bf16_t>(t * to_f(g[k]) + to_f(bg[k]));
  }
}

cudaError_t launch_ln_rows(const bf16_t* x, const bf16_t* g, const bf16_t* bg, bf16_t* y,
                           int M, int D, float eps, cudaStream_t s) {
  ln_rows_bf16_kernel<<<(M + 7) / 8, 256, 0, s>>>(x, g, bg, y, M, D, eps);
  return cudaGetLastError();
}

// Where GEMM block x finds its two 64-column tiles of W: columns x * step
// .. + 63 and x * step + pair .. + 63, in rows `ld` elements apart;
// `blocks` such blocks cover the output.
struct WTiles {
  int ld, blocks, step, pair;
};

// N adjacent columns of a (K, N) W, 128 a block; N % 128 == 0.
WTiles dense_tiles(int N) { return {N, N / 128, 128, 64}; }

// The epilogue of a dense product from one of a column pair:
// pair(m, n, v0, v1) takes row m's sums at columns n, n + 1, of either tile.
template <class Pair>
struct DenseEpilogue {
  Pair pair;
  __device__ __forceinline__ void operator()(int m, int n0, int n1, float a0, float a1,
                                             float b0, float b1) const {
    pair(m, n0, a0, a1);
    pair(m, n1, b0, b1);
  }
};

// grid (wt.blocks, ceil(M / 128))
template <class Epilogue>
__global__ void __launch_bounds__(GTHREADS, 2)
gemm_bf16_kernel(const bf16_t* __restrict__ A, const bf16_t* __restrict__ W, int M, int K,
                 WTiles wt, Epilogue epi) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t sbase = raw + ((1024 - (raw & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int c0 = blockIdx.x * wt.step, c1 = c0 + wt.pair;
  const int m0 = blockIdx.y * GM, kt = K / GK;

  auto load = [&](int t) {  // stage t % STAGES: A rows m0.., W rows t * 64..
    if (t < kt) {
      const uint32_t sa = sbase + (t % GSTAGES) * 4 * GTILE, sb = sa + 2 * GTILE;
      const int k0 = t * GK;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * GTHREADS;
        const int r = e >> 3, c = e & 7, row = m0 + r;  // A: 128 rows x 8 chunks
        sm90::cp_async16(sa + sm90::swizzle128(r, c),
                         A + (size_t)(row < M ? row : 0) * K + k0 + c * 8, row < M);
        const int kr = e >> 4, cc = e & 15;  // W: 64 rows x 2 tiles x 8 chunks
        sm90::cp_async16(sb + (cc >> 3) * GTILE + sm90::swizzle128(kr, cc & 7),
                         W + (size_t)(k0 + kr) * wt.ld + (cc < 8 ? c0 : c1) + (cc & 7) * 8,
                         true);
      }
    }
    sm90::cp_async_commit();  // one group per stage, empty past the last
  };
#pragma unroll
  for (int t = 0; t < GSTAGES - 1; ++t) load(t);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = 0; t < kt; ++t) {
    sm90::cp_async_wait<GSTAGES - 2>();  // stage t has landed
    sm90::fence_proxy_async();
    __syncthreads();  // every thread's copies, and stage t - 1 is free
    load(t + GSTAGES - 1);
    const uint32_t sa = sbase + (t % GSTAGES) * 4 * GTILE, sb = sa + 2 * GTILE;
    // A: +32 bytes a k16 step; W: 16 rows (2048 bytes = 128 units) a k16
    // step, its second 64-column tile LBO = GTILE bytes away
    const uint64_t da = sm90::desc128(sa + wg * GTILE, 16, 1024);
    const uint64_t db = sm90::desc128(sb, GTILE, 1024);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_m64n128k16_ss<1>(acc, da + 2 * kk, db + 128 * kk, 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
  }

  // group j: columns 8j + kc, kc + 1 of the first tile; group j + 8 the
  // same columns of the second
  const int r = m0 + wg * 64 + warp * 16 + (lane >> 2), kc = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n0 = c0 + 8 * j + kc, n1 = c1 + 8 * j + kc;
    if (r < M)
      epi(r, n0, n1, acc[4 * j], acc[4 * j + 1], acc[4 * j + 32], acc[4 * j + 33]);
    if (r + 8 < M)
      epi(r + 8, n0, n1, acc[4 * j + 2], acc[4 * j + 3], acc[4 * j + 34], acc[4 * j + 35]);
  }
}

template <class Epilogue>
cudaError_t launch_gemm(const bf16_t* A, const bf16_t* W, int M, int K, WTiles wt,
                        Epilogue epi, cudaStream_t s) {
  cudaError_t err = pt_allow_smem(gemm_bf16_kernel<Epilogue>, GSMEM);
  if (err != cudaSuccess) return err;
  gemm_bf16_kernel<<<dim3(wt.blocks, (M + GM - 1) / GM), GTHREADS, GSMEM, s>>>(A, W, M, K,
                                                                             wt, epi);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pt
