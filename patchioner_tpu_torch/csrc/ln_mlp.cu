// Kernel C: out = x + ls * fc2(GELU(fc1(LN(x)))), the MLP half of an
// encoder block.
//
// Replaces patchioner_tpu/ops/mlp.py:fused_ln_mlp (body _kernel).
//
// Bound on the H100: at the flagship shape (8*1374 rows, D = 768,
// H = 3072) the two products are 104 GFLOP against ~43 MB of weights and
// activations: 0.105 ms at the bf16 tensor-core peak, so arithmetic bounds
// it. Rounding points (ops/mlp.py:_kernel) are kept in both types: LN(x)
// rounds to T, fc1's f32 sum rounds to T before + b1, GELU (exact erf, or
// tanh with gelu_approx) runs in f32 and rounds to T, fc2's f32 sum over
// the whole hidden rounds to T once before + b2, and x + o * ls rounds to
// T after each operation.
//
// bf16 design. The TPU kernel keeps a row block's (rows, 4D) hidden in
// VMEM; on this card the hidden's round trip through device memory (67.5 MB
// written and read, ~40 us at 3.35 TB/s) costs less than a fused block's
// weight traffic (each 64-row block would re-read 9.4 MB of W1 and W2, and
// hold a 64 x 768 f32 output tile). So the wrapper runs three launches:
// - LN(x) of every row, rounded to bf16, into the output buffer (17 MB
//   written and read again, ~10 us);
// - fc1: one wgmma GEMM over LN(x) and W1 whose epilogue adds b1, applies
//   GELU and writes the bf16 hidden into a scratch tensor of the wrapper;
// - fc2: the same GEMM template over the hidden and W2 whose epilogue adds
//   b2, scales by ls and adds x into the output.
// The GEMM: 128 x 128 output tiles, 256 threads, each warpgroup 64 rows;
// per 64-deep stage 4 wgmma.m64n128k16 (f32 accumulators: 64 registers a
// thread), A K-major and W MN-major (the transpose bit), both read from
// 128-byte-swizzled shared memory; a ring of 3 stages (32 KB each) filled
// by the block's own 16-byte cp.async copies runs two stages ahead of the
// tensor cores; 97 KB of shared memory a block, two blocks an SM. Ragged
// rows are zero-filled on load and never stored.
//
// f32 design (for the checks): SIMT, one block of 32 rows streams the
// hidden in 32-wide chunks, LN(x) in shared memory, fc1 + bias + GELU of a
// chunk into shared memory, its fc2 contribution added to a 4 x 24 f32
// register tile a thread; the hidden is never written out.
#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// ---- bf16: LN(x) into the output buffer, then two launches of the wgmma
// GEMM template of gemm_sm90.cuh (fc1 with the bias + GELU epilogue into
// the hidden scratch, fc2 with the bias + layerscale + residual epilogue
// into the output). Needs D % 128 == 0 and H % 128 == 0.

// h = GELU(round(round(acc) + b1)), rounded to bf16
struct Fc1Epilogue {
  const bf16* b1;
  bf16* h;
  int H;
  bool approx;
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1) const {
    float v[2] = {v0, v1};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[e] = pt::gelu(pt::round_t<bf16>(pt::round_t<bf16>(v[e]) + pt::to_f(b1[n + e])),
                      approx);
    *(uint32_t*)(h + (size_t)m * H + n) = pt::sm90::pack_bf16(v[0], v[1]);
  }
};

// out = x + round(round(round(acc) + b2) * ls), rounded to bf16
struct Fc2Epilogue {
  const bf16 *x, *b2, *ls;
  bf16* out;
  int D;
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1) const {
    float v[2] = {v0, v1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float o = pt::round_t<bf16>(pt::round_t<bf16>(v[e]) + pt::to_f(b2[n + e]));
      const float os = pt::round_t<bf16>(o * pt::to_f(ls[n + e]));
      v[e] = pt::to_f(x[(size_t)m * D + n + e]) + os;
    }
    *(uint32_t*)(out + (size_t)m * D + n) = pt::sm90::pack_bf16(v[0], v[1]);
  }
};

}  // namespace

// Shapes as each kernel states; the wrapper checks them. `hidden` is the
// (M, H) bf16 scratch of the bf16 path (unused in f32).
extern "C" int pt_ln_mlp(const void* x, const void* g, const void* bg,
                         const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* ls, void* out, void* hidden,
                         int M, int D, int H, float eps, int gelu_approx, int dtype,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == pt::kBF16) {
    const bf16 *xb = (const bf16*)x, *w1b = (const bf16*)w1, *w2b = (const bf16*)w2;
    bf16 *ob = (bf16*)out, *hb = (bf16*)hidden;
    err = pt::launch_ln_rows(xb, (const bf16*)g, (const bf16*)bg, ob, M, D, eps, s);
    if (err == cudaSuccess)  // LN(x) sits in `out` until fc2 overwrites it
      err = pt::launch_gemm(ob, w1b, M, D, pt::dense_tiles(H),
                            pt::DenseEpilogue<Fc1Epilogue>{
                                {(const bf16*)b1, hb, H, gelu_approx != 0}}, s);
    if (err == cudaSuccess)
      err = pt::launch_gemm(hb, w2b, M, H, pt::dense_tiles(D),
                            pt::DenseEpilogue<Fc2Epilogue>{
                                {xb, (const bf16*)b2, (const bf16*)ls, ob, D}}, s);
    return (int)err;
  }
  const int blocks = (M + BM - 1) / BM;
  const size_t smem = (size_t)(BM * (D + 8) + HC * D + 32 * HC + BM * HC) * sizeof(float);
  err = pt_allow_smem(ln_mlp_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_f32_kernel<<<blocks, THREADS, smem, s>>>(
      (const float*)x, (const float*)g, (const float*)bg, (const float*)w1,
      (const float*)b1, (const float*)w2, (const float*)b2, (const float*)ls,
      (float*)out, M, D, H, eps, gelu_approx != 0);
  return (int)cudaGetLastError();
}
