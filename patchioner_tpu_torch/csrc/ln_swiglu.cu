// Kernel G: out = x + ls * ((silu(x1) * x2) @ W3 + b3) with
// [x1 | x2] = LN(x) @ W12 + b12, the SwiGLU FFN half of a DINOv2-giant
// block.
//
// Replaces patchioner_tpu/ops/mlp.py:fused_ln_swiglu (body _ln_swiglu_kernel).
//
// Bound on the H100: at the giant shape (8*1374 rows, D = 1536, H = 4096)
// the two products are 415 GFLOP against ~105 MB of weights and
// activations, so arithmetic bounds it: 0.4195 ms at 989 TFLOP/s. The plain
// version additionally writes and reads the 360 MB f32 hidden tensor.
//
// Rounding points of _ln_swiglu_kernel, kept in both types: LN(x) rounds to
// T; h1 and h2 are f32 sums with the bias added in f32 (not rounded, unlike
// kernel C's fc1); g = h1 * (1 / (1 + exp(-h1))) * h2 in f32, rounded to T
// before W3; the W3 sum stays f32 over the whole hidden and + b3 is f32; o
// * ls rounds to T, then x + it rounds to T.
//
// bf16 design. The TPU kernel carries a row block's (rows, D) f32 W3 sum
// across its hidden grid axis in VMEM. A fused Hopper block would have to
// re-read all of W12 and W3 (38 MB) for every row block: the WMMA kernel
// this replaces did, 16 rows a block, about 26 GB through L2 a call, and
// took 48x its bound. So the (M, H) bf16 hidden goes through device memory
// (90 MB written and read, ~54 us at 3.35 TB/s) and the wrapper runs three
// launches of kernel C's pieces (gemm_sm90.cuh):
// - LN(x) of every row, rounded to bf16, into the output buffer;
// - fc1: the wgmma GEMM over LN(x) and w12, block x reading the gate tile
//   at columns 64x.. and its linear partner at H + 64x.. of the one w12 (as
//   the TPU kernel addresses it), whose epilogue forms g from both f32 sums
//   and writes it into the wrapper's (M, H) scratch; grid H / 64 x
//   ceil(M / 128);
// - fc2: the same GEMM over the hidden and W3, whose epilogue adds b3,
//   scales by ls and adds x into the output; grid D / 128 x ceil(M / 128).
// Where it loses to the bound: the hidden's round trip and the LN pass
// (~75 us), and the GEMM template's own limits (a block barrier and a full
// wgmma wait every 64-deep stage, no TMA, 128 x 128 tiles; C's fc1 runs at
// about a third of the peak); at giant's shape fc2's 1032 blocks are 3.9
// waves of the 264 that fit at once.
//
// f32 design (for the checks): SIMT, one block owns 16 rows and walks the
// whole hidden itself, LN(x) in shared memory, the 16-row f32 output tile in
// registers (2 rows x 48 columns a thread at D = 1536); the hidden is never
// written out.
#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// ---- bf16: LN(x) into the output buffer, then fc1 and fc2 on the wgmma
// GEMM template. Needs D % 128 == 0 and H % 64 == 0.

// g = silu(acc_gate + b12[n]) * (acc_lin + b12[H + n]) in f32, rounded to
// bf16, at column n of the (M, H) hidden
struct SwigluFc1Epilogue {
  const bf16* b12;
  bf16* g;
  int H;
  __device__ __forceinline__ void operator()(int m, int n, int nl, float g0, float g1,
                                             float l0, float l1) const {
    const float v0 = swiglu(g0 + pt::to_f(b12[n]), l0 + pt::to_f(b12[nl]));
    const float v1 = swiglu(g1 + pt::to_f(b12[n + 1]), l1 + pt::to_f(b12[nl + 1]));
    *(uint32_t*)(g + (size_t)m * H + n) = pt::sm90::pack_bf16(v0, v1);
  }
};

// out = x + round((acc + b3) * ls), rounded to bf16; acc + b3 in f32
struct SwigluFc2Epilogue {
  const bf16 *x, *b3, *ls;
  bf16* out;
  int D;
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1) const {
    float v[2] = {v0, v1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float os = pt::round_t<bf16>((v[e] + pt::to_f(b3[n + e])) * pt::to_f(ls[n + e]));
      v[e] = pt::to_f(x[(size_t)m * D + n + e]) + os;
    }
    *(uint32_t*)(out + (size_t)m * D + n) = pt::sm90::pack_bf16(v[0], v[1]);
  }
};

}  // namespace

// Shapes as each kernel states; the wrapper checks them. `hidden` is the
// (M, H) bf16 scratch of the bf16 path (unused in f32).
extern "C" int pt_ln_swiglu(const void* x, const void* g, const void* bg,
                            const void* w12, const void* b12, const void* w3,
                            const void* b3, const void* ls, void* out, void* hidden,
                            int M, int D, int H, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == pt::kBF16) {
    const bf16* xb = (const bf16*)x;
    bf16 *ob = (bf16*)out, *hb = (bf16*)hidden;
    err = pt::launch_ln_rows(xb, (const bf16*)g, (const bf16*)bg, ob, M, D, eps, s);
    if (err == cudaSuccess)  // LN(x) sits in `out` until fc2 overwrites it
      err = pt::launch_gemm(ob, (const bf16*)w12, M, D, pt::WTiles{2 * H, H / 64, 64, H},
                            SwigluFc1Epilogue{(const bf16*)b12, hb, H}, s);
    if (err == cudaSuccess)
      err = pt::launch_gemm(hb, (const bf16*)w3, M, H, pt::dense_tiles(D),
                            pt::DenseEpilogue<SwigluFc2Epilogue>{
                                {xb, (const bf16*)b3, (const bf16*)ls, ob, D}}, s);
    return (int)err;
  }
  const size_t smem =
      (size_t)(BM * (D + 8) + FCK * 2 * FHC + BM * FHC + FW3R * D) * sizeof(float);
  err = pt_allow_smem(ln_swiglu_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ln_swiglu_f32_kernel<<<(M + BM - 1) / BM, THREADS, smem, s>>>(
      (const float*)x, (const float*)g, (const float*)bg, (const float*)w12,
      (const float*)b12, (const float*)w3, (const float*)b3, (const float*)ls,
      (float*)out, M, D, H, eps);
  return (int)cudaGetLastError();
}
