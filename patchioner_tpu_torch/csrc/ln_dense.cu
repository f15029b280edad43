// Kernel A: out = LN(x) @ W + b, the LN + qkv projection of every encoder
// block. Kernel E: out = r + ls * (x @ W + b), the attention
// out-projection with its layerscale and residual add folded into the
// product's epilogue.
//
// Replace patchioner_tpu/ops/mlp.py:fused_ln_dense (body _ln_dense_kernel)
// and fused_dense_residual (body _dense_res_kernel, reached by proj_fused).
//
// Bound on the H100: A's product at the flagship shape (8*1374 rows,
// D = 768, O = 2304) is 38.9 GFLOP against 71 MB of x, W and output, far
// above the card's ~295 FLOP/byte ridge, so arithmetic bounds it (0.039 ms
// at 989 TFLOP/s); at giant's (D = 1536, O = 4608) 155.6 GFLOP, 0.157 ms.
// E's (O = 768) is 13 GFLOP against 52 MB (x, r and out, 17 MB each, and
// W): about 250 FLOP/byte, just under the ridge, so bound by bytes.
//
// Rounding points, kept in both types: A's LN(x) takes the reference's
// two-pass f32 statistics and rounds to the element type T before the
// product; its f32 sum rounds to T before + b, and the sum rounds again
// (the reference's dot(...).astype(T) + b). E rounds after + b, after * ls
// and after + r, each to T.
//
// A, bf16: two launches of kernel C's pieces (gemm_sm90.cuh):
// - LN(x) of every row, rounded to bf16, into the wrapper's (M, D) scratch;
// - the wgmma GEMM over that scratch and W, 128 x 128 output tiles (a grid
//   of O / 128 x ceil(M / 128): 18 x 86 blocks on the flagship, 36 x 86 on
//   giant), whose epilogue adds b with A's two roundings and stores packed
//   bf16 pairs.
// What is given up: the TPU kernel never writes LN(x); here it makes a
// round trip through device memory, M * D * 2 bytes written and read (34 MB
// on the flagship, ~10 us at 3.35 TB/s; 68 MB on giant, ~20 us) against
// bounds of 39 and 157 us. The alternative, normalising inside the GEMM's
// A loader, would turn the asynchronous 16-byte copies of the ring into
// register round trips with a barrier before every stage; a fused LN
// prologue is a later question. The scratch cannot be `out`, as C reuses
// its output: A's output rows are 3D wide, and its GEMM reads rows of LN(x)
// while other blocks write the outputs of those same rows.
//
// E, bf16: tensor cores through warp-level WMMA 16x16x16 tiles with f32
// accumulators. One block copies 32 rows of x into shared memory and
// sweeps all output columns in 128-wide tiles, W streamed in 64-row slices
// with 16-byte copies; a tile's f32 sums go through shared memory to the
// rounding epilogue. E is the last user of this template.
//
// float32 (both): the SIMT kernel of dense_f32.cuh.
#include <mma.h>

#include "dense_f32.cuh"
#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// out[m, n .. n + 1] = round(round(acc) + b), packed bf16 pairs
struct QkvEpilogue {
  const bf16* b;
  bf16* out;
  int O;
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1) const {
    const float o0 = pt::round_t<bf16>(v0) + pt::to_f(b[n]);
    const float o1 = pt::round_t<bf16>(v1) + pt::to_f(b[n + 1]);
    *(uint32_t*)(out + (size_t)m * O + n) = pt::sm90::pack_bf16(o0, o1);
  }
};

// ---- E, bf16: 8 warps as 2 row groups x 4 column groups, each owning a
// 16x32 sub-tile (2 fragments) of a 32x128 output tile. Needs D % 64 == 0
// and O % 128 == 0 (the wrapper checks).
constexpr int THREADS = 256, WBM = 32, WBN = 128, WKS = 64, BLD = WBN + 8,
              CLD = WBN + 4;

__global__ void __launch_bounds__(THREADS)
dense_residual_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                           const bf16* __restrict__ bias, const bf16* __restrict__ r,
                           const bf16* __restrict__ ls, bf16* __restrict__ out, int M,
                           int D, int O) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DP = D + 8;
  bf16* Ys = (bf16*)smem_raw;                  // [WBM][DP] rows of x
  bf16* Bs = Ys + WBM * DP;                    // [WKS][BLD] W slice
  float* Cs = (float*)(Bs + WKS * BLD);        // [WBM][CLD] f32 sums
  const int m0 = blockIdx.x * WBM;
  const int tid = threadIdx.x, warp = tid >> 5;

  for (int e = tid; e < WBM * D / 8; e += THREADS) {  // 16-byte copies, zeros past M
    const int i = e / (D / 8), k = (e % (D / 8)) * 8, m = m0 + i;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < M) v = *(const uint4*)(x + (size_t)m * D + k);
    *(uint4*)(Ys + i * DP + k) = v;
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
      v = pt::to_f(r[o]) + pt::round_t<bf16>(v * pt::to_f(ls[n0 + n]));
      out[o] = pt::from_f<bf16>(v);
    }
  }
}

}  // namespace

// bf16 needs D % 64 == 0 and O % 128 == 0 (the wrapper checks); `ln` is the
// (M, D) bf16 scratch of the bf16 path (unused in f32).
extern "C" int pt_ln_dense(const void* x, const void* g, const void* bg,
                           const void* w, const void* b, void* out, void* ln, int M,
                           int D, int O, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == pt::kBF16) {
    bf16* y = (bf16*)ln;
    err = pt::launch_ln_rows((const bf16*)x, (const bf16*)g, (const bf16*)bg, y, M, D,
                             eps, s);
    if (err == cudaSuccess)
      err = pt::launch_gemm(y, (const bf16*)w, M, D, pt::dense_tiles(O),
                            pt::DenseEpilogue<QkvEpilogue>{{(const bf16*)b, (bf16*)out, O}},
                            s);
    return (int)err;
  }
  err = pt::launch_dense_f32<false>((const float*)x, (const float*)g, (const float*)bg,
                                    (const float*)w, (const float*)b, nullptr, nullptr,
                                    (float*)out, M, D, O, eps, s);
  return (int)err;
}

extern "C" int pt_dense_residual(const void* x, const void* r, const void* w,
                                 const void* b, const void* ls, void* out,
                                 int M, int D, int O, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kBF16) {
    const size_t smem = (size_t)(WBM * (D + 8) + WKS * BLD) * sizeof(bf16) +
                        (size_t)WBM * CLD * sizeof(float);
    cudaError_t err = pt_allow_smem(dense_residual_bf16_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dense_residual_bf16_kernel<<<(M + WBM - 1) / WBM, THREADS, smem, s>>>(
        (const bf16*)x, (const bf16*)w, (const bf16*)b, (const bf16*)r, (const bf16*)ls,
        (bf16*)out, M, D, O);
    return (int)cudaGetLastError();
  }
  return (int)pt::launch_dense_f32<true>((const float*)x, nullptr, nullptr,
                                         (const float*)w, (const float*)b,
                                         (const float*)r, (const float*)ls, (float*)out,
                                         M, D, O, 0.f, s);
}
