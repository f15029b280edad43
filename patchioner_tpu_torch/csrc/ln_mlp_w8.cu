// Kernel I: the W8A8 MLP half of an encoder block,
//   out = x + ls * (q(h) @ W2q * s_h * s2 + b2),
//   h = GELU(q(y) @ W1q * s_y * s1 + b1), y = LN(x) in f32,
// with int8 weights quantized per output column (s1, s2) and the
// activations quantized per row inside the kernel: s = max(amax / 127,
// 1e-12), q(a) = clip(round_half_even(a / s), -127, 127); int8 products
// summed in int32.
//
// Replaces patchioner_tpu/ops/mlp.py:fused_ln_mlp_w8 (body _w8_kernel).
//
// Bound on the H100: at the flagship shape (8*1374 rows, D = 768,
// H = 3072) the two products are 104 G int8 operations against ~38 MB of
// weights and activations, so the bound is arithmetic (0.052 ms at 1,979
// TOP/s). The products run on the int8 tensor cores through WMMA m8n32k16
// tiles (s8 x s8 -> s32); the plain version in float64 is exact but
// materialises the (rows, H) hidden three times.
//
// Design: the second product's activation scale is the amax of a row's
// whole 3072-wide hidden, so no part of that product can start before the
// row's hidden is complete. One block owns 8 rows and keeps their f32
// hidden in shared memory (96 KB at H = 3072): the first product streams
// W1q in 256-column chunks (each warp one 8x32 tile), its int32 sums are
// written in place and turned into GELU(acc * s_y * s1 + b1) there; then
// one warp per row finds the amax, quantizes the row, and the second
// product streams W2q rows into int32 accumulators (D/256 tiles a warp).
// The alternative, a second pass over W1q to find the amax first, would
// repeat half the arithmetic. WMMA wants 32-byte aligned tile pointers,
// and an int8 k-step of 16 is 16 bytes, so the activations are stored
// transposed ([k][row], 16 bytes a k) and loaded as column-major A tiles.
// Numerics of _w8_kernel: LN in f32 (not rounded to T), true division by
// the scale, rintf (half to even), dequantized as (f32(acc) * s_a) * s_w,
// GELU in f32, + b in f32, o * ls rounded to T, then x + it.
// Quantization turns an ulp into a step: a row whose LN output differs by
// one ulp from another implementation's can round one activation the other
// way, which moves that row's whole hidden and, through its amax, the
// rounding of the second product. So every f32 step here is one that the
// plain version (ops/mlp.py:ln_mlp_w8_plain) repeats exactly: the LN
// statistics are summed in f64 (the mean, and the squares of x - mean,
// are exact there up to f64 rounding) and rounded to f32 once; every
// product and sum of the elementwise steps rounds on its own (__fmul_rn,
// __fadd_rn: no fused multiply-add), as torch's separate operations do.
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int THREADS = 256, BM = 8, HC = 256, CK = 64, W2R = 32, MAX_FRAGS = 3;
constexpr int ALD = 16;        // bytes per k of a transposed activation tile
constexpr int W1LD = HC + 16;  // int8 W1q slice rows

__device__ __forceinline__ signed char quantize(float a, float s) {
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(a, s)), -127.f), 127.f);
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (acc * s_a) * s_w + b, each step rounded
__device__ __forceinline__ float dequant(int acc, float sa, float sw, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)acc, sa), sw), b);
}

// Needs D % 64 == 0, D <= 768, H % 256 == 0 (the wrapper checks).
// Shared memory: Xq [D][16] transposed int8 LN(x), Hs [8][H+4] f32 hidden
// (int32 sums, then GELU output; the epilogue's int32 tile [8][D+4]),
// Hq [H][16] transposed int8 hidden, Ws: W1q [64][272] or W2q [32][D+16]
// int8 slices; 180 KB at the flagship shape.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_mlp_w8_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const T* __restrict__ bg, const signed char* __restrict__ w1,
                 const float* __restrict__ s1, const float* __restrict__ b1,
                 const signed char* __restrict__ w2, const float* __restrict__ s2,
                 const float* __restrict__ b2, const T* __restrict__ ls,
                 T* __restrict__ out, int M, int D, int H, float eps, bool approx) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int HP = H + 4, W2LD = D + 16;
  signed char* Xq = (signed char*)smem_raw;
  float* Hs = (float*)(Xq + D * ALD);
  int* Hi = (int*)Hs;
  signed char* Hq = (signed char*)(Hs + BM * HP);
  signed char* Ws = Hq + H * ALD;
  __shared__ float mean_s[BM], rstd_s[BM], sa_s[BM], sh_s[BM];
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // LN(x) in f32 with f64 statistics, its row amax, and the quantized
  // row; one warp per row
  {
    const int r = warp, m = m0 + r;
    const T* xr = x + (size_t)m * D;
    if (m < M) {
      double s = 0.0;
      for (int k = lane; k < D; k += 32) s += (double)pt::to_f(xr[k]);
      const float mu = (float)(warp_sum_d(s) / D);
      double v = 0.0;
      for (int k = lane; k < D; k += 32) {
        const double c = (double)__fsub_rn(pt::to_f(xr[k]), mu);
        v += c * c;
      }
      const double var = warp_sum_d(v) / D;
      if (lane == 0) {
        mean_s[r] = mu;
        rstd_s[r] = (float)(1.0 / sqrt(var + (double)eps));
      }
    }
    __syncwarp();
    auto y = [&](int k) {
      const float t = __fmul_rn(__fsub_rn(pt::to_f(xr[k]), mean_s[r]), rstd_s[r]);
      return __fadd_rn(__fmul_rn(t, pt::to_f(g[k])), pt::to_f(bg[k]));
    };
    float amax = 0.f;
    if (m < M)
      for (int k = lane; k < D; k += 32) amax = fmaxf(amax, fabsf(y(k)));
    const float s = row_scale(pt::warp_max(amax));
    for (int k = lane; k < D; k += 32) Xq[k * ALD + r] = m < M ? quantize(y(k), s) : 0;
    if (lane == 0) sa_s[r] = s;
  }

  // first product: warp w owns hidden columns h0 + 32 w .. + 31
  for (int h0 = 0; h0 < H; h0 += HC) {
    wmma::fragment<wmma::accumulator, 8, 32, 16, int> acc;
    wmma::fill_fragment(acc, 0);
    for (int k0 = 0; k0 < D; k0 += CK) {
      __syncthreads();
      for (int e = tid; e < CK * HC / 16; e += THREADS) {  // 16-byte copies
        const int k = e / (HC / 16), c = (e % (HC / 16)) * 16;
        *(uint4*)(Ws + k * W1LD + c) = *(const uint4*)(w1 + (size_t)(k0 + k) * H + h0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 8, 32, 16, signed char, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 8, 32, 16, signed char, wmma::row_major> b;
        wmma::load_matrix_sync(a, Xq + (k0 + kk) * ALD, ALD);
        wmma::load_matrix_sync(b, Ws + kk * W1LD + warp * 32, W1LD);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    const int c0 = h0 + warp * 32;
    wmma::store_matrix_sync(Hi + c0, acc, HP, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < BM * 32; e += 32) {
      const int r = e / 32, c = c0 + e % 32;
      Hs[r * HP + c] = pt::gelu(dequant(Hi[r * HP + c], sa_s[r], s1[c], b1[c]), approx);
    }
  }
  __syncthreads();

  // the hidden's row amax and the quantized hidden; one warp per row
  {
    const int r = warp;
    float amax = 0.f;
    for (int c = lane; c < H; c += 32) amax = fmaxf(amax, fabsf(Hs[r * HP + c]));
    const float s = row_scale(pt::warp_max(amax));
    for (int c = lane; c < H; c += 32) Hq[c * ALD + r] = quantize(Hs[r * HP + c], s);
    if (lane == 0) sh_s[r] = s;
  }

  // second product: warp w owns output tiles w, w + 8, w + 16 (32 columns each)
  const int nt = D / 32;
  wmma::fragment<wmma::accumulator, 8, 32, 16, int> oacc[MAX_FRAGS];
#pragma unroll
  for (int i = 0; i < MAX_FRAGS; ++i) wmma::fill_fragment(oacc[i], 0);
  for (int k0 = 0; k0 < H; k0 += W2R) {
    __syncthreads();  // Hq complete; Ws free
    for (int e = tid; e < W2R * D / 16; e += THREADS) {
      const int k = e / (D / 16), n = (e % (D / 16)) * 16;
      *(uint4*)(Ws + k * W2LD + n) = *(const uint4*)(w2 + (size_t)(k0 + k) * D + n);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < W2R; kk += 16) {
      wmma::fragment<wmma::matrix_a, 8, 32, 16, signed char, wmma::col_major> a;
      wmma::load_matrix_sync(a, Hq + (k0 + kk) * ALD, ALD);
#pragma unroll
      for (int i = 0; i < MAX_FRAGS; ++i) {
        const int t = warp + 8 * i;
        if (t < nt) {
          wmma::fragment<wmma::matrix_b, 8, 32, 16, signed char, wmma::row_major> b;
          wmma::load_matrix_sync(b, Ws + kk * W2LD + t * 32, W2LD);
          wmma::mma_sync(oacc[i], a, b, oacc[i]);
        }
      }
    }
  }

  __syncthreads();  // Hs becomes the int32 output tile [8][D+4]
  const int OP = D + 4;
#pragma unroll
  for (int i = 0; i < MAX_FRAGS; ++i) {
    const int t = warp + 8 * i;
    if (t < nt) wmma::store_matrix_sync(Hi + t * 32, oacc[i], OP, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < BM * D; e += THREADS) {
    const int r = e / D, n = e % D, m = m0 + r;
    if (m >= M) continue;
    const float o = dequant(Hi[r * OP + n], sh_s[r], s2[n], b2[n]);
    const float os = pt::round_t<T>(o * pt::to_f(ls[n]));
    out[(size_t)m * D + n] = pt::from_f<T>(pt::to_f(x[(size_t)m * D + n]) + os);
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* bg, const void* w1,
           const void* s1, const void* b1, const void* w2, const void* s2,
           const void* b2, const void* ls, void* out, int M, int D, int H,
           float eps, bool approx, cudaStream_t s) {
  const size_t ws = (size_t)(CK * W1LD > W2R * (D + 16) ? CK * W1LD : W2R * (D + 16));
  const size_t smem = (size_t)D * ALD + (size_t)BM * (H + 4) * sizeof(float) +
                      (size_t)H * ALD + ws;
  cudaError_t err = pt_allow_smem(ln_mlp_w8_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_w8_kernel<T><<<(M + BM - 1) / BM, THREADS, smem, s>>>(
      (const T*)x, (const T*)g, (const T*)bg, (const signed char*)w1,
      (const float*)s1, (const float*)b1, (const signed char*)w2,
      (const float*)s2, (const float*)b2, (const T*)ls, (T*)out, M, D, H, eps,
      approx);
  return (int)cudaGetLastError();
}

}  // namespace

// x, g, bg, ls and out in the element type `dtype`; w1 (D, H) and w2 (H, D)
// int8; s1, b1 (H) and s2, b2 (D) f32.
extern "C" int pt_ln_mlp_w8(const void* x, const void* g, const void* bg,
                            const void* w1, const void* s1, const void* b1,
                            const void* w2, const void* s2, const void* b2,
                            const void* ls, void* out, int M, int D, int H,
                            float eps, int gelu_approx, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kBF16)
    return launch<bf16>(x, g, bg, w1, s1, b1, w2, s2, b2, ls, out, M, D, H, eps,
                        gelu_approx != 0, s);
  return launch<float>(x, g, bg, w1, s1, b1, w2, s2, b2, ls, out, M, D, H, eps,
                       gelu_approx != 0, s);
}
