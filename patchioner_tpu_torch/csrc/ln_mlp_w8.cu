// Kernel I: the W8A8 MLP half of an encoder block,
//   out = x + ls * (q(h) @ W2q * s_h * s2 + b2),
//   h = GELU(q(y) @ W1q * s_y * s1 + b1), y = LN(x) in f32,
// with int8 weights quantized per output column (s1, s2) and the
// activations quantized per row: s = max(amax / 127, 1e-12), q(a) =
// clip(round_half_even(a / s), -127, 127); int8 products summed in int32.
//
// Replaces patchioner_tpu/ops/mlp.py:fused_ln_mlp_w8 (body _w8_kernel).
//
// Bound on the H100: at the flagship shape (8*1374 rows, D = 768,
// H = 3072) the two products are 104 G int8 operations against ~38 MB of
// weights and activations, so the bound is arithmetic (0.052 ms at 1,979
// TOP/s).
//
// Design. The second product's activation scale is the amax of a row's
// whole H-wide hidden. On the TPU one grid step holds the full row; here
// the row's hidden columns are spread over the blocks of a GEMM, so the
// amax is a reduction across blocks. Five launches, each over the whole
// card:
// 1. the weights transposed (W1q to (H, D), W2q to (D, H)) into the
//    wrapper's scratch: wgmma takes an 8-bit B operand K-major only, and the
//    public layout is the JAX package's (2.4 MB each at the flagship);
// 2. LN and quantize, one warp a row: f64 statistics, y in f32, the row's
//    amax, Xq (M, D) int8 and s_y (M); it also zeroes the (M) amax buffer
//    of step 3;
// 3. fc1 as an int8 wgmma GEMM, Xq @ W1q: its epilogue computes h =
//    GELU(dequant(acc, s_y, s1, b1)), stores it in f32 (M, H) and folds
//    |h| into the row's amax with atomicMax on the float's bits (exact, and
//    order-free for values >= 0): a thread's 32 columns, then the 4 lanes
//    of a row, then one atomic a warp and row;
// 4. the f32 hidden quantized with s_h = row_scale(amax) into Hq (M, H)
//    int8, 16 values a thread;
// 5. fc2 as an int8 wgmma GEMM, Hq @ W2q, whose epilogue computes
//    x + round_T(dequant(acc, s_h, s2, b2) * ls).
// Why the f32 round trip (270 MB of traffic at the flagship) and not a
// second fc1 pass that quantizes in its epilogue: the epilogue's GELU, not
// the int8 products, sets fc1's pace (fc1 0.144 ms a pass against fc2's
// 0.065 for the same operations), so the second pass cost more than the
// bytes. Measured on the card both ways: 0.35-0.38 ms a call against
// 0.48-0.50 on an H100 (PERF.md §6).
// The GEMM: 128 x 128 output tiles, 256 threads, each warpgroup 64 rows;
// per 128-deep stage 4 wgmma.m64n128k32.s32.s8.s8, both operands K-major
// in 128-byte-swizzled shared memory; a ring of 3 stages (32 KB each)
// filled by 16-byte cp.async copies runs two stages ahead of the tensor
// cores; 97 KB of shared memory a block, two blocks an SM. Ragged rows are
// zero-filled on load and never stored. Needs D % 128 == 0 and H % 128 ==
// 0 (the wrapper checks); no cap on either.
//
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
// The int32 sums are exact in any order.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using s8 = signed char;

constexpr int THREADS = 256, GM = 128, GN = 128, GK = 128, STAGES = 3;
constexpr int TILE = 64 * 128;  // bytes of one swizzled 64-row x 128-byte tile
// a stage: A 128 rows x 128 bytes of K, B 128 rows x 128 bytes of K
constexpr size_t SMEM = 1024 + STAGES * 4 * TILE;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ s8 quantize(float a, float s) {
  return (s8)fminf(fmaxf(rintf(__fdiv_rn(a, s)), -127.f), 127.f);
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// (acc * s_a) * s_w + b, each step rounded
__device__ __forceinline__ float dequant(int acc, float sa, float sw, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)acc, sa), sw), b);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pt::sm90::pack_bf16(a, b);
}

// ---- 1. W1q (D, H) -> W1t (H, D) and W2q (H, D) -> W2t (D, H): a 64 x 64
// byte tile a block (blockIdx.y picks the matrix; both have D H / 4096
// tiles), read and written in 16-byte rows.
__global__ void __launch_bounds__(256)
transpose_s8_kernel(const s8* __restrict__ w1, const s8* __restrict__ w2, s8* __restrict__ w1t,
                    s8* __restrict__ w2t, int D, int H) {
  __shared__ __align__(16) unsigned char tile[64][80];
  const bool second = blockIdx.y != 0;
  const int C = second ? D : H, R = second ? H : D;
  const s8* src = second ? w2 : w1;
  s8* dst = second ? w2t : w1t;
  const int r0 = (blockIdx.x / (C / 64)) * 64, c0 = (blockIdx.x % (C / 64)) * 64;
  const int row = threadIdx.x >> 2, ch = threadIdx.x & 3;
  *reinterpret_cast<uint4*>(&tile[row][ch * 16]) =
      *reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * C + c0 + ch * 16);
  __syncthreads();
  // output row c0 + row, bytes r0 + 16 ch .. + 15: column `row` of the tile
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = ch * 16 + 4 * i;
    w[i] = (uint32_t)tile[k][row] | (uint32_t)tile[k + 1][row] << 8 |
           (uint32_t)tile[k + 2][row] << 16 | (uint32_t)tile[k + 3][row] << 24;
  }
  *reinterpret_cast<uint4*>(dst + (size_t)(c0 + row) * R + r0 + ch * 16) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// ---- 2. y = LN(x) in f32 with f64 statistics, quantized per row into xq,
// its scale into sy, and the row's fc1 amax zeroed; one warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
ln_quant_rows_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ bg,
                     s8* __restrict__ xq, float* __restrict__ sy, unsigned* __restrict__ amax_h,
                     int M, int D, float eps) {
  const int lane = threadIdx.x & 31, m = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (m >= M) return;
  const T* xr = x + (size_t)m * D;
  double s = 0.0;
  for (int k = lane; k < D; k += 32) s += (double)pt::to_f(xr[k]);
  const float mu = (float)(warp_sum_d(s) / D);
  double v = 0.0;
  for (int k = lane; k < D; k += 32) {
    const double c = (double)__fsub_rn(pt::to_f(xr[k]), mu);
    v += c * c;
  }
  const float rstd = (float)(1.0 / sqrt(warp_sum_d(v) / D + (double)eps));
  auto y = [&](int k) {
    const float t = __fmul_rn(__fsub_rn(pt::to_f(xr[k]), mu), rstd);
    return __fadd_rn(__fmul_rn(t, pt::to_f(g[k])), pt::to_f(bg[k]));
  };
  float amax = 0.f;
  for (int k = lane; k < D; k += 32) amax = fmaxf(amax, fabsf(y(k)));
  const float sc = row_scale(pt::warp_max(amax));
  for (int k = lane; k < D; k += 32) xq[(size_t)m * D + k] = quantize(y(k), sc);
  if (lane == 0) {
    sy[m] = sc;
    amax_h[m] = 0u;
  }
}

// ---- 3-5. epi(A @ Bt^T) for A (M, K) and Bt (N, K) int8 row-major, K %
// 128 == 0, N % 128 == 0; grid (N / 128, ceil(M / 128)). The epilogue gets
// the thread's whole accumulator: in the m64n128 layout (sm90.cuh) group j
// holds columns n + 8j, n + 8j + 1 of row r (acc[4j], acc[4j + 1]) and of
// row r + 8 (acc[4j + 2], acc[4j + 3]).
template <class Epilogue>
__global__ void __launch_bounds__(THREADS, 2)
gemm_s8_kernel(const s8* __restrict__ A, const s8* __restrict__ Bt, int M, int K,
               Epilogue epi) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = pt::sm90::smem_addr(smem_raw);
  const uint32_t sbase = raw + ((1024 - (raw & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM, kt = K / GK;

  auto load = [&](int t) {  // stage t % STAGES: A rows m0.., Bt rows n0.., K t * 128..
    if (t < kt) {
      const uint32_t sa = sbase + (t % STAGES) * 4 * TILE, sb = sa + 2 * TILE;
      const size_t k0 = (size_t)t * GK;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * THREADS;
        const int r = e >> 3, c = e & 7, row = m0 + r;  // 128 rows x 8 chunks each
        pt::sm90::cp_async16(sa + pt::sm90::swizzle128(r, c),
                             A + (size_t)(row < M ? row : 0) * K + k0 + c * 16, row < M);
        pt::sm90::cp_async16(sb + pt::sm90::swizzle128(r, c),
                             Bt + (size_t)(n0 + r) * K + k0 + c * 16, true);
      }
    }
    pt::sm90::cp_async_commit();  // one group per stage, empty past the last
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load(t);

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int t = 0; t < kt; ++t) {
    pt::sm90::cp_async_wait<STAGES - 2>();  // stage t has landed
    pt::sm90::fence_proxy_async();
    __syncthreads();  // every thread's copies, and stage t - 1 is free
    load(t + STAGES - 1);
    const uint32_t sa = sbase + (t % STAGES) * 4 * TILE, sb = sa + 2 * TILE;
    // both K-major: +32 bytes a k32 step; B's 128 rows are 16 atoms SBO apart
    const uint64_t da = pt::sm90::desc128(sa + wg * TILE, 16, 1024);
    const uint64_t db = pt::sm90::desc128(sb, 16, 1024);
    pt::sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pt::sm90::wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk, 1);
    pt::sm90::wgmma_commit();
    pt::sm90::wgmma_wait<0>();
    pt::sm90::fence_operands(acc);
  }
  epi(acc, m0 + wg * 64 + warp * 16 + (lane >> 2), n0 + (lane & 3) * 2, M);
}

template <class Epilogue>
cudaError_t launch_gemm_s8(const s8* A, const s8* Bt, int M, int N, int K, Epilogue epi,
                           cudaStream_t s) {
  cudaError_t err = pt_allow_smem(gemm_s8_kernel<Epilogue>, SMEM);
  if (err != cudaSuccess) return err;
  gemm_s8_kernel<<<dim3(N / GN, (M + GM - 1) / GM), THREADS, SMEM, s>>>(A, Bt, M, K, epi);
  return cudaGetLastError();
}

// fc1: h = GELU(dequant(acc, s_y, s1, b1)) stored in f32, |h| folded into
// the row's amax (float bits; |h| >= 0 orders as its bits do): a thread's
// 32 columns, then the 4 lanes of a row, then one atomic a warp and row.
struct W8Fc1Epilogue {
  const float *sy, *s1, *b1;
  unsigned* amax;
  float* hf;
  int H;
  bool approx;
  __device__ __forceinline__ void operator()(const int (&acc)[64], int r, int n, int M) const {
    bool ok[2];
    float sa[2], mx[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      ok[half] = r + 8 * half < M;
      sa[half] = ok[half] ? sy[r + 8 * half] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n + 8 * j;
      const float2 sw = load_pair(s1 + c), bb = load_pair(b1 + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float h0 = pt::gelu(dequant(acc[4 * j + 2 * half], sa[half], sw.x, bb.x), approx);
        const float h1 = pt::gelu(dequant(acc[4 * j + 2 * half + 1], sa[half], sw.y, bb.y), approx);
        if (ok[half]) store_pair(hf + (size_t)(r + 8 * half) * H + c, h0, h1);
        mx[half] = fmaxf(mx[half], fmaxf(fabsf(h0), fabsf(h1)));
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = fmaxf(mx[half], __shfl_xor_sync(FULL, mx[half], 1));
      v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
      if (ok[half] && (threadIdx.x & 3) == 0) atomicMax(amax + r + 8 * half, __float_as_uint(v));
    }
  }
};

// Hq = q(h) with s_h = row_scale(amax), 16 values a thread
__global__ void __launch_bounds__(256)
quant_hidden_kernel(const float* __restrict__ hf, const unsigned* __restrict__ amax,
                    s8* __restrict__ hq, int M, int H) {
  const size_t i = ((size_t)blockIdx.x * 256 + threadIdx.x) * 16;
  if (i >= (size_t)M * H) return;
  const float s = row_scale(__uint_as_float(amax[i / H]));
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(hf + i + 4 * k);
    w[k] = (uint32_t)(unsigned char)quantize(v.x, s) |
           (uint32_t)(unsigned char)quantize(v.y, s) << 8 |
           (uint32_t)(unsigned char)quantize(v.z, s) << 16 |
           (uint32_t)(unsigned char)quantize(v.w, s) << 24;
  }
  *reinterpret_cast<uint4*>(hq + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

// fc2: out = x + round_T(dequant(acc, s_h, s2, b2) * ls), rounded to T
template <typename T>
struct W8Fc2Epilogue {
  const T *x, *ls;
  const float *s2, *b2;
  const unsigned* amax;
  T* out;
  int D;
  __device__ __forceinline__ void operator()(const int (&acc)[64], int r, int n, int M) const {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = r + 8 * half;
      if (m >= M) continue;
      const float sh = row_scale(__uint_as_float(amax[m]));
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = n + 8 * j;
        const size_t o = (size_t)m * D + c;
        const float2 sw = load_pair(s2 + c), bb = load_pair(b2 + c), l = load_pair(ls + c);
        const float2 xv = load_pair(x + o);
        const float o0 = pt::round_t<T>(__fmul_rn(dequant(acc[4 * j + 2 * half], sh, sw.x, bb.x), l.x));
        const float o1 = pt::round_t<T>(__fmul_rn(dequant(acc[4 * j + 2 * half + 1], sh, sw.y, bb.y), l.y));
        store_pair(out + o, __fadd_rn(xv.x, o0), __fadd_rn(xv.y, o1));
      }
    }
  }
};

template <typename T>
int launch(const void* x, const void* g, const void* bg, const void* w1, const void* s1,
           const void* b1, const void* w2, const void* s2, const void* b2, const void* ls,
           void* out, void* scratch, int M, int D, int H, float eps, bool approx,
           cudaStream_t s) {
  // the scratch, as the wrapper sizes it: the f32 hidden (M, H), Xq (M, D),
  // Hq (M, H), W1t (H, D), W2t (D, H) int8, then s_y (M) f32 and the
  // hidden's amax (M) as bits
  float* hf = (float*)scratch;
  s8* xq = (s8*)(hf + (size_t)M * H);
  s8* hq = xq + (size_t)M * D;
  s8* w1t = hq + (size_t)M * H;
  s8* w2t = w1t + (size_t)D * H;
  float* sy = (float*)(w2t + (size_t)D * H);
  unsigned* amax = (unsigned*)(sy + M);
  transpose_s8_kernel<<<dim3((D / 64) * (H / 64), 2), 256, 0, s>>>(
      (const s8*)w1, (const s8*)w2, w1t, w2t, D, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_quant_rows_kernel<T><<<(M + 7) / 8, 256, 0, s>>>((const T*)x, (const T*)g, (const T*)bg,
                                                     xq, sy, amax, M, D, eps);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_gemm_s8(xq, w1t, M, H, D,
                         W8Fc1Epilogue{sy, (const float*)s1, (const float*)b1, amax, hf, H,
                                       approx}, s);
  if (err == cudaSuccess) {
    const size_t n16 = (size_t)M * H / 16;
    quant_hidden_kernel<<<(unsigned)((n16 + 255) / 256), 256, 0, s>>>(hf, amax, hq, M, H);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = launch_gemm_s8(hq, w2t, M, D, H,
                         W8Fc2Epilogue<T>{(const T*)x, (const T*)ls, (const float*)s2,
                                          (const float*)b2, amax, (T*)out, D}, s);
  return (int)err;
}

}  // namespace

// x, g, bg, ls and out in the element type `dtype`; w1 (D, H) and w2 (H, D)
// int8; s1, b1 (H) and s2, b2 (D) f32; `scratch` M (D + 5 H + 8) + 2 D H
// bytes, 16-byte aligned. D % 128 == 0, H % 128 == 0 (the wrapper checks).
extern "C" int pt_ln_mlp_w8(const void* x, const void* g, const void* bg,
                            const void* w1, const void* s1, const void* b1,
                            const void* w2, const void* s2, const void* b2,
                            const void* ls, void* out, void* scratch, int M, int D, int H,
                            float eps, int gelu_approx, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kBF16)
    return launch<bf16>(x, g, bg, w1, s1, b1, w2, s2, b2, ls, out, scratch, M, D, H, eps,
                        gelu_approx != 0, s);
  return launch<float>(x, g, bg, w1, s1, b1, w2, s2, b2, ls, out, scratch, M, D, H, eps,
                       gelu_approx != 0, s);
}
