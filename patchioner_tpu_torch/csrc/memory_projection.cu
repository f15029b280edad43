// Kernels D and H: support-memory projection, one streaming pass over the
// bank.
//
// D replaces patchioner_tpu/ops/memory_projection.py:memory_project_pallas,
// H replaces memory_project_int8 (_mem_proj_call_q, _mem_proj_kernel_q);
// both are the reference's one body _mem_proj_step:
//   sim = f . (row * inv_norm) / T   (rows >= num_real excluded)
//   out = softmax(sim) @ rows, optionally L2-normalised.
// D reads f32 or bf16 rows; H reads int8 rows dequantized as q * scale
// (per-row f32 scale) and scores them with the ORIGINAL f32 rows' inverse
// norms. As in the reference, the two differ only in how a row is loaded
// (`bank_val`), so a masking or rescale fix reaches both.
//
// Bound on the H100: bandwidth. The prepared 591,753 x 768 bank is 0.91 GB
// in bf16 (1.82 GB at giant's D = 1536) and 0.45 GB in int8, and is read
// once; at B = 8 each bank element feeds 16 FLOPs, far below the card's
// ~295 FLOP/byte ridge, so the ideal is the bank's bytes over 3.35 TB/s
// (~0.27 ms bf16, ~0.14 ms int8 at D = 768). The plain version reads the
// bank twice and materialises the (B, M) similarity matrix and an f32 copy
// of the bank.
//
// Design: the TPU walks the bank axis in order, carrying (max, denom, acc)
// in scratch. Hopper blocks run in parallel and in no order, and one block
// per batch tile would leave almost every SM idle at B = 8, so the bank is
// split into chunks of consecutive rows, one block per (chunk, 8 batch
// rows). Each block streams its chunk in 16-row tiles through shared memory
// with an online softmax in f32 and writes a partial (max, denom, acc); a
// second small kernel combines the partials (project_partial /
// combine_partials, memory_projection.py:116-153) and L2-normalises. Rows
// past num_real are never read, which masks them exactly as the
// reference's -1e30 does: a zero row would otherwise score 0, above every
// real negative cosine. sim / T stays f32 with max subtraction (T = 0.01
// puts logits near +-100). The features arrive L2-normalised in f32. Each
// thread holds NQ = D / 256 columns of the 8 accumulators: NQ = 3 up to
// D = 768, 6 up to D = 1536 (two instantiations, so the flagship's
// registers do not grow with giant's width).
#include "common.cuh"

namespace {

constexpr int BB = 8, TR = 16, THREADS = 256, MAX_D = 1536;

// One bank element in f32: D's rows as they are, H's dequantized.
__device__ __forceinline__ float bank_val(const float* r, size_t i, float) { return r[i]; }
__device__ __forceinline__ float bank_val(const __nv_bfloat16* r, size_t i, float) {
  return __bfloat162float(r[i]);
}
__device__ __forceinline__ float bank_val(const signed char* r, size_t i, float s) {
  return (float)r[i] * s;
}

// scale: H's per-row scales, or null for D.
template <typename T, int NQ>
__global__ void __launch_bounds__(THREADS)
mem_proj_partial_kernel(const float* __restrict__ f, const T* __restrict__ rows,
                        const float* __restrict__ scale, const float* __restrict__ inv,
                        float* __restrict__ m_part, float* __restrict__ l_part,
                        float* __restrict__ acc_part,
                        int B, int D, int num_real, int chunk_rows,
                        float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fs = (float*)smem_raw;  // [BB][D]
  float* rs = fs + BB * D;       // [TR][D]
  __shared__ float ps[BB][TR];
  __shared__ float m_s[BB], l_s[BB], sc_s[BB];

  const int chunk = blockIdx.x, b0 = blockIdx.y * BB;
  const int c0 = chunk * chunk_rows;
  const int c1 = min(c0 + chunk_rows, num_real);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < BB * D; e += THREADS) {
    const int bi = e / D, d = e % D;
    fs[e] = (b0 + bi < B) ? f[(size_t)(b0 + bi) * D + d] : 0.f;
  }
  if (tid < BB) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[BB][NQ];
#pragma unroll
  for (int bi = 0; bi < BB; ++bi)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[bi][q] = 0.f;

  for (int r0 = c0; r0 < c1; r0 += TR) {
    __syncthreads();
    for (int e = tid; e < TR * D; e += THREADS) {
      const int rr = e / D, d = e % D, row = r0 + rr;
      rs[e] = (row < c1) ? bank_val(rows, (size_t)row * D + d, scale ? scale[row] : 1.f)
                         : 0.f;
    }
    __syncthreads();
    // 8 warps x 2 rows x 8 batch rows of cosine similarities
    for (int t = 0; t < 2 * BB; ++t) {
      const int rr = warp * 2 + t / BB, bi = t % BB, row = r0 + rr;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot = fmaf(fs[bi * D + d], rs[rr * D + d], dot);
      dot = pt::warp_sum(dot);
      if (lane == 0) ps[bi][rr] = (row < c1) ? dot * inv[row] * inv_temp : -1e30f;
    }
    __syncthreads();
    if (tid < BB) {
      float mx = -1e30f;
      for (int rr = 0; rr < TR; ++rr) mx = fmaxf(mx, ps[tid][rr]);
      const float m_new = fmaxf(m_s[tid], mx);
      const float sc = expf(m_s[tid] - m_new);
      float sum = 0.f;
      for (int rr = 0; rr < TR; ++rr) {
        const float p = expf(ps[tid][rr] - m_new);
        ps[tid][rr] = p;
        sum += p;
      }
      l_s[tid] = l_s[tid] * sc + sum;
      m_s[tid] = m_new;
      sc_s[tid] = sc;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int d = tid + q * THREADS;
      if (d >= D) continue;
      float rv[TR];
#pragma unroll
      for (int rr = 0; rr < TR; ++rr) rv[rr] = rs[rr * D + d];
#pragma unroll
      for (int bi = 0; bi < BB; ++bi) {
        float a = acc[bi][q] * sc_s[bi];
#pragma unroll
        for (int rr = 0; rr < TR; ++rr) a = fmaf(ps[bi][rr], rv[rr], a);
        acc[bi][q] = a;
      }
    }
  }

  __syncthreads();
  for (int bi = 0; bi < BB; ++bi) {
    const int b = b0 + bi;
    if (b >= B) break;
    const size_t slot = (size_t)chunk * B + b;
    if (tid == 0) {
      m_part[slot] = m_s[bi];
      l_part[slot] = l_s[bi];
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int d = tid + q * THREADS;
      if (d < D) acc_part[slot * D + d] = acc[bi][q];
    }
  }
}

template <int NQ>
__global__ void __launch_bounds__(THREADS)
mem_proj_combine_kernel(const float* __restrict__ m_part,
                        const float* __restrict__ l_part,
                        const float* __restrict__ acc_part, float* __restrict__ out,
                        int B, int D, int nchunks, int normalize) {
  __shared__ float red[THREADS / 32];
  __shared__ float total;
  const int b = blockIdx.x, tid = threadIdx.x;
  float mx = -1e30f;
  for (int c = 0; c < nchunks; ++c) mx = fmaxf(mx, m_part[(size_t)c * B + b]);
  float denom = 0.f;
  float acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const size_t slot = (size_t)c * B + b;
    const float sc = expf(m_part[slot] - mx);
    denom += l_part[slot] * sc;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int d = tid + q * THREADS;
      if (d < D) acc[q] += acc_part[slot * D + d] * sc;
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    acc[q] /= denom;
    if (tid + q * THREADS < D) ss += acc[q] * acc[q];
  }
  if (normalize) {
    ss = pt::warp_sum(ss);
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) t += red[w];
      total = rsqrtf(t);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int d = tid + q * THREADS;
    if (d < D) out[(size_t)b * D + d] = normalize ? acc[q] * total : acc[q];
  }
}

template <typename T, int NQ>
int launch(const void* f, const void* rows, const void* scale, const void* inv,
           void* m_part, void* l_part, void* acc_part, void* out, int B, int D,
           int num_real, int chunk_rows, float inv_temp, int normalize,
           cudaStream_t stream) {
  const int nchunks = (num_real + chunk_rows - 1) / chunk_rows;
  const size_t smem = (size_t)(BB + TR) * D * sizeof(float);
  cudaError_t err = pt_allow_smem(mem_proj_partial_kernel<T, NQ>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nchunks, (B + BB - 1) / BB);
  mem_proj_partial_kernel<T, NQ><<<grid, THREADS, smem, stream>>>(
      (const float*)f, (const T*)rows, (const float*)scale, (const float*)inv,
      (float*)m_part, (float*)l_part, (float*)acc_part, B, D, num_real, chunk_rows,
      inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mem_proj_combine_kernel<NQ><<<B, THREADS, 0, stream>>>(
      (const float*)m_part, (const float*)l_part, (const float*)acc_part,
      (float*)out, B, D, nchunks, normalize);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* f, const void* rows, const void* scale, const void* inv,
             void* m_part, void* l_part, void* acc_part, void* out, int B, int D,
             int num_real, int chunk_rows, float inv_temp, int normalize,
             cudaStream_t s) {
  if (D <= 768)
    return launch<T, 3>(f, rows, scale, inv, m_part, l_part, acc_part, out, B, D,
                        num_real, chunk_rows, inv_temp, normalize, s);
  return launch<T, MAX_D / THREADS>(f, rows, scale, inv, m_part, l_part, acc_part,
                                    out, B, D, num_real, chunk_rows, inv_temp,
                                    normalize, s);
}

}  // namespace

// Requires D <= 1536 (the wrapper checks). dtype: 0 f32, 1 bf16 (D, scale
// null), 2 int8 (H, scale the per-row scales). The partial buffers hold
// ceil(num_real / chunk_rows) * B entries (times D for acc_part).
extern "C" int pt_memory_project(const void* f, const void* rows,
                                 const void* scale, const void* inv,
                                 void* m_part, void* l_part, void* acc_part,
                                 void* out, int B, int D, int num_real,
                                 int chunk_rows, float inv_temp, int normalize,
                                 int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kI8)
    return launch_d<signed char>(f, rows, scale, inv, m_part, l_part, acc_part,
                                 out, B, D, num_real, chunk_rows, inv_temp,
                                 normalize, s);
  if (dtype == pt::kBF16)
    return launch_d<__nv_bfloat16>(f, rows, nullptr, inv, m_part, l_part,
                                   acc_part, out, B, D, num_real, chunk_rows,
                                   inv_temp, normalize, s);
  return launch_d<float>(f, rows, nullptr, inv, m_part, l_part, acc_part, out,
                         B, D, num_real, chunk_rows, inv_temp, normalize, s);
}
