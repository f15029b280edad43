// Kernels D and H: support-memory projection, one streaming pass over the
// bank.
//
// D replaces patchioner_tpu/ops/memory_projection.py:memory_project_pallas,
// H replaces memory_project_int8 (_mem_proj_call_q, _mem_proj_kernel_q);
// both are the reference's one body _mem_proj_step:
//   sim = f . (row * inv_norm) / T   (rows >= num_real excluded)
//   out = softmax(sim) @ rows, optionally L2-normalised.
// H reads int8 rows dequantized as q * scale (per-row f32 scale) and scores
// them with the ORIGINAL f32 rows' inverse norms.
//
// Bound on the H100: bandwidth. The 591,753 x 768 bank is 911 MB in bf16
// (1.82 GB at giant's D = 1536) and 0.45 GB in int8, and is read once; at
// B = 8 each bank element feeds 16 FLOPs, far below the card's ~295
// FLOP/byte ridge, so the ideal is the bank's bytes over 3.35 TB/s: 0.272
// ms for the flagship's bf16 bank, 0.543 ms for giant's.
//
// Shared by both bodies: Hopper blocks run in parallel and in no order,
// and one block per batch tile would leave almost every SM idle at B = 8,
// so the bank is split into ranges of consecutive rows, one block per
// (range, 8 batch rows). Each block streams its range with an online
// softmax in f32 and writes a partial (max, denom, acc); a second small
// kernel combines the partials (the reference's project_partial /
// combine_partials, memory_projection.py:116-153) and L2-normalises. A
// block whose range is empty writes max -1e30 and denom 0, which the
// combine weighs 0. Rows past num_real are never read, which masks them
// exactly as the reference's -1e30 does: a zero row would otherwise score
// 0, above every real negative cosine. sim / T stays f32 with max
// subtraction (T = 0.01 puts logits near +-100). The features arrive
// L2-normalised in f32.
//
// The bf16 body (D's bank in bf16, every bf16 model path): tensor cores
// for both products, fed by an asynchronous ring.
// - Numerics. The bf16 rows are the tensor-core operand of both products
//   as they are: sim^T (rows x 8) = R F^T and acc^T (D x 8) += R^T P^T,
//   both read from one shared-memory tile (ldmatrix, and ldmatrix.trans for
//   R^T). Neither f nor P may be rounded to bf16 once: the logits are
//   cosines x 100. Emulated on the CPU (f64 reference, seeded N(0, 1) bf16
//   bank, T = 0.01, normalize, relative to max|ref|, D = 768 / 200k rows
//   and D = 1536 / 100k rows): f in one bf16 4.75e-3 / 3.81e-3; P in one
//   bf16 8.88e-4 / 7.71e-4; both as hi + lo (hi = bf16(x), lo = bf16(x -
//   hi)) 8.98e-6 / 5.66e-6, ten times under the 1e-4 gate. So each product
//   is two MMAs, hi and lo, summed in f32; the denominator sums the f32 P.
//   The 4 x 7.27 GFLOP of tensor work on the flagship bank (58 GFLOP on
//   giant's) is well under 0.1 ms: the bytes set the pace.
// - Copies. A tile is 16 rows and their 16 inverse norms, brought by
//   16-byte cp.async (zero-filled past the range) into a ring of 4 stages;
//   each row is padded by 16 bytes, so the 8 rows an ldmatrix phase reads
//   fall in 8 different bank groups. Each block has 2 tiles in flight while
//   it computes: 49 KB at D = 768 with 2 blocks a SM (111,872 bytes of
//   shared memory each), 99 KB at D = 1536 with one (210,176 bytes), against
//   the ~25 KB that 3.35 TB/s x ~1 us over 132 SMs needs.
// - Work. Each of the 8 warps owns D / 8 columns: it holds f's two pieces
//   for them in registers, computes the 16 x 8 partial scores of a tile
//   over them, and accumulates acc^T for them. The partial scores go to
//   shared memory; after the next barrier every warp sums the 8 slices in
//   one order (so every warp computes the same max and weights), masks,
//   scales by inv_norm / T and runs the online softmax for the tile's 16
//   rows, four rows of one batch row a lane, then the P^T products. So
//   iteration t scores tile t and accumulates tile t - 1, and one block
//   barrier a tile orders the ring, the scores and the weights.
// - Grid. One wave: the wrapper asks pt_memory_project_blocks how many
//   blocks fit on the card at once and cuts the bank into that many ranges,
//   each a multiple of the 16-row tile.
// - Limits: D % 128 == 0 (16-column steps split over 8 warps) and D <=
//   1536; two instantiations, KMAX = 6 steps a warp up to D = 768 and 12 up
//   to 1536, so the flagship's registers do not grow with giant's width.
//
// The SIMT body (f32 and int8 banks; f32 is the checks' path): each block
// streams its range in 16-row tiles through an f32 tile in shared memory,
// warps compute the dot products and threads the online softmax; each
// thread holds NQ = D / 256 columns of the 8 accumulators (NQ = 3 up to D =
// 768, 6 up to 1536). D and H differ only in how a row is loaded
// (`bank_val`), so a masking or rescale fix reaches both.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BB = 8, TR = 16, THREADS = 256, MAX_D = 1536;

// One bank element in f32 for the SIMT body: D's f32 rows as they are, H's
// dequantized.
__device__ __forceinline__ float bank_val(const float* r, size_t i, float) { return r[i]; }
__device__ __forceinline__ float bank_val(const signed char* r, size_t i, float s) {
  return (float)r[i] * s;
}

// ----------------------------------------------------------- bf16 body

namespace tc {

constexpr int NW = THREADS / 32;  // warps, each owning D / NW columns
constexpr int STAGES = 4;
constexpr int PS = 24;  // floats between batch rows of a partial-score slice
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int row_bytes(int d) { return 2 * d + 16; }
__host__ __device__ constexpr int stage_bytes(int d) { return TR * row_bytes(d) + TR * 4; }
// [2 tiles][NW warps][BB batch rows][PS] partial scores
constexpr int PART_BYTES = 2 * NW * BB * PS * 4;
constexpr size_t smem_bytes(int d) { return (size_t)STAGES * stage_bytes(d) + PART_BYTES; }

template <int KMAX>
__global__ void __launch_bounds__(THREADS, KMAX <= 6 ? 2 : 1)
mem_proj_bf16_kernel(const float* __restrict__ f, const __nv_bfloat16* __restrict__ rows,
                     const float* __restrict__ inv, float* __restrict__ m_part,
                     float* __restrict__ l_part, float* __restrict__ acc_part, int B,
                     int D, int num_real, int chunk_rows, float inv_temp) {
  using namespace pt::sm90;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row group, column pair
  const int chunk = blockIdx.x, b0 = blockIdx.y * BB;
  const int c0 = chunk * chunk_rows;
  const int c1 = min(c0 + chunk_rows, num_real);
  const int ntiles = c1 > c0 ? (c1 - c0 + TR - 1) / TR : 0;
  const int rb = row_bytes(D), sb = stage_bytes(D);
  const int kw = D / (16 * NW);  // 16-column steps of this warp's slice
  const int col0 = warp * kw * 16;
  const uint32_t smem0 = smem_addr(smem);
  float* part = reinterpret_cast<float*>(smem + STAGES * sb);

  // tile t of the range into stage t % STAGES; one commit group per call
  auto load_tile = [&](int t) {
    if (t < ntiles) {
      const int r0 = c0 + t * TR, cpr = D >> 3;
      const uint32_t st = smem0 + (t % STAGES) * sb;
      for (int e = tid; e < TR * cpr; e += THREADS) {
        const int r = e / cpr, c = e - r * cpr;
        const bool ok = r0 + r < c1;
        cp_async16(st + r * rb + c * 16, rows + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok);
      }
      if (tid < TR / 4) {
        const int n = min(max(c1 - (r0 + 4 * tid), 0), 4);
        cp_async16_n(st + TR * rb + tid * 16, n ? inv + r0 + 4 * tid : inv, 4 * n);
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < STAGES - 2; ++t) load_tile(t);

  // f's two bf16 pieces as the B operand (column g = batch row b0 + g) of
  // this warp's column steps
  uint32_t fh[KMAX][2], fl[KMAX][2];
  const bool live = b0 + g < B;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v = make_float2(0.f, 0.f);
      if (j < kw && live)
        v = *reinterpret_cast<const float2*>(f + (size_t)(b0 + g) * D + col0 + j * 16 +
                                             h * 8 + 2 * q);
      split_bf16(v.x, v.y, fh[j][h], fl[j][h]);
    }

  // acc^T fragments: column steps i, rows d = col0 + 16 i + g (+ 8), batch
  // rows 2q, 2q + 1; m, l of batch row g (the same in the 4 lanes of g)
  float acc[KMAX][4];
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[i][h] = 0.f;
  float m_run = -1e30f, l_run = 0.f;

  // lane addresses of the A operand: R (rows x columns) for the scores,
  // R^T (columns x rows, transposed) for the accumulators
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int t_row = (lane & 7) + (lane >> 4) * 8, t_col = ((lane >> 3) & 1) * 8;

  for (int it = 0; it <= ntiles; ++it) {
    cp_async_wait<STAGES - 3>();  // tile `it` has landed
    __syncthreads();              // for every thread; tile it - 2's stage is free
    load_tile(it + STAGES - 2);

    if (it < ntiles) {  // partial scores of tile `it` over this warp's columns
      const uint32_t a0 = smem0 + (it % STAGES) * sb + a_row * rb + (col0 + a_col) * 2;
      float c[2][2][4] = {};  // [step parity][hi, lo]: four independent chains
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < kw) {
          uint32_t a[4];
          ldmatrix_x4(a, a0 + j * 32);
          mma_m16n8k16(c[j & 1][0], a, fh[j][0], fh[j][1]);
          mma_m16n8k16(c[j & 1][1], a, fl[j][0], fl[j][1]);
        }
      }
      float* pp = part + ((it & 1) * NW + warp) * BB * PS;
#pragma unroll
      for (int h = 0; h < 4; ++h)  // (row g or g + 8, batch row 2q or 2q + 1)
        pp[(2 * q + (h & 1)) * PS + g + (h >> 1) * 8] =
            (c[0][0][h] + c[0][1][h]) + (c[1][0][h] + c[1][1][h]);
    }

    if (it > 0) {  // softmax and P^T product of tile it - 1
      const int t = it - 1, r0 = c0 + t * TR;
      const unsigned char* st = smem + (t % STAGES) * sb;
      const float* invs = reinterpret_cast<const float*>(st + TR * rb);
      const float* pp = part + (t & 1) * NW * BB * PS + g * PS + 2 * q;
      // rows 2q, 2q + 1, 2q + 8, 2q + 9 of batch row g: the B operand P^T
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float2 lo = *reinterpret_cast<const float2*>(pp + w * BB * PS);
        const float2 hi = *reinterpret_cast<const float2*>(pp + w * BB * PS + 8);
        s[0] += lo.x;
        s[1] += lo.y;
        s[2] += hi.x;
        s[3] += hi.y;
      }
      float mx = -1e30f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 2 * q + (k & 1) + (k >> 1) * 8;
        s[k] = r0 + r < c1 ? s[k] * invs[r] * inv_temp : -1e30f;
        mx = fmaxf(mx, s[k]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float sc = expf(m_run - m_new);
      float p[4], sum = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        p[k] = expf(s[k] - m_new);
        sum += p[k];
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l_run = l_run * sc + sum;
      m_run = m_new;
      // the rescale of batch rows 2q and 2q + 1, held by lanes 8q and 8q + 4
      const float sc0 = __shfl_sync(FULL, sc, 8 * q), sc1 = __shfl_sync(FULL, sc, 8 * q + 4);
      uint32_t ph[2], pl[2];
      split_bf16(p[0], p[1], ph[0], pl[0]);
      split_bf16(p[2], p[3], ph[1], pl[1]);
      const uint32_t a0 = smem0 + (t % STAGES) * sb + t_row * rb + (col0 + t_col) * 2;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < kw) {
          acc[i][0] *= sc0;
          acc[i][1] *= sc1;
          acc[i][2] *= sc0;
          acc[i][3] *= sc1;
          uint32_t a[4];
          ldmatrix_x4_trans(a, a0 + i * 32);
          mma_m16n8k16(acc[i], a, ph[0], ph[1]);
          mma_m16n8k16(acc[i], a, pl[0], pl[1]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i >= kw) continue;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int b = b0 + 2 * q + (h & 1), d = col0 + i * 16 + g + (h >> 1) * 8;
      if (b < B) acc_part[((size_t)chunk * B + b) * D + d] = acc[i][h];
    }
  }
  if (warp == 0 && q == 0 && live) {
    m_part[(size_t)chunk * B + b0 + g] = m_run;
    l_part[(size_t)chunk * B + b0 + g] = l_run;
  }
}

template <int KMAX>
cudaError_t bf16_attributes(int D) {
  auto* k = mem_proj_bf16_kernel<KMAX>;
  cudaError_t err = pt_allow_smem(k, smem_bytes(D));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int KMAX>
cudaError_t bf16_blocks(int D, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = bf16_attributes<KMAX>(D);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mem_proj_bf16_kernel<KMAX>,
                                                        THREADS, smem_bytes(D));
  *blocks = per_sm * sms;
  return err;
}

template <int KMAX>
cudaError_t bf16_partial(const void* f, const void* rows, const void* inv, void* m_part,
                         void* l_part, void* acc_part, int B, int D, int num_real,
                         int chunk_rows, int nchunks, float inv_temp, cudaStream_t s) {
  cudaError_t err = bf16_attributes<KMAX>(D);
  if (err != cudaSuccess) return err;
  dim3 grid(nchunks, (B + BB - 1) / BB);
  mem_proj_bf16_kernel<KMAX><<<grid, THREADS, smem_bytes(D), s>>>(
      (const float*)f, (const __nv_bfloat16*)rows, (const float*)inv, (float*)m_part,
      (float*)l_part, (float*)acc_part, B, D, num_real, chunk_rows, inv_temp);
  return cudaGetLastError();
}

}  // namespace tc

// ----------------------------------------------------------- SIMT body

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

template <typename T, int NQ>
cudaError_t simt_partial(const void* f, const void* rows, const void* scale, const void* inv,
                         void* m_part, void* l_part, void* acc_part, int B, int D,
                         int num_real, int chunk_rows, int nchunks, float inv_temp,
                         cudaStream_t s) {
  const size_t smem = (size_t)(BB + TR) * D * sizeof(float);
  cudaError_t err = pt_allow_smem(mem_proj_partial_kernel<T, NQ>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nchunks, (B + BB - 1) / BB);
  mem_proj_partial_kernel<T, NQ><<<grid, THREADS, smem, s>>>(
      (const float*)f, (const T*)rows, (const float*)scale, (const float*)inv,
      (float*)m_part, (float*)l_part, (float*)acc_part, B, D, num_real, chunk_rows,
      inv_temp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t simt_partial_d(const void* f, const void* rows, const void* scale,
                           const void* inv, void* m_part, void* l_part, void* acc_part,
                           int B, int D, int num_real, int chunk_rows, int nchunks,
                           float inv_temp, cudaStream_t s) {
  if (D <= 768)
    return simt_partial<T, 3>(f, rows, scale, inv, m_part, l_part, acc_part, B, D,
                              num_real, chunk_rows, nchunks, inv_temp, s);
  return simt_partial<T, MAX_D / THREADS>(f, rows, scale, inv, m_part, l_part, acc_part,
                                          B, D, num_real, chunk_rows, nchunks, inv_temp, s);
}

// ----------------------------------------------------------- combine

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

}  // namespace

// Blocks of the bf16 body that fit on the card at once for width D (its
// one-wave grid), written to *blocks (an int).
extern "C" int pt_memory_project_blocks(int D, void* blocks, void* stream) {
  (void)stream;
  if (D % 128 || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (D <= 768) return (int)tc::bf16_blocks<6>(D, (int*)blocks);
  return (int)tc::bf16_blocks<12>(D, (int*)blocks);
}

// dtype: 0 f32 and 1 bf16 (D, scale null), 2 int8 (H, scale the per-row
// scales). nchunks blocks of chunk_rows rows each (the last ones may be
// empty); the partial buffers hold nchunks * B entries (times D for
// acc_part). Requires D <= 1536, and for bf16 D % 128 == 0 (the wrapper
// checks).
extern "C" int pt_memory_project(const void* f, const void* rows,
                                 const void* scale, const void* inv,
                                 void* m_part, void* l_part, void* acc_part,
                                 void* out, int B, int D, int num_real,
                                 int chunk_rows, int nchunks, float inv_temp,
                                 int normalize, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == pt::kBF16) {
    if (D % 128 || D > MAX_D) return (int)cudaErrorInvalidValue;
    err = D <= 768 ? tc::bf16_partial<6>(f, rows, inv, m_part, l_part, acc_part, B, D,
                                         num_real, chunk_rows, nchunks, inv_temp, s)
                   : tc::bf16_partial<12>(f, rows, inv, m_part, l_part, acc_part, B, D,
                                          num_real, chunk_rows, nchunks, inv_temp, s);
  } else if (dtype == pt::kI8) {
    err = simt_partial_d<signed char>(f, rows, scale, inv, m_part, l_part, acc_part, B, D,
                                      num_real, chunk_rows, nchunks, inv_temp, s);
  } else {
    err = simt_partial_d<float>(f, rows, nullptr, inv, m_part, l_part, acc_part, B, D,
                                num_real, chunk_rows, nchunks, inv_temp, s);
  }
  if (err != cudaSuccess) return (int)err;
  if (D <= 768)
    mem_proj_combine_kernel<3><<<B, THREADS, 0, s>>>(
        (const float*)m_part, (const float*)l_part, (const float*)acc_part, (float*)out, B,
        D, nchunks, normalize);
  else
    mem_proj_combine_kernel<MAX_D / THREADS><<<B, THREADS, 0, s>>>(
        (const float*)m_part, (const float*)l_part, (const float*)acc_part, (float*)out, B,
        D, nchunks, normalize);
  return (int)cudaGetLastError();
}
