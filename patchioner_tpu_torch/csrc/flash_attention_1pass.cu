// Kernel J: attention on (B, H, N, hd) q, k and v with a one-pass exact
// softmax: the exact row max and sum over every key, no online rescale.
//
// Replaces patchioner_tpu/ops/attention.py:flash_attention_1pass (body
// _flash1p_kernel / _softmax_attend), reached by attn_impl: flash1p.
//
// Bound on the H100: at the flagship shape (B*H = 96, N = 1374, hd = 64)
// QK^T and PV are 46 GFLOP against 68 MB of q, k, v and output, so it is
// bound by arithmetic (0.047 ms at the bf16 tensor-core peak); the 181 M
// exp also cost the SFUs a time of that order.
//
// Design: the TPU kernel holds a head's whole key range in VMEM; K and V
// of one head (352 KB in bf16 at N = 1374) do not fit on an SM. What
// carries over is the one-pass exact softmax: a block owns 16 queries of
// one (batch, head) and keeps their whole f32 logit rows in shared memory
// (16 x 1408 x 4 B = 88 KB at the flagship). Pass 1 writes q.k into the
// rows, one 64-key tile of K at a time. Each warp then takes whole rows:
// the exact max over the keys below num_real_k (the rest count as -1e30),
// p = exp(s - max) summed in f32, and p rounded to T. Pass 2 sums p V over
// 64-key tiles of V in f32, which is divided by the row sum once at the
// end. q * scale is rounded to T first, as in the reference.
//
// bf16 runs both products on the tensor cores (WMMA 16x16x16, f32
// accumulators): each of the eight warps stages its own key tiles (tiles
// w, w + 8, ...) in shared memory with 16-byte copies, so the passes need
// no block-wide barrier; p is written as bf16 over the front half of its
// own logit row, and the warps' partial PV sums meet in shared memory at
// the end. float32 runs the same passes on the SIMT pipes, so its sums
// stay exact f32, with block-wide K and V tiles.
#include "attention_wmma.cuh"

namespace {

constexpr int BQ = 16, BKEYS = 64, HD = 64, THREADS = 256, LD = HD + 1;

__host__ __device__ inline int padded_keys(int n) {
  return (n + BKEYS - 1) / BKEYS * BKEYS;
}

using bf16 = __nv_bfloat16;
constexpr int WARPS = THREADS / 32;
constexpr size_t WARP_TILE = 64 * pt::WA_LDB * sizeof(bf16);  // per-warp K / V tile

__global__ void __launch_bounds__(THREADS)
flash1p_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int N,
                    int num_real_k, float scale) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int NP = padded_keys(N);
  float* S = (float*)smem_raw;                          // [BQ][NP] logits
  unsigned char* tiles = smem_raw + (size_t)BQ * NP * sizeof(float);
  bf16* Qs = (bf16*)(tiles + WARPS * WARP_TILE);        // [BQ][LDB]
  __shared__ float l_s[BQ];

  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * N * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Tw = (bf16*)(tiles + warp * WARP_TILE);         // this warp's tile
  const float scale_t = pt::round_t<bf16>(scale);

  for (int e = tid; e < BQ * HD / 8; e += THREADS) {
    const int r = e / (HD / 8), d = (e % (HD / 8)) * 8, qi = q0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (qi < N) raw = *(const uint4*)(q + base + (size_t)qi * HD + d);
    bf16* vals = (bf16*)&raw;
#pragma unroll
    for (int t = 0; t < 8; ++t) vals[t] = pt::from_f<bf16>(pt::to_f(vals[t]) * scale_t);
    *(uint4*)(Qs + r * pt::WA_LDB + d) = raw;
  }
  __syncthreads();

  // pass 1: S[:, key tile] = Q K^T, warp w on tiles w, w + 8, ...
  for (int k0 = warp * BKEYS; k0 < N; k0 += WARPS * BKEYS) {
    pt::wa_load_tile(Tw, k + base, HD, k0, N, lane, 32);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + kk, pt::WA_LDB);
        wmma::load_matrix_sync(b, Tw + j * 16 * pt::WA_LDB + kk, pt::WA_LDB);
        wmma::mma_sync(sf, a, b, sf);
      }
      wmma::store_matrix_sync(S + k0 + j * 16, sf, NP, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();

  // exact softmax numerators, one warp per row; p (bf16) overwrites the
  // front half of its own row: chunk c's p lands on logits before c
  for (int r = warp; r < BQ; r += WARPS) {
    float* row = S + r * NP;
    bf16* prow = (bf16*)row;
    float mx = -1e30f;
    for (int c = lane; c < NP; c += 32)
      if (c < num_real_k) mx = fmaxf(mx, row[c]);
    mx = pt::warp_max(mx);
    float sum = 0.f;
    for (int c0 = 0; c0 < NP; c0 += 32) {
      const int c = c0 + lane;
      const float p = expf((c < num_real_k ? row[c] : -1e30f) - mx);
      __syncwarp();
      sum += p;
      prow[c] = pt::from_f<bf16>(p);
    }
    sum = pt::warp_sum(sum);
    if (lane == 0) l_s[r] = sum;
  }
  __syncthreads();

  // pass 2: each warp's partial P V over its tiles of V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(of[j], 0.f);
  const bf16* P = (const bf16*)S;  // row stride 2 * NP
  for (int k0 = warp * BKEYS; k0 < N; k0 += WARPS * BKEYS) {
    pt::wa_load_tile(Tw, v + base, HD, k0, N, lane, 32);
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKEYS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, P + k0 + kk, 2 * NP);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Tw + kk * pt::WA_LDB + j * 16, pt::WA_LDB);
        wmma::mma_sync(of[j], a, b, of[j]);
      }
    }
    __syncwarp();
  }
  float* Rw = (float*)Tw;  // [16][WA_LDS] this warp's partial sums
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Rw + j * 16, of[j], pt::WA_LDS, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD, qi = q0 + r;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      acc += ((const float*)(tiles + w * WARP_TILE))[r * pt::WA_LDS + d];
    if (qi < N) out[base + (size_t)qi * HD + d] = pt::from_f<bf16>(acc / l_s[r]);
  }
}

// float32 on the SIMT pipes: thread (ty, tx) owns rows ty*4 .. ty*4+3 of
// key tx in pass 1 and of output column tx in pass 2
__global__ void __launch_bounds__(THREADS)
flash1p_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out, int N,
                   int num_real_k, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int NP = padded_keys(N);
  float* Qs = (float*)smem_raw;  // [BQ][LD]
  float* KVs = Qs + BQ * LD;     // [BKEYS][LD] a K tile, then a V tile
  float* S = KVs + BKEYS * LD;   // [BQ][NP] logits, then p
  __shared__ float l_s[BQ];

  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * N * HD;
  const int tid = threadIdx.x, tx = tid % 64, ty = tid / 64;
  const int warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD, qi = q0 + r;
    Qs[r * LD + d] = qi < N ? q[base + (size_t)qi * HD + d] * scale : 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BKEYS) {
    __syncthreads();
    for (int e = tid; e < BKEYS * HD; e += THREADS) {
      const int r = e / HD, d = e % HD, key = k0 + r;
      KVs[r * LD + d] = key < N ? k[base + (size_t)key * HD + d] : 0.f;
    }
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kv = KVs[tx * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = fmaf(Qs[(ty * 4 + i) * LD + d], kv, s[i]);
    }
    const int key = k0 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) S[(ty * 4 + i) * NP + key] = key < num_real_k ? s[i] : -1e30f;
  }
  __syncthreads();

  for (int r = warp; r < BQ; r += THREADS / 32) {  // one warp per row
    float* row = S + r * NP;
    float mx = -1e30f;
    for (int c = lane; c < NP; c += 32) mx = fmaxf(mx, row[c]);
    mx = pt::warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < NP; c += 32) {
      const float p = expf(row[c] - mx);
      sum += p;
      row[c] = p;
    }
    sum = pt::warp_sum(sum);
    if (lane == 0) l_s[r] = sum;
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < N; k0 += BKEYS) {
    __syncthreads();
    for (int e = tid; e < BKEYS * HD; e += THREADS) {
      const int r = e / HD, d = e % HD, key = k0 + r;
      KVs[r * LD + d] = key < N ? v[base + (size_t)key * HD + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BKEYS; ++kk) {
      const float vv = KVs[kk * LD + tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(S[(ty * 4 + i) * NP + k0 + kk], vv, acc[i]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
    if (qi < N) out[base + (size_t)qi * HD + tx] = acc[i] / l_s[r];
  }
}

}  // namespace

// (BH, N, 64) q, k, v and out, 16-byte aligned; N up to what the logit
// rows allow in shared memory (the wrapper checks).
extern "C" int pt_flash_attention_1pass(const void* q, const void* k,
                                        const void* v, void* out, int BH, int N,
                                        int num_real_k, float scale, int dtype,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kBF16) {
    const size_t smem = (size_t)BQ * padded_keys(N) * sizeof(float) +
                        WARPS * WARP_TILE + BQ * pt::WA_LDB * sizeof(bf16);
    cudaError_t err = pt_allow_smem(flash1p_bf16_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + BQ - 1) / BQ, BH);
    flash1p_bf16_kernel<<<grid, THREADS, smem, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, N, num_real_k,
        scale);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)(BQ * LD + BKEYS * LD + BQ * padded_keys(N)) * sizeof(float);
  cudaError_t err = pt_allow_smem(flash1p_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  flash1p_f32_kernel<<<dim3((N + BQ - 1) / BQ, BH), THREADS, smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, N, num_real_k,
      scale);
  return (int)cudaGetLastError();
}
