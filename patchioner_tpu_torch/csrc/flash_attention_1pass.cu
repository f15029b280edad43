// Kernel J: attention on (B, H, N, hd) q, k and v with a one-pass exact
// softmax: p = exp(s - m) against the exact row max m over every real key,
// no online rescale, p rounded to T before PV, and the f32 sum of the
// unrounded p dividing the PV sum once at the end.
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
// of one head (352 KB in bf16 at N = 1374) do not fit on an SM. bf16 runs
// the exact-max form of kernel B's wgmma body (attention_sm90.cuh): a first
// sweep over the K tiles finds each row's exact max, a second runs B's
// softmax and PV with that max fixed; any N. float32 runs the SIMT kernel
// below, so its sums stay exact f32: a block owns 16 queries and keeps
// their whole f32 logit rows in shared memory (16 x N x 4 B), which caps N
// (the wrapper checks). q * scale is rounded to T first, as in the
// reference.
#include "attention_sm90.cuh"

namespace {

constexpr int BQ = 16, BKEYS = 64, HD = 64, THREADS = 256, LD = HD + 1;

__host__ __device__ inline int padded_keys(int n) {
  return (n + BKEYS - 1) / BKEYS * BKEYS;
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

// (BH, N, 64) q, k, v and out, 16-byte aligned; in float32, N up to what
// the logit rows allow in shared memory (the wrapper checks).
extern "C" int pt_flash_attention_1pass(const void* q, const void* k,
                                        const void* v, void* out, int BH, int N,
                                        int num_real_k, float scale, int dtype,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kBF16) {
    const pt::RowLayout layout{(long long)N * HD, 0, HD};
    return pt::launch_attention_sm90<true>(
        (const pt::bf16_t*)q, (const pt::bf16_t*)k, (const pt::bf16_t*)v,
        (pt::bf16_t*)out, layout, layout, BH, 1, N, num_real_k, scale, s);
  }
  const size_t smem = (size_t)(BQ * LD + BKEYS * LD + BQ * padded_keys(N)) * sizeof(float);
  cudaError_t err = pt_allow_smem(flash1p_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  flash1p_f32_kernel<<<dim3((N + BQ - 1) / BQ, BH), THREADS, smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, N, num_real_k,
      scale);
  return (int)cudaGetLastError();
}
