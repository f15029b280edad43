// Attention in bf16 on Hopper's warpgroup tensor cores, for head dim 64,
// over q, k and v rows addressed by strides, in two softmax forms: the
// online one (kernels B and F on the fused qkv activation, kernel K on (B,
// H, N, hd) tensors) and the exact-max one (kernel J on (B, H, N, hd)
// tensors).
//
// Replaces the bf16 path of patchioner_tpu/ops/attention.py:
// fused_qkv_attention (body _fusedqkv_kernel, _softmax_attend), the
// attention half of fused_qkv_attention_proj (_fusedqkv_proj_kernel),
// flash_attention (body _flash_kernel) and flash_attention_1pass (body
// _flash1p_kernel, _softmax_attend).
//
// Bound on the H100: at the flagship shape QK^T and PV are 46.4 GFLOP
// against 68 MB of q, k, v and output, 0.047 ms at the bf16 tensor-core
// peak, so the products bound it; each logit also costs one exp2 on the
// SFUs, and the softmax between the two products is what keeps the tensor
// cores waiting.
//
// Design, FlashAttention-3 shaped without a producer warp:
// - a block of 256 threads owns 128 queries of one (batch, head): two
//   consumer warpgroups of 64 queries each, grid (ceil(N / 128), heads,
//   batch), two blocks an SM;
// - q * scale is rounded to bf16 (as the reference rounds it) and stored
//   once into a 128-byte-swizzled tile; 64-key tiles of K and V stream
//   through a ring of 4 stages filled by the block's own 16-byte cp.async
//   copies, 3 tiles in flight while one is consumed; rows at or past N are
//   zero-filled on load and never stored;
// - S = (q * scale) K^T: 4 wgmma.m64n64k16, both operands in shared
//   memory, K K-major; the f32 logits stay in the accumulator registers;
// - the softmax runs on those registers: a row's 64 values live in the 4
//   threads of a quad, so its max takes two shuffles; keys at or beyond
//   num_real_k get -1e30; p = exp(s - m) in f32, added unrounded to the
//   thread's part of the row sum, rounded to bf16 and packed as the A
//   fragment of the PV product; the accumulator is rescaled by
//   exp(m_prev - m_new);
// - PV: 4 wgmma.m64n64k16 with P in registers (the RS form) and V MN-major
//   in shared memory (the transpose bit), so no tile goes through shared
//   memory;
// - the output acc / l is rounded once to bf16 and written at the head's
//   columns of the output row.
// The exact-max form (ExactMax = true) keeps what defines kernel J: p =
// exp(s - m) against the exact row max m over every real key, with no
// online rescale. The TPU kernel holds a head's whole key range in VMEM;
// here K and V of one head (352 KB at N = 1374) do not fit on an SM, so the
// block sweeps the keys twice through the same ring: sweep 1 loads only K
// tiles and runs QK^T for the masked row max (no exp, no PV, no V loads);
// sweep 2 is the loop above with m fixed at that max, so the rescale factors
// are 1 and drop out. Sweep 1's QK^T (half of the products again) is the
// design's cost.
// Shared memory: 16 KB of q, 4 x 16 KB of K and V, 1 KB for the 1024-byte
// alignment of the swizzle atoms: 81 KB a block.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace pt {
namespace {  // internal linkage: each source that includes this has its own copy

using bf16_t = __nv_bfloat16;

constexpr int FA_BQ = 128, FA_BK = 64, FA_STAGES = 4, FA_THREADS = 256;
constexpr int FA_TILE = 64 * 128;  // bytes of one swizzled 64 x 64 bf16 tile
constexpr size_t FA_SMEM = 1024 + 2 * FA_TILE + FA_STAGES * 2 * FA_TILE;
constexpr float FA_LOG2E = 1.4426950408889634f;

// grid (ceil(N / 128), heads, batch); rows of q, k, v and out 16-byte aligned
template <bool ExactMax>
__global__ void __launch_bounds__(FA_THREADS, 2)
attention_sm90_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                      const bf16_t* __restrict__ v, bf16_t* __restrict__ out,
                      RowLayout in, RowLayout ol, int N, int num_real_k,
                      float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sQ = sm90::smem_addr(smem);  // 128 rows of q * scale
  const uint32_t sKV = sQ + 2 * FA_TILE;      // stage s: K tile, then V tile

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = blockIdx.x * FA_BQ;
  const long long off = blockIdx.z * in.batch + blockIdx.y * in.head;
  const bf16_t* kb = k + off;
  const bf16_t* vb = v + off;
  const int ntiles = (N + FA_BK - 1) / FA_BK;
  // step t < ntiles of the exact-max form is sweep 1 over key tile t;
  // every other step is the softmax and PV of key tile t % ntiles
  const int nsteps = ExactMax ? 2 * ntiles : ntiles;

  auto load_kv = [&](int t) {  // step t's key tile into stage t % STAGES
    if (t < nsteps) {
      const bool with_v = !ExactMax || t >= ntiles;
      const int j = t < ntiles ? t : t - ntiles;
      const uint32_t dk = sKV + (t % FA_STAGES) * 2 * FA_TILE, dv = dk + FA_TILE;
      for (int e = tid; e < 64 * 8; e += FA_THREADS) {
        const int r = e >> 3, c = e & 7, row = j * FA_BK + r;
        const long long src = (long long)(row < N ? row : 0) * in.row + c * 8;
        sm90::cp_async16(dk + sm90::swizzle128(r, c), kb + src, row < N);
        if (with_v) sm90::cp_async16(dv + sm90::swizzle128(r, c), vb + src, row < N);
      }
    }
    sm90::cp_async_commit();  // one group per step, empty past the last
  };
#pragma unroll
  for (int t = 0; t < FA_STAGES - 1; ++t) load_kv(t);

  const float scale_t = round_t<bf16_t>(scale);
  for (int e = tid; e < FA_BQ * 8; e += FA_THREADS) {
    const int r = e >> 3, c = e & 7, row = q0 + r;
    uint4 raw4 = make_uint4(0u, 0u, 0u, 0u);
    if (row < N) raw4 = __ldg((const uint4*)(q + off + row * in.row + c * 8));
    bf16_t* vals = (bf16_t*)&raw4;
#pragma unroll
    for (int t = 0; t < 8; ++t) vals[t] = from_f<bf16_t>(to_f(vals[t]) * scale_t);
    *(uint4*)(smem + sm90::swizzle128(r, c)) = raw4;
  }

  const uint64_t dq = sm90::desc128(sQ + wg * FA_TILE, 16, 1024);
  float o[32], m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const int kcol = (lane & 3) * 2;

  for (int t = 0; t < nsteps; ++t) {
    sm90::cp_async_wait<FA_STAGES - 2>();  // step t's tile has landed
    sm90::fence_proxy_async();
    __syncthreads();  // every thread's copies of step t, and step t - 1's stage is free
    load_kv(t + FA_STAGES - 1);
    const bool max_only = ExactMax && t < ntiles;  // sweep 1
    const int j = t < ntiles ? t : t - ntiles;
    const uint32_t dk = sKV + (t % FA_STAGES) * 2 * FA_TILE, dv = dk + FA_TILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    sm90::wgmma_fence();
    const uint64_t dkd = sm90::desc128(dk, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // k16 steps over the head dim: +32 bytes
      sm90::wgmma_m64n64k16_ss<0>(s, dq + 2 * kk, dkd + 2 * kk, 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);

    // rows r0 (s[4c], s[4c+1]) and r0 + 8 (s[4c+2], s[4c+3]), keys
    // j * 64 + 8c + kcol + {0, 1}
    float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (j * FA_BK + 8 * c + kcol + e >= num_real_k) {
          s[4 * c + e] = -1e30f;
          s[4 * c + 2 + e] = -1e30f;
        }
        mx0 = fmaxf(mx0, s[4 * c + e]);
        mx1 = fmaxf(mx1, s[4 * c + 2 + e]);
      }
    }
    // the online form's new max and rescale factors; the exact form's are
    // its sweep-1 max and 1
    float a0 = 1.f, a1 = 1.f;
    if (!ExactMax || max_only) {
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      if (!ExactMax) {
        a0 = exp2f((m0 - n0) * FA_LOG2E);
        a1 = exp2f((m1 - n1) * FA_LOG2E);
      }
      m0 = n0;
      m1 = n1;
      if (max_only) continue;
    }
    const float ms0 = m0 * FA_LOG2E, ms1 = m1 * FA_LOG2E;
    uint32_t p[16];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float x0 = exp2f(fmaf(s[4 * c], FA_LOG2E, -ms0));
      const float x1 = exp2f(fmaf(s[4 * c + 1], FA_LOG2E, -ms0));
      const float y0 = exp2f(fmaf(s[4 * c + 2], FA_LOG2E, -ms1));
      const float y1 = exp2f(fmaf(s[4 * c + 3], FA_LOG2E, -ms1));
      ps0 += x0 + x1;
      ps1 += y0 + y1;
      p[2 * c] = sm90::pack_bf16(x0, x1);
      p[2 * c + 1] = sm90::pack_bf16(y0, y1);
    }
    l0 = l0 * a0 + ps0;  // a0 = a1 = 1 in the exact form
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      o[4 * c] *= a0;
      o[4 * c + 1] *= a0;
      o[4 * c + 2] *= a1;
      o[4 * c + 3] *= a1;
    }

    // PV: the A fragment of k16 step kk is p[4kk .. 4kk + 3] (keys 16kk +
    // kcol (rows r0, r0 + 8), then 16kk + 8 + kcol); V's 16 rows of the
    // step start 2048 bytes further. V has one 64-column chunk, so its
    // descriptor's LBO is never used.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      sm90::wgmma_m64n64k16_rs<1>(o, a, sm90::desc128(dv + kk * 2048, 1024, 1024), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(o);
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  bf16_t* ob = out + blockIdx.z * ol.batch + blockIdx.y * ol.head + kcol;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (r0 < N)
      *(uint32_t*)(ob + r0 * ol.row + 8 * c) = sm90::pack_bf16(o[4 * c] / l0, o[4 * c + 1] / l0);
    if (r0 + 8 < N)
      *(uint32_t*)(ob + (r0 + 8) * ol.row + 8 * c) =
          sm90::pack_bf16(o[4 * c + 2] / l1, o[4 * c + 3] / l1);
  }
}

template <bool ExactMax>
int launch_attention_sm90(const bf16_t* q, const bf16_t* k, const bf16_t* v,
                          bf16_t* out, RowLayout in, RowLayout ol, int batch,
                          int heads, int N, int num_real_k, float scale,
                          cudaStream_t s) {
  cudaError_t err = pt_allow_smem(attention_sm90_kernel<ExactMax>, FA_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + FA_BQ - 1) / FA_BQ, heads, batch);
  attention_sm90_kernel<ExactMax><<<grid, FA_THREADS, FA_SMEM, s>>>(
      q, k, v, out, in, ol, N, num_real_k, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace pt
