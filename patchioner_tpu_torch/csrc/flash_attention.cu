// Kernel K: attention on (B, H, N, hd) q, k and v with an online softmax
// over key tiles (running max, sum and accumulator, rescaled as the max
// moves, one division by the sum at the end).
//
// Replaces patchioner_tpu/ops/attention.py:flash_attention (body
// _flash_kernel), reached by attn_impl: flash.
//
// Bound on the H100: at the flagship shape (B*H = 96, N = 1374, hd = 64)
// QK^T and PV are 46 GFLOP against 68 MB of q, k, v and output, so it is
// bound by arithmetic (0.047 ms at the bf16 tensor-core peak); the 181 M
// exp also cost the SFUs a time of that order.
//
// Design: bf16 runs kernel B's wgmma body (attention_sm90.cuh: m64n64k16
// QK^T and PV with P in registers, the softmax on the accumulators, p
// rounded to bf16 before PV); float32 runs the SIMT kernel of
// attention_simt.cuh, so its sums stay exact f32. Both read a (batch *
// head)'s rows at stride 64.
#include "attention_simt.cuh"
#include "attention_sm90.cuh"

// (BH, N, 64) q, k, v and out, 16-byte aligned (the wrapper checks).
extern "C" int pt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int BH, int N, int num_real_k,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const pt::RowLayout layout{(long long)N * 64, 0, 64};
  if (dtype == pt::kBF16)
    return pt::launch_attention_sm90<false>(
        (const pt::bf16_t*)q, (const pt::bf16_t*)k, (const pt::bf16_t*)v,
        (pt::bf16_t*)out, layout, layout, BH, 1, N, num_real_k, scale, s);
  return pt::launch_attention_simt(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, layout,
      layout, BH, 1, N, num_real_k, scale, s);
}
