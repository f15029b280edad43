// Kernel F: out = x + ls * (attention(qkv) @ W_proj + b), the whole
// attention half of an encoder block after the qkv projection.
//
// Replaces patchioner_tpu/ops/attention.py:fused_qkv_attention_proj (body
// _fusedqkv_proj_kernel), reached by attn_impl: fusedqkv_proj.
//
// Bound on the H100: at the flagship shape (B = 8, N = 1374, 12 heads of
// 64, D = 768) attention is 46 GFLOP and the out-projection 13 GFLOP
// against 86 MB of qkv, x, W and output, so it is bound by arithmetic
// (0.060 ms at 989 TFLOP/s); at giant's (24 heads, D = 1536) 93 + 52 GFLOP.
//
// The reference's numerics, kept in both types: each head's attention
// output is rounded to T (pair.astype before its product), its product
// with W_proj is summed in f32 across all heads, and the epilogue adds
// bias, scales by ls and adds the residual in f32, with one rounding to T
// (_finish). That is not kernel E's epilogue, which rounds after each step.
//
// Design: two launches on the current stream, the merged (B, N, D)
// attention output going through a scratch tensor of the wrapper:
// - bf16: kernel B's wgmma attention (attention_sm90.cuh) writes each
//   head's output, rounded to bf16, at its columns of the merged row; then
//   the wgmma GEMM of gemm_sm90.cuh over the merged rows and W_proj, 128 x
//   128 output tiles, whose epilogue is F's: x + (acc + b) * ls in f32,
//   rounded once, stored as packed bf16 pairs. Needs D % 128 == 0, so an
//   even head count at head dim 64 (the TPU kernel's own head pairs).
// - float32: kernel B's SIMT attention (attention_simt.cuh) into an f32
//   scratch, then the SIMT product of dense_f32.cuh, whose
//   r + (acc + b) * ls epilogue is F's in f32 (no rounding step does
//   anything there). Any head count.
// Why not one kernel: the out-projection of a 128-query tile needs that
// tile's whole merged row, as f32 accumulators 128 x 768 x 4 = 393 KB (more
// than an SM's 256 KB of registers), or as bf16 in shared memory 196 KB at
// D = 768 and 393 KB at D = 1536 beside B's 81 KB ring, against 227 KB a
// block. The merged tensor's round trip costs 2 x 17 MB, ~10 us on the
// flagship (2 x 34 MB on giant), against a 60 us bound. Ragged rows are
// zero-filled on load and never stored.
#include "attention_simt.cuh"
#include "attention_sm90.cuh"
#include "dense_f32.cuh"
#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// out = bf16(x + (acc + b) * ls), all in f32
struct AttnProjEpilogue {
  const bf16 *x, *b, *ls;
  bf16* out;
  int D;
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1) const {
    const size_t o = (size_t)m * D + n;
    const float o0 = pt::to_f(x[o]) + (v0 + pt::to_f(b[n])) * pt::to_f(ls[n]);
    const float o1 = pt::to_f(x[o + 1]) + (v1 + pt::to_f(b[n + 1])) * pt::to_f(ls[n + 1]);
    *(uint32_t*)(out + o) = pt::sm90::pack_bf16(o0, o1);
  }
};

}  // namespace

// Requires head_dim == 64 and, in bf16, D = 64 * H % 128 == 0 (the wrapper
// checks); `merged` is the (B, N, D) scratch in the element type.
extern "C" int pt_qkv_attention_proj(const void* qkv, const void* x,
                                     const void* w, const void* b,
                                     const void* ls, void* out, void* merged, int B,
                                     int N, int H, int num_real_k, float scale,
                                     int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int D = H * 64, M = B * N;
  const pt::RowLayout in{(long long)N * 3 * D, 64, 3LL * D};
  const pt::RowLayout ol{(long long)N * D, 64, D};
  if (dtype == pt::kBF16) {
    const bf16* q = (const bf16*)qkv;
    bf16* mb = (bf16*)merged;
    int err = pt::launch_attention_sm90<false>(q, q + D, q + 2 * D, mb, in, ol, B, H, N,
                                               num_real_k, scale, s);
    if (err == cudaSuccess)
      err = (int)pt::launch_gemm(
          mb, (const bf16*)w, M, D, pt::dense_tiles(D),
          pt::DenseEpilogue<AttnProjEpilogue>{
              {(const bf16*)x, (const bf16*)b, (const bf16*)ls, (bf16*)out, D}},
          s);
    return err;
  }
  const float* q = (const float*)qkv;
  float* mf = (float*)merged;
  int err = pt::launch_attention_simt(q, q + D, q + 2 * D, mf, in, ol, B, H, N,
                                      num_real_k, scale, s);
  if (err == cudaSuccess)
    err = (int)pt::launch_dense_f32<true>(mf, nullptr, nullptr, (const float*)w,
                                          (const float*)b, (const float*)x,
                                          (const float*)ls, (float*)out, M, D, D, 0.f, s);
  return err;
}
