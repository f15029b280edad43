// Kernel B: bidirectional multi-head attention read straight from the
// fused (B, N, 3D) qkv activation, written in merged (B, N, D) layout.
//
// Replaces patchioner_tpu/ops/attention.py:fused_qkv_attention.
//
// Bound on the H100: at the flagship shape (B = 8, N = 1374, 12 heads of
// 64) QK^T and PV are 46 GFLOP per layer against ~68 MB of qkv and output,
// so the kernel is bound by arithmetic, and the plain version's cost is the
// (B, H, N, N) f32 logits tensor (725 MB) it writes and reads. The kernel
// never materialises the logits.
//
// Design: the TPU kernel keeps a head's whole key range resident; K plus V
// for one head at N = 1374 is 352 KB in bf16, over an SM's shared memory.
// So it runs the streamed online softmax that kernel K runs: in bf16 the
// wgmma kernel of attention_sm90.cuh (128 queries a block, m64n64k16 QK^T
// and PV, a 4-stage cp.async ring of 64-key tiles, 81 KB of shared memory;
// its note gives the design), in float32 the SIMT kernel of
// attention_simt.cuh, with q, k and v of head h read at columns h*hd,
// D + h*hd and 2D + h*hd of a token's row (row stride 3D) and the output
// written at column h*hd of the merged row.
#include "attention_simt.cuh"
#include "attention_sm90.cuh"

namespace {

template <typename T, typename Launch>
int launch(Launch fn, const void* qkv, void* out, int B, int N, int H,
           int num_real_k, float scale, cudaStream_t stream) {
  const long long D = (long long)H * 64;
  const T* q = (const T*)qkv;
  const pt::RowLayout in{N * 3 * D, 64, 3 * D};
  const pt::RowLayout ol{N * D, 64, D};
  return fn(q, q + D, q + 2 * D, (T*)out, in, ol, B, H, N, num_real_k, scale, stream);
}

}  // namespace

// Requires head_dim == 64 (the wrapper checks).
extern "C" int pt_qkv_attention(const void* qkv, void* out, int B, int N,
                                int H, int num_real_k, float scale, int dtype,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kBF16)
    return launch<pt::bf16_t>(pt::launch_attention_sm90<false>, qkv, out, B, N, H,
                              num_real_k, scale, s);
  return launch<float>(pt::launch_attention_simt, qkv, out, B, N, H,
                       num_real_k, scale, s);
}
