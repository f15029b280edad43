// Kernel A: out = LN(x) @ W + b, the LN + qkv projection of every encoder
// block. Kernel E: out = r + ls * (x @ W + b), the attention
// out-projection with its layerscale and residual add folded into the
// product's epilogue.
//
// Replace patchioner_tpu/ops/mlp.py:fused_ln_dense (body _ln_dense_kernel)
// and fused_dense_residual (body _dense_res_kernel, reached by proj_fused).
//
// Bound on the H100: A's product at the flagship shape (8*1374 rows,
// D = 768, O = 2304) is 38.9 GFLOP against 71 MB of x, W and output, far
// above the card's ~295 FLOP/byte ridge, so arithmetic bounds it (0.039 ms
// at 989 TFLOP/s); at giant's (D = 1536, O = 4608) 155.6 GFLOP, 0.157 ms.
// E's (O = 768) is 13 GFLOP against 52 MB (x, r and out, 17 MB each, and
// W): about 250 FLOP/byte, just under the ridge, so bound by bytes.
//
// Rounding points, kept in both types: A's LN(x) takes the reference's
// two-pass f32 statistics and rounds to the element type T before the
// product; its f32 sum rounds to T before + b, and the sum rounds again
// (the reference's dot(...).astype(T) + b). E rounds after + b, after * ls
// and after + r, each to T.
//
// A, bf16: two launches of kernel C's pieces (gemm_sm90.cuh):
// - LN(x) of every row, rounded to bf16, into the wrapper's (M, D) scratch;
// - the wgmma GEMM over that scratch and W, 128 x 128 output tiles (a grid
//   of O / 128 x ceil(M / 128): 18 x 86 blocks on the flagship, 36 x 86 on
//   giant), whose epilogue adds b with A's two roundings and stores packed
//   bf16 pairs.
// What is given up: the TPU kernel never writes LN(x); here it makes a
// round trip through device memory, M * D * 2 bytes written and read (34 MB
// on the flagship, ~10 us at 3.35 TB/s; 68 MB on giant, ~20 us) against
// bounds of 39 and 157 us. The alternative, normalising inside the GEMM's
// A loader, would turn the asynchronous 16-byte copies of the ring into
// register round trips with a barrier before every stage; a fused LN
// prologue is a later question. The scratch cannot be `out`, as C reuses
// its output: A's output rows are 3D wide, and its GEMM reads rows of LN(x)
// while other blocks write the outputs of those same rows.
//
// E, bf16: one launch of the same GEMM template over x and W (a grid of
// O / 128 x ceil(M / 128): 6 x 86 blocks on the flagship, about two waves
// at two blocks an SM; 12 x 86 at giant's width), whose epilogue reads the
// residual r as one 4-byte bf16 pair a column pair, applies E's three
// roundings and stores one packed pair. What bounds E is bytes (x, r and
// out once, W once), and the template moves little more: the column tiles
// of a row tile are the fastest grid index, so the 6 blocks that read the
// same 128 rows of x run together and x comes from device memory about
// once (its other reads hit L2); W (1.2 MB) stays in L2 and streams
// through the 3-stage cp.async ring; r and out are touched once, 4 bytes
// a thread a column pair. What keeps E above its byte bound is the
// template's own gap: under two waves of blocks, and a full wgmma wait
// and block barrier at every stage.
//
// float32 (both): the SIMT kernel of dense_f32.cuh.
#include "dense_f32.cuh"
#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// out[m, n .. n + 1] = round(round(acc) + b), packed bf16 pairs
struct QkvEpilogue {
  const bf16* b;
  bf16* out;
  int O;
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1) const {
    const float o0 = pt::round_t<bf16>(v0) + pt::to_f(b[n]);
    const float o1 = pt::round_t<bf16>(v1) + pt::to_f(b[n + 1]);
    *(uint32_t*)(out + (size_t)m * O + n) = pt::sm90::pack_bf16(o0, o1);
  }
};

// out[m, n .. n + 1] = round(r + round(round(round(acc) + b) * ls)), the
// residual read and the output stored as packed bf16 pairs
struct DenseResidualEpilogue {
  const bf16 *b, *r, *ls;
  bf16* out;
  int O;
  __device__ __forceinline__ void operator()(int m, int n, float v0, float v1) const {
    const size_t o = (size_t)m * O + n;
    const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(r + o);
    float v[2] = {v0, v1};
    const float rf[2] = {__low2float(rv), __high2float(rv)};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float d = pt::round_t<bf16>(pt::round_t<bf16>(v[e]) + pt::to_f(b[n + e]));
      v[e] = rf[e] + pt::round_t<bf16>(d * pt::to_f(ls[n + e]));
    }
    *(uint32_t*)(out + o) = pt::sm90::pack_bf16(v[0], v[1]);
  }
};

}  // namespace

// bf16 needs D % 64 == 0 and O % 128 == 0 (the wrapper checks); `ln` is the
// (M, D) bf16 scratch of the bf16 path (unused in f32).
extern "C" int pt_ln_dense(const void* x, const void* g, const void* bg,
                           const void* w, const void* b, void* out, void* ln, int M,
                           int D, int O, float eps, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == pt::kBF16) {
    bf16* y = (bf16*)ln;
    err = pt::launch_ln_rows((const bf16*)x, (const bf16*)g, (const bf16*)bg, y, M, D,
                             eps, s);
    if (err == cudaSuccess)
      err = pt::launch_gemm(y, (const bf16*)w, M, D, pt::dense_tiles(O),
                            pt::DenseEpilogue<QkvEpilogue>{{(const bf16*)b, (bf16*)out, O}},
                            s);
    return (int)err;
  }
  err = pt::launch_dense_f32<false>((const float*)x, (const float*)g, (const float*)bg,
                                    (const float*)w, (const float*)b, nullptr, nullptr,
                                    (float*)out, M, D, O, eps, s);
  return (int)err;
}

extern "C" int pt_dense_residual(const void* x, const void* r, const void* w,
                                 const void* b, const void* ls, void* out,
                                 int M, int D, int O, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kBF16)
    return (int)pt::launch_gemm(
        (const bf16*)x, (const bf16*)w, M, D, pt::dense_tiles(O),
        pt::DenseEpilogue<DenseResidualEpilogue>{
            {(const bf16*)b, (const bf16*)r, (const bf16*)ls, (bf16*)out, O}},
        s);
  return (int)pt::launch_dense_f32<true>((const float*)x, nullptr, nullptr,
                                         (const float*)w, (const float*)b,
                                         (const float*)r, (const float*)ls, (float*)out,
                                         M, D, O, 0.f, s);
}
