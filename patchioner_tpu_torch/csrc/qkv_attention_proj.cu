// Kernel F: out = x + ls * (attention(qkv) @ W_proj + b), the whole
// attention half of an encoder block after the qkv projection, with the
// merged (B, N, D) attention output never written to device memory.
//
// Replaces patchioner_tpu/ops/attention.py:fused_qkv_attention_proj (body
// _fusedqkv_proj_kernel), reached by attn_impl: fusedqkv_proj.
//
// Bound on the H100: at the flagship shape (B = 8, N = 1374, 12 heads of
// 64, D = 768) attention is 46 GFLOP and the out-projection 13 GFLOP
// against 86 MB of qkv, x, W and output, so it is bound by arithmetic.
//
// The reference's numerics, kept by both designs: each head's attention
// output is rounded to T (pair.astype before its product), its product
// with the head's 64 rows of W_proj is summed in f32 across all heads, and
// the epilogue adds bias, scales by ls and adds the residual in f32, with
// one rounding to T (_finish). The reference's head pairs fill its 128-wide
// matrix unit and change only the f32 summation order.
//
// Design (bf16): one block of eight warps owns 64 queries of one batch row
// and walks the heads in pairs, as the reference does: warps 0-3 take the
// pair's first head and warps 4-7 its second, each group with its own q,
// K and V tiles, and each warp runs the tensor-core online-softmax step of
// attention_wmma.cuh for 16 queries over 64-key tiles. A head's rounded
// (64, 64) output lands in its columns of a (64, D) bf16 tile in shared
// memory (97 KB at D = 768). Then the out-projection runs on WMMA over
// that tile, 128 output columns at a time, with W_proj streamed in 64-row
// slices and the K = D sum kept in f32 accumulator fragments, and the f32
// epilogue writes the residual stream once. Needs an even head count.
//
// Design (float32, SIMT, so its sums stay exact f32): one block owns 32
// queries and loops over the heads one at a time with kernel B's online
// softmax, then multiplies the head's output by its rows of W_proj,
// streamed 16 rows at a time, into a (32, D) f32 accumulator held in
// registers (4 rows x D/32 columns a thread).
#include "attention_wmma.cuh"

namespace {

constexpr int BQ = 32, BKEYS = 64, HD = 64, THREADS = 256, LD = HD + 1;
constexpr int WR = 16;        // W_proj rows per shared-memory chunk
constexpr int MAX_COLS = 24;  // D / 32 <= 24: D <= 768

__global__ void __launch_bounds__(THREADS)
qkv_attention_proj_f32_kernel(const float* __restrict__ qkv,
                              const float* __restrict__ xres,
                              const float* __restrict__ w,
                              const float* __restrict__ bias,
                              const float* __restrict__ ls, float* __restrict__ out,
                              int N, int H, int num_real_k, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int D = H * HD, row_stride = 3 * D;
  float* Qs = (float*)smem_raw;  // [BQ][LD] q; after a head's keys, its output
  float* Ks = Qs + BQ * LD;      // [BKEYS][LD]
  float* Vs = Ks + BKEYS * LD;   // [BKEYS][LD]
  float* Ps = Vs + BKEYS * LD;   // [BQ][LD] probabilities
  float* Ws = Ps + BQ * LD;      // [WR][D] rows of W_proj

  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const float* base = qkv + (size_t)b * N * row_stride;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;                     // attention
  const int lane = tid & 31, rg = tid >> 5, ncols = D / 32;  // out-projection

  float pacc[4][MAX_COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) pacc[i][j] = 0.f;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head's output in Qs has been read
    for (int e = tid; e < BQ * HD; e += THREADS) {
      const int r = e / HD, d = e % HD, qi = q0 + r;
      Qs[r * LD + d] = qi < N ? base[(size_t)qi * row_stride + h * HD + d] * scale : 0.f;
    }

    float m[2], l[2], acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = -1e30f;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < N; k0 += BKEYS) {
      __syncthreads();
      for (int e = tid; e < BKEYS * HD; e += THREADS) {
        const int r = e / HD, d = e % HD, key = k0 + r;
        float kv = 0.f, vv = 0.f;
        if (key < N) {
          const float* row = base + (size_t)key * row_stride + h * HD + d;
          kv = row[D];
          vv = row[2 * D];
        }
        Ks[r * LD + d] = kv;
        Vs[r * LD + d] = vv;
      }
      __syncthreads();

      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float qa[2], ka[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) qa[i] = Qs[(ty * 2 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -1e30f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          if (key >= N || key >= num_real_k) s[i][j] = -1e30f;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float rescale = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_new);
          sum += p;
          Ps[(ty * 2 + i) * LD + tx + 16 * j] = p;
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l[i] = l[i] * rescale + sum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= rescale;
      }
      __syncthreads();

#pragma unroll 8
      for (int kk = 0; kk < BKEYS; ++kk) {
        float pa[2], va[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) pa[i] = Ps[(ty * 2 + i) * LD + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) va[j] = Vs[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
      }
    }

    __syncthreads();  // every thread is done with this head's q
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Qs[(ty * 2 + i) * LD + tx + 16 * j] = acc[i][j] / l[i];

    // out-projection of this head: pacc += O_h (32 x 64) @ W[h*64 .. h*64+63, :]
    for (int w0 = 0; w0 < HD; w0 += WR) {
      __syncthreads();  // Qs written; the previous chunk of Ws has been read
      for (int e = tid; e < WR * D; e += THREADS)
        Ws[e] = w[(size_t)(h * HD + w0 + e / D) * D + e % D];
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < WR; ++k) {
        float ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ov[i] = Qs[(rg * 4 + i) * LD + w0 + k];
#pragma unroll
        for (int j = 0; j < MAX_COLS; ++j) {
          if (j < ncols) {
            const float wv = Ws[k * D + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) pacc[i][j] = fmaf(ov[i], wv, pacc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= N) continue;
    const size_t row = ((size_t)b * N + qi) * D;
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) {
      if (j >= ncols) continue;
      const int n = lane + 32 * j;
      out[row + n] = xres[row + n] + (pacc[i][j] + bias[n]) * ls[n];
    }
  }
}

using bf16 = __nv_bfloat16;

constexpr int FB_BQ = 64, FB_WARPS = 8, FB_THREADS = 32 * FB_WARPS;
constexpr int FB_BN = 128, FB_LDW = FB_BN + 8, FB_LDC = FB_BN + 4;
// shared memory: two groups' q, K, V tiles (later the W slices), each
// warp's p and f32 scratch (later the f32 output tile), the head outputs
constexpr size_t FB_TILES = 2 * 3 * 64 * pt::WA_LDB * sizeof(bf16);
constexpr size_t FB_SCRATCH = FB_WARPS * (pt::WA_WARP_BF16 * sizeof(bf16) +
                                          pt::WA_WARP_F32 * sizeof(float));

__global__ void __launch_bounds__(FB_THREADS)
qkv_attention_proj_bf16_kernel(const bf16* __restrict__ qkv,
                               const bf16* __restrict__ xres,
                               const bf16* __restrict__ w,
                               const bf16* __restrict__ bias,
                               const bf16* __restrict__ ls, bf16* __restrict__ out,
                               int N, int H, int num_real_k, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int D = H * HD, DO = D + 8;
  const long long row_stride = 3LL * D;
  bf16* tiles = (bf16*)smem_raw;
  bf16* Ps = (bf16*)(smem_raw + FB_TILES);
  float* Ss = (float*)(Ps + FB_WARPS * pt::WA_WARP_BF16);
  bf16* Os = (bf16*)(smem_raw + FB_TILES + FB_SCRATCH);  // [BQ][DO]

  const int q0 = blockIdx.x * FB_BQ, b = blockIdx.y;
  const bf16* base = qkv + (size_t)b * N * row_stride;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = warp >> 2, gw = warp & 3, gtid = tid & 127;
  bf16* Qs = tiles + group * 3 * 64 * pt::WA_LDB;
  bf16* Ks = Qs + 64 * pt::WA_LDB;
  bf16* Vs = Ks + 64 * pt::WA_LDB;
  const float scale_t = pt::round_t<bf16>(scale);

  for (int h0 = 0; h0 < H; h0 += 2) {
    const int h = h0 + group;
    __syncthreads();  // the previous pair is done with the tiles
    pt::wa_load_tile(Qs, base + h * HD, row_stride, q0, N, gtid, 128, scale_t);
    pt::WarpAttention st;
    pt::wa_init(st);
    for (int k0 = 0; k0 < N; k0 += pt::WA_BKEYS) {
      __syncthreads();
      pt::wa_load_tile(Ks, base + D + h * HD, row_stride, k0, N, gtid, 128);
      pt::wa_load_tile(Vs, base + 2 * D + h * HD, row_stride, k0, N, gtid, 128);
      __syncthreads();
      pt::wa_tile(st, Qs + gw * 16 * pt::WA_LDB, Ks, Vs, Ps + warp * pt::WA_WARP_BF16,
                  Ss + warp * pt::WA_WARP_F32, k0, num_real_k);
    }
    bf16* o = Os + (gw * 16 + (lane >> 1)) * DO + h * HD + (lane & 1) * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) o[c] = pt::from_f<bf16>(st.acc[c] / st.l);
  }

  // out-projection: warp (wr, wc) owns rows wr*16 .. +15 and columns
  // wc*64 .. +63 of each 128-wide output tile
  namespace wmma = nvcuda::wmma;
  bf16* Ws = tiles;  // [64][LDW] slice of W_proj
  float* Cs = Ss;    // [BQ][LDC] f32 sums of an output tile
  const int wr = warp & 3, wc = warp >> 2;
  for (int n0 = 0; n0 < D; n0 += FB_BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k0 = 0; k0 < D; k0 += 64) {
      __syncthreads();  // Os is complete; the previous slice has been read
      for (int e = tid; e < 64 * FB_BN / 8; e += FB_THREADS) {
        const int k = e / (FB_BN / 8), n = (e % (FB_BN / 8)) * 8;
        *(uint4*)(Ws + k * FB_LDW + n) = *(const uint4*)(w + (size_t)(k0 + k) * D + n0 + n);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Os + wr * 16 * DO + k0 + kk, DO);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
          wmma::load_matrix_sync(bw, Ws + kk * FB_LDW + wc * 64 + j * 16, FB_LDW);
          wmma::mma_sync(acc[j], a, bw, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + wr * 16 * FB_LDC + wc * 64 + j * 16, acc[j], FB_LDC,
                              wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < FB_BQ * FB_BN; e += FB_THREADS) {
      const int i = e / FB_BN, n = e % FB_BN, qi = q0 + i;
      if (qi >= N) continue;
      const size_t o = ((size_t)b * N + qi) * D + n0 + n;
      const float a = (Cs[i * FB_LDC + n] + pt::to_f(bias[n0 + n])) * pt::to_f(ls[n0 + n]);
      out[o] = pt::from_f<bf16>(pt::to_f(xres[o]) + a);
    }
  }
}

}  // namespace

// Requires head_dim == 64, D = 64 * H up to 768 and, in bf16, an even H
// (the wrapper checks).
extern "C" int pt_qkv_attention_proj(const void* qkv, const void* x,
                                     const void* w, const void* b,
                                     const void* ls, void* out, int B, int N,
                                     int H, int num_real_k, float scale,
                                     int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == pt::kBF16) {
    const size_t smem = FB_TILES + FB_SCRATCH + (size_t)FB_BQ * (H * HD + 8) * sizeof(bf16);
    cudaError_t err = pt_allow_smem(qkv_attention_proj_bf16_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + FB_BQ - 1) / FB_BQ, B);
    qkv_attention_proj_bf16_kernel<<<grid, FB_THREADS, smem, s>>>(
        (const bf16*)qkv, (const bf16*)x, (const bf16*)w, (const bf16*)b,
        (const bf16*)ls, (bf16*)out, N, H, num_real_k, scale);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)(2 * BQ * LD + 2 * BKEYS * LD + WR * H * HD) * sizeof(float);
  cudaError_t err = pt_allow_smem(qkv_attention_proj_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  qkv_attention_proj_f32_kernel<<<dim3((N + BQ - 1) / BQ, B), THREADS, smem, s>>>(
      (const float*)qkv, (const float*)x, (const float*)w, (const float*)b,
      (const float*)ls, (float*)out, N, H, num_real_k, scale);
  return (int)cudaGetLastError();
}
