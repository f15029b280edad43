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
// (1.82 GB at giant's D = 1536) and 0.46 GB in int8 (0.91 GB at 1536), and
// is read once; at B = 8 each bank element feeds 16 FLOPs, far below the
// card's ~295 FLOP/byte ridge, so the ideal is the bank's bytes over 3.35
// TB/s: 0.272 ms for the flagship's bf16 bank, 0.137 ms for its int8 one.
//
// Shared by all bodies: Hopper blocks run in parallel and in no order,
// and one block per batch tile would leave almost every SM idle at B = 8,
// so the bank is split into ranges of consecutive rows, one block per
// (range, 8 batch rows). Each block streams its range with an online
// softmax in f32 and writes a partial (max, denom, acc); the combine (the
// reference's project_partial / combine_partials, memory_projection.py:
// 116-153) merges the partials and L2-normalises. A block whose range is
// empty writes max -1e30 and denom 0, which the combine weighs 0. Rows past
// num_real are never read, which masks them exactly as the reference's
// -1e30 does: a zero row would otherwise score 0, above every real negative
// cosine. sim / T stays f32 with max subtraction (T = 0.01 puts logits near
// +-100). The features arrive L2-normalised in f32.
//
// The tensor-core body (bf16 banks for D, every int8 bank for H): tensor
// cores for both products, fed by an asynchronous ring.
// - Numerics. The rows are the tensor-core operand of both products as
//   they are: sim^T (rows x 8) = R F^T and acc^T (D x 8) += R^T P^T. Every
//   int8 value is exact in bf16 (|q| <= 128 < 2^8), so H feeds q with no
//   rounding. Neither f nor P may be rounded to bf16 once: the logits are
//   cosines x 100. Emulated on the CPU (f64 reference, seeded N(0, 1) bf16
//   bank, T = 0.01, normalize, relative to max|ref|, D = 768 / 200k rows
//   and D = 1536 / 100k rows): f in one bf16 4.75e-3 / 3.81e-3; P in one
//   bf16 8.88e-4 / 7.71e-4; both as hi + lo (hi = bf16(x), lo = bf16(x -
//   hi)) 8.98e-6 / 5.66e-6, ten times under the 1e-4 gate. So each product
//   is two MMAs, hi and lo, summed in f32; the denominator sums the f32 P.
//   H's per-row scale folds into the row's score factor, (f . q) * (inv *
//   scale / T), and into the weight before the split: acc += (p * scale)^T
//   q, while the denominator sums p. H's scores take f in three int8
//   pieces instead (below), thirty times finer than two bf16 pieces.
// - Copies. A tile is 16 rows and their 16 inverse norms (and H's 16
//   scales), brought by 16-byte cp.async (zero-filled past the range) into
//   a ring; each row is padded by 16 bytes, so the rows a warp reads at one
//   column fall in different bank groups. D's ring has 4 stages of 16 bf16
//   rows, 2 tiles in flight while it computes: 49 KB at D = 768 with 2
//   blocks a SM (112,416 bytes of shared memory each), 99 KB at D = 1536
//   with one (210,720 bytes). An int8 tile is half the bytes, so H's ring
//   has 8 stages, 6 tiles in flight: 74 KB at D = 768, still 2 blocks a SM
//   (114,208 bytes each), 150 KB at 1536 (212,512 bytes). Either is well
//   over the ~25 KB a block that 3.35 TB/s x ~1 us over 132 SMs needs.
// - Operands. D's bf16 tile is read by ldmatrix (R) and ldmatrix.trans
//   (R^T). H reads 32-bit words of its int8 stage and builds the fragments
//   in registers; nothing is converted in shared memory, where a bf16 copy
//   of each tile (24.8 KB at D = 768) would cost the second block on each
//   SM. Scores: q is the A operand of integer MMAs (m16n8k32, s8) as it
//   lies in shared memory, row-major with k contiguous, and f goes in as
//   three int8 pieces, f = (p0 + p1 / 254 + p2 / 254^2) / 127 (|f| <= 1),
//   within 6.1e-8: three exact int32 products a 32-column chunk, summed in
//   f32 (split_s8). Accumulators: R^T needs pairs of rows at one column,
//   so there two bytes become an exact bf16 pair with 2 LOP3 and one
//   bf16x2 subtraction (s8x2_bf16), and the bf16 MMAs run as in D. The
//   output column that a fragment row stands for is permuted, and the
//   store to acc_part follows the same map: the words at columns 32c + 4g
//   .. + 3 of rows 2q, 2q + 1, 2q + 8 and 2q + 9 (one PRMT per two rows)
//   give the fragments of two 16-column steps. At the row stride D + 16
//   bytes a warp's 32 words fall in 32 banks in both phases. Cost a 16-row
//   tile at D = 768, per warp: 12 loads and 9 integer MMAs for the scores
//   (bf16 pieces of f would take 84 instructions of conversion and 12 bf16
//   MMAs), 96 instructions of conversion and 12 bf16 MMAs for the
//   accumulators. The conversions, not the bytes, set H's pace: its body
//   reads at about half the rate of D's.
// - Work. Each of the 8 warps owns D / 8 columns: it holds f's pieces for
//   them in registers and computes the 16 x 8 partial scores of a tile
//   over them. The partial scores go to shared memory; after the next
//   barrier warp w alone sums the 8 slices for batch row w, masks, scales
//   and runs its online softmax over the tile's 16 rows (a row a lane) and
//   writes the weights, split into hi and lo pieces, as the B fragments of
//   the P^T product, with the row's rescale factor; a second barrier, then
//   every warp rescales its accumulators and runs the P^T products over
//   its columns. (H's warp owns the 32-column chunks warp, warp + 8, ...)
//   So iteration t scores tile t and runs the softmax and the product of
//   tile t - 1, with two block barriers a tile.
// - Grid. One wave: the wrapper asks pt_memory_project_blocks how many
//   blocks of the body fit on the card at once and cuts the bank into that
//   many ranges, each a multiple of the 16-row tile.
// - Limits: D % 128 == 0 (16-column steps split over 8 warps) and D <=
//   1536; two instantiations of each kernel, KMAX = 6 steps a warp up to
//   D = 768 and 12 up to 1536, so the flagship's registers do not grow
//   with giant's width.
//
// The SIMT body (f32 banks, the checks' path): each block streams 2048-row
// ranges in 16-row tiles through shared memory, warps compute the dot
// products and threads the online softmax; each thread holds NQ = D / 256
// columns of the 8 accumulators (NQ = 3 up to D = 768, 6 up to 1536).
//
// The combine: one block per (32-column slice, batch row), each warp one
// column a lane over every eighth partial, the 8 warps' sums added in
// shared memory; every block finds the row's max and denominator itself
// from the nchunks (max, denom) pairs. The L2 normalisation needs the
// whole row, so it is a second launch of one block a row.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BB = 8, TR = 16, THREADS = 256, MAX_D = 1536;
constexpr unsigned FULL = 0xffffffffu;

// ----------------------------------------------------- tensor-core body

namespace tc {

constexpr int NW = THREADS / 32;  // warps, each owning D / NW columns of the scores
constexpr int PS = 24;  // floats between batch rows of a partial-score slice
// [2 tiles][NW warps][BB batch rows][PS] partial scores, then a tile's
// weights as P^T fragments (BB x 4 lanes' uint4) and rescale factors (BB)
constexpr int PART_BYTES = 2 * NW * BB * PS * 4, PW_BYTES = BB * 4 * 16 + BB * 4;
static_assert(NW == BB, "warp w runs the softmax of batch row w");

// The ring of each row type: bytes an element, stages, and the f32 vectors
// a tile brings beside its rows (inv_norm; H's scale too).
template <typename R> struct Ring;
template <> struct Ring<__nv_bfloat16> {
  static constexpr int ELEM = 2, STAGES = 4, VECS = 1;
};
template <> struct Ring<signed char> {
  static constexpr int ELEM = 1, STAGES = 8, VECS = 2;
};

template <typename R>
__host__ __device__ constexpr int row_bytes(int d) { return Ring<R>::ELEM * d + 16; }
template <typename R>
__host__ __device__ constexpr int stage_bytes(int d) {
  return TR * row_bytes<R>(d) + Ring<R>::VECS * TR * 4;
}
template <typename R>
constexpr size_t smem_bytes(int d) {
  return (size_t)Ring<R>::STAGES * stage_bytes<R>(d) + PART_BYTES + PW_BYTES;
}

template <uint32_t M>
__device__ __forceinline__ uint32_t and_or(uint32_t x, uint32_t c) {
  uint32_t d;  // (x & M) | c in one LOP3 (the compiler would take two)
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(d) : "r"(x), "n"(M), "r"(c));
  return d;
}
// Bytes 0 and 2 of x, two int8 values, as an exact bf16 pair (byte 0 in
// the low half): (v & 0x7f) | 0x4300 is the bf16 128 + (v & 0x7f), and
// (v & 0x80) | 0x4300 is 128, or 256 when the sign bit is set, so their
// difference is the signed byte.
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t x) {
  const uint32_t lo7 = and_or<0x007f007fu>(x, 0x43004300u);
  const uint32_t sign = and_or<0x00800080u>(x, 0x43004300u);
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo7),
                                   *reinterpret_cast<const __nv_bfloat162*>(&sign));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four values of f (|f| <= 1: f is L2-normalised) as three int8 pieces
// each, four to a register: f = (p0 + p1 / 254 + p2 / 254^2) / 127 within
// 6.1e-8 plus f32 rounding, against ~2^-17 |f| for two bf16 pieces. Each
// residual is exact in f32 (fmaf), and each piece within +-127.
__device__ __forceinline__ void split_s8(float4 v, uint32_t (&p)[3]) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  p[0] = p[1] = p[2] = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float r = x[e], m = 127.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float n = rintf(r * m);
      r = fmaf(r, m, -n);
      m = 254.f;
      p[k] |= ((uint32_t)(int)n & 0xffu) << (8 * e);
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One online-softmax step of a tile for batch row `warp`, which this warp
// alone computes (NW == BB): lane l takes row l % 16 and sums half the NW
// partial-score slices, rows at or past `valid` are masked and each is
// scaled by inv (times H's scale) / T. The weights (times H's scale) go to
// pw as every lane's P^T fragments, hi and lo bf16 pieces (lane 4g + q of
// any warp reads pw[4g + q]: rows 2q, 2q + 1 and 2q + 8, 2q + 9 of batch
// row g), the batch row's rescale factor to psc; m_run and l_run move on.
template <bool SCALED>
__device__ __forceinline__ void tile_softmax(const float* part_t, int valid, const float* invs,
                                             const float* scales, float inv_temp, uint4* pw,
                                             float* psc, float& m_run, float& l_run) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r = lane & 15;
  const float* pp = part_t + (lane >> 4) * (NW / 2) * BB * PS + warp * PS + r;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NW / 2; ++w) s += pp[w * BB * PS];
  s += __shfl_xor_sync(FULL, s, 16);  // both halves now hold rows 0 .. 15
  s = r < valid ? (SCALED ? s * invs[r] * scales[r] : s * invs[r]) * inv_temp : -1e30f;
  float mx = s;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  const float m_new = fmaxf(m_run, mx);
  const float sc = expf(m_run - m_new), p = expf(s - m_new);
  float sum = p;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
  l_run = l_run * sc + sum;
  m_run = m_new;
  const float w = SCALED ? p * scales[r] : p;
  const float w1 = __shfl_down_sync(FULL, w, 1);
  if (lane < 16 && !(lane & 1)) {  // rows 2j, 2j + 1: b0 of lane q = j, b1 of q = j - 4
    const int j = lane >> 1;
    uint32_t hi, lo;
    pt::sm90::split_bf16(w, w1, hi, lo);
    uint32_t* dst = reinterpret_cast<uint32_t*>(pw + warp * 4 + (j & 3));
    dst[j >> 2] = hi;
    dst[2 + (j >> 2)] = lo;
  }
  if (lane == 0) psc[warp] = sc;
}

__device__ __forceinline__ void rescale(float (&acc)[4], float sc0, float sc1) {
  acc[0] *= sc0;
  acc[1] *= sc1;
  acc[2] *= sc0;
  acc[3] *= sc1;
}

// The body of both kernels; R is the row type (bf16 for D, int8 for H,
// whose `scale` the bf16 body never reads).
template <typename R, int KMAX>
__device__ __forceinline__ void body(const float* __restrict__ f, const R* __restrict__ rows,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ inv, float* __restrict__ m_part,
                                     float* __restrict__ l_part, float* __restrict__ acc_part,
                                     int B, int D, int num_real, int chunk_rows,
                                     float inv_temp) {
  using namespace pt::sm90;
  constexpr bool I8 = std::is_same<R, signed char>::value;
  constexpr int STAGES = Ring<R>::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row group, column pair
  const int chunk = blockIdx.x, b0 = blockIdx.y * BB;
  const int c0 = chunk * chunk_rows;
  const int c1 = min(c0 + chunk_rows, num_real);
  const int ntiles = c1 > c0 ? (c1 - c0 + TR - 1) / TR : 0;
  const int rb = row_bytes<R>(D), sb = stage_bytes<R>(D);
  const int kw = D / (16 * NW);  // 16-column steps of this warp's score slice
  const int col0 = warp * kw * 16;
  const uint32_t smem0 = smem_addr(smem);
  float* part = reinterpret_cast<float*>(smem + STAGES * sb);
  uint4* pw = reinterpret_cast<uint4*>(smem + STAGES * sb + PART_BYTES);
  float* psc = reinterpret_cast<float*>(pw + BB * 4);

  // tile t of the range into stage t % STAGES; one commit group per call
  auto load_tile = [&](int t) {
    if (t < ntiles) {
      const int r0 = c0 + t * TR, cpr = D * Ring<R>::ELEM / 16;
      const uint32_t st = smem0 + (t % STAGES) * sb;
      // warp w copies rows w and w + 8, a lane every 32nd 16-byte chunk
#pragma unroll
      for (int r = warp; r < TR; r += NW) {
        const bool ok = r0 + r < c1;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(rows) +
                                   (size_t)(ok ? r0 + r : 0) * cpr * 16;
        for (int c = lane; c < cpr; c += 32) cp_async16(st + r * rb + c * 16, src + c * 16, ok);
      }
      // the tile's inv_norm (and scale): four 16-byte copies each
      if (tid < Ring<R>::VECS * TR / 4) {
        const int k = tid % (TR / 4);
        const float* vec = tid < TR / 4 ? inv : scale;
        const int n = min(max(c1 - (r0 + 4 * k), 0), 4);
        cp_async16_n(st + TR * rb + tid * 16, n ? vec + r0 + 4 * k : vec, 4 * n);
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < STAGES - 2; ++t) load_tile(t);

  // f as the B operand (column g = batch row b0 + g): D's two bf16 pieces
  // for each 16-column step of this warp's slice, H's three int8 pieces
  // for each of its 32-column chunks warp + NW k (rows 4q .. 4q + 3 and
  // 16 + 4q .. of the chunk)
  uint32_t fh[KMAX][2], fl[KMAX][2], fq[KMAX / 2][2][3];
  const bool live = b0 + g < B;
  const float* frow = f + (size_t)(b0 + g) * D;
  // an int8 piece cannot carry a NaN: H's batch rows whose f holds one
  // (a zero feature) get a NaN score factor, as the bf16 products would
  float row_temp = inv_temp;
  if constexpr (I8) {
    bool bad = false;
#pragma unroll
    for (int k = 0; k < KMAX / 2; ++k) {
      const int cc = warp + NW * k;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (cc < D / 32 && live)
          v = *reinterpret_cast<const float4*>(frow + cc * 32 + h * 16 + 4 * q);
        bad |= isnan(v.x + v.y + v.z + v.w);
        split_s8(v, fq[k][h]);
      }
    }
    for (int r = 0; r < BB; ++r)
      if (__syncthreads_or(bad && g == r) && warp == r) row_temp = __int_as_float(0x7fc00000);
  } else {
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 v = make_float2(0.f, 0.f);
        if (j < kw && live)
          v = *reinterpret_cast<const float2*>(frow + col0 + j * 16 + h * 8 + 2 * q);
        split_bf16(v.x, v.y, fh[j][h], fl[j][h]);
      }
  }

  // acc^T fragments, 16 output columns a step: D's step i is columns
  // col0 + 16 i + g (+ 8); H's steps 2k and 2k + 1 are the 32-column chunk
  // c = warp + NW k, columns 32c + 4g + {0, 1} and + {2, 3} (the permuted
  // output columns). Batch rows 2q, 2q + 1; m, l of batch row `warp`.
  float acc[KMAX][4];
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[i][h] = 0.f;
  float m_run = -1e30f, l_run = 0.f;

  // D's lane addresses of the A operand: R (rows x columns) for the
  // scores, R^T (columns x rows, transposed) for the accumulators
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int t_row = (lane & 7) + (lane >> 4) * 8, t_col = ((lane >> 3) & 1) * 8;

  for (int it = 0; it <= ntiles; ++it) {
    cp_async_wait<STAGES - 3>();  // tile `it` has landed
    __syncthreads();              // for every thread; tile it - 2's stage is free
    load_tile(it + STAGES - 2);

    if (it < ntiles) {  // partial scores of tile `it` over this warp's columns
      float sv[4];  // (row g or g + 8, batch row 2q or 2q + 1)
      if constexpr (I8) {
        // q (exact in int8) times f's three int8 pieces, one integer MMA a
        // piece for each 32-column chunk; rows g and g + 8 of the chunk
        const unsigned char* st = smem + (it % STAGES) * sb + g * rb + 4 * q;
        int c[3][4] = {};
#pragma unroll
        for (int k = 0; k < KMAX / 2; ++k) {
          const int cc = warp + NW * k;
          if (cc < D / 32) {
            const unsigned char* w = st + cc * 32;
            const uint32_t a[4] = {lds32(w), lds32(w + 8 * rb), lds32(w + 16),
                                   lds32(w + 8 * rb + 16)};
#pragma unroll
            for (int piece = 0; piece < 3; ++piece)
              mma_s8_m16n8k32(c[piece], a, fq[k][0][piece], fq[k][1][piece]);
          }
        }
#pragma unroll
        for (int h = 0; h < 4; ++h)  // |c0| <= 127^2 D / 8, so c0 254 + c1 fits an int
          sv[h] = fmaf((float)c[2][h], 1.f / (127.f * 254.f * 254.f),
                       (float)(c[0][h] * 254 + c[1][h]) * (1.f / (127.f * 254.f)));
      } else {
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
#pragma unroll
        for (int h = 0; h < 4; ++h) sv[h] = (c[0][0][h] + c[0][1][h]) + (c[1][0][h] + c[1][1][h]);
      }
      float* pp = part + ((it & 1) * NW + warp) * BB * PS;
#pragma unroll
      for (int h = 0; h < 4; ++h) pp[(2 * q + (h & 1)) * PS + g + (h >> 1) * 8] = sv[h];
    }

    if (it > 0) {  // softmax, then (after a barrier) the P^T product of tile it - 1
      const int t = it - 1;
      const unsigned char* st = smem + (t % STAGES) * sb;
      const float* invs = reinterpret_cast<const float*>(st + TR * rb);
      tile_softmax<I8>(part + (t & 1) * NW * BB * PS, c1 - (c0 + t * TR), invs, invs + TR,
                       row_temp, pw, psc, m_run, l_run);
      __syncthreads();
      // rows 2q, 2q + 1, 2q + 8, 2q + 9 of batch row g: the B operand P^T;
      // the rescale factors of batch rows 2q, 2q + 1
      const uint4 pv = pw[g * 4 + q];
      const uint32_t ph[2] = {pv.x, pv.y}, pl[2] = {pv.z, pv.w};
      const float2 scv = *reinterpret_cast<const float2*>(psc + 2 * q);
      const float sc0 = scv.x, sc1 = scv.y;
      if constexpr (I8) {
#pragma unroll
        for (int k = 0; k < KMAX / 2; ++k) {
          const int cc = warp + NW * k;
          if (cc < D / 32) {
            rescale(acc[2 * k], sc0, sc1);
            rescale(acc[2 * k + 1], sc0, sc1);
            const unsigned char* w = st + 2 * q * rb + cc * 32 + 4 * g;
            const uint32_t w0 = lds32(w), w1 = lds32(w + rb);
            const uint32_t w8 = lds32(w + 8 * rb), w9 = lds32(w + 9 * rb);
#pragma unroll
            for (int sub = 0; sub < 2; ++sub) {
              // bytes 2 sub, 2 sub + 1 of rows (2q, 2q + 1) and (2q + 8, 2q + 9)
              const uint32_t sel = sub ? 0x7632u : 0x5410u;
              const uint32_t t01 = __byte_perm(w0, w1, sel), t89 = __byte_perm(w8, w9, sel);
              const uint32_t a[4] = {s8x2_bf16(t01), s8x2_bf16(t01 >> 8), s8x2_bf16(t89),
                                     s8x2_bf16(t89 >> 8)};
              mma_m16n8k16(acc[2 * k + sub], a, ph[0], ph[1]);
              mma_m16n8k16(acc[2 * k + sub], a, pl[0], pl[1]);
            }
          }
        }
      } else {
        const uint32_t a0 = smem0 + (t % STAGES) * sb + t_row * rb + (col0 + t_col) * 2;
#pragma unroll
        for (int i = 0; i < KMAX; ++i) {
          if (i < kw) {
            rescale(acc[i], sc0, sc1);
            uint32_t a[4];
            ldmatrix_x4_trans(a, a0 + i * 32);
            mma_m16n8k16(acc[i], a, ph[0], ph[1]);
            mma_m16n8k16(acc[i], a, pl[0], pl[1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    const int cc = warp + NW * (i >> 1);
    if (I8 ? cc >= D / 32 : i >= kw) continue;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int b = b0 + 2 * q + (h & 1);
      const int d = I8 ? cc * 32 + 4 * g + 2 * (i & 1) + (h >> 1)
                       : col0 + i * 16 + g + (h >> 1) * 8;
      if (b < B) acc_part[((size_t)chunk * B + b) * D + d] = acc[i][h];
    }
  }
  if (lane == 0 && b0 + warp < B) {
    m_part[(size_t)chunk * B + b0 + warp] = m_run;
    l_part[(size_t)chunk * B + b0 + warp] = l_run;
  }
}

// D over a bf16 bank (scale unused) and H over an int8 one: two kernels,
// so that each instantiation can be told apart in the binary.
template <int KMAX>
__global__ void __launch_bounds__(THREADS, KMAX <= 6 ? 2 : 1)
mem_proj_bf16_kernel(const float* __restrict__ f, const __nv_bfloat16* __restrict__ rows,
                     const float* __restrict__ scale, const float* __restrict__ inv,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     float* __restrict__ acc_part, int B, int D, int num_real,
                     int chunk_rows, float inv_temp) {
  body<__nv_bfloat16, KMAX>(f, rows, scale, inv, m_part, l_part, acc_part, B, D, num_real,
                            chunk_rows, inv_temp);
}

template <int KMAX>
__global__ void __launch_bounds__(THREADS, KMAX <= 6 ? 2 : 1)
mem_proj_int8_kernel(const float* __restrict__ f, const signed char* __restrict__ rows,
                     const float* __restrict__ scale, const float* __restrict__ inv,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     float* __restrict__ acc_part, int B, int D, int num_real,
                     int chunk_rows, float inv_temp) {
  body<signed char, KMAX>(f, rows, scale, inv, m_part, l_part, acc_part, B, D, num_real,
                          chunk_rows, inv_temp);
}

template <typename R, int KMAX>
auto kernel_fn() {
  if constexpr (std::is_same<R, signed char>::value)
    return mem_proj_int8_kernel<KMAX>;
  else
    return mem_proj_bf16_kernel<KMAX>;
}

template <typename R, int KMAX>
cudaError_t attributes(int D) {
  auto* k = kernel_fn<R, KMAX>();
  cudaError_t err = pt_allow_smem(k, smem_bytes<R>(D));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename R, int KMAX>
cudaError_t resident_blocks(int D, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = attributes<R, KMAX>(D);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_fn<R, KMAX>(), THREADS,
                                                        smem_bytes<R>(D));
  *blocks = per_sm * sms;
  return err;
}

template <typename R, int KMAX>
cudaError_t partial(const void* f, const void* rows, const void* scale, const void* inv,
                    void* m_part, void* l_part, void* acc_part, int B, int D, int num_real,
                    int chunk_rows, int nchunks, float inv_temp, cudaStream_t s) {
  cudaError_t err = attributes<R, KMAX>(D);
  if (err != cudaSuccess) return err;
  dim3 grid(nchunks, (B + BB - 1) / BB);
  auto* k = kernel_fn<R, KMAX>();
  k<<<grid, THREADS, smem_bytes<R>(D), s>>>(
      (const float*)f, (const R*)rows, (const float*)scale, (const float*)inv, (float*)m_part,
      (float*)l_part, (float*)acc_part, B, D, num_real, chunk_rows, inv_temp);
  return cudaGetLastError();
}

template <typename R>
cudaError_t blocks_d(int D, int* blocks) {
  return D <= 768 ? resident_blocks<R, 6>(D, blocks) : resident_blocks<R, 12>(D, blocks);
}

template <typename R>
cudaError_t partial_d(const void* f, const void* rows, const void* scale, const void* inv,
                      void* m_part, void* l_part, void* acc_part, int B, int D, int num_real,
                      int chunk_rows, int nchunks, float inv_temp, cudaStream_t s) {
  return D <= 768 ? partial<R, 6>(f, rows, scale, inv, m_part, l_part, acc_part, B, D,
                                  num_real, chunk_rows, nchunks, inv_temp, s)
                  : partial<R, 12>(f, rows, scale, inv, m_part, l_part, acc_part, B, D,
                                   num_real, chunk_rows, nchunks, inv_temp, s);
}

}  // namespace tc

// ----------------------------------------------------------- SIMT body

template <int NQ>
__global__ void __launch_bounds__(THREADS)
mem_proj_partial_kernel(const float* __restrict__ f, const float* __restrict__ rows,
                        const float* __restrict__ inv, float* __restrict__ m_part,
                        float* __restrict__ l_part, float* __restrict__ acc_part,
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
      rs[e] = (row < c1) ? rows[(size_t)row * D + d] : 0.f;
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
cudaError_t simt_partial(const void* f, const void* rows, const void* inv, void* m_part,
                         void* l_part, void* acc_part, int B, int D, int num_real,
                         int chunk_rows, int nchunks, float inv_temp, cudaStream_t s) {
  const size_t smem = (size_t)(BB + TR) * D * sizeof(float);
  cudaError_t err = pt_allow_smem(mem_proj_partial_kernel<NQ>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nchunks, (B + BB - 1) / BB);
  mem_proj_partial_kernel<NQ><<<grid, THREADS, smem, s>>>(
      (const float*)f, (const float*)rows, (const float*)inv, (float*)m_part, (float*)l_part,
      (float*)acc_part, B, D, num_real, chunk_rows, inv_temp);
  return cudaGetLastError();
}

// ----------------------------------------------------------- combine

constexpr int NWARPS = THREADS / 32;

// op over the block's THREADS values, returned to every thread
template <typename Op>
__device__ __forceinline__ float block_all(float v, Op op, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();  // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) v = op(v, red[w]);
  return v;
}

// out[b, d] for the 32 columns of slice blockIdx.x and batch row
// blockIdx.y: warp w sums partials w, w + 8, ... of column 32 x + lane.
__global__ void __launch_bounds__(THREADS)
mem_proj_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                        const float* __restrict__ acc_part, float* __restrict__ out, int B,
                        int D, int nchunks) {
  __shared__ float red[NWARPS];
  __shared__ float sums[NWARPS][32];
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = blockIdx.x * 32 + lane;
  const auto max_op = [](float x, float y) { return fmaxf(x, y); };
  const auto add = [](float x, float y) { return x + y; };
  float mx = -1e30f;
  for (int c = tid; c < nchunks; c += THREADS) mx = fmaxf(mx, m_part[(size_t)c * B + b]);
  mx = block_all(mx, max_op, red);
  float denom = 0.f;
  for (int c = tid; c < nchunks; c += THREADS) {
    const size_t slot = (size_t)c * B + b;
    denom += l_part[slot] * expf(m_part[slot] - mx);
  }
  denom = block_all(denom, add, red);
  float acc = 0.f;
  if (d < D)
    for (int c = warp; c < nchunks; c += NWARPS) {
      const size_t slot = (size_t)c * B + b;
      acc += acc_part[slot * D + d] * expf(m_part[slot] - mx);
    }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && d < D) {
    float t = sums[0][lane];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) t += sums[w][lane];
    out[(size_t)b * D + d] = t / denom;
  }
}

// Row blockIdx.x of out L2-normalised in place.
__global__ void __launch_bounds__(THREADS)
mem_proj_normalize_kernel(float* __restrict__ out, int D) {
  constexpr int NQ = MAX_D / THREADS;
  __shared__ float red[NWARPS];
  float* row = out + (size_t)blockIdx.x * D;
  float v[NQ], ss = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int d = threadIdx.x + q * THREADS;
    v[q] = d < D ? row[d] : 0.f;
    ss += v[q] * v[q];
  }
  const float total = rsqrtf(block_all(ss, [](float x, float y) { return x + y; }, red));
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int d = threadIdx.x + q * THREADS;
    if (d < D) row[d] = v[q] * total;
  }
}

}  // namespace

// Blocks of the tensor-core body for `dtype` (1 bf16, 2 int8) that fit on
// the card at once at width D (its one-wave grid), written to *blocks (an
// int).
extern "C" int pt_memory_project_blocks(int D, int dtype, void* blocks, void* stream) {
  (void)stream;
  if (D % 128 || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (dtype == pt::kBF16) return (int)tc::blocks_d<__nv_bfloat16>(D, (int*)blocks);
  if (dtype == pt::kI8) return (int)tc::blocks_d<signed char>(D, (int*)blocks);
  return (int)cudaErrorInvalidValue;
}

// out (B, D) = the combined nchunks partials (max, denom: nchunks x B;
// acc: nchunks x B x D), L2-normalised when `normalize`. Requires D <= 1536.
extern "C" int pt_memory_project_combine(const void* m_part, const void* l_part,
                                         const void* acc_part, void* out, int B, int D,
                                         int nchunks, int normalize, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  mem_proj_combine_kernel<<<dim3((D + 31) / 32, B), THREADS, 0, s>>>(
      (const float*)m_part, (const float*)l_part, (const float*)acc_part, (float*)out, B, D,
      nchunks);
  if (normalize) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mem_proj_normalize_kernel<<<B, THREADS, 0, s>>>((float*)out, D);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 f32 (the SIMT body), 1 bf16 (D) and 2 int8 (H, scale the
// per-row scales; the tensor-core body). nchunks blocks of chunk_rows rows
// each (the last ones may be empty); the partial buffers hold nchunks * B
// entries (times D for acc_part). Requires D <= 1536, and for bf16 and
// int8 D % 128 == 0 (the wrapper checks).
extern "C" int pt_memory_project(const void* f, const void* rows,
                                 const void* scale, const void* inv,
                                 void* m_part, void* l_part, void* acc_part,
                                 void* out, int B, int D, int num_real,
                                 int chunk_rows, int nchunks, float inv_temp,
                                 int normalize, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (D > MAX_D) return (int)cudaErrorInvalidValue;
  if (dtype == pt::kBF16 || dtype == pt::kI8) {
    if (D % 128) return (int)cudaErrorInvalidValue;
    err = dtype == pt::kBF16
              ? tc::partial_d<__nv_bfloat16>(f, rows, nullptr, inv, m_part, l_part, acc_part,
                                             B, D, num_real, chunk_rows, nchunks, inv_temp, s)
              : tc::partial_d<signed char>(f, rows, scale, inv, m_part, l_part, acc_part, B,
                                           D, num_real, chunk_rows, nchunks, inv_temp, s);
  } else {
    err = D <= 768 ? simt_partial<3>(f, rows, inv, m_part, l_part, acc_part, B, D, num_real,
                                     chunk_rows, nchunks, inv_temp, s)
                   : simt_partial<MAX_D / THREADS>(f, rows, inv, m_part, l_part, acc_part, B,
                                                   D, num_real, chunk_rows, nchunks,
                                                   inv_temp, s);
  }
  if (err != cudaSuccess) return (int)err;
  return pt_memory_project_combine(m_part, l_part, acc_part, out, B, D, nchunks, normalize,
                                   stream);
}
