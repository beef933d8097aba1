// Backward of the folded CrossPath (the fusion net's feature-fusion module)
// in bf16, two streaming passes over the tokens, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's custom_vjp of pallas_ffm.py
// recomputes crosspath_folded_xla through XLA, and the port's plain
// backward recomputed crosspath_folded_ref under autograd in f32, with the
// full 128-wide projections, the full [128, 128] grams, the contexts
// applied as K = 128 products against zero-padded matrices, and [B, N, 128]
// f32 temporaries (1.26 GB each at [8, 307200]): 167 ms a call on the
// H100. These kernels compute the same gradients with nothing the size of
// the tokens kept between the passes.
//
// Notation as in ffm.cu: r_i = bf16(relu(x_i Wp_i + bp_i)) = [y_i, u_i]
// (x_3 = s); o1 = y3 M0 + u1 M1 + be1, o2 = y3 M2 + u2 M3 + be2 with the
// forward's bf16 context matrices; out_i = LayerNorm(x_i + o_i). g_i is
// out_i's cotangent and dh_i the gradient at the LayerNorm's input.
//
// Pass A' (segmif_ffm_bwd_reduce): per token y3, u_i, o_i, the LayerNorm's
// statistics (E[t^2] - mu^2, as the forward) and dh_i; summed over the
// tokens: dM0 = y3^T dh1, dM1 = u1^T dh1, dM2 = y3^T dh2, dM3 = u2^T dh2,
// and per channel sum(dh_i) (be_i), sum(g_i xhat_i) and sum(g_i) (the
// LayerNorm's scale and bias). The caller turns dM (rounded to bf16, the
// gradient of the fold's cast) into the grams' gradient dG_i through the
// tiny context step and passes S_i = dG_i + dG_i^T to pass B'.
// Pass B' (segmif_ffm_bwd_rows): per token dh_i again; dy3 = dh1 M0^T +
// dh2 M2^T, du_i = dh_i M_{2i-1}^T, dy_i = y_i S_i (i = 1, 2), du3 = u3 S3;
// dpre_i = bf16(dr_i) where r_i > 0 (the gradient of the projection's cast,
// then relu's); dx_i = dpre_i Wp_i^T, plus dh_i for x1 and x2 (each rounded
// to bf16 before that add, as autograd sums the two bf16 gradients of
// x_i); and summed over the tokens dWp_i = x_i^T dpre_i, dbp_i =
// sum(dpre_i).
//
// Precision: the plain backward's arithmetic at no lower precision.
// Products of two bf16-exact operands (x, r, g, the bf16 mats and
// weights, dpre) run on mma.sync m16n8k16 bf16 with f32 accumulation.
// Where the plain backward holds an operand in f32 (dh; S) it is split into
// three bf16 pieces, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid), each difference exact in f32, so that hi + mid + lo carries v to
// 2^-27 of it (beyond f32's own 2^-24); each piece's product with a
// bf16-exact operand is exact and the three are summed in f32, smallest
// first. (Three bf16 pieces against a TF32 big/small pair: more bits,
// the same fragment layouts and instruction as every other product here,
// and 3 mma m16n8k16 per 16-deep step against TF32's 4 m16n8k8.)
//
// What bounds it on the H100: operations, as the function needs them
// (64 x 64 products a token: A' 3 projections, 4 context products, 4
// token sums against f32 dh; B' 6 projection halves, 4 context products,
// 4 against f32 dh, 3 against f32 S, 3 x 2 for dx and 3 x 2 for dW): 40 x
// 8,192 FLOP a token, 0.81 TFLOP a call at [8, 307200, 64], 0.81 ms at
// the bf16 peak (the 11 against an f32 operand take three bf16 products
// each here). Bytes: x1, x2, s, g1, g2 read and dx1, dx2, ds written
// (bf16), 1,024 a token, 0.75 ms; the two passes read the inputs once
// each, 1,664 bytes a token, 1.22 ms. On the H100 (700 W) pass A' takes
// 2.10 ms and pass B' 4.71 ms there, 12 % of the bound: one block of 8
// warps an SM (by shared memory and registers; pass B' at 255 registers
// with a small spill), two block barriers a step and the loads of a step
// not overlapped with the products leave the tensor cores waiting.
//
// Design:
//  - Token sums need their operands laid out by token (k = token), the
//    per-token chain by channel; and a [64, 64] or [64, 128] f32 sum is 128
//    or 256 registers a warp. So the blocks take 128 tokens a step (8
//    warps x 16), each warp runs the chain in registers on its 16 tokens
//    (as ffm.cu's pass B: bias, relu, the bf16 rounding and the LayerNorm
//    on the accumulators, context products chained through the A
//    fragments), stages the sums' operands (bf16 rows) in shared memory,
//    and after a block barrier every warp adds one share of the block's
//    sums over the 128 tokens (ldmatrix.trans gives both operands'
//    fragments from token rows) into its own f32 registers: 32 a thread.
//    Each step's sums go into fresh accumulators, added to the running
//    f32 sums (24 chained mma a step at most, against the truncating adds
//    of the tensor cores).
//  - Pass A' has grid (chunks, B, 2): block z = o takes output o (y3, u_o,
//    dh_o; dM_{2o}, dM_{2o+1}). Pass B' has grid (chunks, B, 3): block z = q
//    takes projection q's gradient (q < 2: x_q, with dh_q; q = 2: s, which
//    needs both outputs' dh), so that its dWp_q sum fits the block. The
//    y3 projection and a dh are recomputed by more than one block: the
//    price of keeping the sums in registers.
//  - Per-channel sums (be, the LayerNorm's, dbp): quad rows reduced by
//    shuffles, added by lanes 0-3 into the warp's own row of shared memory,
//    the warps' rows summed in warp order at the block's end.
//  - Each block writes one partial per (image, chunk); a second launch sums
//    them in chunk order. No atomics: results repeat bit for bit.
//  - Token rows past the image's end are zero-filled: their cotangent is
//    0, so dh is 0 there; dpre, where y S is not, is masked to 0.
//
// Shapes: x1, x2, s, g1, g2 [B, N, 64] bf16 contiguous; wp [3][64][128]
// bf16 ([in][out], as the JAX layout), bp [3][128] f32 (bf16-exact), mats
// [B][4][64][64] bf16, S [B][3][64][64] f32, be [2][64], lnp [2][2][64]
// f32.

#include "common.cuh"

namespace segmif {
namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;             // channels (the fusion trunk width)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int WT = 16;            // tokens per warp tile
constexpr int STEP = WT * kWarps; // tokens per block step
constexpr int BRS = C + 8;        // padded bf16 row of a [*, 64] array
constexpr int MAT = C * BRS;      // one [64][BRS] matrix
constexpr int TB = WT * BRS;      // one warp tile [16][BRS]
constexpr int DRS = 2 * C + 8;    // padded bf16 row of a [16, 128] dpre tile
constexpr int SLOTS = 5;          // warp tiles per warp
constexpr int RED_PER = 2 * C * C + 3 * C;   // pass A' partial per output
constexpr int ROWS_PER = 2 * C * C + 2 * C;  // pass B' partial per projection

constexpr size_t kReduceSmem = sizeof(bf16) * (4 * MAT + kWarps * SLOTS * TB) +
                               sizeof(float) * (4 * C + kWarps * 3 * C);
constexpr size_t kRowsSmem = sizeof(bf16) * (11 * MAT + kWarps * SLOTS * TB) +
                             sizeof(float) * (8 * C + kWarps * 2 * C);
static_assert(WT * DRS <= 2 * TB, "a dpre tile fits two warp tiles");

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

// A fragments (four k16 steps) of a [16][BRS] bf16 tile.
__device__ __forceinline__ void load_a(const bf16* tile, uint32_t a[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], tile + (lane & 15) * BRS + kk * 16 + (lane >> 4) * 8);
}

// A fragments back to the rows of a [16][rs] bf16 tile (load_a inverted).
__device__ __forceinline__ void store_a(bf16* tile, int rs,
                                        const uint32_t a[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(tile + (g + 8 * (j & 1)) * rs + 16 * kk +
                                   8 * (j >> 1) + 2 * t4) = a[kk][j];
}

// B fragments of k16 step kk, n8 tiles 2 np and 2 np + 1 (b[0..1], b[2..3])
// of a [64][64] bf16 matrix B: stored [k][n] (kKN: ldmatrix.trans) or
// [n][k] (B = W^T of a W stored [n][k] rows; plain ldmatrix).
template <bool kKN>
__device__ __forceinline__ void load_b(uint32_t b[4], const bf16* w, int kk,
                                       int np) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  if (kKN)
    ldmatrix_x4_trans(b, w + (16 * kk + 8 * (i & 1) + r) * BRS + 16 * np +
                             8 * (i >> 1));
  else
    ldmatrix_x4(b, w + (16 * np + 8 * (i >> 1) + r) * BRS + 16 * kk +
                       8 * (i & 1));
}

// acc[8][4] += a (16 x 64, A fragments) @ B (see load_b).
template <bool kKN>
__device__ __forceinline__ void mma_b(float acc[8][4], const uint32_t a[4][4],
                                      const bf16* w) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b<kKN>(b, w, kk, np);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// The two f32 values (x, y) as three packed bf16 pieces, hi + mid + lo.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x, y);
  x -= bf16_lo(hi);
  y -= bf16_hi(hi);
  mid = pack_bf16(x, y);
  x -= bf16_lo(mid);
  y -= bf16_hi(mid);
  lo = pack_bf16(x, y);
}

// acc += d @ B with d f32 in the accumulator layout (16 x 64), split into
// three bf16 pieces per k16 step (accumulator tiles 2 kk, 2 kk + 1 are the
// A fragment of step kk); each B fragment serves the three pieces.
template <bool kKN>
__device__ __forceinline__ void mma_split(float acc[8][4], const float d[8][4],
                                          const bf16* w) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t p[3][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = 2 * kk + (j >> 1), r = j & 1;
      split3(d[nt][2 * r], d[nt][2 * r + 1], p[0][j], p[1][j], p[2][j]);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b<kKN>(b, w, kk, np);
#pragma unroll
      for (int q = 2; q >= 0; --q) {
        mma_bf16(acc[2 * np], p[q], b[0], b[1]);
        mma_bf16(acc[2 * np + 1], p[q], b[2], b[3]);
      }
    }
  }
}

// acc += a @ S, a bf16 (A fragments), S f32 staged as its three bf16
// pieces [k][n] at s (hi), s + MAT (mid), s + 2 MAT (lo).
__device__ __forceinline__ void mma_pieces(float acc[8][4],
                                           const uint32_t a[4][4],
                                           const bf16* s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int q = 2; q >= 0; --q) {
        uint32_t b[4];
        load_b<true>(b, s + q * MAT, kk, np);
        mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
      }
}

// out = bf16(relu(a @ w + bias)) as A fragments (accumulator tiles 2 j,
// 2 j + 1 are k16 step j); w [k][n] bf16, bias [C] f32.
__device__ __forceinline__ void project(const uint32_t a[4][4], const bf16* w,
                                        const float* bias,
                                        uint32_t out[4][4]) {
  float acc[8][4];
  zero(acc);
  mma_b<true>(acc, a, w);
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = 2 * kk + (j >> 1), r = j & 1;
      const float* bb = bias + nt * 8 + 2 * t4;
      out[kk][j] = pack_bf16(fmaxf(acc[nt][2 * r] + bb[0], 0.f),
                             fmaxf(acc[nt][2 * r + 1] + bb[1], 0.f));
    }
}

// Element c of accumulator tile nt from the A fragments of the same 16 x 64
// tile (rows g + 8 (c / 2), column 8 nt + 2 t + c % 2).
__device__ __forceinline__ float elem(const uint32_t a[4][4], int nt, int c) {
  const uint32_t v = a[nt >> 1][2 * (nt & 1) + (c >> 1)];
  return (c & 1) ? bf16_hi(v) : bf16_lo(v);
}

// Quad rows of two values, summed over the four lanes of a quad.
__device__ __forceinline__ void quad_sum(float v[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
}

// sums[8 nt + 2 t + c] += the column sums of the 16 rows of v (in the
// accumulator layout): the two rows of a lane, then the eight row groups by
// shuffles; lanes 0-3 add. sums: this warp's row in shared memory.
__device__ __forceinline__ void col_sums(const float v[8][4], float* sums) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s = v[nt][c] + v[nt][c + 2];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane < 4) sums[8 * nt + 2 * lane + c] += s;
    }
}

// acc (the context products o of this warp's 16 tokens) becomes dh, the
// gradient at the LayerNorm's input t = x + (o + be): f32, eps 1e-5, the
// variance E[t^2] - mu^2 clamped at 0 as the forward takes it (its
// gradient 0 where the clamp holds). x, g: the residual's and the
// cotangent's A fragments; be, gamma: [C] f32. kSums: sum(dh), sum(g xhat)
// and sum(g) over the 16 tokens added to sums[0, C), [C, 2C), [2C, 3C).
template <bool kSums>
__device__ __forceinline__ void ln_grad(float acc[8][4], const uint32_t x[4][4],
                                        const uint32_t g[4][4],
                                        const float* be, const float* gamma,
                                        float* sums) {
  const int t4 = threadIdx.x & 3;
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = nt * 8 + 2 * t4 + (c & 1);
      acc[nt][c] = elem(x, nt, c) + (acc[nt][c] + be[col]);
      sum[c >> 1] += acc[nt][c];
      sq[c >> 1] += acc[nt][c] * acc[nt][c];
    }
  quad_sum(sum);
  quad_sum(sq);
  float mu[2], rstd[2], keep[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mu[r] = sum[r] * (1.f / C);
    const float var = sq[r] * (1.f / C) - mu[r] * mu[r];
    keep[r] = var >= 0.f ? 1.f : 0.f;
    rstd[r] = rsqrtf(fmaxf(var, 0.f) + 1e-5f);
  }
  float sa[2] = {0.f, 0.f}, sax[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1;
      acc[nt][c] = (acc[nt][c] - mu[r]) * rstd[r];   // xhat
      const float a = elem(g, nt, c) * gamma[nt * 8 + 2 * t4 + (c & 1)];
      sa[r] += a;
      sax[r] += a * acc[nt][c];
    }
  quad_sum(sa);
  quad_sum(sax);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sa[r] *= 1.f / C;
    sax[r] *= keep[r] * (1.f / C);
  }
  float gx[8][4], gv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1;
      const float ge = elem(g, nt, c), xh = acc[nt][c];
      acc[nt][c] =
          rstd[r] * (ge * gamma[nt * 8 + 2 * t4 + (c & 1)] - sa[r] - xh * sax[r]);
      if (kSums) {
        gx[nt][c] = ge * xh;
        gv[nt][c] = ge;
      }
    }
  if (kSums) {
    col_sums(acc, sums);
    col_sums(gx, sums + C);
    col_sums(gv, sums + 2 * C);
  }
}

// dpre = bf16(dr) where the projection's output r (A fragments) is
// positive and the token row lies before the image's end (ok0: row g, ok1:
// row g + 8), else 0, as A fragments; dr takes the rounded values, whose
// column sums are added to sums[0, C).
__device__ __forceinline__ void grad_pre(float dr[8][4], const uint32_t r[4][4],
                                         bool ok0, bool ok1,
                                         uint32_t out[4][4], float* sums) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = 2 * kk + (j >> 1), rr = j & 1;
      const uint32_t rv = r[kk][j];
      uint32_t keep = ((rv & 0x7fffu) ? 0xffffu : 0u) |
                      ((rv & 0x7fff0000u) ? 0xffff0000u : 0u);
      if (!(rr ? ok1 : ok0)) keep = 0u;
      const uint32_t v = pack_bf16(dr[nt][2 * rr], dr[nt][2 * rr + 1]) & keep;
      out[kk][j] = v;
      dr[nt][2 * rr] = bf16_lo(v);
      dr[nt][2 * rr + 1] = bf16_hi(v);
    }
  col_sums(dr, sums);
}

// This warp's 16 rows (A fragments) stored to out rows [row0, row0 + 16)
// below n_end, 16 bytes a lane, staged in `tile` (a consumed input).
__device__ __forceinline__ void store_rows(const uint32_t v[4][4], bf16* tile,
                                           bf16* __restrict__ out, int row0,
                                           int n_end) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  store_a(tile, BRS, v);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < WT * 8; i += 32) {
    const int r = i / 8, c = i % 8;
    if (row0 + r < n_end)
      *reinterpret_cast<uint4*>(out + int64_t(row0 + r) * C + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * BRS + c * 8);
  }
}

// A fragment of P^T for a token sum: P a [16][ps] tile of token rows, its
// channels [16 I, 16 I + 16) as the m dimension, the 16 tokens as k.
__device__ __forceinline__ void load_at(uint32_t a[4], const bf16* p, int ps,
                                        int I) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  ldmatrix_x4_trans(a, p + (8 * (i >> 1) + (lane & 7)) * ps + 16 * I +
                           8 * (i & 1));
}

// acc[8][4] += A (load_at) @ Q[:, q0 .. q0 + 64): Q a [16][qs] tile of
// token rows (k = token, n = channel).
__device__ __forceinline__ void mma_tn(float acc[8][4], const uint32_t a[4],
                                       const bf16* q, int qs) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, q + (8 * (i & 1) + (lane & 7)) * qs + 16 * np +
                             8 * (i >> 1));
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// Rows [row0, row0 + 16) of x (row stride C) into `tile`; rows at or past
// n_end are zero-filled.
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* x, int row0,
                                          int n_end) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < WT * 8 / 32; ++it) {
    const int r = (lane + 32 * it) / 8, c = lane % 8;
    const bool ok = row0 + r < n_end;
    cp_async16(tile + r * BRS + c * 8, x + int64_t(ok ? row0 + r : 0) * C + c * 8,
               ok);
  }
}

// A [64][64] bf16 matrix with row stride `stride` into a [64][BRS] tile.
__device__ __forceinline__ void stage_mat(bf16* dst, const bf16* src,
                                          int stride) {
  for (int i = threadIdx.x; i < C * 8; i += kThreads) {
    const int r = i / 8, c = i % 8;
    cp_async16(dst + r * BRS + c * 8, src + int64_t(r) * stride + c * 8, true);
  }
}

// acc += part, the sum's step into its running f32 sum
__device__ __forceinline__ void add_to(float acc[8][4], const float part[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] += part[i][c];
}

// ---------------------------------------------------------------- pass A'

// grid (n_chunks, B, 2): block (chunk, b, o) takes output o of image b's
// token chunk. partial: [B][n_chunks][2][RED_PER]: dM_{2o} (y3^T dh_o),
// dM_{2o+1} (u_o^T dh_o) [C][C] each, then sum(dh_o), sum(g_o xhat_o),
// sum(g_o) [C] each.
//  - Shared memory: Wy3 = wp[2][:, :64], Wu = wp[o][:, 64:], M_{2o},
//    M_{2o+1} ([k][n]); per warp five tiles: s, x_o, g_o, then the sums'
//    operands y3 (over s), u_o (over x_o), dh_o's hi (over g_o), mid, lo.
//  - Warp w adds the block's step into dM_{2o + w / 4}'s rows [16 (w % 4),
//    16 (w % 4) + 16): 8 tiles' A fragments (P^T) by ldmatrix.trans, each
//    against dh's three pieces.
__global__ void __launch_bounds__(kThreads, 1)
    ffm_bwd_reduce_kernel(const bf16* __restrict__ x1,
                          const bf16* __restrict__ x2,
                          const bf16* __restrict__ s,
                          const bf16* __restrict__ g1,
                          const bf16* __restrict__ g2,
                          const bf16* __restrict__ wp,
                          const float* __restrict__ bp,
                          const bf16* __restrict__ mats,
                          const float* __restrict__ be,
                          const float* __restrict__ lnp,
                          float* __restrict__ partial, int n, int chunk) {
  extern __shared__ uint4 smem_u4[];
  bf16* ws = reinterpret_cast<bf16*>(smem_u4);   // [4][MAT]
  bf16* slots = ws + 4 * MAT;                    // [warps][SLOTS][TB]
  float* prm = reinterpret_cast<float*>(slots + kWarps * SLOTS * TB);
  float* csum = prm + 4 * C;                     // [warps][3][C]
  const int b = blockIdx.y, o = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;

  stage_mat(ws, wp + 2 * C * 2 * C, 2 * C);
  stage_mat(ws + MAT, wp + o * C * 2 * C + C, 2 * C);
  stage_mat(ws + 2 * MAT, mats + (int64_t(b) * 4 + 2 * o) * C * C, C);
  stage_mat(ws + 3 * MAT, mats + (int64_t(b) * 4 + 2 * o + 1) * C * C, C);
  cp_async_commit();
  for (int i = threadIdx.x; i < C; i += kThreads) {
    prm[i] = bp[2 * 2 * C + i];             // y3's bias
    prm[C + i] = bp[o * 2 * C + C + i];     // u_o's
    prm[2 * C + i] = be[o * C + i];
    prm[3 * C + i] = lnp[o * 2 * C + i];    // gamma_o
  }
  for (int i = threadIdx.x; i < kWarps * 3 * C; i += kThreads) csum[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  const int64_t img = int64_t(b) * n * C;
  const bf16* xo = (o == 0 ? x1 : x2) + img;
  const bf16* go = (o == 0 ? g1 : g2) + img;
  const int n_begin = blockIdx.x * chunk;
  const int n_end = min(n, n_begin + chunk);
  bf16* mine = slots + warp * SLOTS * TB;
  float* my_sums = csum + warp * 3 * C;
  const int mi = warp >> 2, I = warp & 3;   // this warp's share of the sums
  float red[8][4];
  zero(red);

  for (int base = n_begin; base < n_end; base += STEP) {
    const int row0 = base + WT * warp;
    load_tile(mine, s + img, row0, n_end);
    load_tile(mine + TB, xo, row0, n_end);
    load_tile(mine + 2 * TB, go, row0, n_end);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    uint32_t xa[4][4], y3[4][4], u[4][4], ga[4][4];
    load_a(mine, xa);
    project(xa, ws, prm, y3);
    load_a(mine + TB, xa);
    project(xa, ws + MAT, prm + C, u);
    float acc[8][4];
    zero(acc);
    mma_b<true>(acc, y3, ws + 2 * MAT);
    mma_b<true>(acc, u, ws + 3 * MAT);
    load_a(mine + 2 * TB, ga);
    ln_grad<true>(acc, xa, ga, prm + 2 * C, prm + 3 * C, my_sums);
    __syncwarp();   // every lane has read its tiles
    store_a(mine, BRS, y3);
    store_a(mine + TB, BRS, u);
    {
      uint32_t p[3][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nt = 2 * kk + (j >> 1), r = j & 1;
          split3(acc[nt][2 * r], acc[nt][2 * r + 1], p[0][kk][j], p[1][kk][j],
                 p[2][kk][j]);
        }
#pragma unroll
      for (int q = 0; q < 3; ++q) store_a(mine + (2 + q) * TB, BRS, p[q]);
    }
    __syncthreads();   // every warp's operands staged

    float part[8][4];
    zero(part);
#pragma unroll 1
    for (int j = 0; j < kWarps; ++j) {
      const bf16* theirs = slots + j * SLOTS * TB;
      uint32_t a[4];
      load_at(a, theirs + mi * TB, BRS, I);
#pragma unroll
      for (int q = 2; q >= 0; --q) mma_tn(part, a, theirs + (2 + q) * TB, BRS);
    }
    add_to(red, part);
    __syncthreads();   // the tiles are refilled by the next step
  }

  float* dst = partial + ((int64_t(b) * gridDim.x + blockIdx.x) * 2 + o) *
                             RED_PER;
  const int t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(dst + mi * C * C + (16 * I + g + 8 * r) * C +
                                 8 * nt + 2 * t4) =
          make_float2(red[nt][2 * r], red[nt][2 * r + 1]);
  __syncthreads();   // every warp's column sums
  for (int i = threadIdx.x; i < 3 * C; i += kThreads) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += csum[w * 3 * C + i];
    dst[2 * C * C + i] = v;
  }
}

// ---------------------------------------------------------------- pass B'

// grid (n_chunks, B, 3): block (chunk, b, q) takes projection q's gradient
// for image b's token chunk: q < 2 dx_q, q = 2 ds, and the sums dWp_q,
// dbp_q into partial [B][n_chunks][3][ROWS_PER] ([C][2C] then [2C]).
//  - Matrices ([64][BRS] bf16): 0 Wy3, 1 Wu3 (q = 2) or Wy_q, 2 Wu_1 (q =
//    2) or Wu_q, 3 Wu_2 (q = 2); 4-7 the context matrices (q = 2: M0-M3;
//    q < 2: M_{2q}, M_{2q+1}); 8-10 S_q's pieces hi, mid, lo, split here
//    from f32. The projections' weights serve both r = x W (stored [k][n])
//    and dx = dpre W^T (the same rows as [n][k]).
//  - Per warp five tiles: s, x_a, x_b, g_a, g_b (q < 2: x_q, -, g_q, -);
//    dpre [16][128] is staged over g_a and g_b, the output rows over a
//    consumed input; dWp_q's step reads x_q (or s) and dpre of all 8
//    warps: warp w adds rows [16 (w % 4), + 16) and columns [64 (w / 4), +
//    64).
__global__ void __launch_bounds__(kThreads, 1)
    ffm_bwd_rows_kernel(const bf16* __restrict__ x1,
                        const bf16* __restrict__ x2,
                        const bf16* __restrict__ s,
                        const bf16* __restrict__ g1,
                        const bf16* __restrict__ g2,
                        const bf16* __restrict__ wp,
                        const float* __restrict__ bp,
                        const bf16* __restrict__ mats,
                        const float* __restrict__ sym,
                        const float* __restrict__ be,
                        const float* __restrict__ lnp, bf16* __restrict__ dx1,
                        bf16* __restrict__ dx2, bf16* __restrict__ ds,
                        float* __restrict__ partial, int n, int chunk) {
  extern __shared__ uint4 smem_u4[];
  bf16* ws = reinterpret_cast<bf16*>(smem_u4);   // [11][MAT]
  bf16* slots = ws + 11 * MAT;                   // [warps][SLOTS][TB]
  float* prm = reinterpret_cast<float*>(slots + kWarps * SLOTS * TB);
  float* csum = prm + 8 * C;                     // [warps][2C]
  const int b = blockIdx.y, q = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // weights: (projection, half) of matrices 0-3 and their biases
  const int wsel[2][4][2] = {{{2, 0}, {-1, 0}, {-1, 1}, {-1, 1}},
                             {{2, 0}, {2, 1}, {0, 1}, {1, 1}}};
  const int(*sel)[2] = wsel[q == 2];
  const int nw = q == 2 ? 4 : 3, nm = q == 2 ? 4 : 2;
  for (int m = 0; m < nw; ++m) {
    const int p = sel[m][0] < 0 ? q : sel[m][0], h = sel[m][1];
    stage_mat(ws + m * MAT, wp + p * C * 2 * C + h * C, 2 * C);
    for (int i = threadIdx.x; i < C; i += kThreads)
      prm[m * C + i] = bp[p * 2 * C + h * C + i];
  }
  for (int m = 0; m < nm; ++m)
    stage_mat(ws + (4 + m) * MAT,
              mats + (int64_t(b) * 4 + (q == 2 ? m : 2 * q + m)) * C * C, C);
  cp_async_commit();
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    prm[4 * C + i] = be[i];                                  // be1, be2
    prm[6 * C + i] = lnp[(i / C) * 2 * C + i % C];           // gamma1, 2
  }
  const float* sq = sym + (int64_t(b) * 3 + q) * C * C;
  for (int i = threadIdx.x; i < C * C / 2; i += kThreads) {
    const int r = (2 * i) / C, c = (2 * i) % C;
    const float2 v = *reinterpret_cast<const float2*>(sq + 2 * i);
    uint32_t hi, mid, lo;
    split3(v.x, v.y, hi, mid, lo);
    *reinterpret_cast<uint32_t*>(ws + 8 * MAT + r * BRS + c) = hi;
    *reinterpret_cast<uint32_t*>(ws + 9 * MAT + r * BRS + c) = mid;
    *reinterpret_cast<uint32_t*>(ws + 10 * MAT + r * BRS + c) = lo;
  }
  for (int i = threadIdx.x; i < kWarps * 2 * C; i += kThreads) csum[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  const int64_t img = int64_t(b) * n * C;
  const int n_begin = blockIdx.x * chunk;
  const int n_end = min(n, n_begin + chunk);
  bf16* mine = slots + warp * SLOTS * TB;
  bf16* dpre = mine + 3 * TB;                    // [16][DRS] over g_a, g_b
  float* my_sums = csum + warp * 2 * C;
  const int xslot = q == 2 ? 0 : 1;              // the tile dWp_q reads
  const int I = warp & 3, h = warp >> 2;
  float red[8][4];
  zero(red);

  for (int base = n_begin; base < n_end; base += STEP) {
    const int row0 = base + WT * warp;
    const bool ok0 = row0 + g < n_end, ok1 = row0 + g + 8 < n_end;
    load_tile(mine, s + img, row0, n_end);
    if (q == 2) {
      load_tile(mine + TB, x1 + img, row0, n_end);
      load_tile(mine + 2 * TB, x2 + img, row0, n_end);
      load_tile(mine + 3 * TB, g1 + img, row0, n_end);
      load_tile(mine + 4 * TB, g2 + img, row0, n_end);
    } else {
      load_tile(mine + TB, (q == 0 ? x1 : x2) + img, row0, n_end);
      load_tile(mine + 3 * TB, (q == 0 ? g1 : g2) + img, row0, n_end);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    uint32_t xa[4][4], ga[4][4], y3[4][4], u[4][4], py[4][4], pu[4][4];
    float acc[8][4], d2[8][4];
    load_a(mine, xa);
    project(xa, ws, prm, y3);
    if (q == 2) {
      // output 1: dh1, then dy3 = dh1 M0^T + dh2 M2^T
      load_a(mine + TB, xa);
      project(xa, ws + 2 * MAT, prm + 2 * C, u);
      zero(acc);
      mma_b<true>(acc, y3, ws + 4 * MAT);
      mma_b<true>(acc, u, ws + 5 * MAT);
      load_a(mine + 3 * TB, ga);
      ln_grad<false>(acc, xa, ga, prm + 4 * C, prm + 6 * C, nullptr);
      zero(d2);
      mma_split<false>(d2, acc, ws + 4 * MAT);
      // output 2
      load_a(mine + 2 * TB, xa);
      project(xa, ws + 3 * MAT, prm + 3 * C, u);
      zero(acc);
      mma_b<true>(acc, y3, ws + 6 * MAT);
      mma_b<true>(acc, u, ws + 7 * MAT);
      load_a(mine + 4 * TB, ga);
      ln_grad<false>(acc, xa, ga, prm + 5 * C, prm + 7 * C, nullptr);
      mma_split<false>(d2, acc, ws + 6 * MAT);
      grad_pre(d2, y3, ok0, ok1, py, my_sums);
      // u3: du3 = u3 S3
      load_a(mine, xa);
      project(xa, ws + MAT, prm + C, u);
      zero(d2);
      mma_pieces(d2, u, ws + 8 * MAT);
      grad_pre(d2, u, ok0, ok1, pu, my_sums + C);
      // ds = dpre3 Wp3^T
      zero(acc);
      mma_b<false>(acc, py, ws);
      mma_b<false>(acc, pu, ws + MAT);
      uint32_t out[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nt = 2 * kk + (j >> 1), r = j & 1;
          out[kk][j] = pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
        }
      store_rows(out, mine + TB, ds + img, row0, n_end);
    } else {
      // output q: dh_q, du_q = dh_q M_{2q+1}^T
      load_a(mine + TB, xa);
      project(xa, ws + 2 * MAT, prm + 2 * C, u);
      zero(acc);
      mma_b<true>(acc, y3, ws + 4 * MAT);
      mma_b<true>(acc, u, ws + 5 * MAT);
      load_a(mine + 3 * TB, ga);
      ln_grad<false>(acc, xa, ga, prm + (4 + q) * C, prm + (6 + q) * C,
                     nullptr);
      uint32_t hres[4][4];   // bf16(dh_q), the residual's gradient
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nt = 2 * kk + (j >> 1), r = j & 1;
          hres[kk][j] = pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
        }
      zero(d2);
      mma_split<false>(d2, acc, ws + 5 * MAT);
      grad_pre(d2, u, ok0, ok1, pu, my_sums + C);
      // y_q: dy_q = y_q S_q
      project(xa, ws + MAT, prm + C, u);
      zero(d2);
      mma_pieces(d2, u, ws + 8 * MAT);
      grad_pre(d2, u, ok0, ok1, py, my_sums);
      // dx_q = bf16(bf16(dpre_q Wp_q^T) + bf16(dh_q))
      zero(acc);
      mma_b<false>(acc, py, ws + MAT);
      mma_b<false>(acc, pu, ws + 2 * MAT);
      uint32_t out[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nt = 2 * kk + (j >> 1), r = j & 1;
          const uint32_t pv = pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
          out[kk][j] = pack_bf16(bf16_lo(pv) + bf16_lo(hres[kk][j]),
                                 bf16_hi(pv) + bf16_hi(hres[kk][j]));
        }
      store_rows(out, mine, (q == 0 ? dx1 : dx2) + img, row0, n_end);
    }
    __syncwarp();   // every lane is done with g_a and g_b
    store_a(dpre, DRS, py);
    store_a(dpre + C, DRS, pu);
    __syncthreads();   // every warp's x and dpre staged

    float part[8][4];
    zero(part);
#pragma unroll 1
    for (int j = 0; j < kWarps; ++j) {
      const bf16* theirs = slots + j * SLOTS * TB;
      uint32_t a[4];
      load_at(a, theirs + xslot * TB, BRS, I);
      mma_tn(part, a, theirs + 3 * TB + h * C, DRS);
    }
    add_to(red, part);
    __syncthreads();   // the tiles are refilled by the next step
  }

  float* dst = partial + ((int64_t(b) * gridDim.x + blockIdx.x) * 3 + q) *
                             ROWS_PER;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(dst + (16 * I + g + 8 * r) * 2 * C + h * C +
                                 8 * nt + 2 * t4) =
          make_float2(red[nt][2 * r], red[nt][2 * r + 1]);
  __syncthreads();   // every warp's column sums
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += csum[w * 2 * C + i];
    dst[2 * C * C + i] = v;
  }
}

// out[b] = sum over chunks (in chunk order) of partial[b][chunk], `per`
// floats each.
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int n_chunks,
                                  int per) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per) return;
  const float* p = partial + int64_t(b) * n_chunks * per + e;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += p[int64_t(c) * per];
  out[int64_t(b) * per + e] = acc;
}

int sum_chunks(const float* partial, float* out, int b, int n_chunks, int per,
               cudaStream_t stream) {
  sum_chunks_kernel<<<dim3((per + 255) / 256, b), 256, 0, stream>>>(
      partial, out, n_chunks, per);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace segmif

extern "C" {

// Pass A'. bf16 tokens x1 x2 s g1 g2 [B][N][64]; wp [3][64][128] bf16; bp
// [3][128] f32; mats [B][4][64][64] bf16; be [2][64], lnp [2][2][64] f32.
// partial: f32 scratch [B][n_chunks][2][RED_PER]; out: f32 [B][2][RED_PER]
// (per output o: dM_{2o}, dM_{2o+1}, sum(dh_o), sum(g_o xhat_o), sum(g_o)).
// chunk is a multiple of 128 and n_chunks = ceil(N / chunk). Returns
// cudaGetLastError().
int segmif_ffm_bwd_reduce(const void* x1, const void* x2, const void* s,
                          const void* g1, const void* g2, const void* wp,
                          const void* bp, const void* mats, const void* be,
                          const void* lnp, void* partial, void* out, int b,
                          int n, int chunk, int n_chunks, int dtype,
                          void* stream) {
  using namespace segmif;
  if (dtype != kBF16 || chunk % STEP != 0 ||
      n_chunks != (n + chunk - 1) / chunk)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(ffm_bwd_reduce_kernel, kReduceSmem);
  if (err != cudaSuccess) return int(err);
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  ffm_bwd_reduce_kernel<<<dim3(n_chunks, b, 2), kThreads, kReduceSmem, st>>>(
      h(x1), h(x2), h(s), h(g1), h(g2), h(wp), f(bp), h(mats), f(be), f(lnp),
      static_cast<float*>(partial), n, chunk);
  const int e = int(cudaGetLastError());
  return e != 0 ? e
                : sum_chunks(static_cast<float*>(partial),
                             static_cast<float*>(out), b, n_chunks,
                             2 * RED_PER, st);
}

// Pass B'. As pass A', with sym [B][3][64][64] f32 (S_i = dG_i + dG_i^T);
// dx1, dx2, ds [B][N][64] bf16; partial: f32 scratch [B][n_chunks][3]
// [ROWS_PER]; out: f32 [B][3][ROWS_PER] (per projection: dWp_i [64][128],
// dbp_i [128]). Returns cudaGetLastError().
int segmif_ffm_bwd_rows(const void* x1, const void* x2, const void* s,
                        const void* g1, const void* g2, const void* wp,
                        const void* bp, const void* mats, const void* sym,
                        const void* be, const void* lnp, void* dx1, void* dx2,
                        void* ds, void* partial, void* out, int b, int n,
                        int chunk, int n_chunks, int dtype, void* stream) {
  using namespace segmif;
  if (dtype != kBF16 || chunk % STEP != 0 ||
      n_chunks != (n + chunk - 1) / chunk)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(ffm_bwd_rows_kernel, kRowsSmem);
  if (err != cudaSuccess) return int(err);
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<bf16*>(p); };
  ffm_bwd_rows_kernel<<<dim3(n_chunks, b, 3), kThreads, kRowsSmem, st>>>(
      h(x1), h(x2), h(s), h(g1), h(g2), h(wp), f(bp), h(mats), f(sym), f(be),
      f(lnp), o(dx1), o(dx2), o(ds), static_cast<float*>(partial), n, chunk);
  const int e = int(cudaGetLastError());
  return e != 0 ? e
                : sum_chunks(static_cast<float*>(partial),
                             static_cast<float*>(out), b, n_chunks,
                             3 * ROWS_PER, st);
}

}  // extern "C"
