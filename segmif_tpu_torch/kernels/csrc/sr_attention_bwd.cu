// Backward of MiT spatially-reduced softmax attention in bf16, for Hopper
// (sm_90a): the gradients of out = softmax(q k^T * scale) v with respect to
// q, k and v, on the tensor cores.
//
// Replaces no TPU kernel: the JAX package's custom_vjp of
// segmif_tpu/kernels/pallas_attention.py:101-119 recomputes the attention
// through XLA, and the port's plain backward differentiated an f32
// recompute of sr_attention_ref under autograd: the [B, H, N, M] logits and
// probabilities materialised in f32 (2 GiB each at MiT-B5's stage 1 at
// 1024x1024, [8, 1, 65536, 1024]) and every product an f32 GEMM on the CUDA
// cores.
//
// Notation, per (batch, head): S = q k^T (f32 sums of exact bf16 products),
// x = S * scale * log2(e), lse2 = log2 sum_m 2^x (the row's log-sum-exp in
// log2 units), P = 2^(x - lse2), dP = dO v^T, D = rowsum(P o dP),
// dS = P o (dP - D); dv = P^T dO, dq = scale dS k, dk = scale dS^T q.
//
// What bounds it on the H100: operations. The function needs five products
// of 2 N M D FLOP per (batch, head) (S, dP, dv, dq, dk): 6.5 TFLOP for the
// 52 calls of a SegFormer-B5 training step at 1024x1024, batch 8, 6.6 ms at
// the bf16 peak. Its bytes (q, k, v and dO read, dq, dk and dv written, once
// each) are about 4.8 GB a step, 1.4 ms. What the design does about that:
// every product on mma.sync m16n8k16 bf16 -> f32 with the operands read
// through shared memory by ldmatrix, nothing the size of [N, M] leaves the
// registers, and the long query axis streams through a two-stage cp.async
// ring while a block keeps its own tile (queries or keys) in place.
//
// Precision: the plain VJP's arithmetic at no lower precision. q, k, v and
// dO enter the products as they are (exact in bf16, so S and dP are f32
// sums of exact products). D is rowsum(P o dP) in f32, as the plain VJP's
// softmax backward sums it (not rowsum(dO o out), which would read the
// output after its rounding to bf16). P and dS enter the dv, dq and dk
// products as hi + lo bf16 pairs (hi = bf16(v), lo = bf16(v - hi)), which
// carry them to about 2^-17 of each, as the forward multiplies P by V. The
// tensor cores add into their accumulator with truncation, so each tile's
// products (8 chained mma) go into a fresh accumulator that is added to the
// running f32 sum by an ordinary add. Every sum over N or M stays in f32
// until the single rounding of dq, dk and dv to bf16. That is about 12
// products' worth of mma work against the function's five: two more for the
// hi + lo halves of each of dv, dq and dk, and two for the sweep that sums
// D and lse2.
//
// Three launches a call, no floating-point atomics: two runs give the same
// bits.
//  - dq pass (segmif_sr_attention_bwd_dq): one block per (64 queries, b*h),
//    four warps of 16 queries, Q and dO in registers (ldmatrix A fragments).
//    K and V stream in 64-key tiles through a two-stage cp.async ring, twice:
//    the first sweep computes S and dP and keeps the online softmax's
//    running max and sum and the running sum of P o dP (rescaled as the max
//    moves), which give lse2 and D at its end; the second sweep computes
//    S and dP again, P = 2^(x - lse2), dS, and dq += dS K. lse2 and D are
//    written for the dkv pass, [B*H, N] f32.
//  - dkv pass (segmif_sr_attention_bwd_dkv, first launch): one block per
//    (64 keys, b*h, chunk of the queries), four warps of 16 keys, K and V
//    staged once. Q, dO and the queries' lse2 and D stream in 64-query
//    tiles through a two-stage ring. Each warp computes S^T = K Q^T and
//    dP^T = V dO^T with the keys as rows, so that P^T and dS^T come out of
//    the accumulators in the A-fragment layout of dv += P^T dO and
//    dk += dS^T Q (no shared-memory trip). The query axis is split into
//    chunks so that the grid holds about four blocks per SM (two waves at
//    two resident blocks) at every stage shape; each block writes its f32
//    partial [chunk][b*h][M][D].
//  - reduce (its second launch): the chunks' partials summed in chunk
//    order, dk scaled, both rounded once to bf16 into [B, M, H, D].
//  - Ragged tiles: keys at index >= M are zero-filled and masked to P = 0;
//    queries past N (or past the block's chunk) are zero-filled, so their
//    dO, dP, D and dS are 0 and they add nothing.
//
// Shapes: q and dO [B, N, H, D], k and v [B, M, H, D], read through their
// batch, token and head strides (the last dim contiguous, rows on 16
// bytes), k and v the strided halves of the kv projection as in the
// forward; dq [B, N, H, D], dk and dv [B, M, H, D] contiguous; D is 32 or
// 64; any N >= 1 and M >= 1.

#include "common.cuh"

namespace segmif {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;  // queries or keys per tile
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 2 * kTile, "a thread copies one lse2 or D value");

template <int D> struct Geo {
  static constexpr int RS = D + 8;       // padded bf16 row
  static constexpr int CPR = D / 8;      // 16-byte chunks per row
  static constexpr int T = kTile * RS;   // one [64][RS] tile
  static constexpr size_t SMEM_DQ = sizeof(bf16) * 6 * T;
  static constexpr size_t SMEM_DKV =
      sizeof(bf16) * 6 * T + sizeof(float) * 2 * 2 * kTile;
};

// Element strides of q, k, v and dO: batch, token, head.
struct Strides {
  int64_t qb, qn, qh, kb, km, kh, vb, vm, vh, gb, gn, gh;
};

// 4-byte async copy; with valid == false the destination is zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Rows [r0, r0 + 64) of a bf16 array with row stride srow into a [64][RS]
// tile; rows at or past `end` zero-filled (nothing is read for them).
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t srow, int r0, int end) {
  using G = Geo<D>;
  for (int i = threadIdx.x; i < kTile * G::CPR; i += kThreads) {
    const int r = i / G::CPR, c = i % G::CPR;
    const bool ok = r0 + r < end;
    cp_async16(dst + r * G::RS + c * 8,
               src + int64_t(ok ? r0 + r : 0) * srow + c * 8, ok);
  }
}

// The 16 x 16 A fragments (hi and lo bf16 halves) of k16 step j from the
// f32 accumulators of n8 tiles 2j and 2j + 1: rows g and g + 8, columns
// 2 t4, 2 t4 + 1 (+ 8).
__device__ __forceinline__ void split_a(float a[][4], int j,
                                        uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const float p0 = a[2 * j + (f >> 1)][2 * (f & 1)];
    const float p1 = a[2 * j + (f >> 1)][2 * (f & 1) + 1];
    hi[f] = pack_bf16(p0, p1);
    lo[f] = pack_bf16(p0 - bf16_lo(hi[f]), p1 - bf16_hi(hi[f]));
  }
}

// part = (A_hi + A_lo) B over the 64 columns of A's accumulators (the k
// axis), B a [64][RS] tile stored [k][n] and read by ldmatrix.trans; the
// sum of each tile starts from zero (see "Precision").
template <int D>
__device__ __forceinline__ void product_hi_lo(float part[][4],
                                              float a[][4],
                                              const bf16* bt, int vb_row,
                                              int vb_col) {
  constexpr int RS = Geo<D>::RS, DN = D / 8;
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[i][c] = 0.f;
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) {
    uint32_t hi[4], lo[4];
    split_a(a, j, hi, lo);
#pragma unroll
    for (int dp = 0; dp < DN / 2; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, bt + (j * 16 + vb_row) * RS + dp * 16 + vb_col);
      mma_bf16(part[2 * dp], lo, bf[0], bf[1]);
      mma_bf16(part[2 * dp], hi, bf[0], bf[1]);
      mma_bf16(part[2 * dp + 1], lo, bf[2], bf[3]);
      mma_bf16(part[2 * dp + 1], hi, bf[2], bf[3]);
    }
  }
}

// acc[n8 tile][4] = A B^T over D: A fragments in registers, B a [64][RS]
// tile stored [n][k] (ldmatrix, not transposed); 64 columns.
template <int D>
__device__ __forceinline__ void product_abt(float acc[][4],
                                            uint32_t af[][4],
                                            const bf16* bt, int kb_row,
                                            int kb_col) {
  constexpr int RS = Geo<D>::RS;
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, bt + (np * 16 + kb_row) * RS + kk * 16 + kb_col);
      mma_bf16(acc[2 * np], af[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af[kk], bf[2], bf[3]);
    }
}

// ------------------------------------------------------------ the dq pass

// Lane (g, t4) = (lane / 4, lane % 4) of a warp holds rows g and g + 8 of
// its 16 queries: S, dP and dq accumulator element c of an n8 tile is row
// g + 8 (c / 2), column 2 t4 + c % 2.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    sra_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ go,
                      bf16* __restrict__ dq, float* __restrict__ lse2_out,
                      float* __restrict__ delta_out, int n, int m,
                      int h_count, Strides st, float scale,
                      float scale_log2) {
  using G = Geo<D>;
  constexpr int RS = G::RS, CPR = G::CPR;
  constexpr int DK = D / 16, DN = D / 8, KN = kTile / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);  // [64][RS] Q
  bf16* gs = qs + G::T;                         // [64][RS] dO
  bf16* ring = gs + G::T;                       // [2][K, V][64][RS]

  const int bh = blockIdx.y;
  const int b = bh / h_count, h = bh % h_count;
  const int q0 = blockIdx.x * kTile;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  load_rows<D>(qs, q + b * st.qb + h * st.qh, st.qn, q0, n);
  load_rows<D>(gs, go + b * st.gb + h * st.gh, st.gn, q0, n);
  load_rows<D>(ring, kb, st.km, 0, m);
  load_rows<D>(ring + G::T, vb, st.vm, 0, m);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix row addresses: A rows; B stored [n][k]; B stored [k][n]
  // through .trans
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_col = ((lane >> 3) & 1) * 8;
  const int vb_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int vb_col = (lane >> 4) * 8;

  uint32_t qf[DK][4], gf[DK][4];
  float dqa[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dqa[i][c] = 0.f;
  // first sweep: running max, sum of 2^(x - max), sum of 2^(x - max) dP;
  // then lse2 and D
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  float drow[2] = {0.f, 0.f}, lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};

  const int tiles = (m + kTile - 1) / kTile;
  for (int it = 0; it < 2 * tiles; ++it) {
    const int tile = it < tiles ? it : it - tiles;
    if (it + 1 < 2 * tiles) {
      const int next = it + 1 < tiles ? it + 1 : it + 1 - tiles;
      bf16* stage = ring + ((it + 1) & 1) * 2 * G::T;
      load_rows<D>(stage, kb, st.km, next * kTile, m);
      load_rows<D>(stage + G::T, vb, st.vm, next * kTile, m);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        ldmatrix_x4(qf[kk], qs + (warp * 16 + a_row) * RS + kk * 16 + a_col);
        ldmatrix_x4(gf[kk], gs + (warp * 16 + a_row) * RS + kk * 16 + a_col);
      }
    }
    const bf16* ks = ring + (it & 1) * 2 * G::T;
    const bf16* vs = ks + G::T;

    float s[KN][4], dp[KN][4];
    product_abt<D>(s, qf, ks, kb_row, kb_col);   // S = Q K^T
    product_abt<D>(dp, gf, vs, kb_row, kb_col);  // dP = dO V^T

    // scaled logits in log2 units; keys past m masked to -inf
    const bool ragged = (tile + 1) * kTile > m;
#pragma unroll
    for (int i = 0; i < KN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[i][c] * scale_log2;
        if (ragged && tile * kTile + i * 8 + 2 * t4 + (c & 1) >= m)
          x = -INFINITY;
        s[i][c] = x;
      }

    if (it < tiles) {
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int i = 0; i < KN; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[i][c]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // key 0 is in tile 0, so mx is finite from the first tile on
        const float alpha = exp2f(mrow[r] - mx[r]);
        mrow[r] = mx[r];
        lrow[r] *= alpha;
        drow[r] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < KN; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp2f(s[i][c] - mx[c >> 1]);
          lrow[c >> 1] += p;  // this lane's columns; the quad sums below
          drow[c >> 1] = fmaf(p, dp[i][c], drow[c >> 1]);
        }
      if (it == tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float l = lrow[r], d = drow[r];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          lse2[r] = mrow[r] + log2f(l);
          dlt[r] = d / l;
          const int qi = q0 + warp * 16 + g + 8 * r;
          if (t4 == 0 && qi < n) {
            lse2_out[int64_t(bh) * n + qi] = lse2[r];
            delta_out[int64_t(bh) * n + qi] = dlt[r];
          }
        }
      }
    } else {
      // dS = P (dP - D) with P = 2^(x - lse2); dq += dS K
#pragma unroll
      for (int i = 0; i < KN; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[i][c] = exp2f(s[i][c] - lse2[c >> 1]) * (dp[i][c] - dlt[c >> 1]);
      float part[DN][4];
      product_hi_lo<D>(part, s, ks, vb_row, vb_col);
#pragma unroll
      for (int i = 0; i < DN; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) dqa[i][c] += part[i][c];
    }
    __syncthreads();  // the stage is refilled two tiles on
  }

  // dq = scale * sum, rounded once, staged in this warp's Q rows and stored
  // in 16-byte rows
  bf16* stage = qs + warp * 16 * RS;
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * r) * RS + i * 8 + 2 * t4) =
          pack_bf16(dqa[i][2 * r] * scale, dqa[i][2 * r + 1] * scale);
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    const int qi = q0 + warp * 16 + r;
    if (qi < n)
      *reinterpret_cast<uint4*>(dq + ((int64_t(b) * n + qi) * h_count + h) *
                                         D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * RS + c * 8);
  }
}

// ----------------------------------------------------------- the dkv pass

// Lane (g, t4) holds rows (keys) g and g + 8 of its warp's 16 keys: S^T,
// dP^T, dk and dv accumulator element c of an n8 tile is key g + 8 (c / 2),
// column (query, or head dim) 2 t4 + c % 2.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    sra_bwd_dkv_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ go,
                       const float* __restrict__ lse2,
                       const float* __restrict__ delta,
                       float* __restrict__ partial, int n, int m,
                       int h_count, int chunk, Strides st,
                       float scale_log2) {
  using G = Geo<D>;
  constexpr int RS = G::RS;
  constexpr int DK = D / 16, DN = D / 8, KN = kTile / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* ks = reinterpret_cast<bf16*>(smem_u4);  // [64][RS] K
  bf16* vs = ks + G::T;                         // [64][RS] V
  bf16* ring = vs + G::T;                       // [2][Q, dO][64][RS]
  float* stats = reinterpret_cast<float*>(ring + 4 * G::T);  // [2][2][64]

  const int bh = blockIdx.y;
  const int b = bh / h_count, h = bh % h_count;
  const int k0 = blockIdx.x * kTile;
  const int n0 = blockIdx.z * chunk;
  const int n1 = min(n, n0 + chunk);
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* gb = go + b * st.gb + h * st.gh;
  const float* lb = lse2 + int64_t(bh) * n;
  const float* db = delta + int64_t(bh) * n;
  const int sel = threadIdx.x / kTile, si = threadIdx.x % kTile;
  const float* stat_src = sel ? db : lb;

  load_rows<D>(ks, k + b * st.kb + h * st.kh, st.km, k0, m);
  load_rows<D>(vs, v + b * st.vb + h * st.vh, st.vm, k0, m);
  load_rows<D>(ring, qb, st.qn, n0, n1);
  load_rows<D>(ring + G::T, gb, st.gn, n0, n1);
  cp_async4(stats + sel * kTile + si, stat_src + (n0 + si < n1 ? n0 + si : 0),
            n0 + si < n1);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_col = ((lane >> 3) & 1) * 8;
  const int vb_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int vb_col = (lane >> 4) * 8;
  // this lane's keys past m (a ragged last key tile) take P = 0
  const bool key_out[2] = {k0 + warp * 16 + g >= m,
                           k0 + warp * 16 + g + 8 >= m};

  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int tiles = (n1 - n0 + kTile - 1) / kTile;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      const int r0 = n0 + (it + 1) * kTile;
      bf16* stage = ring + ((it + 1) & 1) * 2 * G::T;
      load_rows<D>(stage, qb, st.qn, r0, n1);
      load_rows<D>(stage + G::T, gb, st.gn, r0, n1);
      cp_async4(stats + ((it + 1) & 1) * 2 * kTile + sel * kTile + si,
                stat_src + (r0 + si < n1 ? r0 + si : 0), r0 + si < n1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = ring + (it & 1) * 2 * G::T;
    const bf16* gs = qs + G::T;
    const float* ls = stats + (it & 1) * 2 * kTile;
    const float* ds = ls + kTile;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and the tile's
    // 64 queries; K's and V's A fragments reloaded each tile
    float sT[KN][4], dpT[KN][4];
    {
      uint32_t af[DK][4];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldmatrix_x4(af[kk], ks + (warp * 16 + a_row) * RS + kk * 16 + a_col);
      product_abt<D>(sT, af, qs, kb_row, kb_col);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldmatrix_x4(af[kk], vs + (warp * 16 + a_row) * RS + kk * 16 + a_col);
      product_abt<D>(dpT, af, gs, kb_row, kb_col);
    }

    // P^T = 2^(x - lse2), dS^T = P^T (dP^T - D); column 2 t4 + (c & 1) of
    // n8 tile i is query i * 8 + 2 t4 + (c & 1) of the tile
#pragma unroll
    for (int i = 0; i < KN; ++i) {
      const float2 lq = *reinterpret_cast<const float2*>(ls + i * 8 + 2 * t4);
      const float2 dl = *reinterpret_cast<const float2*>(ds + i * 8 + 2 * t4);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p =
            key_out[c >> 1]
                ? 0.f
                : exp2f(sT[i][c] * scale_log2 - ((c & 1) ? lq.y : lq.x));
        sT[i][c] = p;
        dpT[i][c] = p * (dpT[i][c] - ((c & 1) ? dl.y : dl.x));
      }
    }

    float part[DN][4];
    product_hi_lo<D>(part, sT, gs, vb_row, vb_col);  // dv += P^T dO
#pragma unroll
    for (int i = 0; i < DN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dva[i][c] += part[i][c];
    product_hi_lo<D>(part, dpT, qs, vb_row, vb_col);  // dk += dS^T Q
#pragma unroll
    for (int i = 0; i < DN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dka[i][c] += part[i][c];
    __syncthreads();  // the stage is refilled two tiles on
  }

  // this block's partials: [dk, dv][chunk][b*h][m][D] f32
  const int64_t per = int64_t(gridDim.y) * m * D;  // one chunk's, one tensor
  float* pk = partial + (int64_t(blockIdx.z) * gridDim.y + bh) * m * D;
  float* pv = pk + int64_t(gridDim.z) * per;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key_out[r]) continue;
    const int64_t row = int64_t(k0 + warp * 16 + g + 8 * r) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      *reinterpret_cast<float2*>(pk + row + dn * 8) =
          make_float2(dka[dn][2 * r], dka[dn][2 * r + 1]);
      *reinterpret_cast<float2*>(pv + row + dn * 8) =
          make_float2(dva[dn][2 * r], dva[dn][2 * r + 1]);
    }
  }
}

// The chunks' partials summed in chunk order, dk times scale, both rounded
// once to bf16 into [B, M, H, D]: four elements a thread.
__global__ void __launch_bounds__(256)
    sra_bwd_reduce_kernel(const float* __restrict__ partial,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int chunks, int bh_count, int m, int h_count, int d,
                          float scale) {
  const int64_t per = int64_t(bh_count) * m * d;
  const int64_t quads = 2 * per / 4;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < quads;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int which = i >= per / 4;  // 0: dk, 1: dv
    const int64_t e = (i - which * (per / 4)) * 4;
    const float* src = partial + which * chunks * per + e;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int c = 1; c < chunks; ++c) {
      const float4 t = *reinterpret_cast<const float4*>(src + c * per);
      acc.x += t.x;
      acc.y += t.y;
      acc.z += t.z;
      acc.w += t.w;
    }
    const float f = which ? 1.f : scale;
    const int64_t bh = e / (int64_t(m) * d), rem = e % (int64_t(m) * d);
    const int64_t key = rem / d, dd = rem % d;
    const int64_t b = bh / h_count, h = bh % h_count;
    bf16* dst = (which ? dv : dk) + ((b * m + key) * h_count + h) * d + dd;
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16(acc.x * f, acc.y * f),
                   pack_bf16(acc.z * f, acc.w * f));
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* go,
              void* dq, void* lse2, void* delta, int b, int n, int m, int h,
              const Strides& st, float scale, cudaStream_t stream) {
  auto kern = sra_bwd_dq_kernel<D>;
  cudaError_t err = allow_smem(kern, Geo<D>::SMEM_DQ);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + kTile - 1) / kTile, b * h);
  kern<<<grid, kThreads, Geo<D>::SMEM_DQ, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(go),
      static_cast<bf16*>(dq), static_cast<float*>(lse2),
      static_cast<float*>(delta), n, m, h, st, scale, scale * kLog2e);
  return int(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* go,
               const void* lse2, const void* delta, void* partial, void* dk,
               void* dv, int b, int n, int m, int h, int chunk, int nchunk,
               const Strides& st, float scale, cudaStream_t stream) {
  auto kern = sra_bwd_dkv_kernel<D>;
  cudaError_t err = allow_smem(kern, Geo<D>::SMEM_DKV);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((m + kTile - 1) / kTile, b * h, nchunk);
  kern<<<grid, kThreads, Geo<D>::SMEM_DKV, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(go),
      static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<float*>(partial), n, m, h, chunk, st, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int64_t quads = int64_t(b) * h * m * D / 2;  // 2 tensors / 4
  const int64_t want = (quads + 255) / 256;
  const int blocks = int(want < 8192 ? want : 8192);
  sra_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), nchunk, b * h, m, h, D, scale);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace segmif

extern "C" {

// q/k/v/go (dO): bf16 device pointers, strides in elements (batch, token,
// head), rows on 16 bytes; dq [B, N, H, D] bf16 and lse2, delta [B*H, N]
// f32 written; stream: a cudaStream_t. Returns cudaGetLastError().
int segmif_sr_attention_bwd_dq(const void* q, const void* k, const void* v,
                               const void* go, void* dq, void* lse2,
                               void* delta, int b, int n, int m, int h,
                               int d, int64_t sqb, int64_t sqn, int64_t sqh,
                               int64_t skb, int64_t skm, int64_t skh,
                               int64_t svb, int64_t svm, int64_t svh,
                               int64_t sgb, int64_t sgn, int64_t sgh,
                               float scale, void* stream) {
  using namespace segmif;
  if (n < 1 || m < 1) return int(cudaErrorInvalidValue);
  const Strides st{sqb, sqn, sqh, skb, skm, skh, svb, svm, svh, sgb, sgn, sgh};
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq<64>(q, k, v, go, dq, lse2, delta, b, n, m, h, st, scale,
                         s);
  if (d == 32)
    return launch_dq<32>(q, k, v, go, dq, lse2, delta, b, n, m, h, st, scale,
                         s);
  return int(cudaErrorInvalidValue);
}

// As segmif_sr_attention_bwd_dq's, and lse2, delta read; partial: f32
// scratch [2][nchunk][B*H][M][D]; dk, dv [B, M, H, D] bf16 written; chunk:
// the queries a block takes, a multiple of 64, nchunk = ceil(N / chunk).
// Two launches.
int segmif_sr_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* go, const void* lse2,
                                const void* delta, void* partial, void* dk,
                                void* dv, int b, int n, int m, int h, int d,
                                int chunk, int nchunk, int64_t sqb,
                                int64_t sqn, int64_t sqh, int64_t skb,
                                int64_t skm, int64_t skh, int64_t svb,
                                int64_t svm, int64_t svh, int64_t sgb,
                                int64_t sgn, int64_t sgh, float scale,
                                void* stream) {
  using namespace segmif;
  if (n < 1 || m < 1 || chunk < 1 || chunk % kTile ||
      nchunk != (n + chunk - 1) / chunk)
    return int(cudaErrorInvalidValue);
  const Strides st{sqb, sqn, sqh, skb, skm, skh, svb, svm, svh, sgb, sgn, sgh};
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv<64>(q, k, v, go, lse2, delta, partial, dk, dv, b, n, m,
                          h, chunk, nchunk, st, scale, s);
  if (d == 32)
    return launch_dkv<32>(q, k, v, go, lse2, delta, partial, dk, dv, b, n, m,
                          h, chunk, nchunk, st, scale, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
