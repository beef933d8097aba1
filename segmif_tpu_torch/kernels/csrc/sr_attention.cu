// MiT spatially-reduced softmax attention, forward, for Hopper (sm_90a).
//
// Replaces: segmif_tpu/kernels/pallas_attention.py, _sr_attention_fwd_impl
// (kernel _sr_attn_kernel): out = softmax(q k^T * scale) v per (batch, head)
// with f32 logits and an f32 probability-value product. The TPU kernel holds
// the whole K/V block in VMEM and makes one pass; a Hopper block has 227 KB
// of shared memory, so K/V stream through it here instead.
//
// Shapes: q [B,N,H,D], k/v [B,M,H,D], read in place through their batch,
// token and head strides (the last dim contiguous), so the TPU wrapper's
// transposes and pads are not needed; k and v are the strided halves of
// the kv projection. out [B,N,H,D] contiguous. D is 32 or 64. At 480x640
// every mit_b3 stage has M = 300 and D = 64; at 1080p, M = 1980.
//
// What bounds it on the H100: in bf16 the bytes (q, k, v and out, a few
// MB at mit_b3's shapes) over the memory rate, about 0.026 ms for the four
// stage shapes; the 4*N*M*D FLOP take less at the bf16 tensor-core peak.
// In f32, 3xTF32 makes it 3 x 4*N*M*D TF32 FLOP, 0.139 ms at the TF32
// peak. In practice the issue of instructions bounds both: the mma.sync,
// the exponentials and the per-tile softmax bookkeeping, in f32 also the
// split of every K and V value each warp loads; at the small stage-4 grid
// (320 blocks) the latency of five dependent key tiles per block.
//
// bf16 (the serving dtype): the FlashAttention-2 structure on mma.sync.
//  - One block per (64 queries, b*h), four warps of 16 queries, three
//    blocks per SM (159 registers, no spills). Q goes through shared
//    memory once (cp.async) and into registers (ldmatrix).
//  - K and V stream in tiles of 64 keys through a two-stage cp.async ring
//    of bf16 rows padded by 16 bytes (ldmatrix is free of bank conflicts).
//    Shared memory does not depend on M: any M >= 1 is taken. Keys at
//    index >= M (the ragged last tile) are zero-filled and masked to -inf.
//  - S = Q K^T with mma.sync m16n8k16 bf16 -> f32: products of bf16 inputs
//    are exact, so these are the TPU kernel's f32 logits up to sum order.
//    The scale and log2(e) are folded into one multiply; the online
//    softmax (running row max and sum, exp2f) stays in registers.
//  - P V at f32 accuracy: the TPU kernel multiplies f32 p by f32 v. P is
//    split into P_hi + P_lo, both bf16, taken from the S accumulators in
//    the A-fragment layout (no shared-memory trip), and both are
//    multiplied by V (exact in bf16, read by ldmatrix.trans): the product
//    matches f32 to about 2^-17 relative, for 1.5x the mma work of a
//    bf16-P kernel.
//  - The output is divided by the row sum, rounded to bf16 once, staged in
//    the warp's Q rows and stored in 16-byte rows.
//
// f32 (what compute_dtype float32 runs: the f32 trainer, forward and
// checks): the same FlashAttention-2 structure on mma.sync m16n8k8 .tf32
// as 3xTF32 (common.cuh, split_tf32): each f32 operand a = big + small,
// both TF32, and every product as big*big + big*small + small*big in f32
// accumulators, about 2^-21 of the product. One TF32 product (2^-11) does
// not hold the f32 tolerance of 1e-5: on the H100, Q rounded to TF32 (the
// small*big product dropped) reads 37.5x the limit at mit_b3's stage 2,
// where this kernel reads 0.25 of it and SDPA's own f32 path 0.22.
//  - One block per (64 queries, b*h), four warps of 16 queries, two blocks
//    per SM. Q is staged once (cp.async); its A fragments stay in
//    registers as f32 and are split at each k8 step (holding both halves
//    made ptxas spill at D = 64).
//  - K and V stream in tiles of 64 keys through a two-stage cp.async ring
//    of f32 rows of D + 4 floats: the fragment loads of K (key g, dim t)
//    and of V (key 2t, dim g) fall in 32 distinct banks. Each warp splits
//    the K and V values it loads. Any M >= 1; keys past M masked to -inf.
//  - S = Q K^T from three products per k8 step; the online softmax as in
//    bf16 (scale * log2(e) folded into one multiply, exp2f, registers).
//  - Sums: the tensor cores add a product into their accumulator with
//    truncation, so a chain of mma on one accumulator drifts by about an
//    ulp of the running sum per mma (measured: within 0.81 of the f32
//    limit at M = 1980 so). Each k8 step's three products go into a fresh
//    accumulator, added to the running S or O in f32 (round to nearest).
//  - P V: the m16n8k8 tf32 A fragment takes columns t and t + 4 where the
//    S accumulators hold columns 2t and 2t + 1. A product sums over its k
//    in any order, so k = t stands for key 2t and k = t + 4 for key
//    2t + 1, in P's fragment and in V's rows alike: P is split straight
//    from the S accumulators, with no shuffle and no shared-memory trip.
//  - The output is divided by the row sum and stored as f32 pairs.

#include "common.cuh"

namespace segmif {
namespace {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kQTile = 16 * kMmaWarps;  // queries per block
constexpr int kKTile = 64;              // keys per streamed tile
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------- f32, tensor cores, 3xTF32

template <int D> struct TfGeo {
  static constexpr int RS = D + 4;        // padded f32 row (floats)
  static constexpr int CPR = D / 4;       // 16-byte chunks per row
  static constexpr int KV = kKTile * RS;  // one K or V tile
  static constexpr size_t SMEM = sizeof(float) * (kQTile * RS + 2 * 2 * KV);
};

// Keys [tile * 64, tile * 64 + 64) of K and V into one ring stage; rows at
// or past m are zero-filled (nothing is read for them).
template <int D>
__device__ __forceinline__ void load_kv_f32(float* stage, const float* kb,
                                            const float* vb, int64_t skm,
                                            int64_t svm, int tile, int m) {
  using Gt = TfGeo<D>;
  for (int i = threadIdx.x; i < kKTile * Gt::CPR; i += kMmaThreads) {
    const int r = i / Gt::CPR, c = i % Gt::CPR;
    const int j = tile * kKTile + r;
    const bool ok = j < m;
    const int64_t jj = ok ? j : 0;
    cp_async16(stage + r * Gt::RS + c * 4, kb + jj * skm + c * 4, ok);
    cp_async16(stage + Gt::KV + r * Gt::RS + c * 4, vb + jj * svm + c * 4,
               ok);
  }
}

// Lane (g, t4) of a warp holds rows g and g + 8 of its 16 queries; S and O
// accumulator element c of an n8 tile is row g + 8 (c / 2), column
// 2 t4 + c % 2 (as in the bf16 kernel).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
    sr_attention_kernel_tf32(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ out, int n, int m,
                             int h_count, int64_t sqb, int64_t sqn,
                             int64_t sqh, int64_t skb, int64_t skm,
                             int64_t skh, int64_t svb, int64_t svm,
                             int64_t svh, float scale_log2) {
  using Gt = TfGeo<D>;
  constexpr int RS = Gt::RS, CPR = Gt::CPR;
  constexpr int DK = D / 8;       // k8 steps over the head dim
  constexpr int DN = D / 8;       // n8 tiles of the output
  constexpr int KN = kKTile / 8;  // n8 tiles of a logit tile
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // [kQTile][RS]
  float* ring = qs + kQTile * RS;                 // [2][K, V][kKTile][RS]

  const int bh = blockIdx.y;
  const int b = bh / h_count, h = bh % h_count;
  const int q0 = blockIdx.x * kQTile;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  for (int i = threadIdx.x; i < kQTile * CPR; i += kMmaThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = q0 + r < n;
    cp_async16(qs + r * RS + c * 4,
               qb + int64_t(ok ? q0 + r : 0) * sqn + c * 4, ok);
  }
  load_kv_f32<D>(ring, kb, vb, skm, svm, 0, m);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float qf[DK][4];  // Q's A fragments, split at each use
  float o[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  const int tiles = (m + kKTile - 1) / kKTile;
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      load_kv_f32<D>(ring + ((tile + 1) & 1) * 2 * Gt::KV, kb, vb, skm, svm,
                     tile + 1, m);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tile == 0) {
      const float* qw = qs + warp * 16 * RS;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        qf[kk][0] = qw[g * RS + 8 * kk + t4];
        qf[kk][1] = qw[(g + 8) * RS + 8 * kk + t4];
        qf[kk][2] = qw[g * RS + 8 * kk + t4 + 4];
        qf[kk][3] = qw[(g + 8) * RS + 8 * kk + t4 + 4];
      }
    }
    const float* ks = ring + (tile & 1) * 2 * Gt::KV;
    const float* vs = ks + Gt::KV;

    // S = Q K^T for this warp's 16 queries and the tile's 64 keys: B is
    // K^T, b0 = K[key g][dim t], b1 = K[key g][dim t + 4]
    float s[KN][4];
#pragma unroll
    for (int i = 0; i < KN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qbig[4], qsmall[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) split_tf32(qf[kk][f], qbig[f], qsmall[f]);
#pragma unroll
      for (int nt = 0; nt < KN; ++nt) {
        const float* kr = ks + (nt * 8 + g) * RS + 8 * kk + t4;
        uint32_t b0, b0s, b1, b1s;
        split_tf32(kr[0], b0, b0s);
        split_tf32(kr[4], b1, b1s);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, qsmall, b0, b1);
        mma_tf32(part, qbig, b0s, b1s);
        mma_tf32(part, qbig, b0, b1);
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] += part[c];
      }
    }

    // scaled logits in log2 units; keys past m masked to -inf
    const bool ragged = (tile + 1) * kKTile > m;
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int i = 0; i < KN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[i][c] * scale_log2;
        if (ragged && tile * kKTile + i * 8 + 2 * t4 + (c & 1) >= m)
          x = -INFINITY;
        s[i][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 is in tile 0, so mx is finite from the first tile on
      alpha[r] = exp2f(mrow[r] - mx[r]);
      mrow[r] = mx[r];
      lrow[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < DN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] *= alpha[c >> 1];
#pragma unroll
    for (int i = 0; i < KN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[i][c] - mx[c >> 1]);
        s[i][c] = p;
        lrow[c >> 1] += p;  // this lane's columns; the quad sums at the end
      }

    // O += P V over the tile's eight 8-key groups; k = t is key 2t and
    // k = t + 4 key 2t + 1 of the group: a = (P[g][2t], P[g + 8][2t],
    // P[g][2t + 1], P[g + 8][2t + 1]), b0 = V[2t][dim g], b1 = V[2t + 1][g]
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      uint32_t pbig[4], psmall[4];
      split_tf32(s[j][0], pbig[0], psmall[0]);
      split_tf32(s[j][2], pbig[1], psmall[1]);
      split_tf32(s[j][1], pbig[2], psmall[2]);
      split_tf32(s[j][3], pbig[3], psmall[3]);
      const float* vr = vs + (j * 8 + 2 * t4) * RS + g;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b0s, b1, b1s;
        split_tf32(vr[dn * 8], b0, b0s);
        split_tf32(vr[RS + dn * 8], b1, b1s);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, psmall, b0, b1);
        mma_tf32(part, pbig, b0s, b1s);
        mma_tf32(part, pbig, b0, b1);
#pragma unroll
        for (int c = 0; c < 4; ++c) o[dn][c] += part[c];
      }
    }
    __syncthreads();  // the stage is refilled two tiles on
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = lrow[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= n) continue;
    float* op = out + ((int64_t(b) * n + qi) * h_count + h) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<float2*>(op + dn * 8) =
          make_float2(o[dn][2 * r] * inv[r], o[dn][2 * r + 1] * inv[r]);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int n, int m, int h, int64_t sqb, int64_t sqn, int64_t sqh,
               int64_t skb, int64_t skm, int64_t skh, int64_t svb,
               int64_t svm, int64_t svh, float scale, cudaStream_t stream) {
  if (m < 1) return int(cudaErrorInvalidValue);
  auto kern = sr_attention_kernel_tf32<D>;
  cudaError_t err = allow_smem(kern, TfGeo<D>::SMEM);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + kQTile - 1) / kQTile, b * h);
  kern<<<grid, kMmaThreads, TfGeo<D>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, m, h, sqb,
      sqn, sqh, skb, skm, skh, svb, svm, svh, scale * kLog2e);
  return int(cudaGetLastError());
}

// ------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;

template <int D> struct MmaGeo {
  static constexpr int RS = D + 8;       // padded bf16 row
  static constexpr int CPR = D / 8;      // 16-byte chunks per row
  static constexpr int KV = kKTile * RS;  // one K or V tile
  static constexpr size_t SMEM = sizeof(bf16) * (kQTile * RS + 2 * 2 * KV);
};

// Keys [tile * 64, tile * 64 + 64) of K and V into one ring stage; rows at
// or past m are zero-filled (nothing is read for them).
template <int D>
__device__ __forceinline__ void load_kv(bf16* stage, const bf16* kb,
                                        const bf16* vb, int64_t skm,
                                        int64_t svm, int tile, int m) {
  using Gm = MmaGeo<D>;
  for (int i = threadIdx.x; i < kKTile * Gm::CPR; i += kMmaThreads) {
    const int r = i / Gm::CPR, c = i % Gm::CPR;
    const int j = tile * kKTile + r;
    const bool ok = j < m;
    const int64_t jj = ok ? j : 0;
    cp_async16(stage + r * Gm::RS + c * 8, kb + jj * skm + c * 8, ok);
    cp_async16(stage + Gm::KV + r * Gm::RS + c * 8, vb + jj * svm + c * 8,
               ok);
  }
}

// Lane (g, t4) = (lane / 4, lane % 4) of a warp holds rows g and g + 8 of
// its 16 queries: S and O accumulator element c of an n8 tile is row
// g + 8 * (c / 2), column 2 * t4 + c % 2.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 3)
    sr_attention_kernel_mma(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            bf16* __restrict__ out, int n, int m,
                            int h_count, int64_t sqb, int64_t sqn,
                            int64_t sqh, int64_t skb, int64_t skm,
                            int64_t skh, int64_t svb, int64_t svm,
                            int64_t svh, float scale_log2) {
  using Gm = MmaGeo<D>;
  constexpr int RS = Gm::RS, CPR = Gm::CPR;
  constexpr int DK = D / 16;      // k16 steps over the head dim
  constexpr int DN = D / 8;       // n8 tiles of the output
  constexpr int KN = kKTile / 8;  // n8 tiles of a logit tile
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);  // [kQTile][RS]
  bf16* ring = qs + kQTile * RS;                // [2][K, V][kKTile][RS]

  const int bh = blockIdx.y;
  const int b = bh / h_count, h = bh % h_count;
  const int q0 = blockIdx.x * kQTile;
  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + h * skh;
  const bf16* vb = v + b * svb + h * svh;
  for (int i = threadIdx.x; i < kQTile * CPR; i += kMmaThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = q0 + r < n;
    cp_async16(qs + r * RS + c * 8, qb + int64_t(ok ? q0 + r : 0) * sqn + c * 8,
               ok);
  }
  load_kv<D>(ring, kb, vb, skm, svm, 0, m);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  // ldmatrix row addresses: A (Q) rows, B (K, [n][k]) rows, B (V, [k][n])
  // rows through .trans
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_col = ((lane >> 3) & 1) * 8;
  const int vb_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int vb_col = (lane >> 4) * 8;

  uint32_t qf[DK][4];
  float o[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  const int tiles = (m + kKTile - 1) / kKTile;
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      load_kv<D>(ring + ((tile + 1) & 1) * 2 * Gm::KV, kb, vb, skm, svm,
                 tile + 1, m);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + a_row) * RS + kk * 16 + a_col);
    }
    const bf16* ks = ring + (tile & 1) * 2 * Gm::KV;
    const bf16* vs = ks + Gm::KV;

    // S = Q K^T for this warp's 16 queries and the tile's 64 keys
    float s[KN][4];
#pragma unroll
    for (int i = 0; i < KN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int np = 0; np < KN / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (np * 16 + kb_row) * RS + kk * 16 + kb_col);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scaled logits in log2 units; keys past m masked to -inf
    const bool ragged = (tile + 1) * kKTile > m;
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int i = 0; i < KN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[i][c] * scale_log2;
        if (ragged && tile * kKTile + i * 8 + 2 * t4 + (c & 1) >= m)
          x = -INFINITY;
        s[i][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 is in tile 0, so mx is finite from the first tile on
      alpha[r] = exp2f(mrow[r] - mx[r]);
      mrow[r] = mx[r];
      lrow[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < DN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] *= alpha[c >> 1];
#pragma unroll
    for (int i = 0; i < KN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[i][c] - mx[c >> 1]);
        s[i][c] = p;
        lrow[c >> 1] += p;  // this lane's columns; the quad sums at the end
      }

    // O += (P_hi + P_lo) V; the accumulators of key tiles 2j, 2j+1 are
    // the A fragment of k16 step j
#pragma unroll
    for (int j = 0; j < kKTile / 16; ++j) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float p0 = s[2 * j + (f >> 1)][2 * (f & 1)];
        const float p1 = s[2 * j + (f >> 1)][2 * (f & 1) + 1];
        hi[f] = pack_bf16(p0, p1);
        lo[f] = pack_bf16(p0 - bf16_lo(hi[f]), p1 - bf16_hi(hi[f]));
      }
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + (j * 16 + vb_row) * RS + dp * 16 + vb_col);
        mma_bf16(o[2 * dp], lo, bf[0], bf[1]);
        mma_bf16(o[2 * dp], hi, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], lo, bf[2], bf[3]);
        mma_bf16(o[2 * dp + 1], hi, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the stage is refilled two tiles on
  }

  // divide by the row sums, round once, stage in this warp's Q rows and
  // store 16-byte rows
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = lrow[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
  bf16* stage = qs + warp * 16 * RS;
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * r) * RS + i * 8 + 2 * t4) =
          pack_bf16(o[i][2 * r] * inv[r], o[i][2 * r + 1] * inv[r]);
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    const int qi = q0 + warp * 16 + r;
    if (qi < n)
      *reinterpret_cast<uint4*>(out + ((int64_t(b) * n + qi) * h_count + h) *
                                          D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * RS + c * 8);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int b, int n, int m, int h, int64_t sqb, int64_t sqn,
                int64_t sqh, int64_t skb, int64_t skm, int64_t skh,
                int64_t svb, int64_t svm, int64_t svh, float scale,
                cudaStream_t stream) {
  if (m < 1) return int(cudaErrorInvalidValue);
  auto kern = sr_attention_kernel_mma<D>;
  cudaError_t err = allow_smem(kern, MmaGeo<D>::SMEM);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + kQTile - 1) / kQTile, b * h);
  kern<<<grid, kMmaThreads, MmaGeo<D>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), n, m, h, sqb,
      sqn, sqh, skb, skm, skh, svb, svm, svh, scale * kLog2e);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace segmif

extern "C" {

// q/k/v/out: device pointers; strides in elements; dtype 0 = f32,
// 1 = bf16 (then every row start is 16-byte aligned); stream: a
// cudaStream_t. Returns cudaGetLastError().
int segmif_sr_attention(const void* q, const void* k, const void* v,
                        void* out, int b, int n, int m, int h, int d,
                        int64_t sqb, int64_t sqn, int64_t sqh, int64_t skb,
                        int64_t skm, int64_t skh, int64_t svb, int64_t svm,
                        int64_t svh, float scale, int dtype, void* stream) {
  using namespace segmif;
  auto s = static_cast<cudaStream_t>(stream);
#define SEGMIF_SRA(FN, DD)                                                  \
  return FN<DD>(q, k, v, out, b, n, m, h, sqb, sqn, sqh, skb, skm, skh,    \
                svb, svm, svh, scale, s)
  if (dtype == kF32 && d == 64) SEGMIF_SRA(launch_f32, 64);
  if (dtype == kF32 && d == 32) SEGMIF_SRA(launch_f32, 32);
  if (dtype == kBF16 && d == 64) SEGMIF_SRA(launch_bf16, 64);
  if (dtype == kBF16 && d == 32) SEGMIF_SRA(launch_bf16, 32);
#undef SEGMIF_SRA
  return int(cudaErrorInvalidValue);
}

const char* segmif_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
