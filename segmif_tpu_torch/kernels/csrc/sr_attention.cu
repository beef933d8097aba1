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
// What bounds it on the H100: the bytes (q, k, v and out, a few MB at
// mit_b3's shapes) over the memory rate, about 0.026 ms for the four
// stage shapes; the 4*N*M*D FLOP take less at the bf16 tensor-core peak.
// In practice the mma.sync rate, the exponentials and the per-tile softmax
// bookkeeping bound it, and at the small stage-4 grid (320 blocks) the
// latency of five dependent key tiles per block.
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
// f32 stays on the CUDA cores in f32 FMA (TF32 or a bf16 split would not
// hold the f32 tolerance, and f32 is not the serving dtype): one block per
// (128 queries, b*h) with Q staged once; K and V stream through a
// two-stage cp.async ring of 64-key tiles (rows of D+4 floats), with the
// online softmax of the bf16 kernel per query (one warp, eight queries,
// two keys per lane), so any M is taken, as the TPU kernel takes it.

#include "common.cuh"

namespace segmif {
namespace {

// ------------------------------------------------- f32, CUDA cores

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kQueriesPerBlock = 128;
constexpr int kQueriesPerWarp = kQueriesPerBlock / kWarps;
constexpr int kKeyTile = 64;  // keys per streamed tile: two per lane

template <int D> struct F32Geo {
  static constexpr int S = D + 4;                // padded K/V row, floats
  static constexpr int KV = kKeyTile * S;        // one K or V tile
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(kQueriesPerBlock) * D + 2 * 2 * KV +
                       size_t(kWarps) * kKeyTile);
};

// 4-byte async copy (any 4-byte aligned source); with valid == false the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Keys [tile * 64, tile * 64 + 64) of K and V into one ring stage; rows at
// or past m are zero-filled (nothing is read for them).
template <int D>
__device__ __forceinline__ void load_kv_f32(float* stage, const float* kb,
                                            const float* vb, int64_t skm,
                                            int64_t svm, int tile, int m) {
  using Gf = F32Geo<D>;
  for (int i = threadIdx.x; i < kKeyTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int j = tile * kKeyTile + r;
    const bool ok = j < m;
    const int64_t jj = ok ? j : 0;
    cp_async4(stage + r * Gf::S + d, kb + jj * skm + d, ok);
    cp_async4(stage + Gf::KV + r * Gf::S + d, vb + jj * svm + d, ok);
  }
}

// One block per (128 queries, b*h); K and V stream through a two-stage
// cp.async ring in tiles of 64 keys, so shared memory does not depend on
// M and any M >= 1 is taken. Warp w owns queries w, w + 16, ... of the
// block; for each, per tile, lane l computes the logits of keys l and
// l + 32, then the online softmax (running max and sum; the output
// rescaled by exp(old max - new max)) and out[d] for its D / 32 dims.
template <int D>
__global__ void __launch_bounds__(kThreads)
    sr_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        int n, int m, int h_count, int64_t sqb, int64_t sqn,
                        int64_t sqh, int64_t skb, int64_t skm, int64_t skh,
                        int64_t svb, int64_t svm, int64_t svh, float scale) {
  using Gf = F32Geo<D>;
  constexpr int S = Gf::S;
  constexpr int DPL = D / 32;  // output dims per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);    // [128][D]
  float* ring = qs + kQueriesPerBlock * D;        // [2][K, V][64][S]
  float* ps = ring + 2 * 2 * Gf::KV;              // [kWarps][64]

  const int bh = blockIdx.y;
  const int b = bh / h_count;
  const int h = bh % h_count;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  for (int i = threadIdx.x; i < kQueriesPerBlock * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = q0 + r < n ? qb[int64_t(q0 + r) * sqn + d] : 0.f;
  }
  load_kv_f32<D>(ring, kb, vb, skm, svm, 0, m);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = ps + warp * kKeyTile;
  float mrow[kQueriesPerWarp], lrow[kQueriesPerWarp];
  float o[kQueriesPerWarp][DPL];
#pragma unroll
  for (int u = 0; u < kQueriesPerWarp; ++u) {
    mrow[u] = -INFINITY;
    lrow[u] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) o[u][t] = 0.f;
  }

  const int tiles = (m + kKeyTile - 1) / kKeyTile;
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      load_kv_f32<D>(ring + ((tile + 1) & 1) * 2 * Gf::KV, kb, vb, skm, svm,
                     tile + 1, m);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `tile` (and Q) have landed for every thread
    const float* ks = ring + (tile & 1) * 2 * Gf::KV;
    const float* vs = ks + Gf::KV;
    const bool valid0 = tile * kKeyTile + lane < m;
    const bool valid1 = tile * kKeyTile + lane + 32 < m;
#pragma unroll
    for (int u = 0; u < kQueriesPerWarp; ++u) {
      const int r = warp + kWarps * u;
      if (q0 + r >= n) break;  // warp-uniform; later u are past n too
      const float* qrow = qs + r * D;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qrow + d);
        const float4 k0 = *reinterpret_cast<const float4*>(ks + lane * S + d);
        const float4 k1 =
            *reinterpret_cast<const float4*>(ks + (lane + 32) * S + d);
        acc0 = fmaf(qq.x, k0.x, acc0);
        acc0 = fmaf(qq.y, k0.y, acc0);
        acc0 = fmaf(qq.z, k0.z, acc0);
        acc0 = fmaf(qq.w, k0.w, acc0);
        acc1 = fmaf(qq.x, k1.x, acc1);
        acc1 = fmaf(qq.y, k1.y, acc1);
        acc1 = fmaf(qq.z, k1.z, acc1);
        acc1 = fmaf(qq.w, k1.w, acc1);
      }
      const float l0 = valid0 ? acc0 * scale : -INFINITY;
      const float l1 = valid1 ? acc1 * scale : -INFINITY;
      // key 0 is in tile 0, so the running max is finite from then on
      const float mx = fmaxf(mrow[u], warp_max(fmaxf(l0, l1)));
      const float alpha = expf(mrow[u] - mx);
      const float e0 = expf(l0 - mx), e1 = expf(l1 - mx);
      p[lane] = e0;
      p[lane + 32] = e1;
      lrow[u] = lrow[u] * alpha + warp_sum(e0 + e1);
      mrow[u] = mx;
      __syncwarp();
      // out[d] = out[d] alpha + sum_j p_j v[j, d], lane owns dims lane*DPL..
      const float* vcol = vs + lane * DPL;
      float o0[DPL], o1[DPL];
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        o0[t] = o[u][t] * alpha;
        o1[t] = 0.f;
      }
#pragma unroll 8
      for (int j = 0; j < kKeyTile; j += 2) {
        const float pa = p[j], pb = p[j + 1];
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          o0[t] = fmaf(pa, vcol[j * S + t], o0[t]);
          o1[t] = fmaf(pb, vcol[(j + 1) * S + t], o1[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < DPL; ++t) o[u][t] = o0[t] + o1[t];
      __syncwarp();  // p is rewritten by the next query
    }
    __syncthreads();  // the stage is refilled two tiles on
  }

#pragma unroll
  for (int u = 0; u < kQueriesPerWarp; ++u) {
    const int qi = q0 + warp + kWarps * u;
    if (qi >= n) break;
    const float inv = 1.f / lrow[u];
    float* op = out + ((int64_t(b) * n + qi) * h_count + h) * D + lane * DPL;
#pragma unroll
    for (int t = 0; t < DPL; ++t) op[t] = o[u][t] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int n, int m, int h, int64_t sqb, int64_t sqn, int64_t sqh,
               int64_t skb, int64_t skm, int64_t skh, int64_t svb,
               int64_t svm, int64_t svh, float scale, cudaStream_t stream) {
  if (m < 1) return int(cudaErrorInvalidValue);
  auto kern = sr_attention_kernel<D>;
  cudaError_t err = allow_smem(kern, F32Geo<D>::SMEM);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, b * h);
  kern<<<grid, kThreads, F32Geo<D>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, m, h, sqb,
      sqn, sqh, skb, skm, skh, svb, svm, svh, scale);
  return int(cudaGetLastError());
}

// ------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kQTile = 16 * kMmaWarps;  // queries per block
constexpr int kKTile = 64;              // keys per streamed tile
constexpr float kLog2e = 1.4426950408889634f;

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
