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
// f32: the first version stays, on the CUDA cores (TF32 or a bf16 split
// would not hold the f32 tolerance, and f32 is not the serving dtype): one
// block per (128 queries, b*h), K and V staged whole in shared memory as
// f32 rows of D+4 floats, one query per warp at a time, logits into a
// per-warp row of shared memory. Shared memory is 4*(2*M*(D+4) + 16*M)
// bytes, so M is limited (382 at D = 64) and the wrapper refuses more.

#include "common.cuh"

namespace segmif {
namespace {

// ------------------------------------------------- f32, CUDA cores

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kQueriesPerBlock = 128;
constexpr int kKeysPerLane = 4;

template <int D> __host__ __device__ constexpr int row_stride() {
  return D + 4;
}

template <int D> size_t smem_bytes(int m) {
  return sizeof(float) *
         (size_t(2) * m * row_stride<D>() + size_t(kWarps) * m);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sr_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        int n, int m, int h_count, int64_t sqb, int64_t sqn,
                        int64_t sqh, int64_t skb, int64_t skm, int64_t skh,
                        int64_t svb, int64_t svm, int64_t svh, float scale) {
  constexpr int S = row_stride<D>();
  constexpr int DPL = D / 32;  // output dims per lane
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [m][S]
  float* vs = ks + m * S;                       // [m][S]
  float* ps = vs + m * S;                       // [kWarps][m]

  const int bh = blockIdx.y;
  const int b = bh / h_count;
  const int h = bh % h_count;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  for (int i = threadIdx.x; i < m * D; i += kThreads) {
    const int j = i / D, d = i % D;
    ks[j * S + d] = kb[j * skm + d];
    vs[j * S + d] = vb[j * svm + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = ps + warp * m;
  const int q_end = min(n, (blockIdx.x + 1) * kQueriesPerBlock);
  for (int qi = blockIdx.x * kQueriesPerBlock + warp; qi < q_end;
       qi += kWarps) {
    const float* qp = q + b * sqb + int64_t(qi) * sqn + h * sqh;
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qp[d];

    // logits of keys j = lane (mod 32), kept in this warp's row p
    float mx = -INFINITY;
    for (int j0 = 0; j0 < m; j0 += 32 * kKeysPerLane) {
      float acc[kKeysPerLane];
      const float* kr[kKeysPerLane];
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        acc[u] = 0.f;
        const int j = j0 + u * 32 + lane;
        kr[u] = ks + (j < m ? j : m - 1) * S;
      }
#pragma unroll
      for (int d = 0; d < D; d += 4) {
#pragma unroll
        for (int u = 0; u < kKeysPerLane; ++u) {
          const float4 kk = *reinterpret_cast<const float4*>(kr[u] + d);
          acc[u] = fmaf(qr[d], kk.x, acc[u]);
          acc[u] = fmaf(qr[d + 1], kk.y, acc[u]);
          acc[u] = fmaf(qr[d + 2], kk.z, acc[u]);
          acc[u] = fmaf(qr[d + 3], kk.w, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        const int j = j0 + u * 32 + lane;
        if (j < m) {
          const float l = acc[u] * scale;
          p[j] = l;
          mx = fmaxf(mx, l);
        }
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < m; j += 32) {  // the same j this lane wrote
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();

    // out[d] = sum_j p_j v[j, d] / sum, lane owns dims lane*DPL ..
    float o0[DPL], o1[DPL];
#pragma unroll
    for (int t = 0; t < DPL; ++t) o0[t] = o1[t] = 0.f;
    const float* vcol = vs + lane * DPL;
    int j = 0;
    for (; j + 1 < m; j += 2) {
      const float pa = p[j], pb = p[j + 1];
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        o0[t] = fmaf(pa, vcol[j * S + t], o0[t]);
        o1[t] = fmaf(pb, vcol[(j + 1) * S + t], o1[t]);
      }
    }
    if (j < m) {
      const float pa = p[j];
#pragma unroll
      for (int t = 0; t < DPL; ++t) o0[t] = fmaf(pa, vcol[j * S + t], o0[t]);
    }
    const float inv = 1.f / sum;
    float* op = out + ((int64_t(b) * n + qi) * h_count + h) * D + lane * DPL;
#pragma unroll
    for (int t = 0; t < DPL; ++t) op[t] = (o0[t] + o1[t]) * inv;
    __syncwarp();  // p is rewritten by the next query
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int n, int m, int h, int64_t sqb, int64_t sqn, int64_t sqh,
               int64_t skb, int64_t skm, int64_t skh, int64_t svb,
               int64_t svm, int64_t svh, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(m);
  if (m < 1 || smem > size_t(max_dynamic_smem()))
    return int(cudaErrorInvalidValue);
  auto kern = sr_attention_kernel<D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, m, h, sqb,
      sqn, sqh, skb, skm, skh, svb, svm, svh, scale);
  return int(cudaGetLastError());
}

template <int D> int max_m() {
  const size_t per_key = sizeof(float) * (2 * row_stride<D>() + kWarps);
  return int(size_t(max_dynamic_smem()) / per_key);
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

// Largest M the f32 kernel holds in shared memory for head dim d (0 if d
// is not a supported head dim). The bf16 kernel takes any M.
int segmif_sr_attention_max_m(int d) {
  if (d == 64) return segmif::max_m<64>();
  if (d == 32) return segmif::max_m<32>();
  return 0;
}

const char* segmif_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
