// Folded CrossPath (the fusion net's feature-fusion module), two streaming
// passes over the tokens, for Hopper (sm_90a).
//
// Replaces: segmif_tpu/kernels/pallas_ffm.py, _grams_pallas (kernel
// _grams_kernel, pass A) and _apply_pallas (kernel _apply_kernel, pass B).
//
// Pass A (segmif_ffm_grams): per token, the three 64-wide half
// projections the contexts read, y1 = relu(x1 W1[:, :64] + b1[:64]),
// y2 = relu(x2 W2[:, :64] + b2[:64]), u3 = relu(s W3[:, 64:] + b3[64:]),
// rounded to the input type, and their f32 grams y1^T y1, y2^T y2,
// u3^T u3 summed over each image's tokens. The TPU kernel computes the
// full [128,128] grams of r_i = relu(x_i Wp_i + bp_i) and the caller reads
// only these three 64x64 blocks; computing just those is the same numbers
// with a quarter of the gram work.
// Pass B (segmif_ffm_apply): recompute y3, u1, u2; o1 = y3 M0 + u1 M1 + be1,
// o2 = y3 M2 + u2 M3 + be2 with the folded [64,64] context matrices; add
// the residual and apply LayerNorm (eps 1e-5, f32).
//
// Shapes: x1, x2, s [B,N,64] contiguous (the fusion trunk's channels_last
// bytes), f32 or bf16; pass A's weights and biases f32; pass B's weights
// and mats in the input type (the wrapper rounds both to it, as the
// reference does), its biases and LayerNorm params f32. At 480x640,
// N = 307,200 per image.
//
// What bounds it on the H100: device-memory traffic is the three inputs
// read once per pass and the two outputs written once (about 5 x B x N x
// 64 elements); the arithmetic is 3 x 2 x 64 x 64 FMA per token in pass A
// and 7 x 64 x 64 in pass B: below the bf16 ridge, so on tensor cores the
// bytes are the bound. On CUDA cores in f32 (pass A) the arithmetic is;
// f32 pass B as 3xTF32 (three TF32 products per f32 product, 0.86 ms at
// the TF32 peak at [8, 307200, 64]) is bound by its bytes again, 1,280 a
// token (0.94 ms), and in practice by the issue of instructions: per k8
// step and n8 tile one 8-byte B read, two splits and three mma.sync.
//
// Pass A in f32: 256 threads per block, token tiles of 64; a thread owns
// a 4x4 micro-tile of a projection or of a gram, so each shared-memory
// read feeds 4 FMAs. Tiles and weights are staged in shared memory as f32
// (rows padded to 68 floats). The TPU kernel carries the gram accumulator
// across a sequential grid; GPU blocks run in parallel and in no order,
// so pass A writes one partial gram per (image, token chunk) and a second
// kernel sums the partials in chunk order. No atomics: results are the
// same from run to run.
//
// Pass A in bf16 (ffm_grams_mma_kernel): both products on tensor cores
// (mma.sync m16n8k16, f32 accumulation), one projection per block (grid
// (chunks, B, 3)), eight warps each walking its own 16-token tiles
// through a private four-stage cp.async ring. The projection is taken
// transposed, r^T = W^T x^T, so its accumulators are already the gram's
// operand fragments (see the kernel); the gram keeps its 10 upper 16x16
// blocks in registers. Per-(image, chunk, projection) partials as above.
//
// Pass B in bf16 (the serving dtype): the seven products on tensor cores
// (mma.sync m16n8k16, f32 accumulation), chained in registers.
//  - One block per SM (150 registers, 173 KB of shared memory) on a share
//    of one image's tokens (grid (chunks, B), four waves of SMs:
//    the folded contexts differ per image), eight warps. The block loads
//    the three projection halves and its image's four contexts once, as
//    bf16 [k][n] rows padded by 16 bytes (7 x 9 KB), read as the B operand
//    by ldmatrix.trans.
//  - Each warp walks its own 16-token tiles of x1, x2 and s through a
//    private two-stage cp.async ring: no block barrier in the token loop.
//  - y3, u1, u2 = relu(x W + b) with bias, relu and the bf16 rounding in
//    registers (pallas_ffm.py:280-282): the f32 accumulators of two
//    adjacent n8 tiles are the A fragment of the next k16 step, so y3 M0 +
//    u1 M1 and y3 M2 + u2 M3 never touch shared memory.
//  - The residual x_i is the A fragment of x_i already in registers (its
//    elements sit where the accumulator's do). LayerNorm in f32 with
//    E[t^2] - mu^2; a row's 64 channels lie on the four lanes of a quad, so
//    two shuffles reduce it. The bf16 rows are staged in the consumed input
//    tile and stored 16 bytes a lane.
//
// Pass B in f32 (ffm_apply_tf32_kernel; what compute_dtype float32 runs):
// the bf16 kernel's structure on mma.sync m16n8k8 .tf32 as 3xTF32
// (common.cuh, split_tf32), each f32 product to about 2^-21 of it.
//  - Grid, warps and chunks as in bf16; the seven matrices raw f32 (112
//    KB, [n][k] with a granule swizzle), each value split as it is read.
//  - Per warp a three-slot cp.async ring (s, x1, x2), each slot refilled
//    with the next tile's input once this tile is done with it.
//  - Chaining: an m16n8k8 tf32 A fragment holds columns t and t + 4 where
//    the accumulator holds 2t and 2t + 1. A product sums over its k in any
//    order, so k = t stands for column 2t and k = t + 4 for 2t + 1, in A's
//    fragment and in the matrix's rows alike (as sr_attention.cu's P V):
//    y3, u1 and u2 feed their context products straight from the
//    accumulators, and each B fragment is one 8-byte read.
//  - Each product's 24 mma per n8 tile (8 k8 steps, 3 each) go into a
//    fresh accumulator added to the running f32 sum (the tensor cores add
//    with truncation, so the two context products of an output are not
//    chained on one; a fresh accumulator per 2 k8 steps ran 1.34x as long
//    on the H100, its zeroing and adding costing issue slots). The
//    residual is read from the staged tile at the accumulator's places;
//    LayerNorm as in bf16; the rows are written over the consumed tile and
//    stored 16 bytes a lane.

#include "common.cuh"

namespace segmif {
namespace {

constexpr int C = 64;           // channels (the fusion trunk width)
constexpr int TILE = 64;        // tokens per tile
constexpr int RS = C + 4;       // padded row stride of staged tiles
constexpr int kThreads = 256;   // 16 x 16 threads, 4x4 micro-tiles

// Stage tokens [n0, n0+TILE) of x (an f32 [N, C] image slice) into
// dst[TILE][RS]; rows past n_end are zero.
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int n0,
                                          int n_end, float* dst) {
  constexpr int LOADS = TILE * C / 4 / kThreads;
#pragma unroll
  for (int r = 0; r < LOADS; ++r) {
    const int e0 = (threadIdx.x + r * kThreads) * 4;
    const int t = e0 / C, c = e0 % C;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n0 + t < n_end)
      v = *reinterpret_cast<const float4*>(x + int64_t(n0 + t) * C + c);
    *reinterpret_cast<float4*>(dst + t * RS + c) = v;
  }
}

// out[TILE][RS] = relu(src @ w + bias) for this thread's 4x4 micro-tile;
// rows >= valid are written as 0.
__device__ __forceinline__ void project(const float* src, const float* w,
                                        const float* bias, float* dst,
                                        int valid) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = bias[4 * tx + j];
#pragma unroll 8
  for (int kk = 0; kk < C; ++kk) {
    const float4 wv = *reinterpret_cast<const float4*>(w + kk * C + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = src[(4 * ty + i) * RS + kk];
      acc[i][0] = fmaf(a, wv.x, acc[i][0]);
      acc[i][1] = fmaf(a, wv.y, acc[i][1]);
      acc[i][2] = fmaf(a, wv.z, acc[i][2]);
      acc[i][3] = fmaf(a, wv.w, acc[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok = 4 * ty + i < valid;
    float4 r;
    r.x = ok ? fmaxf(acc[i][0], 0.f) : 0.f;
    r.y = ok ? fmaxf(acc[i][1], 0.f) : 0.f;
    r.z = ok ? fmaxf(acc[i][2], 0.f) : 0.f;
    r.w = ok ? fmaxf(acc[i][3], 0.f) : 0.f;
    *reinterpret_cast<float4*>(dst + (4 * ty + i) * RS + 4 * tx) = r;
  }
}

// ---------------------------------------------------------------- pass A

// f32. grid (n_chunks, B). w: [3][C][C] (the y1, y2, u3 column halves),
// b: [3][C]. partial: [B][n_chunks][3][C][C].
__global__ void __launch_bounds__(kThreads)
    ffm_grams_kernel(const float* __restrict__ x1,
                     const float* __restrict__ x2,
                     const float* __restrict__ s, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     float* __restrict__ partial, int n, int chunk) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [3][C][C]
  float* bs = ws + 3 * C * C;                   // [3][C]
  float* xs = bs + 3 * C;                       // [TILE][RS]
  float* rs = xs + TILE * RS;                   // [TILE][RS]
  for (int i = threadIdx.x; i < 3 * C * C; i += kThreads) ws[i] = w[i];
  for (int i = threadIdx.x; i < 3 * C; i += kThreads) bs[i] = bias[i];

  const int b = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_begin = blockIdx.x * chunk;
  const int n_end = min(n, n_begin + chunk);
  const float* src[3] = {x1 + int64_t(b) * n * C, x2 + int64_t(b) * n * C,
                         s + int64_t(b) * n * C};
  float g[3][4][4];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[q][i][j] = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += TILE) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      load_tile(src[q], n0, n_end, xs);
      __syncthreads();  // xs ready; every thread is done reading rs
      project(xs, ws + q * C * C, bs + q * C, rs, n_end - n0);
      __syncthreads();  // rs ready; every thread is done reading xs
#pragma unroll 4
      for (int t = 0; t < TILE; ++t) {
        const float* row = rs + t * RS;
        const float4 a = *reinterpret_cast<const float4*>(row + 4 * ty);
        const float4 c = *reinterpret_cast<const float4*>(row + 4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[q][i][0] = fmaf(av[i], c.x, g[q][i][0]);
          g[q][i][1] = fmaf(av[i], c.y, g[q][i][1]);
          g[q][i][2] = fmaf(av[i], c.z, g[q][i][2]);
          g[q][i][3] = fmaf(av[i], c.w, g[q][i][3]);
        }
      }
    }
  }
  float* out = partial + (int64_t(b) * gridDim.x + blockIdx.x) * 3 * C * C;
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(out + q * C * C + (4 * ty + i) * C + 4 * tx) =
          make_float4(g[q][i][0], g[q][i][1], g[q][i][2], g[q][i][3]);
}

// grams[b] = sum over chunks (in chunk order) of partial[b][chunk].
__global__ void ffm_grams_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ grams,
                                        int n_chunks) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * C * C) return;
  const float* p = partial + int64_t(b) * n_chunks * 3 * C * C + e;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += p[int64_t(c) * 3 * C * C];
  grams[int64_t(b) * 3 * C * C + e] = acc;
}

// ------------------------------------------------ pass B, bf16, mma.sync

using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int WT = 16;                   // tokens per warp tile
constexpr int BRS = C + 8;               // padded bf16 row
constexpr int MAT = C * BRS;             // one [64][BRS] matrix
constexpr int WSTAGE = 3 * WT * BRS;     // s, x1, x2 tiles of one stage
constexpr size_t kApplyMmaSmem =
    sizeof(bf16) * (7 * MAT + kMmaWarps * 2 * WSTAGE) + sizeof(float) * 9 * C;

// A fragments (four k16 steps) of a [16][BRS] bf16 tile.
__device__ __forceinline__ void load_a(const bf16* tile, uint32_t a[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], tile + (lane & 15) * BRS + kk * 16 + (lane >> 4) * 8);
}

// acc[8][4] += a (16 x 64) @ w (a [64][BRS] bf16 matrix stored [k][n]).
__device__ __forceinline__ void mma_64(float acc[8][4], const uint32_t a[4][4],
                                       const bf16* w) {
  const int lane = threadIdx.x & 31;
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, w + (kk * 16 + row) * BRS + np * 16 + col);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

// out = bf16(relu(a @ w + bias)) as A fragments of the next product:
// accumulator tiles 2j, 2j+1 are k16 step j.
__device__ __forceinline__ void project_a(const uint32_t a[4][4],
                                          const bf16* w, const float* bias,
                                          uint32_t out[4][4]) {
  float acc[8][4];
  zero(acc);
  mma_64(acc, a, w);
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int f = 0; f < 16; ++f) {
    const int nt = 2 * (f >> 2) + ((f >> 1) & 1), r = f & 1;
    const float* bb = bias + nt * 8 + 2 * t4;
    out[f >> 2][f & 3] = pack_bf16(fmaxf(acc[nt][2 * r] + bb[0], 0.f),
                                   fmaxf(acc[nt][2 * r + 1] + bb[1], 0.f));
  }
}

// out rows = LayerNorm(x + acc + be) * gamma + beta, for this warp's 16
// tokens; x is the residual's A fragments; the rows are staged in `tile`
// (the consumed input) and stored to out rows [row0, row0 + 16) below
// n_end. be, gamma, beta: [C] f32 in shared memory.
__device__ __forceinline__ void ln_store(const float acc[8][4],
                                         const uint32_t x[4][4],
                                         const float* be, const float* gamma,
                                         const float* beta, bf16* tile,
                                         bf16* __restrict__ out, int row0,
                                         int n_end) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float t[8][4], sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1, col = nt * 8 + 2 * t4 + (c & 1);
      const uint32_t xr = x[nt >> 1][2 * (nt & 1) + r];
      const float xe = (c & 1) ? bf16_hi(xr) : bf16_lo(xr);
      t[nt][c] = xe + (acc[nt][c] + be[col]);
      sum[r] += t[nt][c];
      sq[r] += t[nt][c] * t[nt][c];
    }
  float mu[2], rstd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
      sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], o);
    }
    mu[r] = sum[r] * (1.f / C);
    const float var = fmaxf(sq[r] * (1.f / C) - mu[r] * mu[r], 0.f);
    rstd[r] = rsqrtf(var + 1e-5f);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = nt * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(tile + (g + 8 * r) * BRS + col) =
          pack_bf16((t[nt][2 * r] - mu[r]) * rstd[r] * gamma[col] +
                        beta[col],
                    (t[nt][2 * r + 1] - mu[r]) * rstd[r] * gamma[col + 1] +
                        beta[col + 1]);
    }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < WT * 8; i += 32) {
    const int r = i / 8, c = i % 8;
    if (row0 + r < n_end)
      *reinterpret_cast<uint4*>(out + int64_t(row0 + r) * C + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * BRS + c * 8);
  }
}

// grid (n_chunks, B), 8 warps. w: bf16 [3][C][C] [k][n] (y3, u1, u2
// halves); bias f32 [3][C]; mats bf16 [B][4][C][C] [k][n]; be f32 [2][C];
// lnp f32 [2][2][C].
__global__ void __launch_bounds__(kMmaThreads, 1)
    ffm_apply_mma_kernel(const bf16* __restrict__ x1,
                         const bf16* __restrict__ x2,
                         const bf16* __restrict__ s,
                         const bf16* __restrict__ w,
                         const float* __restrict__ bias,
                         const bf16* __restrict__ mats,
                         const float* __restrict__ be,
                         const float* __restrict__ lnp, bf16* __restrict__ o1,
                         bf16* __restrict__ o2, int n, int chunk) {
  extern __shared__ uint4 smem_u4[];
  bf16* ws = reinterpret_cast<bf16*>(smem_u4);  // [7][C][BRS]
  bf16* rings = ws + 7 * MAT;                   // [warps][2][WSTAGE]
  float* prm = reinterpret_cast<float*>(rings + kMmaWarps * 2 * WSTAGE);
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 7 * C * 8; i += kMmaThreads) {
    const int mtx = i / (C * 8), r = (i / 8) % C, c = i % 8;
    const bf16* src =
        mtx < 3 ? w + (mtx * C + r) * C
                : mats + ((int64_t(b) * 4 + mtx - 3) * C + r) * C;
    cp_async16(ws + mtx * MAT + r * BRS + c * 8, src + c * 8, true);
  }
  for (int i = threadIdx.x; i < 9 * C; i += kMmaThreads)
    prm[i] = i < 3 * C ? bias[i] : i < 5 * C ? be[i - 3 * C] : lnp[i - 5 * C];

  const int64_t img = int64_t(b) * n * C;
  const int n_begin = blockIdx.x * chunk;
  const int n_end = min(n, n_begin + chunk);
  bf16* ring = rings + warp * 2 * WSTAGE;
  // this warp's tile at row0 into ring stage st: s, x1, x2
  auto load = [&](int row0, int st) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const bf16* x = (q == 0 ? s : q == 1 ? x1 : x2) + img;
#pragma unroll
      for (int it = 0; it < WT * 8 / 32; ++it) {
        const int r = (lane + 32 * it) / 8, c = lane % 8;
        const bool ok = row0 + r < n_end;
        cp_async16(ring + st * WSTAGE + (q * WT + r) * BRS + c * 8,
                   x + int64_t(ok ? row0 + r : 0) * C + c * 8, ok);
      }
    }
  };
  constexpr int STEP = WT * kMmaWarps;
  int row0 = n_begin + WT * warp;
  if (row0 < n_end) load(row0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // weights and params of every thread

  const bf16* wy3 = ws;
  const bf16* wu1 = ws + MAT;
  const bf16* wu2 = ws + 2 * MAT;
  const bf16* m = ws + 3 * MAT;
  for (int st = 0; row0 < n_end; row0 += STEP, st ^= 1) {
    if (row0 + STEP < n_end) load(row0 + STEP, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    bf16* ts = ring + st * WSTAGE;
    bf16* tx1 = ts + WT * BRS;
    bf16* tx2 = tx1 + WT * BRS;

    uint32_t xa[4][4], y3[4][4], u[4][4];
    load_a(ts, xa);
    project_a(xa, wy3, prm, y3);
    float acc[8][4];
    // output 1: y3 M0 + u1 M1 + be1, residual x1, LayerNorm 1
    load_a(tx1, xa);
    project_a(xa, wu1, prm + C, u);
    zero(acc);
    mma_64(acc, y3, m);
    mma_64(acc, u, m + MAT);
    ln_store(acc, xa, prm + 3 * C, prm + 5 * C, prm + 6 * C, tx1, o1 + img,
             row0, n_end);
    // output 2: y3 M2 + u2 M3 + be2, residual x2, LayerNorm 2
    load_a(tx2, xa);
    project_a(xa, wu2, prm + 2 * C, u);
    zero(acc);
    mma_64(acc, y3, m + 2 * MAT);
    mma_64(acc, u, m + 3 * MAT);
    ln_store(acc, xa, prm + 4 * C, prm + 7 * C, prm + 8 * C, tx2, o2 + img,
             row0, n_end);
    __syncwarp();  // the stage is refilled by the next iteration's load
  }
}

// ------------------------------------------------ pass B, f32, 3xTF32

constexpr int FMAT = C * C;          // one [64][64] f32 matrix (floats)
constexpr int FTILE = WT * C;        // one 16-token f32 tile (floats)
constexpr size_t kApplyTf32Smem =
    sizeof(float) * (7 * FMAT + kMmaWarps * 3 * FTILE + 9 * C);

// Float index of element (row, col) of a [rows][64] f32 array whose 16-byte
// granule c of row r sits at c ^ 2 (r % 4): the 8-byte fragment reads of
// four rows (a half-warp) then fall in 32 distinct banks.
__device__ __forceinline__ int swz(int row, int col) {
  return row * C + ((((col >> 2) ^ (2 * (row & 3))) << 2) | (col & 3));
}

// acc[8][4] += A (16 x 64) @ M, M a [k][n] matrix staged as [n][k] (swz),
// A given per k8 step j by afrag(j, a) as the four floats a0 = A[g][8j +
// 2t], a1 = A[g + 8][8j + 2t], a2 = A[g][8j + 2t + 1], a3 = A[g + 8][8j +
// 2t + 1]: mma k = t stands for column 8j + 2t and k = t + 4 for 8j + 2t +
// 1, in A's fragment and in M's rows alike (b0 = M[8j + 2t][n], b1 =
// M[8j + 2t + 1][n], one 8-byte read). 3xTF32, both operands split in
// registers (A's eight steps once, each B value as it is read); each n8
// tile's 24 products into a fresh accumulator added to acc in f32.
template <class AF>
__device__ __forceinline__ void mma3_64(float acc[8][4], AF afrag,
                                        const float* m) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  uint32_t ab[8][4], as[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float a[4];
    afrag(j, a);
#pragma unroll
    for (int f = 0; f < 4; ++f) split_tf32(a[f], ab[j][f], as[j][f]);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(
          m + swz(8 * nt + g, 8 * j + 2 * t4));
      uint32_t b0, b0s, b1, b1s;
      split_tf32(bv.x, b0, b0s);
      split_tf32(bv.y, b1, b1s);
      mma_tf32(part, as[j], b0, b1);
      mma_tf32(part, ab[j], b0s, b1s);
      mma_tf32(part, ab[j], b0, b1);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] += part[c];
  }
}

// y = relu(tile @ w + bias) for this warp's 16 tokens, in the accumulator
// layout (y[nt][c]: row g + 8 (c / 2), column 8 nt + 2 t + c % 2), which
// is the A fragment of the next product as mma3_64 reads it.
__device__ __forceinline__ void project_tf32(float y[8][4], const float* tile,
                                             const float* w,
                                             const float* bias) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
  mma3_64(acc, [&](int j, float a[4]) {
    const float2 lo = *reinterpret_cast<const float2*>(
        tile + swz(g, 8 * j + 2 * t4));
    const float2 hi = *reinterpret_cast<const float2*>(
        tile + swz(g + 8, 8 * j + 2 * t4));
    a[0] = lo.x;
    a[1] = hi.x;
    a[2] = lo.y;
    a[3] = hi.y;
  }, w);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * nt +
                                                       2 * t4);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[nt][c] = fmaxf(acc[nt][c] + ((c & 1) ? bb.y : bb.x), 0.f);
  }
}

// acc += y @ m, y in the accumulator layout (project_tf32's output)
__device__ __forceinline__ void chain_tf32(float acc[8][4],
                                           const float y[8][4],
                                           const float* m) {
  mma3_64(acc, [&](int j, float a[4]) {
    a[0] = y[j][0];
    a[1] = y[j][2];
    a[2] = y[j][1];
    a[3] = y[j][3];
  }, m);
}

// out rows = LayerNorm(x + (acc + be)) * gamma + beta for this warp's 16
// tokens: the residual x read from the staged input tile at the
// accumulator's places, the rows written over it, then stored to out rows
// [row0, row0 + 16) below n_end, 16 bytes a lane. be, gamma, beta: [C].
__device__ __forceinline__ void ln_store_tf32(const float acc[8][4],
                                              float* tile, const float* be,
                                              const float* gamma,
                                              const float* beta,
                                              float* __restrict__ out,
                                              int row0, int n_end) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float t[8][4], sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = 8 * nt + 2 * t4;
      const float2 xv = *reinterpret_cast<const float2*>(
          tile + swz(g + 8 * r, col));
      t[nt][2 * r] = xv.x + (acc[nt][2 * r] + be[col]);
      t[nt][2 * r + 1] = xv.y + (acc[nt][2 * r + 1] + be[col + 1]);
#pragma unroll
      for (int c = 2 * r; c < 2 * r + 2; ++c) {
        sum[r] += t[nt][c];
        sq[r] += t[nt][c] * t[nt][c];
      }
    }
  float mu[2], rstd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
      sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], o);
    }
    mu[r] = sum[r] * (1.f / C);
    const float var = fmaxf(sq[r] * (1.f / C) - mu[r] * mu[r], 0.f);
    rstd[r] = rsqrtf(var + 1e-5f);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(tile + swz(g + 8 * r, col)) = make_float2(
          (t[nt][2 * r] - mu[r]) * rstd[r] * gamma[col] + beta[col],
          (t[nt][2 * r + 1] - mu[r]) * rstd[r] * gamma[col + 1] +
              beta[col + 1]);
    }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < WT * 16 / 32; ++it) {
    const int r = 2 * it + (lane >> 4), c = lane & 15;
    if (row0 + r < n_end)
      *reinterpret_cast<float4*>(out + int64_t(row0 + r) * C + 4 * c) =
          *reinterpret_cast<const float4*>(tile + swz(r, 4 * c));
  }
}

// grid (n_chunks, B), 8 warps. w: f32 [3][C][C] [k][n] (y3, u1, u2
// halves); bias [3][C]; mats [B][4][C][C] [k][n]; be [2][C]; lnp
// [2][2][C]; all f32.
//  - The seven matrices are staged once per block as [n][k] (swz), 112
//    KB: split into big and small halves they would not fit, so every B
//    value is split as it is read (mma3_64).
//  - Each warp walks its own 16-token tiles through a private ring of
//    three slots (s, x1, x2; 12 KB a warp): a slot is refilled with the
//    next tile's input as soon as this tile is done with it (s after y3,
//    x_i after output i is stored), so loads run under two thirds of a
//    tile's products, with no block barrier in the token loop.
__global__ void __launch_bounds__(kMmaThreads, 1)
    ffm_apply_tf32_kernel(const float* __restrict__ x1,
                          const float* __restrict__ x2,
                          const float* __restrict__ s,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ mats,
                          const float* __restrict__ be,
                          const float* __restrict__ lnp,
                          float* __restrict__ o1, float* __restrict__ o2,
                          int n, int chunk) {
  extern __shared__ float4 smem_f4[];
  float* ms = reinterpret_cast<float*>(smem_f4);  // [7][C][C], [n][k]
  float* rings = ms + 7 * FMAT;                   // [warps][3][WT][C]
  float* prm = rings + kMmaWarps * 3 * FTILE;     // bias, be, lnp
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t img = int64_t(b) * n * C;
  const int n_begin = blockIdx.x * chunk;
  const int n_end = min(n, n_begin + chunk);
  float* ring = rings + warp * 3 * FTILE;
  const float* src[3] = {s + img, x1 + img, x2 + img};
  // input q (s, x1, x2) of this warp's tile at row0 into slot q; rows past
  // n_end are zero-filled
  auto load = [&](int q, int row0) {
#pragma unroll
    for (int it = 0; it < WT * 16 / 32; ++it) {
      const int r = 2 * it + (lane >> 4), c = lane & 15;
      const bool ok = row0 + r < n_end;
      cp_async16(ring + q * FTILE + swz(r, 4 * c),
                 src[q] + int64_t(ok ? row0 + r : 0) * C + 4 * c, ok);
    }
  };
  constexpr int STEP = WT * kMmaWarps;
  int row0 = n_begin + WT * warp;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (row0 < n_end) load(q, row0);
    cp_async_commit();
  }
  // the matrices transposed into [n][k]: lanes walk k, so that their
  // shared-memory writes fall in distinct banks
  for (int i = threadIdx.x; i < 7 * FMAT / 4; i += kMmaThreads) {
    const int mtx = i / (FMAT / 4), n4 = (i / C) % (C / 4), k = i % C;
    const float* m = mtx < 3 ? w + mtx * FMAT
                             : mats + (int64_t(b) * 4 + mtx - 3) * FMAT;
    const float4 v = *reinterpret_cast<const float4*>(m + k * C + 4 * n4);
    float* d = ms + mtx * FMAT;
    d[swz(4 * n4, k)] = v.x;
    d[swz(4 * n4 + 1, k)] = v.y;
    d[swz(4 * n4 + 2, k)] = v.z;
    d[swz(4 * n4 + 3, k)] = v.w;
  }
  for (int i = threadIdx.x; i < 9 * C; i += kMmaThreads)
    prm[i] = i < 3 * C ? bias[i] : i < 5 * C ? be[i - 3 * C] : lnp[i - 5 * C];
  __syncthreads();  // matrices and params of every thread

  // cp.async groups are committed in the order s, x1, x2 of each tile, one
  // per slot refill: the slot needed next is always the third newest
  float* const ts = ring;
  float* const tx1 = ring + FTILE;
  float* const tx2 = ring + 2 * FTILE;
  for (; row0 < n_end; row0 += STEP) {
    const int next = row0 + STEP;
    float y3[8][4], u[8][4], acc[8][4];
    cp_async_wait<2>();
    __syncwarp();
    project_tf32(y3, ts, ms, prm);
    __syncwarp();  // every lane has read s
    if (next < n_end) load(0, next);
    cp_async_commit();
    // output 1: y3 M0 + u1 M1 + be1, residual x1, LayerNorm 1
    cp_async_wait<2>();
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
    chain_tf32(acc, y3, ms + 3 * FMAT);
    project_tf32(u, tx1, ms + FMAT, prm + C);
    chain_tf32(acc, u, ms + 4 * FMAT);
    ln_store_tf32(acc, tx1, prm + 3 * C, prm + 5 * C, prm + 6 * C, o1 + img,
                  row0, n_end);
    __syncwarp();  // every lane has stored its rows from x1's slot
    if (next < n_end) load(1, next);
    cp_async_commit();
    // output 2: y3 M2 + u2 M3 + be2, residual x2, LayerNorm 2
    cp_async_wait<2>();
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
    chain_tf32(acc, y3, ms + 5 * FMAT);
    project_tf32(u, tx2, ms + 2 * FMAT, prm + 2 * C);
    chain_tf32(acc, u, ms + 6 * FMAT);
    ln_store_tf32(acc, tx2, prm + 4 * C, prm + 7 * C, prm + 8 * C, o2 + img,
                  row0, n_end);
    __syncwarp();
    if (next < n_end) load(2, next);
    cp_async_commit();
  }
}

// ------------------------------------------------ pass A, bf16, mma.sync

constexpr int kGramWarps = 8;
constexpr int kGramThreads = kGramWarps * 32;
constexpr int GSTAGES = 4;               // per-warp ring of 16-token tiles
constexpr size_t kGramsMmaSmem =
    sizeof(bf16) * kGramWarps * GSTAGES * WT * BRS + sizeof(float) * C * C;

// grid (n_chunks, B, 3): block (chunk, b, q) takes projection q (y1, y2,
// u3) of image b's token chunk. w: f32 [3][C][C] [k][n] (bf16-exact);
// bias f32 [3][C]; partial: [B][n_chunks][3][C][C].
//  - r^T = W^T x^T per 16-token tile: W^T is the A operand, held in
//    registers for the whole block (4 channel tiles x 4 k16 steps); the
//    token tile is the B operand, ldmatrix'd (no transpose) from the
//    warp's cp.async ring. Lane (g, t) then holds r^T[ch g][tok 2t, 2t+1]:
//    after bias, relu and the bf16 pack, that is at once the A fragment
//    (r^T, 16 ch x 16 tok) and the B fragments (r, 16 tok x 8 ch) of the
//    gram's mma: no shared-memory round trip, no transpose.
//  - The gram is symmetric: a warp accumulates its 10 upper 16x16 blocks
//    (80 registers). At the block's end the warps add them into shared
//    memory in warp order (mirroring the off-diagonal blocks) and the
//    block writes one full 64x64 partial.
__global__ void __launch_bounds__(kGramThreads, 1)
    ffm_grams_mma_kernel(const bf16* __restrict__ x1,
                         const bf16* __restrict__ x2,
                         const bf16* __restrict__ s,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         float* __restrict__ partial, int n, int chunk) {
  extern __shared__ uint4 smem_u4[];
  // [warps][GSTAGES][WT][BRS] rings, then the block's [C][C] gram
  bf16* rings = reinterpret_cast<bf16*>(smem_u4);
  float* sg =
      reinterpret_cast<float*>(rings + kGramWarps * GSTAGES * WT * BRS);
  const int b = blockIdx.y, q = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* x = (q == 0 ? x1 : q == 1 ? x2 : s) + int64_t(b) * n * C;
  const float* wq = w + q * C * C;
  const float* bq = bias + q * C;

  // A fragments of W^T, [channel tile][k16 step]: W^T[o][k] = wq[k][o]
  uint32_t wa[4][4][4];
  float bv[4][2];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int o = 16 * m + g;
    bv[m][0] = bq[o];
    bv[m][1] = bq[o + 8];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 16 * kk + 2 * t4;
#pragma unroll
      for (int f = 0; f < 4; ++f) {  // rows o, o + 8; columns k, k + 8
        const int oo = o + 8 * (f & 1), k0 = k + 8 * (f >> 1);
        wa[m][kk][f] = pack_bf16(wq[k0 * C + oo], wq[(k0 + 1) * C + oo]);
      }
    }
  }
  float acc[10][2][4];
#pragma unroll
  for (int i = 0; i < 10; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][h][c] = 0.f;

  const int n_begin = blockIdx.x * chunk;
  const int n_end = min(n, n_begin + chunk);
  bf16* ring = rings + warp * GSTAGES * WT * BRS;
  // this warp's 16-token tile at row0 into ring stage st
  auto load = [&](int row0, int st) {
#pragma unroll
    for (int it = 0; it < WT * 8 / 32; ++it) {
      const int r = (lane + 32 * it) / 8, c = lane % 8;
      const bool ok = row0 + r < n_end;
      cp_async16(ring + (st * WT + r) * BRS + c * 8,
                 x + int64_t(ok ? row0 + r : 0) * C + c * 8, ok);
    }
  };
  constexpr int STEP = WT * kGramWarps;
  int row0 = n_begin + WT * warp;
#pragma unroll
  for (int st = 0; st < GSTAGES - 1; ++st) {
    if (row0 + st * STEP < n_end) load(row0 + st * STEP, st);
    cp_async_commit();
  }
  for (int i = 0; row0 < n_end; ++i, row0 += STEP) {
    const int ahead = row0 + (GSTAGES - 1) * STEP;
    if (ahead < n_end) load(ahead, (i + GSTAGES - 1) % GSTAGES);
    cp_async_commit();
    cp_async_wait<GSTAGES - 1>();
    __syncwarp();
    const bf16* tile = ring + (i % GSTAGES) * WT * BRS;
    // B fragments of x^T: xb[kk] = {tokens 0-7: k lo, k hi; 8-15: lo, hi}
    uint32_t xb[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(xb[kk], tile + (8 * (lane >> 4) + (lane & 7)) * BRS +
                              16 * kk + 8 * ((lane >> 3) & 1));
    __syncwarp();  // the stage is refilled by a later iteration's load
    // r^T in A-fragment form, [channel tile][4]; tokens past n_end are 0
    uint32_t ra[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float p[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_bf16(p[nt], wa[m][kk], xb[kk][2 * nt], xb[kk][2 * nt + 1]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int tok = row0 + 8 * nt + 2 * t4;
        const bool ok0 = tok < n_end, ok1 = tok + 1 < n_end;
        ra[m][2 * nt] =
            pack_bf16(ok0 ? fmaxf(p[nt][0] + bv[m][0], 0.f) : 0.f,
                      ok1 ? fmaxf(p[nt][1] + bv[m][0], 0.f) : 0.f);
        ra[m][2 * nt + 1] =
            pack_bf16(ok0 ? fmaxf(p[nt][2] + bv[m][1], 0.f) : 0.f,
                      ok1 ? fmaxf(p[nt][3] + bv[m][1], 0.f) : 0.f);
      }
    }
    // gram blocks (I, J), I <= J: r^T[I] times r[J] (its two n8 halves)
#pragma unroll
    for (int I = 0; I < 4; ++I)
#pragma unroll
      for (int J = I; J < 4; ++J) {
        const int blk = I * (7 - I) / 2 + J;
        mma_bf16(acc[blk][0], ra[I], ra[J][0], ra[J][2]);
        mma_bf16(acc[blk][1], ra[I], ra[J][1], ra[J][3]);
      }
  }

  // the warps' grams into shared memory, added in warp order
  __syncthreads();
  for (int wi = 0; wi < kGramWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int I = 0; I < 4; ++I)
#pragma unroll
        for (int J = I; J < 4; ++J)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int i = 16 * I + g + 8 * (c >> 1);
              const int j = 16 * J + 8 * h + 2 * t4 + (c & 1);
              const float v = acc[I * (7 - I) / 2 + J][h][c];
              sg[i * C + j] = wi == 0 ? v : sg[i * C + j] + v;
              if (I != J) sg[j * C + i] = wi == 0 ? v : sg[j * C + i] + v;
            }
    }
    __syncthreads();
  }
  float4* out = reinterpret_cast<float4*>(
      partial + ((int64_t(b) * gridDim.x + blockIdx.x) * 3 + q) * C * C);
  for (int i = threadIdx.x; i < C * C / 4; i += kGramThreads)
    out[i] = reinterpret_cast<const float4*>(sg)[i];
}

constexpr size_t kGramsSmem =
    sizeof(float) * (3 * C * C + 3 * C + 2 * TILE * RS);

int grams_f32(const void* x1, const void* x2, const void* s, const float* w,
              const float* bias, float* partial, int b, int n, int chunk,
              int n_chunks, cudaStream_t stream) {
  auto kern = ffm_grams_kernel;
  cudaError_t err = allow_smem(kern, kGramsSmem);
  if (err != cudaSuccess) return int(err);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  kern<<<dim3(n_chunks, b), kThreads, kGramsSmem, stream>>>(
      f(x1), f(x2), f(s), w, bias, partial, n, chunk);
  return int(cudaGetLastError());
}

int grams_bf16(const void* x1, const void* x2, const void* s, const float* w,
               const float* bias, float* partial, int b, int n, int chunk,
               int n_chunks, cudaStream_t stream) {
  cudaError_t err = allow_smem(ffm_grams_mma_kernel, kGramsMmaSmem);
  if (err != cudaSuccess) return int(err);
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  ffm_grams_mma_kernel<<<dim3(n_chunks, b, 3), kGramThreads, kGramsMmaSmem,
                         stream>>>(h(x1), h(x2), h(s), w, bias, partial, n,
                                   chunk);
  return int(cudaGetLastError());
}

// grams[b] = sum over chunks (in chunk order) of partial[b][chunk].
int grams_reduce(const float* partial, float* out, int b, int n_chunks,
                 cudaStream_t stream) {
  ffm_grams_reduce_kernel<<<dim3((3 * C * C + 255) / 256, b), 256, 0,
                            stream>>>(partial, out, n_chunks);
  return int(cudaGetLastError());
}

int apply_f32(const void* x1, const void* x2, const void* s, const void* w,
              const void* bias, const void* mats, const void* be,
              const void* lnp, void* o1, void* o2, int b, int n, int chunk,
              cudaStream_t stream) {
  cudaError_t err = allow_smem(ffm_apply_tf32_kernel, kApplyTf32Smem);
  if (err != cudaSuccess) return int(err);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int n_chunks = (n + chunk - 1) / chunk;
  ffm_apply_tf32_kernel<<<dim3(n_chunks, b), kMmaThreads, kApplyTf32Smem,
                          stream>>>(
      f(x1), f(x2), f(s), f(w), f(bias), f(mats), f(be), f(lnp),
      static_cast<float*>(o1), static_cast<float*>(o2), n, chunk);
  return int(cudaGetLastError());
}

int apply_bf16(const void* x1, const void* x2, const void* s, const void* w,
               const void* bias, const void* mats, const void* be,
               const void* lnp, void* o1, void* o2, int b, int n, int chunk,
               cudaStream_t stream) {
  cudaError_t err = allow_smem(ffm_apply_mma_kernel, kApplyMmaSmem);
  if (err != cudaSuccess) return int(err);
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int n_chunks = (n + chunk - 1) / chunk;
  ffm_apply_mma_kernel<<<dim3(n_chunks, b), kMmaThreads, kApplyMmaSmem,
                         stream>>>(
      h(x1), h(x2), h(s), h(w), f(bias), h(mats), f(be), f(lnp),
      static_cast<bf16*>(o1), static_cast<bf16*>(o2), n, chunk);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace segmif

extern "C" {

// Pass A. partial: f32 scratch [B][n_chunks][3][64][64]; out: f32
// [B][3][64][64] (y1^T y1, y2^T y2, u3^T u3). chunk is a multiple of 64
// and n_chunks = ceil(N / chunk). Returns cudaGetLastError().
int segmif_ffm_grams(const void* x1, const void* x2, const void* s,
                     const void* w, const void* bias, void* partial,
                     void* out, int b, int n, int chunk, int n_chunks,
                     int dtype, void* stream) {
  using namespace segmif;
  if (chunk % TILE != 0 || n_chunks != (n + chunk - 1) / chunk)
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto bf = static_cast<const float*>(bias);
  auto pf = static_cast<float*>(partial);
  auto of = static_cast<float*>(out);
  int err = int(cudaErrorInvalidValue);
  if (dtype == kF32)
    err = grams_f32(x1, x2, s, wf, bf, pf, b, n, chunk, n_chunks, st);
  if (dtype == kBF16)
    err = grams_bf16(x1, x2, s, wf, bf, pf, b, n, chunk, n_chunks, st);
  return err != 0 ? err : grams_reduce(pf, of, b, n_chunks, st);
}

// Pass B. w [3][64][64] and mats [B][4][64][64] ([in][out]) in the input
// type; bias [3][64], be [2][64], lnp [2][2][64] f32. o1, o2: [B][N][64]
// in the input type. Returns cudaGetLastError().
int segmif_ffm_apply(const void* x1, const void* x2, const void* s,
                     const void* w, const void* bias, const void* mats,
                     const void* be, const void* lnp, void* o1, void* o2,
                     int b, int n, int chunk, int dtype, void* stream) {
  using namespace segmif;
  if (chunk % TILE != 0) return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return apply_f32(x1, x2, s, w, bias, mats, be, lnp, o1, o2, b, n, chunk,
                     st);
  if (dtype == kBF16)
    return apply_bf16(x1, x2, s, w, bias, mats, be, lnp, o1, o2, b, n, chunk,
                      st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
