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
// bytes), f32 or bf16; weights, biases, mats and LayerNorm params f32.
// At 480x640, N = 307,200 per image.
//
// What bounds it on the H100: device-memory traffic is the three inputs
// read once per pass and the two outputs written once (about 5 x B x N x
// 64 elements); the arithmetic is 3 x 2 x 64 x 64 FMA per token in pass A
// and 7 x 64 x 64 in pass B. On CUDA cores in f32, as written here, the
// arithmetic is the bound, not the memory.
//
// Design: 256 threads per block, token tiles of 64; a thread owns a 4x4
// output micro-tile (4 tokens x 4 channels, or 4x4 of a gram) so each
// shared-memory read feeds 4 FMAs. Tiles and weights are staged in shared
// memory as f32 (rows padded to 68 floats). The TPU kernel carries the
// gram accumulator across a sequential grid; GPU blocks run in parallel
// and in no order, so pass A writes one partial gram per (image, token
// chunk) and a second kernel sums the partials in chunk order. No atomics:
// results are the same from run to run.

#include "common.cuh"

namespace segmif {
namespace {

constexpr int C = 64;           // channels (the fusion trunk width)
constexpr int TILE = 64;        // tokens per tile
constexpr int RS = C + 4;       // padded row stride of staged tiles
constexpr int kThreads = 256;   // 16 x 16 threads, 4x4 micro-tiles

// Stage tokens [n0, n0+TILE) of x (a [N, C] image slice) into dst[TILE][RS]
// as f32; rows past n_end are zero.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, int n0,
                                          int n_end, float* dst) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LOADS = TILE * C / VEC / kThreads;
#pragma unroll
  for (int r = 0; r < LOADS; ++r) {
    const int e0 = (threadIdx.x + r * kThreads) * VEC;
    const int t = e0 / C, c = e0 % C;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (n0 + t < n_end)
      raw = *reinterpret_cast<const uint4*>(x + int64_t(n0 + t) * C + c);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[t * RS + c + i] = to_f32(v[i]);
  }
}

// out[TILE][RS] = round_T(relu(src @ w + bias)) for this thread's 4x4
// micro-tile; rows >= valid are written as 0.
template <typename T>
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
    r.x = ok ? round_to<T>(fmaxf(acc[i][0], 0.f)) : 0.f;
    r.y = ok ? round_to<T>(fmaxf(acc[i][1], 0.f)) : 0.f;
    r.z = ok ? round_to<T>(fmaxf(acc[i][2], 0.f)) : 0.f;
    r.w = ok ? round_to<T>(fmaxf(acc[i][3], 0.f)) : 0.f;
    *reinterpret_cast<float4*>(dst + (4 * ty + i) * RS + 4 * tx) = r;
  }
}

// ---------------------------------------------------------------- pass A

// grid (n_chunks, B). w: [3][C][C] (the y1, y2, u3 column halves), b: [3][C].
// partial: [B][n_chunks][3][C][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ffm_grams_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ s, const float* __restrict__ w,
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
  const T* src[3] = {x1 + int64_t(b) * n * C, x2 + int64_t(b) * n * C,
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
      load_tile<T>(src[q], n0, n_end, xs);
      __syncthreads();  // xs ready; every thread is done reading rs
      project<T>(xs, ws + q * C * C, bs + q * C, rs, n_end - n0);
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

// ---------------------------------------------------------------- pass B

// o = a @ m0 + c @ m1 + be for this thread's micro-tile, then residual x
// and LayerNorm, written to out rows [n0, n0 + valid).
template <typename T>
__device__ __forceinline__ void apply_branch(
    const float* a, const float* c, const float* m0, const float* m1,
    const float* be, const float* gamma, const float* beta, const float* x,
    T* __restrict__ out, int valid) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < C; ++kk) {
    const float4 w0 = *reinterpret_cast<const float4*>(m0 + kk * C + 4 * tx);
    const float4 w1 = *reinterpret_cast<const float4*>(m1 + kk * C + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = a[(4 * ty + i) * RS + kk];
      const float cv = c[(4 * ty + i) * RS + kk];
      acc[i][0] = fmaf(cv, w1.x, fmaf(av, w0.x, acc[i][0]));
      acc[i][1] = fmaf(cv, w1.y, fmaf(av, w0.y, acc[i][1]));
      acc[i][2] = fmaf(cv, w1.z, fmaf(av, w0.z, acc[i][2]));
      acc[i][3] = fmaf(cv, w1.w, fmaf(av, w0.w, acc[i][3]));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
    float t[4];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      t[j] = x[row * RS + 4 * tx + j] + (acc[i][j] + be[4 * tx + j]);
      sum += t[j];
      sq += t[j] * t[j];
    }
    // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = sum * (1.f / C);
    const float var = fmaxf(sq * (1.f / C) - mu * mu, 0.f);
    const float rstd = rsqrtf(var + 1e-5f);
    if (row < valid) {
      T* op = out + int64_t(row) * C + 4 * tx;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        op[j] = from_f32<T>((t[j] - mu) * rstd * gamma[4 * tx + j] +
                            beta[4 * tx + j]);
    }
  }
}

// grid (n_chunks, B). w: [3][C][C] (the y3, u1, u2 column halves),
// bias: [3][C], mats: [B][4][C][C], be: [2][C], lnp: [2][2][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ffm_apply_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     const T* __restrict__ s, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ mats,
                     const float* __restrict__ be,
                     const float* __restrict__ lnp, T* __restrict__ o1,
                     T* __restrict__ o2, int n, int chunk) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [3][C][C]
  float* ms = ws + 3 * C * C;                   // [4][C][C]
  float* bs = ms + 4 * C * C;                   // [3][C]
  float* bes = bs + 3 * C;                      // [2][C]
  float* ls = bes + 2 * C;                      // [2][2][C]
  float* xs = ls + 4 * C;                       // [TILE][RS] input tile
  float* ys = xs + TILE * RS;                   // [TILE][RS] y3
  float* us = ys + TILE * RS;                   // [TILE][RS] u1 / u2
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 3 * C * C; i += kThreads) ws[i] = w[i];
  for (int i = threadIdx.x; i < 4 * C * C; i += kThreads)
    ms[i] = mats[int64_t(b) * 4 * C * C + i];
  for (int i = threadIdx.x; i < 3 * C; i += kThreads) bs[i] = bias[i];
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) bes[i] = be[i];
  for (int i = threadIdx.x; i < 4 * C; i += kThreads) ls[i] = lnp[i];

  const int64_t img = int64_t(b) * n * C;
  const int n_begin = blockIdx.x * chunk;
  const int n_end = min(n, n_begin + chunk);
  for (int n0 = n_begin; n0 < n_end; n0 += TILE) {
    const int valid = n_end - n0;
    load_tile<T>(s + img, n0, n_end, xs);
    __syncthreads();
    project<T>(xs, ws, bs, ys, valid);  // y3
    __syncthreads();
    load_tile<T>(x1 + img, n0, n_end, xs);
    __syncthreads();
    project<T>(xs, ws + C * C, bs + C, us, valid);  // u1
    __syncthreads();
    apply_branch<T>(ys, us, ms, ms + C * C, bes, ls, ls + C, xs,
                    o1 + img + int64_t(n0) * C, valid);
    __syncthreads();
    load_tile<T>(x2 + img, n0, n_end, xs);
    __syncthreads();
    project<T>(xs, ws + 2 * C * C, bs + 2 * C, us, valid);  // u2
    __syncthreads();
    apply_branch<T>(ys, us, ms + 2 * C * C, ms + 3 * C * C, bes + C,
                    ls + 2 * C, ls + 3 * C, xs, o2 + img + int64_t(n0) * C,
                    valid);
    __syncthreads();
  }
}

constexpr size_t kGramsSmem =
    sizeof(float) * (3 * C * C + 3 * C + 2 * TILE * RS);
constexpr size_t kApplySmem =
    sizeof(float) * (7 * C * C + 9 * C + 3 * TILE * RS);

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T>
int grams(const void* x1, const void* x2, const void* s, const float* w,
          const float* bias, float* partial, float* out, int b, int n,
          int chunk, int n_chunks, cudaStream_t stream) {
  auto kern = ffm_grams_kernel<T>;
  cudaError_t err = allow_smem(kern, kGramsSmem);
  if (err != cudaSuccess) return int(err);
  kern<<<dim3(n_chunks, b), kThreads, kGramsSmem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const T*>(s), w, bias, partial, n, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  ffm_grams_reduce_kernel<<<dim3((3 * C * C + 255) / 256, b), 256, 0,
                            stream>>>(partial, out, n_chunks);
  return int(cudaGetLastError());
}

template <typename T>
int apply(const void* x1, const void* x2, const void* s, const float* w,
          const float* bias, const float* mats, const float* be,
          const float* lnp, void* o1, void* o2, int b, int n, int chunk,
          cudaStream_t stream) {
  auto kern = ffm_apply_kernel<T>;
  cudaError_t err = allow_smem(kern, kApplySmem);
  if (err != cudaSuccess) return int(err);
  const int n_chunks = (n + chunk - 1) / chunk;
  kern<<<dim3(n_chunks, b), kThreads, kApplySmem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const T*>(s), w, bias, mats, be, lnp, static_cast<T*>(o1),
      static_cast<T*>(o2), n, chunk);
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
  if (dtype == kF32)
    return grams<float>(x1, x2, s, wf, bf, pf, of, b, n, chunk, n_chunks, st);
  if (dtype == kBF16)
    return grams<__nv_bfloat16>(x1, x2, s, wf, bf, pf, of, b, n, chunk,
                                n_chunks, st);
  return int(cudaErrorInvalidValue);
}

// Pass B. o1, o2: [B][N][64] in the input type. Returns cudaGetLastError().
int segmif_ffm_apply(const void* x1, const void* x2, const void* s,
                     const void* w, const void* bias, const void* mats,
                     const void* be, const void* lnp, void* o1, void* o2,
                     int b, int n, int chunk, int dtype, void* stream) {
  using namespace segmif;
  if (chunk % TILE != 0) return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == kF32)
    return apply<float>(x1, x2, s, f(w), f(bias), f(mats), f(be), f(lnp), o1,
                        o2, b, n, chunk, st);
  if (dtype == kBF16)
    return apply<__nv_bfloat16>(x1, x2, s, f(w), f(bias), f(mats), f(be),
                                f(lnp), o1, o2, b, n, chunk, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
