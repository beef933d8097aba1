// The fusion net's dilated residual dense block (DRDB) for Hopper (sm_90a):
// the dense-growth chain of five dilation-2 3x3 convs, and the
// concat-free tail (1x1 bottleneck, bias, relu, residual).
//
// Replaces: segmif_tpu/kernels/pallas_drdb.py, _drdb_pallas_impl (kernel
// _make_kernel: the whole block on one VMEM canvas), and
// segmif_tpu/kernels/pallas_drdb_tail.py, _tail_impl (kernel _tail_kernel).
//
// Why not one launch per block, as on the TPU: the TPU kernel keeps x and
// r1..r5 (224 channels) of a 120x152 canvas in VMEM. A Hopper block has
// 227 KB of shared memory; at an 8x8 output tile the 10 px halo of five
// convs makes a 28x28 canvas, about 190 KB in bf16 (no room for f32), and
// 3.5x the block's FLOPs in overcompute. Instead:
//
//  segmif_drdb_growth: five launches of one implicit-GEMM conv kernel.
//    Conv t (0..4) reads the first 64 + 32t channels of the dense feature
//    (x from its own pointer, r1..r_t from one [B,H,W,160] buffer) and
//    writes its 32 relu'd channels into its slice of that buffer: the
//    concat never exists and nothing is copied. GEMM shape per conv:
//    M = output pixels (a 16x16 tile per block), N = 32, K = 9 x cin.
//    The input tile plus a 2 px halo (20x20 pixels) and the weights are
//    staged through shared memory in chunks of 32 channels, double
//    buffered with cp.async.
//  segmif_drdb_tail: out = x + relu(round(x Wb[0:64] + sum_i r_i Wb_i)
//    + bb) over 128-pixel tiles; x and r_i are read through their pixel
//    strides (the buffer's slices), K = 224, N = 64.
//
// Precision: bf16 runs on tensor cores (mma.sync m16n8k16, f32
// accumulation, operands by ldmatrix); f32 runs on CUDA cores (FMA, no
// TF32). Rounding follows the plain chain: a conv's f32 accumulator plus
// bias is rounded to the working type before the relu; the tail rounds
// its accumulator, then adds the bias, applies relu and adds x, each in
// the working type (pallas_drdb_tail.py:59-63).
//
// Borders: each conv zero-pads at the true image border: halo pixels
// outside the image are zero-filled in shared memory (cp.async with a
// source size of 0), and outputs outside the image are not stored. Any
// H x W is taken.
//
// What bounds it on the H100: about 0.37 MFLOP per pixel for the growth
// chain against about 1.6 KB of device-memory traffic per pixel (operands
// re-read per conv, halo overlap served by L2): about 230 FLOP per byte,
// near the bf16 ridge (about 295). A simple mma.sync kernel is bounded by
// shared-memory operand reads (4 ldmatrix.x4 per 8 mma) and by latency
// at two blocks per SM, not by device memory; wgmma, TMA and a deeper
// pipeline are the next steps.

#include "common.cuh"

namespace segmif {
namespace {

constexpr int C = 64;                // trunk channels
constexpr int G = 32;                // growth per conv
constexpr int NCONV = 5;             // growth convs
constexpr int RCH = G * NCONV;       // channels of the growth buffer (160)
constexpr int KC = 32;               // input channels per staged chunk
constexpr int TH = 16, TW = 16;      // output tile of a growth block
constexpr int HALO_H = TH + 4, HALO_W = TW + 4;  // dilation 2, reach 2
constexpr int HALO_PIX = HALO_H * HALO_W;
constexpr int kThreads = 256;        // 8 warps
constexpr int KT = C + RCH;          // tail contraction (224)
constexpr int TP = 128;              // pixels per tail block

// ------------------------------------------------------------ primitives

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared-memory geometry per element type. Rows (one pixel's 32 channels
// of a chunk, or one weight row) are padded by one 16-byte granule, so
// the 8 rows an ldmatrix phase reads fall in distinct banks.
template <typename T>
struct Geo {
  static constexpr int EPG = 16 / sizeof(T);   // elements per granule
  static constexpr int RS = KC + EPG;          // padded row
  static constexpr int GPR = KC / EPG;         // granules per row
  static constexpr int HALO = HALO_PIX * RS;   // [20*20][RS]
  static constexpr int WGT = 9 * KC * RS;      // [9 taps][32][RS]
  static constexpr int STAGE = HALO + WGT;
  static constexpr size_t SMEM = 2 * STAGE * sizeof(T);  // double buffer
};

// ---------------------------------------------------------- growth conv

// Stage chunk `chunk` (input channels [32 chunk, 32 chunk + 32)) of the
// tile at (y0, x0) with its halo, and that chunk's weights. Chunks 0-1
// are x's channels; chunk 2 + i is r_{i+1} in the growth buffer.
template <typename T>
__device__ __forceinline__ void load_chunk(T* stage, const T* x, int64_t x_ps,
                                           const T* rs, const T* w, int chunk,
                                           int b, int y0, int x0, int h,
                                           int wd) {
  using Gm = Geo<T>;
  const T* src = chunk < 2 ? x + chunk * KC : rs + (chunk - 2) * KC;
  const int64_t ps = chunk < 2 ? x_ps : RCH;
  for (int i = threadIdx.x; i < HALO_PIX * Gm::GPR; i += kThreads) {
    const int p = i / Gm::GPR, q = i % Gm::GPR;
    const int iy = y0 - 2 + p / HALO_W, ix = x0 - 2 + p % HALO_W;
    const bool ok = iy >= 0 && iy < h && ix >= 0 && ix < wd;
    const T* g =
        ok ? src + ((int64_t(b) * h + iy) * wd + ix) * ps + q * Gm::EPG : src;
    cp_async16(stage + p * Gm::RS + q * Gm::EPG, g, ok);
  }
  const T* wc = w + int64_t(chunk) * 9 * KC * KC;
  T* ws = stage + Gm::HALO;
  for (int i = threadIdx.x; i < 9 * KC * Gm::GPR; i += kThreads) {
    const int r = i / Gm::GPR, q = i % Gm::GPR;
    cp_async16(ws + r * Gm::RS + q * Gm::EPG, wc + r * KC + q * Gm::EPG,
               true);
  }
}

// bf16 chunk product on tensor cores. Warp w owns output rows 2w, 2w+1
// of the tile (two m16 tiles of 16 pixels) and all 32 output channels
// (four n8 tiles). Weights in shared memory are [tap][n][k]: the "col"
// B operand ldmatrix reads without a transpose.
__device__ __forceinline__ void growth_chunk_mma(const __nv_bfloat16* stage,
                                                 float acc[2][4][4]) {
  using Gm = Geo<__nv_bfloat16>;
  const __nv_bfloat16* halo = stage;
  const __nv_bfloat16* ws = stage + Gm::HALO;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a_px = lane & 15, a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t bf[2][4];
#pragma unroll
      for (int nh = 0; nh < 2; ++nh)
        ldmatrix_x4(bf[nh],
                    ws + (tap * KC + nh * 16 + b_n) * Gm::RS + kk + b_k);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = 2 * warp + mt;
        uint32_t a[4];
        ldmatrix_x4(a, halo + ((r + 2 * ky) * HALO_W + a_px + 2 * kx) *
                                  Gm::RS + kk + a_k);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a, bf[nt >> 1][(nt & 1) * 2],
                   bf[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
  }
}

// f32 chunk product on CUDA cores. Thread: 8 output channels (8 tx) of 4
// pixels of one row (columns tx' + 4j), so a warp's 8 pixel groups read
// distinct banks. Weights in shared memory are [tap][k][n].
__device__ __forceinline__ void growth_chunk_fma(const float* stage,
                                                 float acc[4][8]) {
  using Gm = Geo<float>;
  const float* halo = stage;
  const float* ws = stage + Gm::HALO;
  const int tx = threadIdx.x & 3, tp = threadIdx.x >> 2;
  const int row = tp >> 2, col = tp & 3;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    const float* hrow = halo + ((row + 2 * ky) * HALO_W + col + 2 * kx) *
                                   Gm::RS;
    const float* wrow = ws + tap * KC * Gm::RS + 8 * tx;
#pragma unroll 4
    for (int ci = 0; ci < KC; ++ci) {
      const float4 w0 = *reinterpret_cast<const float4*>(wrow + ci * Gm::RS);
      const float4 w1 =
          *reinterpret_cast<const float4*>(wrow + ci * Gm::RS + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = hrow[4 * j * Gm::RS + ci];
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[j][n] = fmaf(a, wv[n], acc[j][n]);
      }
    }
  }
}

// One growth conv: rs[..., out_off:out_off+32] = relu(conv(feat) + bias),
// feat = [x, rs[..., :32 (nchunks - 2)]]. grid (ceil(W/16), ceil(H/16), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    growth_conv_kernel(const T* __restrict__ x, int64_t x_ps, T* rs,
                       const T* __restrict__ w, const float* __restrict__ bias,
                       int nchunks, int out_off, int h, int wd) {
  using Gm = Geo<T>;
  constexpr bool kMma = sizeof(T) == 2;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  float acc_m[2][4][4];  // bf16 path: [m tile][n tile][fragment]
  float acc_f[4][8];     // f32 path: [pixel][channel]
  if constexpr (kMma) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc_m[i][j][k] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc_f[i][j] = 0.f;
  }

  load_chunk<T>(smem, x, x_ps, rs, w, 0, b, y0, x0, h, wd);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks)
      load_chunk<T>(smem + ((c + 1) & 1) * Gm::STAGE, x, x_ps, rs, w, c + 1,
                    b, y0, x0, h, wd);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();  // chunk c has landed for every thread
    const T* st = smem + (c & 1) * Gm::STAGE;
    if constexpr (kMma)
      growth_chunk_mma(st, acc_m);
    else
      growth_chunk_fma(st, acc_f);
    __syncthreads();  // stage c & 1 is free for chunk c + 2
  }

  if constexpr (kMma) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int iy = y0 + 2 * warp + mt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ix = x0 + g + 8 * half;
        if (iy >= h || ix >= wd) continue;
        T* o = rs + ((int64_t(b) * h + iy) * wd + ix) * RCH + out_off;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = nt * 8 + 2 * t;
          const float v0 = acc_m[mt][nt][2 * half] + bias[n];
          const float v1 = acc_m[mt][nt][2 * half + 1] + bias[n + 1];
          store2(reinterpret_cast<__nv_bfloat16*>(o + n), fmaxf(v0, 0.f),
                 fmaxf(v1, 0.f));
        }
      }
    }
  } else {
    const int tx = threadIdx.x & 3, tp = threadIdx.x >> 2;
    const int iy = y0 + (tp >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ix = x0 + (tp & 3) + 4 * j;
      if (iy >= h || ix >= wd) continue;
      float* o = reinterpret_cast<float*>(rs) +
                 ((int64_t(b) * h + iy) * wd + ix) * RCH + out_off + 8 * tx;
      float v[8];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        v[n] = fmaxf(acc_f[j][n] + bias[8 * tx + n], 0.f);
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// ------------------------------------------------------------------ tail

template <typename T>
struct TailGeo {
  static constexpr int EPG = 16 / sizeof(T);
  static constexpr int ARS = KT + EPG;          // [128 pixels][ARS]
  static constexpr int GPP = KT / EPG;          // granules per pixel
  // weights: bf16 [n=64][k=224] (mma B operand), f32 [k=224][n=64]
  static constexpr int WROWS = sizeof(T) == 2 ? C : KT;
  static constexpr int WCOLS = sizeof(T) == 2 ? KT : C;
  static constexpr int WRS = WCOLS + EPG;
  static constexpr int A = TP * ARS;
  static constexpr size_t SMEM = (A + WROWS * WRS) * sizeof(T);
};

template <typename T>
struct TailArgs {
  const T* x;
  const T* r[NCONV];
  const T* wb;        // packed as TailGeo<T> says
  const float* bb;    // [64]
  T* out;             // [npix][64]
  int64_t x_ps, r_ps, npix;
};

// grid ceil(npix / 128). A block stages its 128 pixels' 224 channels
// (x and r1..r5 side by side, no concat in device memory) and the whole
// bottleneck, then each warp computes 16 pixels x 64 channels (bf16) or
// each thread 4 pixels x 8 channels (f32).
template <typename T>
__global__ void __launch_bounds__(kThreads) tail_kernel(TailArgs<T> args) {
  using Tg = TailGeo<T>;
  extern __shared__ float4 smem4[];
  T* sa = reinterpret_cast<T*>(smem4);
  T* sw = sa + Tg::A;
  const int64_t p0 = int64_t(blockIdx.x) * TP;

  for (int i = threadIdx.x; i < TP * Tg::GPP; i += kThreads) {
    const int p = i / Tg::GPP, e = (i % Tg::GPP) * Tg::EPG;
    const int64_t pix = p0 + p;
    const bool ok = pix < args.npix;
    const T* g;
    if (e < C) {
      g = args.x + (ok ? pix * args.x_ps + e : 0);
    } else {
      const int k = e - C;
      g = args.r[k / G] + (ok ? pix * args.r_ps + k % G : 0);
    }
    cp_async16(sa + p * Tg::ARS + e, g, ok);
  }
  constexpr int WG = Tg::WCOLS / Tg::EPG;
  for (int i = threadIdx.x; i < Tg::WROWS * WG; i += kThreads) {
    const int r = i / WG, e = (i % WG) * Tg::EPG;
    cp_async16(sw + r * Tg::WRS + e, args.wb + r * Tg::WCOLS + e, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if constexpr (sizeof(T) == 2) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int a_px = lane & 15, a_k = (lane >> 4) * 8;
    const int b_n = (lane & 7) + ((lane >> 4) << 3);
    const int b_k = ((lane >> 3) & 1) * 8;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < KT; k += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sa + (16 * warp + a_px) * Tg::ARS + k + a_k);
#pragma unroll
      for (int nh = 0; nh < 4; ++nh) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sw + (nh * 16 + b_n) * Tg::WRS + k + b_k);
        mma_bf16(acc[2 * nh], a, bf[0], bf[1]);
        mma_bf16(acc[2 * nh + 1], a, bf[2], bf[3]);
      }
    }
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 16 * warp + g + 8 * half;
      if (p0 + p >= args.npix) continue;
      const T* xs = sa + p * Tg::ARS;
      T* o = args.out + (p0 + p) * C;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float y = round_to<T>(round_to<T>(acc[nt][2 * half + j]) +
                                      args.bb[n + j]);
          v[j] = to_f32(xs[n + j]) + fmaxf(y, 0.f);
        }
        store2(reinterpret_cast<__nv_bfloat16*>(o + n), v[0], v[1]);
      }
    }
  } else {
    const int tx = threadIdx.x & 7, tp = threadIdx.x >> 3;
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[j][n] = 0.f;
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      const float* wr = reinterpret_cast<const float*>(sw) + k * Tg::WRS +
                        8 * tx;
      const float4 w0 = *reinterpret_cast<const float4*>(wr);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = to_f32(sa[(tp + 32 * j) * Tg::ARS + k]);
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[j][n] = fmaf(a, wv[n], acc[j][n]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tp + 32 * j;
      if (p0 + p >= args.npix) continue;
      const float* xs = reinterpret_cast<const float*>(sa) + p * Tg::ARS;
      float v[8];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        v[n] = xs[8 * tx + n] + fmaxf(acc[j][n] + args.bb[8 * tx + n], 0.f);
      float* o = reinterpret_cast<float*>(args.out) + (p0 + p) * C + 8 * tx;
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

template <typename T>
int growth(const void* x, int64_t x_ps, void* rs, const void* w,
           const float* bias, int b, int h, int wd, cudaStream_t stream) {
  auto kern = growth_conv_kernel<T>;
  cudaError_t err = allow_smem(kern, Geo<T>::SMEM);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, b);
  const T* wt = static_cast<const T*>(w);
  for (int t = 0; t < NCONV; ++t) {
    const int nchunks = 2 + t;  // (64 + 32 t) / 32
    kern<<<grid, kThreads, Geo<T>::SMEM, stream>>>(
        static_cast<const T*>(x), x_ps, static_cast<T*>(rs), wt, bias + G * t,
        nchunks, G * t, h, wd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    wt += int64_t(nchunks) * 9 * KC * KC;
  }
  return 0;
}

template <typename T>
int tail(const void* x, int64_t x_ps, const void* const r[NCONV],
         int64_t r_ps, const void* wb, const float* bb, void* out,
         int64_t npix, cudaStream_t stream) {
  auto kern = tail_kernel<T>;
  cudaError_t err = allow_smem(kern, TailGeo<T>::SMEM);
  if (err != cudaSuccess) return int(err);
  TailArgs<T> a;
  a.x = static_cast<const T*>(x);
  for (int i = 0; i < NCONV; ++i) a.r[i] = static_cast<const T*>(r[i]);
  a.wb = static_cast<const T*>(wb);
  a.bb = bb;
  a.out = static_cast<T*>(out);
  a.x_ps = x_ps;
  a.r_ps = r_ps;
  a.npix = npix;
  const int64_t blocks = (npix + TP - 1) / TP;
  kern<<<unsigned(blocks), kThreads, TailGeo<T>::SMEM, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace segmif

extern "C" {

// The growth chain. x: [B,H,W,64] with pixel stride x_ps (elements);
// rs: [B,H,W,160] contiguous, receives r1..r5; w: the five convs'
// weights packed per 32-channel input chunk, [chunk][tap][n][k] for bf16
// and [chunk][tap][k][n] for f32 (20 chunks of 9 x 32 x 32 in all);
// bias: f32 [160]. Returns cudaGetLastError().
int segmif_drdb_growth(const void* x, int64_t x_ps, void* rs, const void* w,
                       const void* bias, int b, int h, int wd, int dtype,
                       void* stream) {
  using namespace segmif;
  auto st = static_cast<cudaStream_t>(stream);
  auto bf = static_cast<const float*>(bias);
  if (dtype == kF32) return growth<float>(x, x_ps, rs, w, bf, b, h, wd, st);
  if (dtype == kBF16)
    return growth<__nv_bfloat16>(x, x_ps, rs, w, bf, b, h, wd, st);
  return int(cudaErrorInvalidValue);
}

// The tail. x: [npix][64] at pixel stride x_ps; r1..r5: [npix][32] at
// pixel stride r_ps; wb: the bottleneck packed [64][224] (bf16) or
// [224][64] (f32); bb: f32 [64]; out: [npix][64] contiguous.
int segmif_drdb_tail(const void* x, int64_t x_ps, const void* r1,
                     const void* r2, const void* r3, const void* r4,
                     const void* r5, int64_t r_ps, const void* wb,
                     const void* bb, void* out, int64_t npix, int dtype,
                     void* stream) {
  using namespace segmif;
  const void* r[NCONV] = {r1, r2, r3, r4, r5};
  auto st = static_cast<cudaStream_t>(stream);
  auto bf = static_cast<const float*>(bb);
  if (dtype == kF32)
    return tail<float>(x, x_ps, r, r_ps, wb, bf, out, npix, st);
  if (dtype == kBF16)
    return tail<__nv_bfloat16>(x, x_ps, r, r_ps, wb, bf, out, npix, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
