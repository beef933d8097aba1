// The fusion net's DRDB in int8 for Hopper (sm_90a): calibrated serving.
//
// Replaces: segmif_tpu/kernels/pallas_drdb_int8.py, drdb_strips_int8_pallas
// (kernel _make_kernel: the whole int8 block per phase halo strip in VMEM).
// The strips, the src9 lane stacking and the VMEM scratch round-trips of
// that kernel are Mosaic workarounds and are not carried over; this file
// computes the same function in image layout with dilation 2, as the JAX
// package computes it off the TPU (pallas_drdb.py:814-817).
//
// What it computes (static per-tensor activation scales s_in = amax/127 +
// eps of x, r1..r5; per-output-column weight scales):
//   xq   = clip(rint(x / s_x), +-127)                          entry
//   pre  = acc_x * sv_x + bias, then + acc_1 * sv_1, + acc_2 * sv_2, ...
//   r_t  = clip(rint(relu(pre) * (1 / s_t)), 0, 127)           growth
//   out  = x + relu(acc_b * svb + bb)                          tail
// where acc_s is the exact int32 sum of source s's 3x3 (dilation 2) int8
// conv and sv_s = sw_s * s_in[s] its f32 column scale, so the partial sums
// are f32 and folded per source in the TPU kernel's order
// (pallas_drdb_int8.py:129-142). Every f32 step is an explicit _rn
// intrinsic: nvcc contracts nothing into an FMA, so the plain version
// (kernels/int8.py, drdb_int8_ref), which runs the same operations in the
// same order, gives the same bits.
//
// Layout: one channels_last int8 feature buffer [B, H, W, 224] holds xq
// (channels 0:64) and r1..r5 (64 + 32 (t - 1)). Three kernels:
//  int8_entry_kernel: quantises x (bf16 or f32, any pixel stride) into
//    channels 0:64.
//  int8_conv_kernel: growth conv t (five launches), an implicit GEMM with
//    mma.sync m16n8k32 s8 x s8 -> s32. M = a 16x16 output tile, N = 32,
//    K = 9 taps x 32-channel chunks of the buffer; each chunk is exactly
//    one k32 step per tap, its halo tile (20x20 pixels) and weights staged
//    by cp.async, double buffered, and read by ldmatrix (byte pairs as
//    b16). One int32 accumulator per source (x is 2 chunks, each r one),
//    folded into the f32 partial sums when its taps are done; the requant
//    epilogue writes r_t into its channels. Halo pixels outside the image
//    are zero (cp.async with a source size of 0): the conv's zero padding.
//  int8_tail_kernel: [128 pixels, 224] x [224, 64] int8 GEMM, 7 k32 steps,
//    then the f32 epilogue against x, stored in x's dtype.
//
// What bounds it on the H100: about 0.40 M int8 ops per pixel (0.98 T ops
// per block at [8, 64, 480, 640]: 0.49 ms at NVIDIA's 1,979 dense int8
// TOP/s) against 256 bytes of x in and out per pixel (0.19 ms at 3.35
// TB/s): compute-bound. This first version moves more than that: the
// buffer goes to device memory between convs (about 1.3 KB per pixel with
// the halo re-reads served by L2), and mma.sync fed by ldmatrix reaches
// part of the tensor rate. wgmma, TMA and keeping r1..r5 on chip are the
// next steps.

#include "common.cuh"

namespace segmif {
namespace {

constexpr int C = 64;                 // trunk channels
constexpr int G = 32;                 // growth per conv
constexpr int NCONV = 5;
constexpr int CT = C + G * NCONV;     // channels of the int8 buffer (224)
constexpr int KC = 32;                // channels per chunk: one k32 step
constexpr int TH = 16, TW = 16;       // output tile of a growth block
constexpr int HALO_H = TH + 4, HALO_W = TW + 4;  // dilation 2, reach 2
constexpr int HALO_PIX = HALO_H * HALO_W;
constexpr int kThreads = 256;         // 8 warps
// Shared-memory rows (one pixel's chunk, one weight row, one tail pixel)
// are padded by one 16-byte granule, so the 8 rows an ldmatrix phase reads
// fall in distinct banks.
constexpr int RS = KC + 16;                       // 48 bytes
constexpr int HALO_BYTES = HALO_PIX * RS;         // 19,200
constexpr int WGT_BYTES = 9 * G * RS;             // 13,824: [tap][n][k]
constexpr int STAGE = HALO_BYTES + WGT_BYTES;
constexpr size_t CONV_SMEM = 2 * STAGE;           // 66,048: double buffer
constexpr int TP = 128;                           // pixels per tail block
constexpr int ARS = CT + 16;                      // 240 bytes
constexpr size_t TAIL_SMEM = (TP + C) * ARS;      // 46,080

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulators
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int8_t requant(float pre, float inv) {
  const float q = rintf(__fmul_rn(fmaxf(pre, 0.f), inv));
  return static_cast<int8_t>(fminf(q, 127.f));
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ----------------------------------------------------------------- entry

// feat[p, 0:64] = clip(rint(x[p] / s_x), +-127); one thread per 8 channels.
template <typename T>
__global__ void int8_entry_kernel(const T* __restrict__ x, int64_t x_ps,
                                  int8_t* __restrict__ feat,
                                  const float* __restrict__ s_in,
                                  int64_t npix) {
  const float s = s_in[0];
  const int64_t n = npix * (C / 8);
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t p = i / (C / 8);
    const int c0 = int(i % (C / 8)) * 8;
    const T* src = x + p * x_ps + c0;
    union {
      int8_t q[8];
      int2 v;
    } u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float r = rintf(__fdiv_rn(to_f32(src[j]), s));
      u.q[j] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    }
    *reinterpret_cast<int2*>(feat + p * CT + c0) = u.v;
  }
}

// ---------------------------------------------------------- growth conv

// Stage chunk `chunk` (buffer channels [32 chunk, 32 chunk + 32)) of the
// tile at (y0, x0) with its halo, and that chunk's weights [tap][n][k].
__device__ __forceinline__ void load_chunk(int8_t* stage, const int8_t* feat,
                                           const int8_t* w, int chunk, int b,
                                           int y0, int x0, int h, int wd) {
  const int8_t* src = feat + chunk * KC;
  for (int i = threadIdx.x; i < HALO_PIX * 2; i += kThreads) {
    const int p = i >> 1, q = i & 1;
    const int iy = y0 - 2 + p / HALO_W, ix = x0 - 2 + p % HALO_W;
    const bool ok = iy >= 0 && iy < h && ix >= 0 && ix < wd;
    const int8_t* g =
        ok ? src + ((int64_t(b) * h + iy) * wd + ix) * CT + q * 16 : src;
    cp_async16(stage + p * RS + q * 16, g, ok);
  }
  const int8_t* wc = w + int64_t(chunk) * 9 * G * KC;
  int8_t* ws = stage + HALO_BYTES;
  for (int i = threadIdx.x; i < 9 * G * 2; i += kThreads) {
    const int r = i >> 1, q = i & 1;
    cp_async16(ws + r * RS + q * 16, wc + r * KC + q * 16, true);
  }
}

// One chunk's 9 taps. Warp w owns output rows 2w, 2w+1 of the tile (two
// m16 tiles of 16 pixels) and all 32 output channels (four n8 tiles).
__device__ __forceinline__ void chunk_mma(const int8_t* stage,
                                          int acc[2][4][4]) {
  const int8_t* halo = stage;
  const int8_t* ws = stage + HALO_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a_px = lane & 15, a_k = (lane >> 4) * 16;
  const int b_n = (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    uint32_t bf[2][4];
#pragma unroll
    for (int nh = 0; nh < 2; ++nh)
      ldmatrix_x4(bf[nh], ws + (tap * G + nh * 16 + b_n) * RS + b_k);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = 2 * warp + mt;
      uint32_t a[4];
      ldmatrix_x4(a, halo + ((r + 2 * ky) * HALO_W + a_px + 2 * kx) * RS +
                         a_k);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_s8(acc[mt][nt], a, bf[nt >> 1][(nt & 1) * 2],
               bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
}

// Growth conv t: feat[..., out_off : out_off + 32] = requant(pre) over the
// first nchunks = 2 + t chunks of feat. sv: this target's f32 column
// scales [source][32]; bias: its 32 biases; inv: 1 / s of r_{t+1}.
// grid (ceil(W/16), ceil(H/16), B).
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(int8_t* feat, const int8_t* __restrict__ w,
                     const float* __restrict__ sv,
                     const float* __restrict__ bias,
                     const float* __restrict__ inv, int nchunks, int out_off,
                     int h, int wd) {
  extern __shared__ float4 smem4[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem4);
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int lane = threadIdx.x & 31, tg = lane & 3;

  int acc[2][4][4];
  float pre[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[i][j][k] = 0;
        pre[i][j][k] = 0.f;
      }

  load_chunk(smem, feat, w, 0, b, y0, x0, h, wd);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks)
      load_chunk(smem + ((c + 1) & 1) * STAGE, feat, w, c + 1, b, y0, x0, h,
                 wd);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();  // chunk c has landed for every thread
    chunk_mma(smem + (c & 1) * STAGE, acc);
    __syncthreads();  // stage c & 1 is free for chunk c + 2
    if (c == 0) continue;  // x's second chunk completes its source
    // fold source s: pre = acc_x sv_x + bias, then pre + acc_s sv_s
    const int s = c - 1;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nt * 8 + 2 * tg + (j & 1);
          const float v =
              __fmul_rn(__int2float_rn(acc[mt][nt][j]), sv[s * G + n]);
          pre[mt][nt][j] = s == 0 ? __fadd_rn(v, bias[n])
                                  : __fadd_rn(pre[mt][nt][j], v);
          acc[mt][nt][j] = 0;
        }
  }

  const float iv = *inv;
  const int warp = threadIdx.x >> 5, g = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int iy = y0 + 2 * warp + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ix = x0 + g + 8 * half;
      if (iy >= h || ix >= wd) continue;
      int8_t* o = feat + ((int64_t(b) * h + iy) * wd + ix) * CT + out_off;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = nt * 8 + 2 * tg;
        *reinterpret_cast<char2*>(o + n) =
            make_char2(requant(pre[mt][nt][2 * half], iv),
                       requant(pre[mt][nt][2 * half + 1], iv));
      }
    }
  }
}

// ------------------------------------------------------------------ tail

// grid ceil(npix / 128). A block stages its 128 pixels' 224 int8 channels
// and the [64][224] bottleneck; each warp computes 16 pixels x 64 channels.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_tail_kernel(const T* __restrict__ x, int64_t x_ps,
                     const int8_t* __restrict__ feat,
                     const int8_t* __restrict__ wb,
                     const float* __restrict__ svb,
                     const float* __restrict__ bb, T* __restrict__ out,
                     int64_t npix) {
  extern __shared__ float4 smem4[];
  int8_t* sa = reinterpret_cast<int8_t*>(smem4);
  int8_t* sw = sa + TP * ARS;
  const int64_t p0 = int64_t(blockIdx.x) * TP;
  constexpr int GPP = CT / 16;  // granules per pixel (14)

  for (int i = threadIdx.x; i < TP * GPP; i += kThreads) {
    const int p = i / GPP, q = i % GPP;
    const bool ok = p0 + p < npix;
    cp_async16(sa + p * ARS + q * 16,
               feat + (ok ? (p0 + p) * CT + q * 16 : 0), ok);
  }
  for (int i = threadIdx.x; i < C * GPP; i += kThreads) {
    const int r = i / GPP, q = i % GPP;
    cp_async16(sw + r * ARS + q * 16, wb + r * CT + q * 16, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a_px = lane & 15, a_k = (lane >> 4) * 16;
  const int b_n = (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 16;
  int acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll
  for (int k = 0; k < CT; k += KC) {
    uint32_t a[4];
    ldmatrix_x4(a, sa + (16 * warp + a_px) * ARS + k + a_k);
#pragma unroll
    for (int nh = 0; nh < 4; ++nh) {
      uint32_t bf[4];
      ldmatrix_x4(bf, sw + (nh * 16 + b_n) * ARS + k + b_k);
      mma_s8(acc[2 * nh], a, bf[0], bf[1]);
      mma_s8(acc[2 * nh + 1], a, bf[2], bf[3]);
    }
  }

  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t pix = p0 + 16 * warp + g + 8 * half;
    if (pix >= npix) continue;
    const T* xs = x + pix * x_ps;
    T* o = out + pix * C;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nt * 8 + 2 * tg;
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float yb = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[nt][2 * half + j]), svb[n + j]),
            bb[n + j]);
        v[j] = __fadd_rn(to_f32(xs[n + j]), fmaxf(yb, 0.f));
      }
      store2<T>(o + n, v[0], v[1]);
    }
  }
}

template <typename T>
int growth(const void* x, int64_t x_ps, int8_t* feat, const int8_t* w,
           const float* svk, const float* bias, const float* s_in,
           const float* invs, int b, int h, int wd, cudaStream_t stream) {
  const int64_t npix = int64_t(b) * h * wd;
  const int64_t work = npix * (C / 8);
  const int blocks = int(work / 256 + 1 < 4096 ? work / 256 + 1 : 4096);
  int8_entry_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), x_ps, feat, s_in, npix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = allow_smem(int8_conv_kernel, CONV_SMEM);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, b);
  for (int t = 0; t < NCONV; ++t) {
    const int nchunks = 2 + t;  // (64 + 32 t) / 32
    int8_conv_kernel<<<grid, kThreads, CONV_SMEM, stream>>>(
        feat, w, svk + t * NCONV * G, bias + G * t, invs + 1 + t, nchunks,
        C + G * t, h, wd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    w += int64_t(nchunks) * 9 * G * KC;
  }
  return 0;
}

template <typename T>
int tail(const void* x, int64_t x_ps, const int8_t* feat, const int8_t* wb,
         const float* svb, const float* bb, void* out, int64_t npix,
         cudaStream_t stream) {
  auto kern = int8_tail_kernel<T>;
  cudaError_t err = allow_smem(kern, TAIL_SMEM);
  if (err != cudaSuccess) return int(err);
  const int64_t blocks = (npix + TP - 1) / TP;
  kern<<<unsigned(blocks), kThreads, TAIL_SMEM, stream>>>(
      static_cast<const T*>(x), x_ps, feat, wb, svb, bb, static_cast<T*>(out),
      npix);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace segmif

extern "C" {

// The entry quantise and the five growth convs. x: [B,H,W,64] at pixel
// stride x_ps (elements); feat: int8 [B,H,W,224] contiguous, receives xq
// and r1..r5; w: the growth weights packed per conv, per 32-channel chunk,
// [tap][n][k] (20 chunks of 9 x 32 x 32 int8); svk: f32 [target][source]
// [32] column scales; bias: f32 [160]; s_in, invs: f32 [6] (the scales of
// x, r1..r5 and their reciprocals). Returns cudaGetLastError().
int segmif_drdb_int8_growth(const void* x, int64_t x_ps, void* feat,
                            const void* w, const void* svk, const void* bias,
                            const void* s_in, const void* invs, int b, int h,
                            int wd, int dtype, void* stream) {
  using namespace segmif;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = static_cast<int8_t*>(feat);
  auto wq = static_cast<const int8_t*>(w);
  auto sv = static_cast<const float*>(svk);
  auto bi = static_cast<const float*>(bias);
  auto si = static_cast<const float*>(s_in);
  auto iv = static_cast<const float*>(invs);
  if (dtype == kF32)
    return growth<float>(x, x_ps, f, wq, sv, bi, si, iv, b, h, wd, st);
  if (dtype == kBF16)
    return growth<__nv_bfloat16>(x, x_ps, f, wq, sv, bi, si, iv, b, h, wd,
                                 st);
  return int(cudaErrorInvalidValue);
}

// The tail. x: [npix][64] at pixel stride x_ps; feat: int8 [npix][224];
// wb: int8 [64][224], the scale-folded bottleneck; svb, bb: f32 [64];
// out: [npix][64] contiguous, x's dtype.
int segmif_drdb_int8_tail(const void* x, int64_t x_ps, const void* feat,
                          const void* wb, const void* svb, const void* bb,
                          void* out, int64_t npix, int dtype, void* stream) {
  using namespace segmif;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = static_cast<const int8_t*>(feat);
  auto w = static_cast<const int8_t*>(wb);
  auto sv = static_cast<const float*>(svb);
  auto bi = static_cast<const float*>(bb);
  if (dtype == kF32)
    return tail<float>(x, x_ps, f, w, sv, bi, out, npix, st);
  if (dtype == kBF16)
    return tail<__nv_bfloat16>(x, x_ps, f, w, sv, bi, out, npix, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
