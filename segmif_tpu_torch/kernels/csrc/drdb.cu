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
//    M = output pixels (a 16x16 tile), N = 32, K = 9 x cin, the input
//    tile plus a 2 px halo (20x20 pixels) staged in chunks of 32 channels.
//  segmif_drdb_tail: out = x + relu(round(x Wb[0:64] + sum_i r_i Wb_i)
//    + bb) over 128-pixel tiles; x and r_i are read through their pixel
//    strides (the buffer's slices), K = 224, N = 64.
//
// The growth conv in bf16 (growth_wgmma_kernel, the serving dtype):
//  - wgmma.mma_async m64n32k16 (f32 accumulators in registers), A and B
//    straight from shared memory through K-major descriptors, no ldmatrix.
//    An M tile is 8 image rows x 8 pixels. The halo of a 32-channel chunk
//    is staged [halo row][halo pixel][32 ch] under TMA's 64-byte swizzle:
//    8 pixels are one 512-byte swizzle atom, the 8-row groups of an M tile
//    are one halo row apart (SBO), the k16 step's second half 32 bytes on.
//    The swizzle is a function of the shared-memory address, so a tap
//    (ky, kx) only moves the descriptor's start by (2 ky HALO_W + 2 kx) x
//    64 bytes: 9 taps x 2 k16 steps = 18 wgmma per M tile and chunk. The
//    weights (B) are [tap][granule of 8 k][n = 32][8], no swizzle.
//  - TMA tiled loads (a 4-D tensor map over x and one over the 160-channel
//    buffer, box 32 ch x 20 x 20 x 1) into a ring of 4 stages on
//    mbarriers. TMA zero-fills coordinates outside the tensor, negative
//    ones included: that is the conv's border padding. (Granule planes
//    without a swizzle need 16-byte-wide boxes: built so first, the
//    kernel ran about 1.5x as long on the H100.)
//  - Warp-specialised, persistent: one block per SM walks 16x16 tiles;
//    one producer thread issues the TMA loads, two consumer warpgroups
//    each own two M tiles (8 rows x 16 pixels). The conv's weights
//    (up to 6 chunks x 18 KB) are loaded once per block by cp.async.bulk.
//    A consumer releases a stage when the wgmma reading it has completed,
//    so the producer runs ahead into the next tile during an epilogue.
//  - Epilogue: bias, bf16, relu into a [8][16][32] shared-memory box per
//    warpgroup, written by one TMA store (clipped at the image border)
//    that runs while the warpgroup goes on to the next tile.
// The f32 growth (growth_conv_kernel) runs on CUDA cores (FMA, no TF32):
// the 20x20 halo and the weights double buffered with cp.async.
//
// Precision: the tail's bf16 product runs on mma.sync m16n8k16 (f32
// accumulation, operands by ldmatrix). Rounding follows the plain chain:
// a conv's f32 accumulator plus bias is rounded to the working type
// before the relu; the tail rounds its accumulator, then adds the bias,
// applies relu and adds x, each in the working type
// (pallas_drdb_tail.py:59-63).
//
// Borders: each conv zero-pads at the true image border (TMA's zero
// fill, or cp.async with a source size of 0 in f32), and outputs outside
// the image are not stored. Any H x W is taken.
//
// What bounds it on the H100: about 0.37 MFLOP per pixel for the growth
// chain (0.92 ms of bf16 tensor time at [8, 64, 480, 640]). Five launches
// re-read the growing feature: 640 input plus 160 output channels per
// pixel, 1.6 KB, 1.17 ms at 3.35 TB/s, a floor above the operations'.
// Each m64n32k16 reads 2 KB of A and 1 KB of B from shared memory for
// 64 KFLOP: at 128 B per clock an SM's shared memory caps the tensor
// cores near two thirds of their rate (about 1.4 ms here).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at
                   // run time (encode_tiled), so nothing links libcuda

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

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ primitives

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// mbarriers (shared-memory addresses), TMA and bulk copies
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// One box of a 4-D tensor map into shared memory; coordinates (innermost
// first) may lie outside the tensor, whose elements arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
// A shared-memory box to a 4-D tensor map (elements outside the tensor
// are not written), then its bulk group committed.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// Wait until this thread's bulk stores have read their shared memory
// (kRead) or completed.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma: a shared-memory matrix descriptor without its start address (or
// it in with desc_at); leading and stride byte offsets in bytes; layout 0
// = no swizzle, 2 = 64-byte swizzle. The swizzle is a function of the
// absolute shared-memory address, as TMA's is, so a start address off
// the 512-byte pattern boundary needs no base offset (bits 49-51 stay 0).
__device__ __forceinline__ uint64_t smem_desc(uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t((lbo >> 4) & 0x3fff) << 16) |
         (uint64_t((sbo >> 4) & 0x3fff) << 32) | (uint64_t(layout) << 62);
}
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t addr) {
  return desc | uint64_t((addr >> 4) & 0x3fff);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from touching accumulators across a wgmma wait.
__device__ __forceinline__ void fence_acc(float d[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64 x 32 f32, the warpgroup's fragments) += A (64 x 16) B (16 x 32),
// both bf16, K-major, read from shared memory through descriptors.
__device__ __forceinline__ void wgmma_m64n32k16(float d[16], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// ------------------------------------------------------ f32 growth conv

// Shared-memory geometry. Rows (one pixel's 32 channels of a chunk, or
// one weight row) are padded by one 16-byte granule.
struct Geo {
  static constexpr int RS = KC + 4;            // padded row
  static constexpr int GPR = KC / 4;           // granules per row
  static constexpr int HALO = HALO_PIX * RS;   // [20*20][RS]
  static constexpr int WGT = 9 * KC * RS;      // [9 taps][32][RS]
  static constexpr int STAGE = HALO + WGT;
  static constexpr size_t SMEM = 2 * STAGE * sizeof(float);  // 2 stages
};

// Stage chunk `chunk` (input channels [32 chunk, 32 chunk + 32)) of the
// tile at (y0, x0) with its halo, and that chunk's weights. Chunks 0-1
// are x's channels; chunk 2 + i is r_{i+1} in the growth buffer.
__device__ __forceinline__ void load_chunk(float* stage, const float* x,
                                           int64_t x_ps, const float* rs,
                                           const float* w, int chunk, int b,
                                           int y0, int x0, int h, int wd) {
  const float* src = chunk < 2 ? x + chunk * KC : rs + (chunk - 2) * KC;
  const int64_t ps = chunk < 2 ? x_ps : RCH;
  for (int i = threadIdx.x; i < HALO_PIX * Geo::GPR; i += kThreads) {
    const int p = i / Geo::GPR, q = i % Geo::GPR;
    const int iy = y0 - 2 + p / HALO_W, ix = x0 - 2 + p % HALO_W;
    const bool ok = iy >= 0 && iy < h && ix >= 0 && ix < wd;
    const float* g =
        ok ? src + ((int64_t(b) * h + iy) * wd + ix) * ps + q * 4 : src;
    cp_async16(stage + p * Geo::RS + q * 4, g, ok);
  }
  const float* wc = w + int64_t(chunk) * 9 * KC * KC;
  float* ws = stage + Geo::HALO;
  for (int i = threadIdx.x; i < 9 * KC * Geo::GPR; i += kThreads) {
    const int r = i / Geo::GPR, q = i % Geo::GPR;
    cp_async16(ws + r * Geo::RS + q * 4, wc + r * KC + q * 4, true);
  }
}

// f32 chunk product on CUDA cores. Thread: 8 output channels (8 tx) of 4
// pixels of one row (columns tx' + 4j), so a warp's 8 pixel groups read
// distinct banks. Weights in shared memory are [tap][k][n].
__device__ __forceinline__ void growth_chunk_fma(const float* stage,
                                                 float acc[4][8]) {
  const float* halo = stage;
  const float* ws = stage + Geo::HALO;
  const int tx = threadIdx.x & 3, tp = threadIdx.x >> 2;
  const int row = tp >> 2, col = tp & 3;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    const float* hrow = halo + ((row + 2 * ky) * HALO_W + col + 2 * kx) *
                                   Geo::RS;
    const float* wrow = ws + tap * KC * Geo::RS + 8 * tx;
#pragma unroll 4
    for (int ci = 0; ci < KC; ++ci) {
      const float4 w0 = *reinterpret_cast<const float4*>(wrow + ci * Geo::RS);
      const float4 w1 =
          *reinterpret_cast<const float4*>(wrow + ci * Geo::RS + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = hrow[4 * j * Geo::RS + ci];
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[j][n] = fmaf(a, wv[n], acc[j][n]);
      }
    }
  }
}

// One f32 growth conv: rs[..., out_off:out_off+32] = relu(conv(feat) +
// bias), feat = [x, rs[..., :32 (nchunks - 2)]].
// grid (ceil(W/16), ceil(H/16), B).
__global__ void __launch_bounds__(kThreads)
    growth_conv_kernel(const float* __restrict__ x, int64_t x_ps, float* rs,
                       const float* __restrict__ w,
                       const float* __restrict__ bias, int nchunks,
                       int out_off, int h, int wd) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  float acc[4][8];  // [pixel][channel]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_chunk(smem, x, x_ps, rs, w, 0, b, y0, x0, h, wd);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks)
      load_chunk(smem + ((c + 1) & 1) * Geo::STAGE, x, x_ps, rs, w, c + 1, b,
                 y0, x0, h, wd);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();  // chunk c has landed for every thread
    growth_chunk_fma(smem + (c & 1) * Geo::STAGE, acc);
    __syncthreads();  // stage c & 1 is free for chunk c + 2
  }

  const int tx = threadIdx.x & 3, tp = threadIdx.x >> 2;
  const int iy = y0 + (tp >> 2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ix = x0 + (tp & 3) + 4 * j;
    if (iy >= h || ix >= wd) continue;
    float* o = rs + ((int64_t(b) * h + iy) * wd + ix) * RCH + out_off + 8 * tx;
    float v[8];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      v[n] = fmaxf(acc[j][n] + bias[8 * tx + n], 0.f);
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// ------------------------------------------------- bf16 growth on wgmma

namespace wg {
constexpr int ROW = HALO_W;                     // halo row in smem, pixels
constexpr int PIX = KC * 2;                     // a pixel's chunk, bytes
constexpr int STAGE = HALO_H * ROW * PIX;       // a 32-channel chunk
constexpr int STAGES = 4;
constexpr int WCHUNK = 9 * KC * G * 2;          // a chunk's weights, bytes
constexpr int MAX_CHUNKS = 2 + NCONV - 1;       // conv 5: x's 2, r1..r4
constexpr int CONSUMERS = 2;                    // warpgroups, 8 rows each
constexpr int THREADS = 128 * CONSUMERS + 32;   // + one producer warp
constexpr int OUT = 8 * TW * G * 2;             // a warpgroup's 8 output rows
constexpr int W_OFF = STAGES * STAGE;
constexpr int O_OFF = W_OFF + MAX_CHUNKS * WCHUNK;
constexpr int BAR_OFF = O_OFF + CONSUMERS * OUT;
constexpr size_t SMEM = BAR_OFF + 8 * (2 * STAGES + 1);
static_assert(STAGE % 1024 == 0 && WCHUNK % 128 == 0, "TMA alignment");
}  // namespace wg

// One bf16 growth conv, as growth_conv_kernel, over tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ... (grid: at most one block per SM). w: this
// conv's weights, [chunk][tap][granule][n = 32][8]; xmap, rmap: the halo
// maps over x and the growth buffer, omap: the output map over the
// buffer (halo_map).
__global__ void __launch_bounds__(wg::THREADS, 1)
    growth_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap rmap,
                        const __grid_constant__ CUtensorMap omap,
                        const bf16* __restrict__ w,
                        const float* __restrict__ bias, int nchunks,
                        int out_off, int b, int h, int wd) {
  using namespace wg;
  extern __shared__ __align__(128) uint8_t smem_b[];
  const uint32_t s0 = smem_u32(smem_b);
  const uint32_t ws = s0 + W_OFF;
  const uint32_t full = s0 + BAR_OFF;        // full[s]: stage s has landed
  const uint32_t empty = full + 8 * STAGES;  // empty[s]: stage s is read
  const uint32_t wbar = empty + 8 * STAGES;  // the weights have landed
  const int tiles_x = (wd + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS);  // one arrival per warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {
    // producer: one thread keeps the ring full
    if (lane != 0) return;
    mbar_expect_tx(wbar, nchunks * WCHUNK);
    for (int c = 0; c < nchunks; ++c)
      bulk_load(ws + c * WCHUNK, reinterpret_cast<const uint8_t*>(w) +
                                     c * WCHUNK, WCHUNK, wbar);
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
      const int bi = tile / (tiles_x * tiles_y);
      for (int c = 0; c < nchunks; ++c) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, STAGE);
        const CUtensorMap* map = c < 2 ? &xmap : &rmap;
        const int ch = KC * (c < 2 ? c : c - 2);
        tma_load_4d(s0 + stage * STAGE, map, ch, tx * TW - 2, ty * TH - 2,
                    bi, full + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns tile rows [8 wgi, 8 wgi + 8), as two M
  // tiles (pixels 0-7 and 8-15); warp q of it holds rows 2q, 2q + 1 of
  // each, pixel lane / 4, channels 8 i + 2 (lane % 4) + {0, 1}
  const int wgi = warp >> 2, q = warp & 3, t4 = lane & 3;
  float bv[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bv[2 * i] = bias[8 * i + 2 * t4];
    bv[2 * i + 1] = bias[8 * i + 2 * t4 + 1];
  }
  // A: 64-byte swizzle, 8-row groups one halo row apart (the swizzled
  // layout has no leading offset to set). B: no swizzle, the next granule
  // 32 rows on, 8-row groups 8 rows apart.
  const uint64_t da = smem_desc(16, ROW * PIX, 2);
  const uint64_t db = smem_desc(G * 16, 8 * 16, 0);
  float acc[2][16];
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(wbar, 0);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[mt][i] = 0.f;
    int prev = 0;
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait(full + 8 * stage, phase);
      __syncwarp();
      wgmma_fence();
      const uint32_t a0 = s0 + stage * STAGE + 8 * wgi * ROW * PIX;
      const uint32_t b0 = ws + c * WCHUNK;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t bd = desc_at(db, b0 + (tap * 4 + 2 * kk) * G * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            wgmma_m64n32k16(
                acc[mt],
                desc_at(da, a0 + (2 * ky * ROW + 8 * mt + 2 * kx) * PIX +
                                32 * kk),
                bd);
        }
      }
      wgmma_commit();
      if (c > 0) {  // chunk c - 1's products are done: release its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    // epilogue: bias, bf16, relu into this warpgroup's [8][16][32] output
    // rows in shared memory, then one TMA store (clipped at the image
    // border) that runs while the warpgroup goes on to the next tile
    const uint32_t out = s0 + O_OFF + wgi * OUT;
    if (threadIdx.x % 128 == 0) bulk_wait<true>();  // the last store read it
    bar_sync(1 + wgi, 128);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t o =
            out + ((2 * q + hh) * TW + 8 * mt + (lane >> 2)) * G * 2 + 4 * t4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              fmaxf(acc[mt][4 * i + 2 * hh] + bv[2 * i], 0.f),
              fmaxf(acc[mt][4 * i + 2 * hh + 1] + bv[2 * i + 1], 0.f));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(o + 16 * i),
                       "r"(*reinterpret_cast<const uint32_t*>(&v)));
        }
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + wgi, 128);
    if (threadIdx.x % 128 == 0) {
      const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
      tma_store_4d(&omap, out, out_off, tx * TW, ty * TH + 8 * wgi,
                   tile / (tiles_x * tiles_y));
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait<false>();
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

int growth_f32(const void* x, int64_t x_ps, void* rs, const void* w,
               const float* bias, int b, int h, int wd, cudaStream_t stream) {
  cudaError_t err = allow_smem(growth_conv_kernel, Geo::SMEM);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, b);
  const float* wt = static_cast<const float*>(w);
  for (int t = 0; t < NCONV; ++t) {
    const int nchunks = 2 + t;  // (64 + 32 t) / 32
    growth_conv_kernel<<<grid, kThreads, Geo::SMEM, stream>>>(
        static_cast<const float*>(x), x_ps, static_cast<float*>(rs), wt,
        bias + G * t, nchunks, G * t, h, wd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    wt += int64_t(nchunks) * 9 * KC * KC;
  }
  return 0;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// entry-point query (nullptr if the driver lacks it).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D TMA map over a channels_last bf16 tensor [b][h][wd][channels] at
// pixel stride ps (elements), boxes of 32 channels x bw x bh pixels: with
// the 64-byte swizzle, a 20 x 20 halo chunk as the wgmma A operand reads
// it; without, an output box of 16 x 8 pixels.
bool tile_map(CUtensorMap* map, const void* base, int64_t ps, int channels,
              int b, int h, int wd, int bw, int bh, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t bytes = cuuint64_t(ps) * sizeof(bf16);
  const cuuint64_t dims[4] = {cuuint64_t(channels), cuuint64_t(wd),
                              cuuint64_t(h), cuuint64_t(b)};
  const cuuint64_t strides[3] = {bytes, bytes * wd, bytes * wd * h};
  const cuuint32_t box[4] = {KC, cuuint32_t(bw), cuuint32_t(bh), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 chain: three maps per call (the halos of x and of the growth
// buffer, the buffer's output tiles) serve all five launches.
int growth_bf16(const void* x, int64_t x_ps, void* rs, const void* w,
                const float* bias, int b, int h, int wd,
                cudaStream_t stream) {
  CUtensorMap xmap, rmap, omap;
  if (!tile_map(&xmap, x, x_ps, C, b, h, wd, wg::ROW, HALO_H, true) ||
      !tile_map(&rmap, rs, RCH, RCH, b, h, wd, wg::ROW, HALO_H, true) ||
      !tile_map(&omap, rs, RCH, RCH, b, h, wd, TW, 8, false))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(growth_wgmma_kernel, wg::SMEM);
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = ((wd + TW - 1) / TW) * ((h + TH - 1) / TH) * b;
  const int grid = tiles < sms ? tiles : sms;
  const bf16* wt = static_cast<const bf16*>(w);
  for (int t = 0; t < NCONV; ++t) {
    const int nchunks = 2 + t;
    growth_wgmma_kernel<<<grid, wg::THREADS, wg::SMEM, stream>>>(
        xmap, rmap, omap, wt, bias + G * t, nchunks, G * t, b, h, wd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    wt += int64_t(nchunks) * 9 * KC * G;
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
// weights packed per 32-channel input chunk, [chunk][tap][k granule of 8]
// [n][8] for bf16 (the wgmma B operand) and [chunk][tap][k][n] for f32
// (20 chunks of 9 x 32 x 32 in all); bias: f32 [160]. bf16 needs x_ps a
// multiple of 8 and x 16-byte aligned (TMA). Returns cudaGetLastError(),
// or cudaErrorInvalidValue if the tensor maps cannot be made.
int segmif_drdb_growth(const void* x, int64_t x_ps, void* rs, const void* w,
                       const void* bias, int b, int h, int wd, int dtype,
                       void* stream) {
  using namespace segmif;
  auto st = static_cast<cudaStream_t>(stream);
  auto bf = static_cast<const float*>(bias);
  if (dtype == kF32) return growth_f32(x, x_ps, rs, w, bf, b, h, wd, st);
  if (dtype == kBF16) return growth_bf16(x, x_ps, rs, w, bf, b, h, wd, st);
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
