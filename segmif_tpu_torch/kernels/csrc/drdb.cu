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
//    + bb) over 128-pixel tiles (64 in f32); x and r_i are read through
//    their pixel strides (the buffer's slices), K = 224, N = 64.
//
// The growth conv (growth_kernel, one pipeline for both types; in bf16,
// GrowthBf16, the serving dtype):
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
// The f32 growth (GrowthTf32, what compute_dtype float32 runs) is the
// same pipeline on wgmma.mma_async m64n32k8 .tf32 as 3xTF32: each f32
// operand a = big + small, both TF32 (common.cuh, tf32_big), and each
// product big*big + big*small + small*big in f32 accumulators, about 2^-21
// of the product. On the H100 it reads 0.021 of the f32 limit; x rounded
// to TF32 (conv 1's small*big product dropped) reads 5.5x it.
//  - tf32 wgmma reads A and B K-major from shared memory only, and TMA
//    lands raw f32: when a halo chunk lands, the 256 consumer threads split
//    it in place (big over the raw values, small beside them), then
//    fence.proxy.async and one barrier. The weights arrive split, packed
//    on the host ([big][small] per chunk).
//  - A 32-channel f32 chunk would be 51 KB of halo per half and 37 KB of
//    weights per half: no two stages fit in 227 KB. So a chunk is 16
//    channels: a pixel's 64 bytes take the bf16 kernel's 64-byte swizzle,
//    descriptors and tap offsets unchanged, and a k8 step is half a row
//    (32 bytes), as bf16's k16. The weights no longer fit resident (up to
//    12 chunks x 37 KB): each stage carries its chunk's weights beside
//    the halo, one bulk copy, so a stage is 88 KB and two fit.
//  - Per 16-channel chunk and M tile, 9 taps x 2 k8 steps x 3 products,
//    the small*big and big*small ones first, into a fresh accumulator
//    folded into the tile's sums in f32 once done: the tensor cores add
//    with truncation, and a chain of up to 648 wgmma on one running sum
//    drifted by about an ulp of it per wgmma (0.144 of the f32 limit
//    against 0.021 so; an f32 net whose trunk amplifies the DRDBs
//    50-fold failed the card test against the CPU). The chunk's first
//    wgmma starts part with scale-d 0: zeroing it instead, between
//    wgmmas, made ptxas serialise them all. The producer keeps the next
//    chunk in flight while a chunk's products run; the split waits for
//    them. The epilogue stores f32 boxes of [8][16][32] by TMA.
//
// The tail in bf16 (tail_kernel_bf16) moves 576 bytes per pixel for 28
// KFLOP: bytes bound it (0.42 ms at [8, 64, 480, 640]). So it is a
// persistent TMA pipeline: one block per SM loads the bottleneck once, a
// producer thread keeps a 3-stage ring of 128-pixel tiles (x and r1..r5
// through their pixel strides) in flight while eight warps run the
// product on mma.sync and write their outputs over the x box in shared
// memory, which one TMA store writes out. The f32 tail (tail_kernel_f32)
// is the same pipeline on 64-pixel tiles with two groups of consumer warps
// on alternate tiles, its product on mma.sync m16n8k8 .tf32 as 3xTF32.
//
// Precision: the tail's bf16 product runs on mma.sync m16n8k16 (f32
// accumulation, operands by ldmatrix); its f32 product as 3xTF32 (each
// product to about 2^-21 of it, each 32-channel chunk's twelve mma into a
// fresh accumulator added in f32). Rounding follows the plain chain:
// a conv's f32 accumulator plus bias is rounded to the working type
// before the relu; the tail rounds its accumulator, then adds the bias,
// applies relu and adds x, each in the working type
// (pallas_drdb_tail.py:59-63).
//
// Borders: each conv zero-pads at the true image border (TMA's zero
// fill), and outputs outside
// the image (or past the last pixel, in the tail) are not stored. Any
// H x W is taken.
//
// What bounds it on the H100: about 0.37 MFLOP per pixel for the growth
// chain (0.92 ms of bf16 tensor time at [8, 64, 480, 640]). Five launches
// re-read the growing feature: 640 input plus 160 output channels per
// pixel, 1.6 KB, 1.17 ms at 3.35 TB/s, a floor above the operations'.
// Each m64n32k16 reads 2 KB of A and 1 KB of B from shared memory for
// 64 KFLOP: at 128 B per clock an SM's shared memory caps the tensor
// cores near two thirds of their rate (about 1.4 ms here).
// In f32, 3xTF32 triples the tensor work at half bf16's rate: 5.49 ms
// at the TF32 peak; each m64n32k8 again reads 3 KB for 32 KFLOP, the same
// two-thirds cap (about 8.2 ms), and the f32 bytes of five launches take
// about 2.35 ms. Measured on the H100 (700 W): 12.3 ms, against 29.6 ms
// for the CUDA-core kernel it replaced and 37.2 ms for cuDNN's f32 convs.
// The f32 tail moves 1,152 bytes per pixel (0.845 ms at [8, 64, 480,
// 640]) for 28 KFLOP, 3 x that as 3xTF32 (0.43 ms at the TF32 peak):
// bytes bound it, as in bf16. Each k8 step's splits (8 A and 8 B values
// per lane for 24 mma.sync a warp) make the issue of instructions its
// other limit. Measured on the H100 (700 W): 1.17-1.26 ms, against 3.46
// for the CUDA-core kernel it replaced and 4.32 for cuDNN's f32 1x1 conv
// on a concatenation built beforehand.

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
constexpr int KT = C + RCH;          // tail contraction (224)
constexpr int TP = 128;              // pixels per bf16 tail tile

using bf16 = __nv_bfloat16;

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

// d (64 x 32 f32) = A (64 x 8) B (8 x 32) + (accumulate ? d : 0), both
// tf32 (f32 in shared memory, the low 13 bits ignored), K-major, through
// descriptors.
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float d[16], uint64_t a,
                                                    uint64_t b,
                                                    int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// --------------------------------------------------- growth on wgmma

// The growth pipeline's two element types, as policies of growth_kernel:
// what a stage holds, the chunk width and the epilogue's element. bf16
// keeps the conv's weights resident; f32 (3xTF32) streams a chunk's split
// weights beside its halo.
constexpr int GCONSUMERS = 2;                     // warpgroups, 8 rows each
constexpr int GTHREADS = 128 * GCONSUMERS + 32;   // + one producer warp

struct GrowthBf16 {
  using T = bf16;
  static constexpr bool kTf32 = false;
  static constexpr int KCH = KC;                    // input channels a chunk
  static constexpr int PIX = KCH * 2;               // a pixel's chunk, bytes
  static constexpr int HALO = HALO_H * HALO_W * PIX;  // 25,600
  static constexpr int WCHUNK = 9 * KCH * G * 2;    // a chunk's weights
  static constexpr int STAGE = HALO;
  static constexpr int STAGES = 4;
  static constexpr int STAGE_TX = HALO;             // bytes landing a stage
  static constexpr int W_OFF = STAGES * STAGE;      // the resident weights
  static constexpr int MAX_CHUNKS = 2 + NCONV - 1;  // conv 5: x's 2, r1..r4
  static constexpr int O_OFF = W_OFF + MAX_CHUNKS * WCHUNK;
};

struct GrowthTf32 {
  using T = float;
  static constexpr bool kTf32 = true;
  static constexpr int KCH = KC / 2;
  static constexpr int PIX = KCH * 4;
  static constexpr int HALO = HALO_H * HALO_W * PIX;  // one halo half, 25,600
  static constexpr int WHALF = 9 * KCH * G * 4;       // one weight half
  static constexpr int WCHUNK = 2 * WHALF;            // big and small
  // a stage: [halo big (TMA, split in place)][halo small][weights big][small]
  static constexpr int STAGE = 2 * HALO + WCHUNK;     // 88,064
  static constexpr int STAGES = 2;
  static constexpr int STAGE_TX = HALO + WCHUNK;
  static constexpr int O_OFF = STAGES * STAGE;
};

// a warpgroup's 8 output rows, and the shared memory of growth_kernel<P>
template <class P>
__host__ __device__ constexpr int growth_out() {
  return 8 * TW * G * int(sizeof(typename P::T));
}
template <class P>
__host__ __device__ constexpr int growth_bar_off() {
  return P::O_OFF + GCONSUMERS * growth_out<P>();
}
template <class P>
constexpr size_t growth_smem() {  // + alignment, + full, empty and weights
  return 1024 + growth_bar_off<P>() + 8 * (2 * P::STAGES + 1);
}
static_assert(GrowthBf16::STAGE % 1024 == 0 &&
                  GrowthBf16::WCHUNK % 128 == 0 &&
                  GrowthTf32::HALO % 512 == 0 &&
                  GrowthTf32::WHALF % 512 == 0 &&
                  GrowthTf32::STAGE % 1024 == 0,
              "swizzle and TMA alignment");
static_assert(growth_smem<GrowthBf16>() <= 227 * 1024 &&
                  growth_smem<GrowthTf32>() <= 227 * 1024,
              "shared memory of one block");

// Two output channels into the epilogue's box, in the output's type.
__device__ __forceinline__ void st_shared_pair(uint32_t o, float a, float b,
                                               bf16) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(o),
               "r"(*reinterpret_cast<const uint32_t*>(&v)));
}
__device__ __forceinline__ void st_shared_pair(uint32_t o, float a, float b,
                                               float) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(o), "f"(a),
               "f"(b));
}

// One bf16 chunk of a tile into acc (issued): 9 taps x 2 k16 steps per M
// tile, A at the tap's start in the halo, B in the resident weights.
__device__ __forceinline__ void bf16_chunk(float (&acc)[2][16], uint32_t a0,
                                           uint32_t b0, uint64_t da,
                                           uint64_t db) {
  using P = GrowthBf16;
  wgmma_fence();
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
            desc_at(da, a0 + (2 * ky * HALO_W + 8 * mt + 2 * kx) * P::PIX +
                            32 * kk),
            bd);
    }
  }
  wgmma_commit();
}

// One f32 chunk of a tile into ``part`` (issued, not awaited): split its
// halo in place (both warpgroups together: big over the raw f32 values,
// small beside them; the swizzle moves 16-byte granules, so the
// elementwise split keeps the layout), then every tap's small*big and
// big*small products before the big*big ones, so that the tensor cores'
// truncating adds meet a small running sum first.
__device__ __forceinline__ void tf32_chunk(float (&part)[2][16],
                                           uint8_t* stage_p, uint32_t a0,
                                           uint32_t b0, uint64_t da,
                                           uint64_t db) {
  using P = GrowthTf32;
  float4* hb = reinterpret_cast<float4*>(stage_p);
  float4* hs = reinterpret_cast<float4*>(stage_p + P::HALO);
  for (int i = threadIdx.x; i < P::HALO / 16; i += 128 * GCONSUMERS) {
    const float4 a = hb[i];
    const float4 big = make_float4(tf32_big(a.x), tf32_big(a.y),
                                   tf32_big(a.z), tf32_big(a.w));
    hb[i] = big;
    hs[i] = make_float4(a.x - big.x, a.y - big.y, a.z - big.z, a.w - big.w);
  }
  fence_async_smem();  // the split, seen by the wgmma (async proxy)
  bar_sync(3, 128 * GCONSUMERS);
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 2; ++pass)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t boff = (tap * 4 + 2 * kk) * G * 16;
        const uint64_t bbig = desc_at(db, b0 + boff);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t aoff =
              (2 * ky * HALO_W + 8 * mt + 2 * kx) * P::PIX + 32 * kk;
          const uint64_t abig = desc_at(da, a0 + aoff);
          if (pass == 0) {  // the chunk's first product starts part anew
            wgmma_m64n32k8_tf32(part[mt], desc_at(da, a0 + P::HALO + aoff),
                                bbig, tap + kk > 0);
            wgmma_m64n32k8_tf32(part[mt], abig,
                                desc_at(db, b0 + P::WHALF + boff));
          } else {
            wgmma_m64n32k8_tf32(part[mt], abig, bbig);
          }
        }
      }
    }
  wgmma_commit();
}

// acc += part in f32 (round to nearest) once part's products are done.
// part is only read here: the next chunk's first wgmma ignores its old
// value (scale-d 0), so no instruction writes a wgmma operand between
// wgmmas and ptxas need not serialise them.
__device__ __forceinline__ void fold_tf32(float (&acc)[2][16],
                                          float (&part)[2][16]) {
  fence_acc(part[0]);
  fence_acc(part[1]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[mt][i] += part[mt][i];
}

// One growth conv, rs[..., out_off:out_off+32] = relu(conv(feat) + bias),
// feat = [x, rs[..., :32 t]] in chunks of P::KCH channels, over tiles
// t = blockIdx.x, blockIdx.x + gridDim.x, ... (grid: at most one block per
// SM). w: this conv's packed weights (drdb.py, pack_growth_weights); xmap,
// rmap: the halo maps over x and the growth buffer, omap: the output map
// over the buffer (tile_map).
template <class P>
__global__ void __launch_bounds__(GTHREADS, 1)
    growth_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap rmap,
                  const __grid_constant__ CUtensorMap omap,
                  const uint8_t* __restrict__ w,
                  const float* __restrict__ bias, int nchunks, int out_off,
                  int b, int h, int wd) {
  constexpr int ES = int(sizeof(typename P::T));
  constexpr int XCHUNKS = C / P::KCH;           // x's chunks
  extern __shared__ __align__(128) uint8_t smem_b[];
  const uint32_t raw = smem_u32(smem_b);
  const uint32_t s0 = (raw + 1023) & ~1023u;   // swizzle atoms on 1 KB
  uint8_t* const base = smem_b + (s0 - raw);
  const uint32_t full = s0 + growth_bar_off<P>();  // full[s]: stage s landed
  const uint32_t empty = full + 8 * P::STAGES;     // empty[s]: stage s read
  const uint32_t wbar = empty + 8 * P::STAGES;     // bf16: weights landed
  const int tiles_x = (wd + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * GCONSUMERS);  // one arrival per warp
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * GCONSUMERS) {
    // producer: one thread keeps the ring full
    if (lane != 0) return;
    if constexpr (!P::kTf32) {
      mbar_expect_tx(wbar, nchunks * P::WCHUNK);
      for (int c = 0; c < nchunks; ++c)
        bulk_load(s0 + P::W_OFF + c * P::WCHUNK, w + c * P::WCHUNK,
                  P::WCHUNK, wbar);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
      const int bi = tile / (tiles_x * tiles_y);
      for (int c = 0; c < nchunks; ++c) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t dst = s0 + stage * P::STAGE, bar = full + 8 * stage;
        mbar_expect_tx(bar, P::STAGE_TX);
        const CUtensorMap* map = c < XCHUNKS ? &xmap : &rmap;
        const int ch = P::KCH * (c < XCHUNKS ? c : c - XCHUNKS);
        tma_load_4d(dst, map, ch, tx * TW - 2, ty * TH - 2, bi, bar);
        if constexpr (P::kTf32)  // the chunk's weights beside its halo
          bulk_load(dst + 2 * P::HALO, w + int64_t(c) * P::WCHUNK,
                    P::WCHUNK, bar);
        if (++stage == P::STAGES) {
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
  // layout has no leading offset to set). B: no swizzle, the next k
  // granule 32 rows on, 8-row groups 8 rows apart.
  const uint64_t da = smem_desc(16, HALO_W * P::PIX, 2);
  const uint64_t db = smem_desc(G * 16, 8 * 16, 0);
  // acc: the tile's sums in f32. f32: each chunk's products go into a
  // fresh accumulator, part (its first wgmma ignores the old value),
  // folded into acc once they are done. A second part, to overlap a
  // chunk's products with the next chunk's split, spilled more (288
  // threads get at most 168 registers) and ran slower on the H100.
  float acc[2][16];
  [[maybe_unused]] float part[2][16];
  if constexpr (P::kTf32) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 16; ++i) part[mt][i] = 0.f;
  } else {
    mbar_wait(wbar, 0);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[mt][i] = 0.f;
    int prev = 0;
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a0 = s0 + stage * P::STAGE + 8 * wgi * HALO_W * P::PIX;
      if constexpr (P::kTf32) {
        tf32_chunk(part, base + stage * P::STAGE, a0,
                   s0 + stage * P::STAGE + 2 * P::HALO, da, db);
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * stage);  // the stage is read
        fold_tf32(acc, part);
      } else {
        __syncwarp();
        bf16_chunk(acc, a0, s0 + P::W_OFF + c * P::WCHUNK, da, db);
        if (c > 0) {  // chunk c - 1's products are done: release its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
      }
      if (++stage == P::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (!P::kTf32) {
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (lane == 0) mbar_arrive(empty + 8 * prev);
    }

    // epilogue: bias, relu (rounded to T) into this warpgroup's [8][16][32]
    // output rows in shared memory, then one TMA store (clipped at the
    // image border) that runs while the warpgroup goes on to the next tile
    const uint32_t out = s0 + P::O_OFF + wgi * growth_out<P>();
    if (threadIdx.x % 128 == 0) bulk_wait<true>();  // the last store read it
    bar_sync(1 + wgi, 128);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t o = out +
                           ((2 * q + hh) * TW + 8 * mt + (lane >> 2)) * G * ES +
                           2 * ES * t4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st_shared_pair(o + 8 * ES * i,
                         fmaxf(acc[mt][4 * i + 2 * hh] + bv[2 * i], 0.f),
                         fmaxf(acc[mt][4 * i + 2 * hh + 1] + bv[2 * i + 1],
                               0.f),
                         typename P::T());
      }
    fence_async_smem();
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

// bf16 tail (the serving dtype): persistent, warp-specialised, TMA-fed.
//  - One block per SM walks 128-pixel tiles. A producer thread keeps a
//    3-stage ring full with TMA: x's 64 channels (through its pixel
//    stride) and each r_i's 32 (through theirs) land as [128 px][C_i]
//    boxes, x under the 128-byte swizzle and the r_i under the 64-byte
//    one, so the ldmatrix rows of a fragment fall in distinct banks.
//  - Eight consumer warps, 16 pixels each, run the [16 x 224] x [224 x 64]
//    product on mma.sync m16n8k16 (f32 accumulators) against the
//    bottleneck, loaded once per block into padded [n][k] rows.
//  - Epilogue in the working type (round the accumulator, add the bias,
//    round, relu, add x): each thread overwrites the x elements it read
//    with its outputs, so the x box becomes the output tile, written by
//    one TMA store (clipped at the last pixel) before the stage is freed.
namespace tl {                             // tiles of TP = 128 pixels
constexpr int XB = TP * C * 2;             // x box (then the output), bytes
constexpr int RB = TP * G * 2;             // one r_i box
constexpr int STAGE = XB + NCONV * RB;     // 57,344
constexpr int STAGES = 3;
constexpr int WRS = KT + 8;                // padded weight row, elements
constexpr int WARPS = TP / 16;             // consumers
constexpr int THREADS = 32 * WARPS + 32;   // + one producer warp
constexpr int W_OFF = STAGES * STAGE;
constexpr int BAR_OFF = W_OFF + C * WRS * 2;
constexpr size_t SMEM = 1024 + BAR_OFF + 8 * 2 * STAGES;  // + alignment
static_assert(XB % 1024 == 0 && RB % 1024 == 0, "swizzle alignment");
}  // namespace tl

// out = x + relu(round(round(acc) + bb)) over tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ... (grid: at most one block per SM). maps: x
// [npix][64] and r1..r5 [npix][32] at their pixel strides (loads), out
// [npix][64] (store); wb: [64][224]; bb: f32 [64].
__global__ void __launch_bounds__(tl::THREADS, 1)
    tail_kernel_bf16(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap r1map,
                     const __grid_constant__ CUtensorMap r2map,
                     const __grid_constant__ CUtensorMap r3map,
                     const __grid_constant__ CUtensorMap r4map,
                     const __grid_constant__ CUtensorMap r5map,
                     const __grid_constant__ CUtensorMap omap,
                     const bf16* __restrict__ wb,
                     const float* __restrict__ bb, int64_t npix) {
  using namespace tl;
  extern __shared__ __align__(128) uint8_t smem_b[];
  const uint32_t raw = smem_u32(smem_b);
  const uint32_t s0 = (raw + 1023) & ~1023u;  // swizzle atoms on 1 KB
  uint8_t* base = smem_b + (s0 - raw);
  const uint32_t full = s0 + BAR_OFF;         // full[s]: stage s landed
  const uint32_t empty = full + 8 * STAGES;   // empty[s]: stage s stored
  const int ntiles = int((npix + TP - 1) / TP);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WARPS) {
    // producer: one thread keeps the ring full
    if (lane != 0) return;
    const CUtensorMap* rmaps[NCONV] = {&r1map, &r2map, &r3map, &r4map,
                                       &r5map};
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t dst = s0 + stage * STAGE, bar = full + 8 * stage;
      mbar_expect_tx(bar, STAGE);
      tma_load_2d(dst, &xmap, 0, tile * TP, bar);
      for (int i = 0; i < NCONV; ++i)
        tma_load_2d(dst + XB + i * RB, rmaps[i], 0, tile * TP, bar);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: the bottleneck into padded rows once, the bias in registers
  bf16* sw = reinterpret_cast<bf16*>(base + W_OFF);
  constexpr int WG = KT / 8;  // 16-byte granules per weight row
  for (int i = threadIdx.x; i < C * WG; i += 32 * WARPS) {
    const int r = i / WG, e = (i % WG) * 8;
    cp_async16(sw + r * WRS + e, wb + r * KT + e, true);
  }
  cp_async_commit();
  const int g = lane >> 2, t4 = lane & 3;
  float bv[16];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    bv[2 * nt] = bb[nt * 8 + 2 * t4];
    bv[2 * nt + 1] = bb[nt * 8 + 2 * t4 + 1];
  }
  cp_async_wait<0>();
  bar_sync(1, 32 * WARPS);

  // ldmatrix rows: A = this warp's pixels, B = output channels
  const int a_row = 16 * warp + (lane & 15), a_hi = lane >> 4;
  const int b_n = (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 8;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    mbar_wait(full + 8 * stage, phase);
    uint8_t* const box = base + stage * STAGE;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {
      // k16 step ks: x's 16-byte chunk 2 ks + a_hi of the pixel's 128-byte
      // row (swizzled by row % 8), or r_i's chunk of its 64-byte row
      // (swizzled by (row / 2) % 4)
      int off;
      if (ks < C / 16) {
        off = a_row * 128 + (((2 * ks + a_hi) ^ (a_row & 7)) << 4);
      } else {
        const int i = (ks - C / 16) / 2, kk = (ks - C / 16) % 2;
        off = XB + i * RB + a_row * 64 +
              (((2 * kk + a_hi) ^ ((a_row >> 1) & 3)) << 4);
      }
      uint32_t a[4];
      ldmatrix_x4(a, box + off);
#pragma unroll
      for (int nh = 0; nh < 4; ++nh) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sw + (nh * 16 + b_n) * WRS + ks * 16 + b_k);
        mma_bf16(acc[2 * nh], a, bf[0], bf[1]);
        mma_bf16(acc[2 * nh + 1], a, bf[2], bf[3]);
      }
    }
    // epilogue into the x box: pixel p's channels 8 nt + 2 t4 + {0, 1}
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 16 * warp + g + 8 * half;
      uint8_t* row = box + p * 128 + 4 * t4;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        auto* xo = reinterpret_cast<__nv_bfloat162*>(row + ((nt ^ (p & 7))
                                                            << 4));
        const float2 xv = __bfloat1622float2(*xo);
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float y = round_to<bf16>(round_to<bf16>(acc[nt][2 * half + j])
                                         + bv[2 * nt + j]);
          v[j] = (j == 0 ? xv.x : xv.y) + fmaxf(y, 0.f);
        }
        *xo = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
    fence_async_smem();
    bar_sync(1, 32 * WARPS);  // every warp has read the stage and written
    if (threadIdx.x == 0) {
      tma_store_2d(&omap, s0 + stage * STAGE, 0, tile * TP);
      bulk_wait<true>();  // the store has read the box: free the stage
      mbar_arrive(empty + 8 * stage);
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (threadIdx.x == 0) bulk_wait<false>();
}

// f32 tail (what compute_dtype float32 runs): tail_kernel_bf16's pipeline
// on mma.sync m16n8k8 .tf32 as 3xTF32 (common.cuh, split_tf32).
//  - One block per SM walks 64-pixel tiles (an f32 128-pixel stage, 112 KB,
//    leaves no room for a ring beside the bottleneck). A producer thread
//    keeps a 3-stage ring full with TMA: x's 64 channels as two [64 px][32
//    ch] boxes, each r_i's 32 as one, all through their pixel strides under
//    the 128-byte swizzle (a box row is 128 bytes).
//  - Two groups of four consumer warps take alternate tiles, so one
//    group's loads and epilogue overlap the other's products. A warp owns
//    32 pixels (two m16 tiles) x 32 outputs: per k8 step it reads and
//    splits its A fragments (4 floats a tile) from the swizzled boxes and
//    each B fragment (2 floats) once for both tiles, from the bottleneck,
//    loaded raw once per block as [n][k] rows whose 16-byte granule c sits
//    at c ^ (n % 8); both reads are free of bank conflicts. (16 pixels x
//    64 outputs a warp ran 1.75 ms on the H100; 16 x 32 with 16 warps, at
//    ptxas's 96 registers for 544 threads, 1.36-1.39; this, 1.18.)
//  - Three products per k8 step, small*big and big*small first; each
//    32-channel chunk's twelve into a fresh accumulator added to the f32
//    sum (the tensor cores add with truncation, see the growth above), the
//    first chunk's into the sum itself. A fresh accumulator per 16
//    channels ran 15-20 % slower: its zeroing and adding cost issue slots.
//  - Epilogue in f32 (bias, relu, residual) over the x boxes, once the
//    warps sharing the pixels are done reading them; two TMA stores
//    (clipped at the last pixel) write the boxes out before the stage is
//    freed.
namespace tf {                             // tiles of TP / 2 = 64 pixels
constexpr int TPX = TP / 2;
constexpr int BOX = TPX * 32 * 4;          // one [64 px][32 ch] f32 box
constexpr int NBOX = C / 32 + NCONV;       // x's two boxes, r1..r5
constexpr int STAGE = NBOX * BOX;          // 57,344
constexpr int STAGES = 3;
constexpr int MT = 2;                      // m16 tiles of a warp
constexpr int NSPLIT = 2;                  // warps sharing a pixel's outputs
constexpr int NTW = 8 / NSPLIT;            // n8 tiles of a warp
constexpr int MW = TPX / 16 / MT;          // warps along a tile's pixels
constexpr int GWARPS = MW * NSPLIT;        // warps of a consumer group
constexpr int GROUPS = 2;
constexpr int FOLD = 4;                    // k8 steps per fresh accumulator
constexpr int WARPS = GWARPS * GROUPS;
constexpr int THREADS = 32 * WARPS + 32;   // + one producer warp
constexpr int WROW = KT * 4;               // a bottleneck row, bytes
constexpr int W_OFF = STAGES * STAGE;
constexpr int BAR_OFF = W_OFF + C * WROW;
constexpr size_t SMEM = 1024 + BAR_OFF + 8 * 2 * STAGES;  // + alignment
static_assert(BOX % 1024 == 0 && SMEM <= 227 * 1024 && (KT / 8) % FOLD == 0,
              "f32 tail layout");
}  // namespace tf

__device__ __forceinline__ float lds_f32(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}

// out = x + relu(acc + bb) over tiles t = blockIdx.x, blockIdx.x +
// gridDim.x, ... (grid: at most one block per SM). maps: x [npix][64] (two
// 32-channel boxes) and r1..r5 [npix][32] at their pixel strides (loads),
// out [npix][64] (store); wb: f32 [64][224]; bb: f32 [64].
__global__ void __launch_bounds__(tf::THREADS, 1)
    tail_kernel_f32(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap r1map,
                    const __grid_constant__ CUtensorMap r2map,
                    const __grid_constant__ CUtensorMap r3map,
                    const __grid_constant__ CUtensorMap r4map,
                    const __grid_constant__ CUtensorMap r5map,
                    const __grid_constant__ CUtensorMap omap,
                    const float* __restrict__ wb,
                    const float* __restrict__ bb, int64_t npix) {
  using namespace tf;
  extern __shared__ __align__(128) uint8_t smem_b[];
  const uint32_t raw = smem_u32(smem_b);
  const uint32_t s0 = (raw + 1023) & ~1023u;  // swizzle atoms on 1 KB
  uint8_t* base = smem_b + (s0 - raw);
  const uint32_t full = s0 + BAR_OFF;         // full[s]: stage s landed
  const uint32_t empty = full + 8 * STAGES;   // empty[s]: stage s stored
  const int ntiles = int((npix + TPX - 1) / TPX);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WARPS) {
    // producer: one thread keeps the ring full, the block's i-th tile in
    // stage i % STAGES
    if (lane != 0) return;
    const CUtensorMap* rmaps[NCONV] = {&r1map, &r2map, &r3map, &r4map,
                                       &r5map};
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t dst = s0 + stage * STAGE, bar = full + 8 * stage;
      mbar_expect_tx(bar, STAGE);
      tma_load_2d(dst, &xmap, 0, tile * TPX, bar);
      tma_load_2d(dst + BOX, &xmap, 32, tile * TPX, bar);
      for (int i = 0; i < NCONV; ++i)
        tma_load_2d(dst + (2 + i) * BOX, rmaps[i], 0, tile * TPX, bar);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: the bottleneck once, raw, granule c of row n at c ^ (n % 8)
  constexpr int WG = KT / 4;  // 16-byte granules per row
  for (int i = threadIdx.x; i < C * WG; i += 32 * WARPS) {
    const int n = i / WG, c = i % WG;
    cp_async16(base + W_OFF + n * WROW + ((c ^ (n & 7)) << 4),
               wb + n * KT + c * 4, true);
  }
  cp_async_commit();
  // lane (g, t4) of warp lw of a group holds, of each of its m16 tiles
  // m = MT mw + i, pixels 16 m + g and + 8 (both at row % 8 = g in the
  // swizzle) and, of its n8 tile nt (of the whole 8: j = NTW nh + nt),
  // outputs 8 j + 2 t4, + 1; as B it reads row n = 8 j + g
  const int grp = warp / GWARPS, lw = warp % GWARPS;
  const int mw = lw % MW, nh = lw / MW;
  const int g = lane >> 2, t4 = lane & 3;
  float bv[2 * NTW];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    bv[2 * nt] = bb[(NTW * nh + nt) * 8 + 2 * t4];
    bv[2 * nt + 1] = bb[(NTW * nh + nt) * 8 + 2 * t4 + 1];
  }
  cp_async_wait<0>();
  bar_sync(1, 32 * WARPS);

  const int p0 = 16 * MT * mw + g;
  const uint8_t* wrow = base + W_OFF + (8 * NTW * nh + g) * WROW + 4 * t4;
  for (int i = grp; blockIdx.x + i * gridDim.x < ntiles; i += GROUPS) {
    const int tile = blockIdx.x + i * gridDim.x, stage = i % STAGES;
    mbar_wait(full + 8 * stage, (i / STAGES) & 1);
    uint8_t* const box = base + stage * STAGE;
    const uint8_t* arow = box + p0 * 128 + 4 * t4;
    // chunk kc, k8 steps FOLD kc ... FOLD kc + FOLD - 1, into sum (zeroed
    // here): the first chunk's into acc itself, the others' into a fresh
    // part added to acc
    auto chunk = [&](int kc, float(&sum)[MT][NTW][4]) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) sum[m][nt][c] = 0.f;
#pragma unroll
      for (int h = 0; h < FOLD; ++h) {
        // k8 step s: channels 8 s + t4 (a0, a1) and + 4 (a2, a3), in box
        // s / 4 (x: 0, 1; r_i: 2 + i) at granules 2 (s % 4) and + 1
        const int s = FOLD * kc + h, c0 = 2 * (s % 4);
        uint32_t abig[MT][4], asmall[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint8_t* ab = arow + (s / 4) * BOX + m * 2048;
          split_tf32(lds_f32(ab + ((c0 ^ g) << 4)), abig[m][0],
                     asmall[m][0]);
          split_tf32(lds_f32(ab + 1024 + ((c0 ^ g) << 4)), abig[m][1],
                     asmall[m][1]);
          split_tf32(lds_f32(ab + (((c0 + 1) ^ g) << 4)), abig[m][2],
                     asmall[m][2]);
          split_tf32(lds_f32(ab + 1024 + (((c0 + 1) ^ g) << 4)), abig[m][3],
                     asmall[m][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          // b0 = W[n][8 s + t4], b1 = W[n][8 s + t4 + 4]: granules 2 s,
          // 2 s + 1 of row n; split once for the warp's m16 tiles
          const uint8_t* br = wrow + nt * 8 * WROW;
          uint32_t b0, b0s, b1, b1s;
          split_tf32(lds_f32(br + (((2 * s) ^ g) << 4)), b0, b0s);
          split_tf32(lds_f32(br + (((2 * s + 1) ^ g) << 4)), b1, b1s);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_tf32(sum[m][nt], asmall[m], b0, b1);
            mma_tf32(sum[m][nt], abig[m], b0s, b1s);
            mma_tf32(sum[m][nt], abig[m], b0, b1);
          }
        }
      }
    };
    float acc[MT][NTW][4];
    chunk(0, acc);
#pragma unroll
    for (int kc = 1; kc < KT / 8 / FOLD; ++kc) {
      float part[MT][NTW][4];
      chunk(kc, part);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][nt][c] += part[m][nt][c];
    }
    // epilogue into the x boxes: pixel p's channels n = 8 j + 2 t4, + 1
    // (j = NTW nh + nt), in box j / 4 at granule 2 (j % 4) + t4 / 2, once
    // the other warps of the pixels are done reading x
    bar_sync(2 + grp, 32 * GWARPS);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint8_t* row =
            box + (p0 + 16 * m + 8 * half) * 128 + 8 * (t4 & 1);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const int j = NTW * nh + nt;
          auto* xo = reinterpret_cast<float2*>(
              row + (j / 4) * BOX + (((2 * (j % 4) + (t4 >> 1)) ^ g) << 4));
          const float2 xv = *xo;
          *xo = make_float2(
              xv.x + fmaxf(acc[m][nt][2 * half] + bv[2 * nt], 0.f),
              xv.y + fmaxf(acc[m][nt][2 * half + 1] + bv[2 * nt + 1], 0.f));
        }
      }
    fence_async_smem();
    bar_sync(2 + grp, 32 * GWARPS);  // the group has read the stage, written
    if (lw == 0 && lane == 0) {
      tma_store_2d(&omap, s0 + stage * STAGE, 0, tile * TPX);
      tma_store_2d(&omap, s0 + stage * STAGE + BOX, 32, tile * TPX);
      bulk_wait<true>();  // the stores have read the boxes: free the stage
      mbar_arrive(empty + 8 * stage);
    }
  }
  if (lw == 0 && lane == 0) bulk_wait<false>();
}

// A 4-D TMA map over a channels_last tensor [b][h][wd][channels] of f32
// or bf16 at pixel stride ps (elements), boxes of bc channels x bw x bh
// pixels: with the 64-byte swizzle (bc channels are 64 bytes), a 20 x 20
// halo chunk as the wgmma A operand reads it; without, an output box of
// 16 x 8 pixels.
bool tile_map(CUtensorMap* map, bool f32, const void* base, int64_t ps,
              int channels, int b, int h, int wd, int bc, int bw, int bh,
              bool swizzle) {
  const cuuint64_t bytes = cuuint64_t(ps) * (f32 ? 4 : 2);
  const cuuint64_t dims[4] = {cuuint64_t(channels), cuuint64_t(wd),
                              cuuint64_t(h), cuuint64_t(b)};
  const cuuint64_t strides[3] = {bytes, bytes * wd, bytes * wd * h};
  const cuuint32_t box[4] = {cuuint32_t(bc), cuuint32_t(bw), cuuint32_t(bh),
                             1};
  return encode_map(map,
                    f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    4, base, dims, strides, box,
                    swizzle ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The growth chain in P's type: three maps per call (the halos of x and
// of the growth buffer, the buffer's output tiles) serve all five
// launches; conv t reads (64 + 32 t) / P::KCH chunks.
template <class P>
int growth(const void* x, int64_t x_ps, void* rs, const void* w,
           const float* bias, int b, int h, int wd, cudaStream_t stream) {
  constexpr bool f32 = P::kTf32;
  CUtensorMap xmap, rmap, omap;
  if (!tile_map(&xmap, f32, x, x_ps, C, b, h, wd, P::KCH, HALO_W, HALO_H,
                true) ||
      !tile_map(&rmap, f32, rs, RCH, RCH, b, h, wd, P::KCH, HALO_W, HALO_H,
                true) ||
      !tile_map(&omap, f32, rs, RCH, RCH, b, h, wd, G, TW, 8, false))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(growth_kernel<P>, growth_smem<P>());
  if (err != cudaSuccess) return int(err);
  const int tiles = ((wd + TW - 1) / TW) * ((h + TH - 1) / TH) * b;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  for (int t = 0; t < NCONV; ++t) {
    const int nchunks = (C + G * t) / P::KCH;
    growth_kernel<P><<<grid, GTHREADS, growth_smem<P>(), stream>>>(
        xmap, rmap, omap, wp, bias + G * t, nchunks, G * t, b, h, wd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    wp += int64_t(nchunks) * P::WCHUNK;
  }
  return 0;
}

// A 2-D TMA map over `channels` channels of npix pixels at pixel stride ps
// (elements). bf16: boxes of all the channels x 128 pixels under the
// swizzle whose span is the box's row (128 bytes for 64 channels, 64 for
// 32). f32: boxes of 32 channels (128 bytes) x 64 pixels, 128-byte swizzle.
bool pixel_map(CUtensorMap* map, bool f32, const void* base, int64_t ps,
               int channels, int64_t npix) {
  const cuuint64_t dims[2] = {cuuint64_t(channels), cuuint64_t(npix)};
  const cuuint64_t strides[1] = {cuuint64_t(ps) * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {cuuint32_t(f32 ? 32 : channels),
                             cuuint32_t(f32 ? tf::TPX : TP)};
  return encode_map(map,
                    f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    2, base, dims, strides, box,
                    f32 || channels == C ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B);
}

// The maps of one tail launch (x, r1..r5, out) in either type.
bool tail_maps(bool f32, const void* x, int64_t x_ps,
               const void* const r[NCONV], int64_t r_ps, void* out,
               int64_t npix, CUtensorMap* xmap, CUtensorMap* rmaps,
               CUtensorMap* omap) {
  bool ok = pixel_map(xmap, f32, x, x_ps, C, npix) &&
            pixel_map(omap, f32, out, C, C, npix);
  for (int i = 0; i < NCONV; ++i)
    ok = ok && pixel_map(&rmaps[i], f32, r[i], r_ps, G, npix);
  return ok;
}

int tail_bf16(const void* x, int64_t x_ps, const void* const r[NCONV],
              int64_t r_ps, const void* wb, const float* bb, void* out,
              int64_t npix, cudaStream_t stream) {
  CUtensorMap xmap, rmaps[NCONV], omap;
  if (!tail_maps(false, x, x_ps, r, r_ps, out, npix, &xmap, rmaps, &omap))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(tail_kernel_bf16, tl::SMEM);
  if (err != cudaSuccess) return int(err);
  const int64_t tiles = (npix + TP - 1) / TP;
  const int grid = int(tiles < sm_count() ? tiles : sm_count());
  tail_kernel_bf16<<<grid, tl::THREADS, tl::SMEM, stream>>>(
      xmap, rmaps[0], rmaps[1], rmaps[2], rmaps[3], rmaps[4], omap,
      static_cast<const bf16*>(wb), bb, npix);
  return int(cudaGetLastError());
}

int tail_f32(const void* x, int64_t x_ps, const void* const r[NCONV],
             int64_t r_ps, const void* wb, const float* bb, void* out,
             int64_t npix, cudaStream_t stream) {
  CUtensorMap xmap, rmaps[NCONV], omap;
  if (!tail_maps(true, x, x_ps, r, r_ps, out, npix, &xmap, rmaps, &omap))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(tail_kernel_f32, tf::SMEM);
  if (err != cudaSuccess) return int(err);
  const int64_t tiles = (npix + tf::TPX - 1) / tf::TPX;
  const int grid = int(tiles < sm_count() ? tiles : sm_count());
  tail_kernel_f32<<<grid, tf::THREADS, tf::SMEM, stream>>>(
      xmap, rmaps[0], rmaps[1], rmaps[2], rmaps[3], rmaps[4], omap,
      static_cast<const float*>(wb), bb, npix);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace segmif

extern "C" {

// The growth chain. x: [B,H,W,64] with pixel stride x_ps (elements);
// rs: [B,H,W,160] contiguous, receives r1..r5; w: the five convs'
// weights packed per input chunk as the wgmma B operand: bf16 per 32
// channels, [chunk][tap][k granule of 8][n][8] (20 chunks of 9 x 32 x 32
// in all); f32 per 16 channels, [chunk][big, small][tap][k granule of 4]
// [n][4] (40 chunks of 2 x 9 x 16 x 32); bias: f32 [160]. Needs x 16-byte
// aligned and x_ps a multiple of 16 bytes (TMA). Returns cudaGetLastError(),
// or cudaErrorInvalidValue if the tensor maps cannot be made.
int segmif_drdb_growth(const void* x, int64_t x_ps, void* rs, const void* w,
                       const void* bias, int b, int h, int wd, int dtype,
                       void* stream) {
  using namespace segmif;
  auto st = static_cast<cudaStream_t>(stream);
  auto bf = static_cast<const float*>(bias);
  if (dtype == kF32)
    return growth<GrowthTf32>(x, x_ps, rs, w, bf, b, h, wd, st);
  if (dtype == kBF16)
    return growth<GrowthBf16>(x, x_ps, rs, w, bf, b, h, wd, st);
  return int(cudaErrorInvalidValue);
}

// The tail. x: [npix][64] at pixel stride x_ps; r1..r5: [npix][32] at
// pixel stride r_ps; wb: the bottleneck packed [64][224] ([n][k]) in the
// input type; bb: f32 [64]; out: [npix][64] contiguous. Needs every
// pointer 16-byte aligned and x_ps, r_ps multiples of 16 bytes (TMA).
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
    return tail_f32(x, x_ps, r, r_ps, wb, bf, out, npix, st);
  if (dtype == kBF16)
    return tail_bf16(x, x_ps, r, r_ps, wb, bf, out, npix, st);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
