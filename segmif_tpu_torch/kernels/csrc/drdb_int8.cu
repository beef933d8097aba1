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
//  int8_conv_kernel<t>: growth conv t (five launches), an implicit GEMM
//    on wgmma.mma_async m64n32k32 s8 x s8 -> s32 (A and B K-major from
//    shared memory, as 8-bit wgmma requires). M = output pixels, N = 32,
//    K = 9 taps x 32-channel chunks of the buffer: a chunk is exactly one
//    k32 step per tap. A unit of work is 8 image rows x 16 pixels, two M
//    tiles of 8 rows x 8 pixels. TMA loads each chunk's halo (box 32 ch x
//    20 x 12 over the buffer) into a ring of mbarrier stages under the
//    32-byte swizzle, whose span is one pixel's 32 bytes: 8 pixels are one
//    256-byte atom, the 8-row groups of an M tile one halo row apart, and a
//    tap (ky, kx) only moves the descriptor's start by (2 ky 20 + 2 kx) x
//    32 bytes, since the swizzle follows the shared-memory address. TMA's
//    zero fill outside the tensor is the conv's padding. Persistent and
//    warp-specialised: one block per SM; a producer warpgroup (one thread
//    issues the loads; setmaxnreg gives its registers to the consumers)
//    and two consumer warpgroups that take the block's units alternately,
//    each with its own ring; the conv's weights ([chunk][tap][k granule]
//    [n][16], at most 6 x 9 KB) are loaded once per block. One s32
//    accumulator set per source (x's two chunks are one source, then each
//    r): conv t is a template on t so every set is indexed at compile time
//    (conv 5: 5 sets x 2 M tiles x 16 registers). The sets are zeroed
//    behind an asm fence (else the compiler sinks a later set's zeroing
//    between the wgmma of the unrolled chunk loop, and ptxas serialises
//    them: C7520), and no set is read until wgmma.wait_group 0 has retired
//    every group of the unit. Then the sets are folded into f32 in the
//    reference's order, requantised into a [8][16][32] int8 box per
//    warpgroup and written by one TMA store of r_t's 32-channel slice,
//    clipped at the image border.
//  int8_tail_kernel: [128 pixels, 224] x [224, 64] int8 GEMM, 7 k32 steps,
//    then the f32 epilogue against x, stored in x's dtype.
//
// What bounds it on the H100: about 0.37 M int8 ops per pixel for the five
// convs (906 G ops at [8, 64, 480, 640]: 0.46 ms at NVIDIA's 1,979 dense
// int8 TOP/s). The five launches move 640 bytes in and 160 out per pixel
// (1.97 GB, 0.59 ms at 3.35 TB/s; 0.73 ms with the entry quantise). At N =
// 32 each m64n32k32 reads 2 KB of A and, in each of the four warps, the
// 1 KB of B from shared memory for 131 K ops: the products run near half
// the int8 peak, and the fold (five f32 sources per value) and the store
// of each unit take as long again, overlapped only where the other
// consumer warpgroup is in its products.

#include "common.cuh"

namespace segmif {
namespace {

constexpr int C = 64;                 // trunk channels
constexpr int G = 32;                 // growth per conv
constexpr int NCONV = 5;
constexpr int CT = C + G * NCONV;     // channels of the int8 buffer (224)
constexpr int KC = 32;                // channels per chunk: one k32 step
constexpr int TW = 16;                // output pixels of a growth unit
constexpr int HALO_W = TW + 4;        // dilation 2, reach 2
constexpr int kThreads = 256;         // 8 warps (tail)
// Tail rows (one pixel's 224 channels, one weight row) are padded by one
// 16-byte granule, so the 8 rows an ldmatrix phase reads fall in distinct
// banks.
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

// d (64 x 32 s32, the warpgroup's fragments) += A (64 x 32) B (32 x 32),
// both s8, K-major (8-bit wgmma takes no other), read from shared memory
// through descriptors. Integer sums: exact in any order.
__device__ __forceinline__ void wgmma_m64n32k32_s8(int d[16], uint64_t a,
                                                   uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

namespace wg {
constexpr int UH = 8;                          // output rows of a unit
constexpr int ROW = HALO_W;                    // halo row in smem, pixels
constexpr int PIX = KC;                        // a pixel's chunk, bytes
constexpr int HALO = (UH + 4) * ROW * PIX;     // a chunk's halo, 7,680
constexpr int STAGE = 8 * 1024;                // the halo on 1 KB bounds
constexpr int STAGES = 6;                      // per consumer warpgroup
constexpr int RING = STAGES * STAGE;
constexpr int WCHUNK = 9 * KC * G;             // a chunk's weights, 9,216
constexpr int MAX_CHUNKS = 2 + NCONV - 1;      // conv 5: x's 2, r1..r4
constexpr int CONSUMERS = 2;                   // warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS); // the producer's first
constexpr int OUT = UH * TW * G;               // a unit's output box
constexpr int PRM = NCONV * G + G + 1;         // sv [source][32], bias, inv
constexpr int W_OFF = CONSUMERS * RING;
constexpr int O_OFF = W_OFF + MAX_CHUNKS * WCHUNK;
constexpr int P_OFF = O_OFF + CONSUMERS * OUT;
constexpr int BAR_OFF = P_OFF + (PRM * 4 + 7) / 8 * 8;
// full and empty per ring stage, and the weights'
constexpr int NBAR = 2 * CONSUMERS * STAGES + 1;
constexpr size_t SMEM = 1024 + BAR_OFF + 8 * NBAR;
static_assert(HALO <= STAGE && STAGE % 1024 == 0 && WCHUNK % 128 == 0,
              "TMA alignment");
}  // namespace wg

// Growth conv T (0..4): feat[..., 64 + 32 T : 96 + 32 T] = requant(pre)
// over the first T + 2 chunks of feat (sources x = chunks 0-1, then r1..
// r_T). Work comes in units of 8 rows x 16 pixels, u = blockIdx.x,
// blockIdx.x + gridDim.x, ... (grid: at most one block per SM), taken by
// the two consumer warpgroups alternately, each with its own ring of halo
// stages, so one's epilogue can run under the other's products. lmap: the
// halo map over feat (box 32 ch x 20 x 12, 32-byte swizzle); omap: its
// output map (box 32 ch x 16 x 8); w: this conv's
// weights, [chunk][tap][k granule of 16][n = 32][16]; sv: this target's
// f32 column scales [source][32]; bias: its 32 biases; inv: 1 / s of
// r_{T+1}. T is a template parameter so that every accumulator set is
// indexed at compile time.
template <int T>
__global__ void __launch_bounds__(wg::THREADS, 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap lmap,
                       const __grid_constant__ CUtensorMap omap,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ sv,
                       const float* __restrict__ bias,
                       const float* __restrict__ inv, int b, int h, int wd) {
  using namespace wg;
  constexpr int NSRC = T + 1, NCHUNK = T + 2;
  extern __shared__ __align__(128) uint8_t smem_b[];
  const uint32_t raw = smem_u32(smem_b);
  const uint32_t s0 = (raw + 1023) & ~1023u;  // swizzle atoms on 1 KB
  uint8_t* base = smem_b + (s0 - raw);
  const float* prm = reinterpret_cast<const float*>(base + P_OFF);
  const uint32_t ws = s0 + W_OFF;
  const uint32_t full = s0 + BAR_OFF;           // [consumer][stage]
  const uint32_t empty = full + 8 * CONSUMERS * STAGES;
  const uint32_t wbar = empty + 8 * CONSUMERS * STAGES;  // the weights
  const int tiles_x = (wd + TW - 1) / TW, units_y = (h + UH - 1) / UH;
  const int nunits = tiles_x * units_y * b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < NSRC * G + G + 1; i += THREADS)
    reinterpret_cast<float*>(base + P_OFF)[i] =
        i < NSRC * G ? sv[i] : i < NSRC * G + G ? bias[i - NSRC * G] : *inv;
  if (threadIdx.x == 0) {
    for (int s = 0; s < CONSUMERS * STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    // producer warpgroup: registers to the consumers; one thread keeps
    // both rings full, unit by unit in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 0 || lane != 0) return;
    mbar_expect_tx(wbar, NCHUNK * WCHUNK);
    bulk_load(ws, w, NCHUNK * WCHUNK, wbar);
    int stage[CONSUMERS] = {0, 0};
    uint32_t phase[CONSUMERS] = {0, 0};
    for (int k = 0, u = blockIdx.x; u < nunits; ++k, u += gridDim.x) {
      const int c = k % CONSUMERS;
      const int tx = u % tiles_x, uy = (u / tiles_x) % units_y;
      const int bi = u / (tiles_x * units_y);
      for (int ch = 0; ch < NCHUNK; ++ch) {
        const int s = c * STAGES + stage[c];
        mbar_wait(empty + 8 * s, phase[c] ^ 1);
        mbar_expect_tx(full + 8 * s, HALO);
        tma_load_4d(s0 + c * RING + stage[c] * STAGE, &lmap, KC * ch,
                    tx * TW - 2, uy * UH - 2, bi, full + 8 * s);
        if (++stage[c] == STAGES) {
          stage[c] = 0;
          phase[c] ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup cw takes units cw, cw + 2, ... of this block, as
  // two M tiles (pixels 0-7 and 8-15 of its 8 rows); warp q of it holds
  // rows 2q, 2q + 1 of each, pixel lane / 4, channels 8 i + 2 (lane % 4)
  // + {0, 1}
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = (warp >> 2) - 1, q = warp & 3, t4 = lane & 3;
  const uint32_t ring = s0 + cw * RING;
  const uint32_t my_full = full + 8 * cw * STAGES;
  const uint32_t my_empty = empty + 8 * cw * STAGES;
  const uint32_t out = s0 + O_OFF + cw * OUT;
  // A: 32-byte swizzle (a pixel's 32 channels are one swizzled row, 8
  // pixels one 256-byte atom), 8-row groups one halo row apart. B: no
  // swizzle, the second k granule 32 rows on, 8-row groups 8 rows apart.
  const uint64_t da = smem_desc(16, ROW * PIX, 3);
  const uint64_t db = smem_desc(G * 16, 8 * 16, 0);
  int acc[NSRC][2][16];  // one accumulator set per source
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(wbar, 0);
  for (int u = blockIdx.x + cw * gridDim.x; u < nunits;
       u += CONSUMERS * gridDim.x) {
#pragma unroll
    for (int s = 0; s < NSRC; ++s)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[s][mt][i] = 0;
#pragma unroll
    for (int s = 0; s < NSRC; ++s) {  // every set zeroed before any wgmma
      fence_acc(acc[s][0]);
      fence_acc(acc[s][1]);
    }
    int prev = 0;
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      const int s = c < 2 ? 0 : c - 1;
      mbar_wait(my_full + 8 * stage, phase);
      __syncwarp();
      wgmma_fence();
      const uint32_t a0 = ring + stage * STAGE;
      const uint32_t b0 = ws + c * WCHUNK;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const uint64_t bd = desc_at(db, b0 + tap * KC * G);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          wgmma_m64n32k32_s8(
              acc[s][mt],
              desc_at(da, a0 + (2 * ky * ROW + 8 * mt + 2 * kx) * PIX), bd);
      }
      wgmma_commit();
      if (c > 0) {  // chunk c - 1's products are done: release its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(my_empty + 8 * prev);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < NSRC; ++s) {
      fence_acc(acc[s][0]);
      fence_acc(acc[s][1]);
    }
    if (lane == 0) mbar_arrive(my_empty + 8 * prev);

    // epilogue: the f32 fold in the reference's order, requant, into this
    // warpgroup's [8][16][32] output box in shared memory, then one TMA
    // store (clipped at the image border) that runs while the warpgroup
    // goes on to its next unit
    if (threadIdx.x % 128 == 0) bulk_wait<true>();  // the last store read it
    bar_sync(1 + cw, 128);
    const float iv = prm[NSRC * G + G];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // this thread's channels n, n + 1: their scales and biases
      const int n = 8 * i + 2 * t4;
      float2 svn[NSRC];
#pragma unroll
      for (int s = 0; s < NSRC; ++s)
        svn[s] = *reinterpret_cast<const float2*>(prm + s * G + n);
      const float2 bn = *reinterpret_cast<const float2*>(prm + NSRC * G + n);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int k = 4 * i + 2 * hh;
          // pre = acc_x sv_x + bias, then + acc_s sv_s for s = 1..T
          float p0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[0][mt][k]),
                                         svn[0].x), bn.x);
          float p1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[0][mt][k + 1]),
                                         svn[0].y), bn.y);
#pragma unroll
          for (int s = 1; s < NSRC; ++s) {
            p0 = __fadd_rn(p0, __fmul_rn(__int2float_rn(acc[s][mt][k]),
                                         svn[s].x));
            p1 = __fadd_rn(p1, __fmul_rn(__int2float_rn(acc[s][mt][k + 1]),
                                         svn[s].y));
          }
          const uint32_t pair = uint32_t(uint8_t(requant(p0, iv))) |
                                uint32_t(uint8_t(requant(p1, iv))) << 8;
          const uint32_t o =
              out + ((2 * q + hh) * TW + 8 * mt + (lane >> 2)) * G + n;
          asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(o),
                       "h"(uint16_t(pair)));
        }
    }
    fence_async_smem();
    bar_sync(1 + cw, 128);
    if (threadIdx.x % 128 == 0) {
      const int tx = u % tiles_x, uy = (u / tiles_x) % units_y;
      tma_store_4d(&omap, out, C + G * T, tx * TW, uy * UH,
                   u / (tiles_x * units_y));
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait<false>();
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

// A 4-D TMA map over the int8 buffer [b][h][wd][224], boxes of 32
// channels x bw x bh pixels: with the 32-byte swizzle, a 20 x 20 halo
// chunk as the wgmma A operand reads it; without, an output box.
bool feat_map(CUtensorMap* map, const int8_t* feat, int b, int h, int wd,
              int bw, int bh, bool swizzle) {
  const cuuint64_t dims[4] = {cuuint64_t(CT), cuuint64_t(wd), cuuint64_t(h),
                              cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(CT), cuuint64_t(CT) * wd,
                                 cuuint64_t(CT) * wd * h};
  const cuuint32_t box[4] = {KC, cuuint32_t(bw), cuuint32_t(bh), 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, feat, dims,
                    strides, box,
                    swizzle ? CU_TENSOR_MAP_SWIZZLE_32B
                            : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Growth conv T on `grid` persistent blocks; w: its packed weights.
template <int T>
cudaError_t launch_conv(const CUtensorMap& lmap, const CUtensorMap& omap,
                        const int8_t* w, const float* svk, const float* bias,
                        const float* invs, int b, int h, int wd, int grid,
                        cudaStream_t stream) {
  auto kern = int8_conv_kernel<T>;
  cudaError_t err = allow_smem(kern, wg::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<grid, wg::THREADS, wg::SMEM, stream>>>(
      lmap, omap, w, svk + T * NCONV * G, bias + G * T, invs + 1 + T, b, h,
      wd);
  return cudaGetLastError();
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
  CUtensorMap lmap, omap;
  if (!feat_map(&lmap, feat, b, h, wd, HALO_W, wg::UH + 4, true) ||
      !feat_map(&omap, feat, b, h, wd, TW, wg::UH, false))
    return int(cudaErrorInvalidValue);
  const int units = ((wd + TW - 1) / TW) * ((h + wg::UH - 1) / wg::UH) * b;
  const int grid = units < sm_count() ? units : sm_count();
  using Launch = cudaError_t (*)(const CUtensorMap&, const CUtensorMap&,
                                 const int8_t*, const float*, const float*,
                                 const float*, int, int, int, int,
                                 cudaStream_t);
  const Launch convs[NCONV] = {launch_conv<0>, launch_conv<1>,
                               launch_conv<2>, launch_conv<3>,
                               launch_conv<4>};
  for (int t = 0; t < NCONV; ++t) {
    err = convs[t](lmap, omap, w, svk, bias, invs, b, h, wd, grid, stream);
    if (err != cudaSuccess) return int(err);
    w += int64_t(2 + t) * 9 * G * KC;  // (64 + 32 t) / 32 chunks
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
// [tap][k granule of 16][n][16] (the wgmma B operand; 20 chunks of 9 x 32
// x 32 int8); svk: f32 [target][source][32] column scales; bias: f32
// [160]; s_in, invs: f32 [6] (the scales of x, r1..r5 and their
// reciprocals). Returns cudaGetLastError(), or cudaErrorInvalidValue if
// the tensor maps cannot be made.
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
