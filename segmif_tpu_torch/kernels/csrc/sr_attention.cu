// MiT spatially-reduced softmax attention, forward, for Hopper (sm_90a).
//
// Replaces: segmif_tpu/kernels/pallas_attention.py, _sr_attention_fwd_impl
// (kernel _sr_attn_kernel): out = softmax(q k^T * scale) v per (batch, head)
// with the whole K/V block on chip, f32 logits, one pass, no online
// rescaling.
//
// Shapes: q [B,N,H,D], k/v [B,M,H,D], read in place through their batch,
// token and head strides (the last dim must be contiguous), so the TPU
// wrapper's transposes and pads are not needed. out [B,N,H,D] contiguous.
// At 480x640 every MiT stage has M = 300 and D = 64 (mit_b3).
//
// What bounds it on the H100: with M = 300 the logits never need to leave
// the SM, so device-memory traffic is only q, k, v and out; the work is
// 4*N*M*D FLOP per (b, h). This first version runs that work on the CUDA
// cores in f32 (no tensor cores), so it is bound by shared-memory
// bandwidth and FMA issue, not by device memory.
//
// Design: one block per (query tile of 128, b*h). K and V are staged once
// per block into shared memory as f32 rows padded to D+4 floats (float4
// aligned; consecutive keys land on different banks). Each warp owns one
// query at a time: q sits in registers; each lane computes the logits of
// keys lane, lane+32, ... (four keys in flight for independent FMA
// chains) into a per-warp row of shared memory; a warp max/sum gives the
// softmax; then each lane accumulates D/32 output dims over all M keys.
// Padded and ragged edges are masked by index (no padding copies).
// Shared memory is 4*(2*M*(D+4) + 16*M) bytes: 182,400 at M=300, D=64.
// M beyond what fits (382 at D=64) is refused; 1080p needs a chunked
// online-softmax form.

#include "common.cuh"

namespace segmif {
namespace {

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    sr_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int n,
                        int m, int h_count, int64_t sqb, int64_t sqn,
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
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  for (int i = threadIdx.x; i < m * D; i += kThreads) {
    const int j = i / D, d = i % D;
    ks[j * S + d] = to_f32(kb[j * skm + d]);
    vs[j * S + d] = to_f32(vb[j * svm + d]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p = ps + warp * m;
  const int q_end = min(n, (blockIdx.x + 1) * kQueriesPerBlock);
  for (int qi = blockIdx.x * kQueriesPerBlock + warp; qi < q_end;
       qi += kWarps) {
    const T* qp = q + b * sqb + int64_t(qi) * sqn + h * sqh;
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_f32(qp[d]);

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
    T* op = out + ((int64_t(b) * n + qi) * h_count + h) * D + lane * DPL;
#pragma unroll
    for (int t = 0; t < DPL; ++t) op[t] = from_f32<T>((o0[t] + o1[t]) * inv);
    __syncwarp();  // p is rewritten by the next query
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int n, int m, int h, int64_t sqb, int64_t sqn, int64_t sqh,
           int64_t skb, int64_t skm, int64_t skh, int64_t svb, int64_t svm,
           int64_t svh, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(m);
  if (m < 1 || smem > size_t(max_dynamic_smem()))
    return int(cudaErrorInvalidValue);
  auto kern = sr_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, m, h, sqb, sqn, sqh,
      skb, skm, skh, svb, svm, svh, scale);
  return int(cudaGetLastError());
}

template <int D> int max_m() {
  const size_t per_key = sizeof(float) * (2 * row_stride<D>() + kWarps);
  return int(size_t(max_dynamic_smem()) / per_key);
}

}  // namespace
}  // namespace segmif

extern "C" {

// q/k/v/out: device pointers; strides in elements; dtype 0 = f32,
// 1 = bf16; stream: a cudaStream_t. Returns cudaGetLastError().
int segmif_sr_attention(const void* q, const void* k, const void* v,
                        void* out, int b, int n, int m, int h, int d,
                        int64_t sqb, int64_t sqn, int64_t sqh, int64_t skb,
                        int64_t skm, int64_t skh, int64_t svb, int64_t svm,
                        int64_t svh, float scale, int dtype, void* stream) {
  using namespace segmif;
  auto s = static_cast<cudaStream_t>(stream);
#define SEGMIF_SRA(T, DD)                                                    \
  return launch<T, DD>(q, k, v, out, b, n, m, h, sqb, sqn, sqh, skb, skm,   \
                       skh, svb, svm, svh, scale, s)
  if (dtype == kF32 && d == 64) SEGMIF_SRA(float, 64);
  if (dtype == kF32 && d == 32) SEGMIF_SRA(float, 32);
  if (dtype == kBF16 && d == 64) SEGMIF_SRA(__nv_bfloat16, 64);
  if (dtype == kBF16 && d == 32) SEGMIF_SRA(__nv_bfloat16, 32);
#undef SEGMIF_SRA
  return int(cudaErrorInvalidValue);
}

// Largest M the kernel holds in shared memory for head dim d (0 if d is
// not a supported head dim).
int segmif_sr_attention_max_m(int d) {
  if (d == 64) return segmif::max_m<64>();
  if (d == 32) return segmif::max_m<32>();
  return 0;
}

const char* segmif_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
