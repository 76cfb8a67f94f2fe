// Fused multi-head attention forward for Hopper (sm_90a), bf16 and f32.
//
// Replaces fidm_tpu/ops/attention.py:_attention_kernel, the Pallas TPU kernel
// that _attention_pallas launches. Same function on [B, H, S, D] tensors: per
// (batch, head), q and k are each scaled by D^-0.25 in f32, scores = q k^T,
// a max-subtracted f32 softmax over the keys, out = P v in f32, and out is
// cast to the input dtype.
//
// What bounds it on this card. At the main path's largest call (B=4, H=8,
// S=256, D=64, bf16) the function must move q, k, v and o once:
// 4 * 4*8*256*64 * 2 B = 4.2 MB, about 1.3 us at 3.35 TB/s. It does
// 4*B*H*S*S*D = 0.54 GFLOP, about 0.5 us at the bf16 tensor-core peak of
// 989 TFLOP/s. So it is bound by memory and, below that, by launch latency:
// the whole call is worth a few microseconds.
//
// What the tiling does about that. One thread block owns one (batch*head,
// tile of BQ query rows) and loops over the keys in tiles of BK rows staged in
// shared memory. The softmax is online (f32 running max and sum per row) and
// the output accumulates in f32 registers, so the S x S score matrix never
// leaves the SM: device memory sees q and o once and k, v once per query tile
// (S/BQ reads, served from the 50 MB L2 at these sizes). The TPU kernel held
// the whole score matrix in one VMEM block, which capped S; this one has no
// sequence ceiling and masks a ragged last tile. The products run on the CUDA
// cores in f32, fed from shared memory, and that is what the kernel spends its
// time on: on an H100 SXM at 700 W (chip_smoke.py) the call above takes about
// 0.03 ms of device time, some 24x its bound. The four calls of a UNet
// forward are 0.4% of its device time, so tensor-core (mma / wgmma) products
// and TMA staging are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per shared-memory tile
constexpr int THREADS = 256;  // 16 x 16 threads; each owns 4 rows x (cols/16)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <int D>
constexpr size_t smem_bytes() {
  // Qs[BQ][D] + Ks[BK][D+1] + Vs[BK][D] + Ps[BQ][BK+1] + max/sum/alpha[BQ]
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int S, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KP = D + 1;    // padded row of Ks: column reads hit distinct banks
  constexpr int PP = BK + 1;   // padded row of Ps
  constexpr int DC = D / 16;   // output columns owned by a thread

  extern __shared__ float smem[];
  float* Qs = smem;                   // scaled q tile
  float* Ks = Qs + BQ * D;            // scaled k tile
  float* Vs = Ks + BK * KP;           // v tile
  float* Ps = Vs + BK * D;            // scores, then probabilities
  float* row_max = Ps + BQ * PP;
  float* row_sum = row_max + BQ;
  float* row_alpha = row_sum + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long base = (long long)blockIdx.x * S * D;
  const int q0 = blockIdx.y * BQ;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[i] = (q0 + r < S) ? to_f32(q[base + (long long)(q0 + r) * D + c]) * scale : 0.f;
  }
  if (tid < BQ) {
    row_max[tid] = -INFINITY;
    row_sum[tid] = 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's Ps and Vs are no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < S;
      const long long g = base + (long long)(k0 + r) * D + c;
      Ks[r * KP + c] = ok ? to_f32(k[g]) * scale : 0.f;
      Vs[r * D + c] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty + 16*i and key columns tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        Ps[(ty + 16 * i) * PP + c] = (k0 + c < S) ? s[i][j] : -INFINITY;
      }
    __syncthreads();

    // online softmax: four neighbouring lanes share a row, 16 columns each
    {
      const int r = tid / 4, part = tid % 4;
      float* prow = Ps + r * PP + part * 16;
      const float m_old = row_max[r];
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) m = fmaxf(m, prow[c]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m_old, m);
      float l = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);  // masked keys: exp(-inf) = 0
        prow[c] = p;
        l += p;
      }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      __syncwarp();  // all four lanes have read row_max[r] before it is written
      if (part == 0) {
        const float alpha = expf(m_old - m_new);  // first tile: exp(-inf) = 0
        row_alpha[r] = alpha;
        row_sum[r] = row_sum[r] * alpha + l;
        row_max[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P v for rows ty + 16*i and columns tx + 16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r < S) {
      const float inv = 1.f / row_sum[r];
#pragma unroll
      for (int j = 0; j < DC; ++j)
        o[base + (long long)(q0 + r) * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int s,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + BQ - 1) / BQ);
  attention_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int bh, int s,
                     int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, bh, s, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, s, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, s, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous [bh, s, d] device arrays of one dtype
// (0 = float32, 1 = bfloat16). Returns the cudaError_t of the launch.
extern "C" int fidm_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                  int bh, int s, int d, int dtype, float scale,
                                  void* stream) {
  if (bh <= 0 || s <= 0 || s > 65535 * BQ) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d<float>(q, k, v, o, bh, s, d, scale, st);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(q, k, v, o, bh, s, d, scale, st);
  return (int)cudaErrorInvalidValue;
}
