// Per-column int8 quantization with stochastic rounding, for Hopper (sm_90a).
//
// Replaces fidm_tpu/quant/int8.py:_quantize_pallas, the Pallas TPU kernel
// that quantize_tensor launches for every large weight matrix. Same function
// on a float32 [N, C] matrix x (a kernel reshaped to [rows, out channels]):
//   scale[c] = max(max_r |x[r, c]|, 1e-8) / 127
//   q[r, c]  = clip(floor(x[r, c] / scale[c] + u), -127, 127) as int8
// with u uniform on [0, 1) from 24 random bits. The TPU drew the bits from its
// hardware generator; here they come from a Philox4x32-10 written into the
// kernel, keyed by (seed, 0), its counter the element's flat index / 4 and
// its output lane the flat index % 4. The plain PyTorch version
// (ops/quantize.py:_quantize_stochastic_reference) draws the same bits, so
// the two agree bit for bit.
//
// What bounds it on this card. The function reads x once and writes q and
// the scales once: 5*N*C + 4*C bytes. At the largest weight of the FFHQ-256
// UNet, [9216, 512], that is 23.6 MB, about 7 us at 3.35 TB/s; its few
// operations per element (ten Philox rounds per four elements, a division)
// are far below the card's rate. So it is bound by memory, and at the
// smaller weights by the latency of its launches.
//
// What the design does about that. The TPU kernel held the whole matrix in
// one VMEM block, which a 227 KB SM cannot. Here there are three passes over
// device memory, each one wide enough to fill the card:
//   1. the column absmax over a grid of 32-column tiles x 256-row chunks,
//      one warp-wide row of loads per step (coalesced); partial maxima are
//      combined with atomicMax on the float's bit pattern, which orders like
//      the float for |x| >= 0, and a max is exact in any order, so the scales
//      are bit-equal to a sequential reduction;
//   2. the scales from the maxima, in place, with an IEEE division;
//   3. the rounding, one thread per Philox counter: a 16-byte load of four
//      elements, one generator call for their four draws, a 4-byte store.
// x is read twice (passes 1 and 3). Fusing them needs a grid-wide barrier
// or a row-resident tile per column strip; that is left for a later change.
// Divisions and additions use the _rn intrinsics, so no compiler flag can
// turn them into approximations or fused operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;         // columns per block of the absmax pass
constexpr int ROWS = 8;          // thread rows per block of the absmax pass
constexpr int ROW_CHUNK = 256;   // matrix rows each absmax block reduces
constexpr int THREADS = 256;     // threads per block of the other passes

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      key.x += PHILOX_W0;
      key.y += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, ctr.x), lo0 = PHILOX_M0 * ctr.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, ctr.z), lo1 = PHILOX_M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// absmax_bits[c] must hold 0 on entry; it ends as the bits of max_r |x[r, c]|.
__global__ void __launch_bounds__(COLS * ROWS)
colmax_kernel(const float* __restrict__ x, unsigned int* __restrict__ absmax_bits,
              int n, int c) {
  __shared__ float part[ROWS][COLS];
  const int col = blockIdx.x * COLS + threadIdx.x;
  const int r1 = min((int)(blockIdx.y + 1) * ROW_CHUNK, n);
  float m = 0.0f;
  if (col < c)
    for (int r = blockIdx.y * ROW_CHUNK + threadIdx.y; r < r1; r += ROWS)
      m = fmaxf(m, fabsf(x[(long long)r * c + col]));
  part[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0 && col < c) {
#pragma unroll
    for (int i = 1; i < ROWS; ++i) m = fmaxf(m, part[i][threadIdx.x]);
    atomicMax(absmax_bits + col, __float_as_uint(m));
  }
}

// In place: the absmax bits of each column become its float scale.
__global__ void __launch_bounds__(THREADS) scale_kernel(float* scales, int c) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col < c) {
    const float absmax = __uint_as_float(reinterpret_cast<unsigned int*>(scales)[col]);
    scales[col] = __fdiv_rn(fmaxf(absmax, 1e-8f), 127.0f);
  }
}

__device__ __forceinline__ signed char round_one(float x, float scale, uint32_t bits) {
  // 24 bits as an exact float in [0, 1)
  const float u = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f);
  const float v = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  return (signed char)(int)fminf(fmaxf(v, -127.0f), 127.0f);
}

// One thread per Philox counter k: flat elements 4k .. 4k+3 of x (row-major
// [n, c]). x must be 16-byte aligned and q 4-byte aligned.
__global__ void __launch_bounds__(THREADS)
round_kernel(const float* __restrict__ x, const float* __restrict__ scales,
             signed char* __restrict__ q, long long total, int c, uint32_t seed) {
  const long long k = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long base = 4 * k;
  if (base >= total) return;
  const uint4 r = philox4x32_10(make_uint4((uint32_t)k, (uint32_t)(k >> 32), 0u, 0u),
                                make_uint2(seed, 0u));
  const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
  int col = (int)(base % c);
  if (base + 3 < total) {
    const float4 v = *reinterpret_cast<const float4*>(x + base);
    const float xs[4] = {v.x, v.y, v.z, v.w};
    signed char out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[j] = round_one(xs[j], scales[col], bits[j]);
      if (++col == c) col = 0;
    }
    *reinterpret_cast<char4*>(q + base) = make_char4(out[0], out[1], out[2], out[3]);
  } else {
    for (int j = 0; base + j < total; ++j) {
      q[base + j] = round_one(x[base + j], scales[col], bits[j]);
      if (++col == c) col = 0;
    }
  }
}

}  // namespace

// x: contiguous float32 [n, c] on the device, 16-byte aligned; q: int8 [n, c],
// 4-byte aligned; scales: float32 [c]. Enqueues the three passes on `stream`
// and returns the cudaError_t of the last launch (or of the first failure).
extern "C" int fidm_quantize_int8(const void* x, void* q, void* scales, int n, int c,
                                  uint32_t seed, void* stream) {
  if (n <= 0 || c <= 0 || (n + ROW_CHUNK - 1) / ROW_CHUNK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scales, 0, sizeof(float) * (size_t)c, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((c + COLS - 1) / COLS, (n + ROW_CHUNK - 1) / ROW_CHUNK);
  colmax_kernel<<<grid1, dim3(COLS, ROWS), 0, st>>>(
      static_cast<const float*>(x), static_cast<unsigned int*>(scales), n, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scale_kernel<<<(c + THREADS - 1) / THREADS, THREADS, 0, st>>>(static_cast<float*>(scales), c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = (long long)n * c;
  const long long counters = (total + 3) / 4;
  round_kernel<<<(unsigned)((counters + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(scales),
      static_cast<signed char*>(q), total, c, seed);
  return (int)cudaGetLastError();
}
