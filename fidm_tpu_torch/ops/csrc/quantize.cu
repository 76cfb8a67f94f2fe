// Per-column int8 quantization with stochastic rounding, for Hopper (sm_90a).
//
// Replaces fidm_tpu/quant/int8.py:28 `_quantize_pallas` (its inner `kernel`
// at :33, the `pallas_call` at :52), the Pallas TPU kernel that
// quantize_tensor launches for every large weight matrix. Same function on a
// float32 [N, C] matrix x (a kernel reshaped to [rows, out channels]):
//   scale[c] = max(max_r |x[r, c]|, 1e-8) / 127
//   q[r, c]  = clip(floor(x[r, c] / scale[c] + u), -127, 127) as int8
// with u uniform on [0, 1) from 24 random bits. The TPU drew the bits from its
// hardware generator; here they come from a Philox4x32-10 written into the
// kernel, keyed by (seed, 0), its counter the element's flat index / 4 and
// its output lane the flat index % 4. The plain PyTorch version
// (ops/quantize.py:_quantize_stochastic_reference) draws the same bits, so
// the two agree bit for bit. Every division, multiplication and addition is
// an intrinsic with its rounding written out (_rn; _rd for the floor), so no
// compiler flag can turn them into approximations or contract them.
//
// What bounds it on this card. The function reads x once and writes q and
// the scales once: 5*N*C + 4*C bytes, at the largest weight of the FFHQ-256
// UNet ([9216, 512]) 23.6 MB, 7.0 us at 3.35 TB/s. Its arithmetic is not far
// below that: one Philox call (ten rounds of two 32x32->64 multiplies, on
// the integer multiply pipe) per four elements and an IEEE division (with
// its slow-path check) per element keep every SM's issue slots busy for
// about as long as the bytes take. Neither can move before the other: the
// division needs the scale, the scale needs every row. At the smaller
// weights the launch and the cluster barrier are most of the time.
//
// What the design does about it. One launch, and x is read from device
// memory once:
//   - The matrix is cut into strips of 32 (or 16) columns, a 128- (or 64-)
//     byte piece of each row. One thread-block cluster of at most 8
//     CTAs (the portable limit) takes a strip, its CTAs splitting the
//     strip's rows. The wrapper
//     (ops/quantize.py:quantize_geometry) picks the strip width and cluster
//     size from the card's cluster occupancy so that all clusters run in one
//     wave, one CTA per SM.
//   - Each CTA copies the rows it holds into shared memory with 16-byte
//     cp.async, each thread exactly the float4s that it will round later, so
//     no block-wide wait is needed for the tile. While the copies are in
//     flight its threads draw the Philox words for those elements (they do
//     not depend on x) and keep their top 24 bits in registers, three words
//     per four draws: the draws overlap the load.
//   - Each CTA reduces its columns' |x| maxima (shuffles, then shared
//     memory). After a cluster barrier every CTA reads its peers' partial
//     maxima through distributed shared memory and forms the scales; rank 0
//     writes them. A max is exact in any order, so the scales are bit-equal
//     to a sequential reduction. No memset, no atomics, no second pass.
//   - Each CTA then rounds the tile it still holds: a division, a fused
//     multiply-add (exact: the draw's product is a power-of-two scaling),
//     a clip, a floor by a rounded-down addition of 1.5 * 2^23, 4-byte
//     coalesced stores of four int8.
//   - A CTA whose rows exceed what it can hold (more than TILE_BYTES; no
//     FFHQ-256 weight comes near) holds what fits and streams the rest from
//     device memory twice, for the maxima and again for the rounding, drawing
//     those elements' bits inline. This is a branch of the same kernel.
// Bulk copies (TMA tensor copies of 64-row boxes, one mbarrier each, issued
// by one thread) were tried in place of the per-thread cp.async and lost at
// every weight shape: the copies are already in flight while the draws run
// (the kernel takes about as long warm as cold), so freeing the threads from
// issuing them shortens nothing on the critical path, which is the draws,
// the column maxima, the cluster barrier and the division-bound rounding.
// C must be a multiple of 4, so that a float4 never straddles two rows (its
// four draws are one Philox call) and every row starts 16-byte aligned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STRIP = 32;                  // columns per strip: 16 or 32
constexpr int MAX_GROUPS = MAX_STRIP / 4;      // float4 column groups per strip row
constexpr int TILE_BYTES = 28 * THREADS * 16;  // 229,376 bytes: 28 float4 a thread
constexpr int DRAW_STEPS = 24;                 // steps whose draws wait in registers
constexpr int MAX_CLUSTER = 8;                 // the portable limit

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

// The four draws of flat elements flat .. flat+3 (flat % 4 == 0).
__device__ __forceinline__ uint4 draw(long long flat, uint32_t seed) {
  const unsigned long long k = (unsigned long long)flat >> 2;
  return philox4x32_10(make_uint4((uint32_t)k, (uint32_t)(k >> 32), 0u, 0u),
                       make_uint2(seed, 0u));
}

// The top 24 bits of each of four draws.
__device__ __forceinline__ uint4 top24(uint4 r) {
  return make_uint4(r.x >> 8, r.y >> 8, r.z >> 8, r.w >> 8);
}

// The top 24 bits of four draws in three words, the fourth's three bytes in
// the top bytes of the other three, so that more draws wait in registers.
__device__ __forceinline__ uint3 pack24(uint4 r) {
  return make_uint3((r.x >> 8) | ((r.w >> 8) << 24), (r.y >> 8) | ((r.w >> 16) << 24),
                    (r.z >> 8) | (r.w & 0xFF000000u));
}

__device__ __forceinline__ uint4 unpack24(uint3 p) {
  return make_uint4(p.x & 0xFFFFFFu, p.y & 0xFFFFFFu, p.z & 0xFFFFFFu,
                    (p.x >> 24) | ((p.y >> 16) & 0xFF00u) | ((p.z >> 8) & 0xFF0000u));
}

// The int8 of one element, in the low byte of the result:
// clip(floor(x / scale + u), -127, 127) with u = bits24 * 2^-24.
// Clipping before the floor gives the same integer for every input (NaN
// included: fmaxf returns -127). The floor is an addition of 1.5 * 2^23
// rounded down: the sum is 1.5 * 2^23 + floor(v), whose low byte is floor(v)
// in two's complement, so no float-to-int conversion is needed.
__device__ __forceinline__ uint32_t round_one(float x, float scale, uint32_t bits24) {
  // bits24 * 2^-24 is exact, so the fused multiply-add rounds once, as the
  // addition x / scale + u does
  const float s = __fmaf_rn((float)bits24, 5.9604644775390625e-08f, __fdiv_rn(x, scale));
  const float v = fminf(fmaxf(s, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rd(v, 12582912.0f));
}

// Four int8 in one word, element 0 in the low byte; r: the draws' top 24 bits.
__device__ __forceinline__ uint32_t round4(float4 v, const float (&sc)[4], uint4 r) {
  const uint32_t lo = __byte_perm(round_one(v.x, sc[0], r.x), round_one(v.y, sc[1], r.y), 0x0040);
  const uint32_t hi = __byte_perm(round_one(v.z, sc[2], r.z), round_one(v.w, sc[3], r.w), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ float4 absmax4(float4 m, float4 v) {
  return make_float4(fmaxf(m.x, fabsf(v.x)), fmaxf(m.y, fabsf(v.y)),
                     fmaxf(m.z, fabsf(v.z)), fmaxf(m.w, fabsf(v.w)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Grid (cluster, strips), cluster (cluster, 1, 1). A strip is 4 << log2_groups
// columns. CTA `rank` of a cluster takes rows [rank * rows_per_cta,
// +rows_per_cta) of strip blockIdx.y, holds the first `hold` of them in
// dynamic shared memory ([hold][groups] float4) and streams the rest. Thread
// t owns column group t % groups and rows t / groups + step * k throughout,
// step = THREADS / groups.
__global__ void __launch_bounds__(THREADS, 1)
quantize_kernel(const float* __restrict__ x, uint32_t* __restrict__ q,
                float* __restrict__ scales, int n, int c, int rows_per_cta, int hold,
                int log2_groups, uint32_t seed) {
  extern __shared__ float4 tile[];
  __shared__ float4 warp_max[WARPS][MAX_GROUPS];
  __shared__ float part[MAX_STRIP];  // this CTA's column maxima, read by its cluster
  __shared__ float scale_s[MAX_STRIP];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int groups = 1 << log2_groups, strip = 4 * groups, step = THREADS >> log2_groups;
  const int t = threadIdx.x, lane = t % 32, g = t & (groups - 1), row0 = t >> log2_groups;
  const int c0 = blockIdx.y * strip;
  const int col = c0 + 4 * g;
  const bool active = col < c;  // C % 4 == 0: a group is all inside or all out
  const long long r0 = (long long)rank * rows_per_cta;
  const int rows = (int)max(0LL, min((long long)rows_per_cta, (long long)n - r0));
  const int held = active ? min(rows, hold) : 0;
  const int streamed = active ? rows : 0;
  const long long flat0 = r0 * c + col;  // element (r0, col)
  const float* xs = x + flat0;
  // this thread's held steps, the first DRAW_STEPS of them drawn ahead
  const int nheld = row0 < held ? (held - row0 + step - 1) / step : 0;
  const int ndraw = min(nheld, DRAW_STEPS);

  // 1. the held rows, copied in; their draws while the copies land
#pragma unroll 4
  for (int l = row0; l < held; l += step)
    cp_async16(&tile[l * groups + g], xs + (long long)l * c);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  uint3 bits[DRAW_STEPS];
#pragma unroll
  for (int k = 0; k < DRAW_STEPS; ++k) {
    if (k == ndraw) break;
    bits[k] = pack24(draw(flat0 + (long long)(row0 + k * step) * c, seed));
  }

  // 2. column maxima: the streamed rows from device memory, then the held tile
  float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int l = held + row0; l < streamed; l += step)
    m = absmax4(m, __ldg(reinterpret_cast<const float4*>(xs + (long long)l * c)));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll 4
  for (int l = row0; l < held; l += step) m = absmax4(m, tile[l * groups + g]);
  // the lanes of one column group differ in the lane bits from log2_groups up
  for (int off = groups; off < 32; off *= 2) {
    m.x = fmaxf(m.x, __shfl_xor_sync(0xffffffffu, m.x, off));
    m.y = fmaxf(m.y, __shfl_xor_sync(0xffffffffu, m.y, off));
    m.z = fmaxf(m.z, __shfl_xor_sync(0xffffffffu, m.z, off));
    m.w = fmaxf(m.w, __shfl_xor_sync(0xffffffffu, m.w, off));
  }
  if (lane < groups) warp_max[t / 32][lane] = m;
  __syncthreads();
  if (t < strip) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v = fmaxf(v, reinterpret_cast<const float*>(warp_max[w])[t]);
    part[t] = v;
  }

  // 3. the cluster's maxima through distributed shared memory, and the scales
  cluster_arrive();
  cluster_wait();
  if (t < strip) {
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < ranks) v = fmaxf(v, *cluster.map_shared_rank(part + t, r));
    const float s = __fdiv_rn(fmaxf(v, 1e-8f), 127.0f);
    scale_s[t] = s;
    if (rank == 0 && c0 + t < c) scales[c0 + t] = s;
  }
  __syncthreads();
  cluster_arrive();  // this CTA has read its peers' maxima

  // 4. the rounding: the held tile (drawn ahead, then drawn here), then the
  //    streamed rows again
  const float sc[4] = {scale_s[4 * g], scale_s[4 * g + 1], scale_s[4 * g + 2],
                       scale_s[4 * g + 3]};
  uint32_t* qs = q + (flat0 >> 2);
  const long long qrow = c >> 2;  // words per row of q
#pragma unroll
  for (int k = 0; k < DRAW_STEPS; ++k) {
    if (k == ndraw) break;
    const int l = row0 + k * step;
    qs[l * qrow] = round4(tile[l * groups + g], sc, unpack24(bits[k]));
  }
#pragma unroll 2
  for (int l = row0 + DRAW_STEPS * step; l < held; l += step)
    qs[l * qrow] = round4(tile[l * groups + g], sc, top24(draw(flat0 + (long long)l * c, seed)));
#pragma unroll 2
  for (int l = held + row0; l < streamed; l += step) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(xs + (long long)l * c));
    qs[l * qrow] = round4(v, sc, top24(draw(flat0 + (long long)l * c, seed)));
  }
  cluster_wait();  // no CTA leaves while a peer may still read its maxima
}

// The launch, as the wrapper packs it: 10 int64 values.
struct Launch {
  long long x, q, scales, n, c, seed, strip, cluster, rows_per_cta, hold;
};

cudaError_t check(const Launch& p) {
  const long long strips = p.strip > 0 ? (p.c + p.strip - 1) / p.strip : 0;
  if (p.n < 1 || p.n > INT32_MAX || p.c < 4 || p.c % 4 || p.c > INT32_MAX ||
      (p.strip != 16 && p.strip != 32) || strips > 65535 || p.cluster < 1 ||
      p.cluster > MAX_CLUSTER ||
      p.rows_per_cta < 1 || p.rows_per_cta > INT32_MAX || p.rows_per_cta * p.cluster < p.n ||
      p.hold < 1 || p.hold > p.rows_per_cta || p.hold * p.strip * 4 > TILE_BYTES ||
      p.x % 16 || p.q % 4)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Shared memory beyond 48 KB must be allowed once per device before the
// first launch.
cudaError_t configure() {
  static uint64_t done = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev) & 1) return cudaSuccess;
  err = cudaFuncSetAttribute(quantize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TILE_BYTES);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

cudaLaunchConfig_t launch_config(const Launch& p, cudaLaunchAttribute* attr,
                                 cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.cluster, (unsigned)((p.c + p.strip - 1) / p.strip), 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.hold * p.strip * sizeof(float);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// params: the Launch fields; x: contiguous float32 [n, c] on the device,
// 16-byte aligned, c % 4 == 0; q: int8 [n, c]; scales: float32 [c]. The
// geometry comes from ops/quantize.py:quantize_geometry. Enqueues the one
// kernel on `stream` and returns the launch's cudaError_t.
extern "C" int fidm_quantize_int8(const long long* params, void* stream) {
  const Launch& p = *reinterpret_cast<const Launch*>(params);
  cudaError_t err = check(p);
  if (err == cudaSuccess) err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, &attr, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, quantize_kernel, reinterpret_cast<const float*>(p.x),
                           reinterpret_cast<uint32_t*>(p.q),
                           reinterpret_cast<float*>(p.scales), (int)p.n, (int)p.c,
                           (int)p.rows_per_cta, (int)p.hold, p.strip == 32 ? 3 : 2,
                           (uint32_t)p.seed);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of the launch in `params` (pointers unused) the current
// device can hold at once (cudaOccupancyMaxActiveClusters), in *out.
extern "C" int fidm_quantize_max_active_clusters(const long long* params, int* out) {
  const Launch& p = *reinterpret_cast<const Launch*>(params);
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, &attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)quantize_kernel, &cfg);
}

// out[0]: the shared memory a block may opt into on `device`; out[1]: the
// kernel's static shared memory; both in bytes.
extern "C" int fidm_quantize_device_limits(int device, int* out) {
  cudaError_t err =
      cudaDeviceGetAttribute(&out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attrs;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, quantize_kernel);
  if (err == cudaSuccess) out[1] = (int)attrs.sharedSizeBytes;
  return (int)err;
}
