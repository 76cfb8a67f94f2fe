// Fused multi-head attention forward for Hopper (sm_90a): a bf16 flash kernel
// on the tensor cores, and a float32 kernel on the CUDA cores.
//
// Replaces fidm_tpu/ops/attention.py:_attention_kernel, the Pallas TPU kernel
// that _attention_pallas launches. Same function on [B, H, S, D] views: per
// (batch, head), logits = (q D^-1/4)(k D^-1/4)^T in f32, a max-subtracted f32
// softmax over the keys, out = P v accumulated in f32, cast to the input
// dtype. The TPU kernel holds a head's whole S x S score matrix in one VMEM
// block; here a block walks the keys in tiles with an online softmax (f32
// running max and sum per row), so S has no ceiling and never leaves the SM.
// q, k and v may be strided views (last dimension contiguous, every row start
// 16-byte aligned), such as the q/k/v chunks of one qkv projection; the output
// is contiguous [B, H, S, D].
//
// What bounds it on this card. At the main path's largest call (B=4, H=8,
// S=256, D=64, bf16) the function must move q, k, v and o once, 4.2 MB, about
// 1.25 us at 3.35 TB/s, and does 4*B*H*S*S*D = 0.54 GFLOP, about 0.54 us at
// the bf16 tensor-core peak of 989 TFLOP/s: bound by bytes and, below that,
// by launch latency. Only from S of about 1024 up is it bound by operations
// (S=4096: 0.139 ms).
//
// bf16: attention_fwd_kernel_bf16_mma, FlashAttention-2's layout. A warp owns
// 16 query rows; a block of 4 warps (or two key groups of 4) over 64 rows
// shares K/V tiles of 64 keys in shared memory, brought in by 16-byte
// cp.async, three stages deep (two at D=128), so the next tiles load while
// one is multiplied. Rows are padded by 16 bytes, which puts the 8 rows of
// every ldmatrix on distinct banks. Both products are mma.sync.m16n8k16
// bf16 -> f32: Q's fragments stay in registers for the whole block, K as
// stored is the "col" B operand of Q K^T (ldmatrix), V the B operand of P V
// (ldmatrix.trans). q and k are multiplied unscaled (the bf16 products are
// exact in f32) and D^-1/2 * log2(e) is applied to the f32 scores, so the
// softmax uses exp2f; the scores never leave registers, and P goes from the
// score accumulators (m16n8k16's C layout is its A layout) straight to P V as
// bf16, normalised by the f32 row sum at the end. Rows and keys past S are
// zero-filled by cp.async, masked keys get -inf before the max (every tile
// holds a real key, so the running max stays finite), and rows past S are
// never stored. The output is staged through the warp's own Q rows in shared
// memory and written in 16-byte stores.
//
// Why mma.sync and not wgmma: at the main path's shapes the operation bound
// is below the byte bound, so mma.sync's lower peak costs nothing measurable
// there, and the kernel keeps one warp per 16 rows, with no warpgroup or TMA
// descriptor set up per call. Why two key groups (the wrapper picks one or two
// per shape and card): at the main path's S=256 the grid of 64-row blocks
// (128 for B*H=32) does not fill two blocks per SM, so two key groups of 4
// warps split each block's keys; where the grid alone fills the SMs, one.
// ptxas (-Xptxas=-v, sm_90a): no spills; 132 registers a thread at D=64 with
// one key group, 146 with two.
//
// f32: attention_fwd_kernel_f32, the CUDA-core kernel (64 query rows x 64-key
// tiles staged as f32 in shared memory, products by FMA). TF32 tensor-core
// products would miss the f32 check against the plain version (1e-5).
//
// Times, device time by torch.profiler (chip_smoke.py phase 2, NVIDIA H100
// 80GB HBM3 at a 700 W power limit), bf16, B=4, H=8, D=64: S=256 0.00659 ms
// (the CUDA-core kernel this design replaced: 0.02917; PyTorch's
// scaled_dot_product_attention 0.00592; bound 0.00125, bytes); S=64 0.00331
// (was 0.00935; SDPA 0.00504); S=4096 0.711 (was 5.397; SDPA 0.305; bound
// 0.139, operations). PERF.md keeps the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

struct Strides {  // of a [B, H, S, D] view, in elements; D's stride is 1
  long long b, h, s;
};

// ---------------------------------------------------------------- float32

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per shared-memory tile
constexpr int THREADS = 256;  // 16 x 16 threads; each owns 4 rows x (cols/16)

template <int D>
constexpr size_t f32_smem_bytes() {
  // Qs[BQ][D] + Ks[BK][D+1] + Vs[BK][D] + Ps[BQ][BK+1] + max/sum/alpha[BQ]
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int H, int S,
                         Strides sq, Strides sk, Strides sv, float scale) {
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
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + (long long)bh * S * D;
  const int q0 = blockIdx.y * BQ;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    Qs[i] = (q0 + r < S) ? qb[(long long)(q0 + r) * sq.s + c] * scale : 0.f;
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
      Ks[r * KP + c] = ok ? kb[(long long)(k0 + r) * sk.s + c] * scale : 0.f;
      Vs[r * D + c] = ok ? vb[(long long)(k0 + r) * sv.s + c] : 0.f;
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
        ob[(long long)(q0 + r) * D + tx + 16 * j] = acc[i][j] * inv;
    }
  }
}

// ------------------------------------------------------------------- bf16

constexpr int MMA_BK = 64;  // keys per shared-memory tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>  // all but the N most recent groups have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b: a 16x16 row-major, b 16x8 column-major, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

constexpr int MMA_RW = 4;              // warps over a block's query rows, per key group
constexpr int MMA_ROWS = 16 * MMA_RW;  // query rows per block

// K/V stages in shared memory: 3 (two steps in flight while one is
// multiplied), 2 at D=128, where a third would cost a block's place on the SM
template <int D>
__host__ __device__ constexpr int mma_stages() { return D > 64 ? 2 : 3; }

template <int D, int KG>
constexpr size_t mma_smem_bytes() {
  // Qs[MMA_ROWS][D+8] + Ks[NS][KG][MMA_BK][D+8] + Vs[NS][KG][MMA_BK][D+8], bf16
  return sizeof(__nv_bfloat16) * (MMA_ROWS + 2 * mma_stages<D>() * KG * MMA_BK) * (D + 8);
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16x8):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16x8):  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
//
// A warp owns 16 query rows. A block has KG key groups of RW = 4 such warps;
// warp w takes rows 16 (w % RW).. and key group w / RW. Step j brings key
// tiles j*KG .. j*KG+KG-1 into stage j % NS, one tile per key group; NS-1
// steps are in flight while one is multiplied. With KG = 2 the two groups
// walk alternate tiles and merge their (max, sum, P v) at the end through
// shared memory, which puts twice the warps on a row block when the grid
// alone cannot fill the SMs.
template <int D, int KG>
__global__ void __launch_bounds__(32 * MMA_RW * KG)
attention_fwd_kernel_bf16_mma(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o, int H, int S, int q_tiles,
                              Strides sq, Strides sk, Strides sv, float scale_log2) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int NS = mma_stages<D>();
  constexpr int RW = MMA_RW;
  constexpr int ROWS = MMA_ROWS;    // query rows per block
  constexpr int T = 32 * RW * KG;   // threads
  constexpr int LD = D + 8;         // padded row, elements: 8 rows hit distinct banks
  constexpr int CH = D / 8;         // 16-byte chunks per row
  constexpr int NT = MMA_BK / 8;    // score tiles of 8 keys
  constexpr int OT = D / 8;         // output tiles of 8 columns
  constexpr int KD = D / 16;        // k-steps over D
  constexpr int TILE = MMA_BK * LD; // elements of one K or V tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + ROWS * LD;        // [NS][KG] tiles
  __nv_bfloat16* Vs = Ks + NS * KG * TILE;   // [NS][KG] tiles

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp % RW, kg = warp / RW;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * ROWS;
  const int b = bh / H, h = bh % H;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  // rows r0.. of a [S, D] view into `dst`; rows past S are zero-filled
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long ss, int r0,
                       int rows) {
    for (int i = tid; i < rows * CH; i += T) {
      const int r = i / CH, c = i % CH;
      const bool ok = r0 + r < S;
      cp_async_16(smem_addr(dst + r * LD + c * 8),
                  ok ? src + (long long)(r0 + r) * ss + c * 8 : src, ok);
    }
  };
  const int n_tiles = (S + MMA_BK - 1) / MMA_BK;
  const int n_steps = (n_tiles + KG - 1) / KG;
  auto load_step = [&](int j) {
#pragma unroll
    for (int gr = 0; gr < KG; ++gr) {
      const int tile = j * KG + gr;
      if (j < n_steps && tile < n_tiles) {
        const int off = ((j % NS) * KG + gr) * TILE;
        load_rows(Ks + off, kb, sk.s, tile * MMA_BK, MMA_BK);
        load_rows(Vs + off, vb, sv.s, tile * MMA_BK, MMA_BK);
      }
    }
    cp_async_commit();  // an empty group past the last step keeps the count
  };
  load_rows(Qs, qb, sq.s, q0, ROWS);
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) load_step(j);

  uint32_t qf[KD][4];  // this warp's rows of q, A fragments over D
  float acc[OT][4];    // P v, f32
  float m_run[2];      // rows g and g+8, unscaled scores
  float l_run[2];      // this lane's part of the row sums
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  for (int j = 0; j < n_steps; ++j) {
    cp_async_wait<NS - 2>();  // this thread's copies of step j (and q) have landed
    __syncthreads();          // everyone's have, and everyone is done with step j-1
    load_step(j + NS - 1);    // into the stage of step j-1

    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], smem_addr(Qs + (rw * 16 + lane % 16) * LD + kd * 16 +
                                      (lane / 16) * 8));
    }
    const int key0 = (j * KG + kg) * MMA_BK;
    if (key0 >= S) continue;  // this group's tile lies past the last one
    const __nv_bfloat16* Kt = Ks + ((j % NS) * KG + kg) * TILE;
    const __nv_bfloat16* Vt = Vs + ((j % NS) * KG + kg) * TILE;

    // s = q k^T for 16 rows x MMA_BK keys, unscaled
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 32; ++kc) {
        // keys nt*8.. (row lane % 8), d = kc*32 + 8 * (lane / 8)
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(Kt + (nt * 8 + lane % 8) * LD + kc * 32 + (lane / 8) * 8));
        mma_bf16(s[nt], qf[2 * kc], kf[0], kf[1]);
        mma_bf16(s[nt], qf[2 * kc + 1], kf[2], kf[3]);
      }
    }
    if (key0 + MMA_BK > S) {  // the ragged last tile
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + nt * 8 + 2 * t + (e & 1) >= S) s[nt][e] = -INFINITY;
    }

    // online softmax; the four lanes of a quad hold one row's columns
    uint32_t pf[MMA_BK / 16][4];  // P as A fragments over the tile's keys
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f((m_run[r] - m_new) * scale_log2);  // first tile: 0
      m_run[r] = m_new;
      mb[r] = m_new * scale_log2;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = exp2f(fmaf(s[nt][0], scale_log2, -mb[0]));  // masked: 0
      const float p1 = exp2f(fmaf(s[nt][1], scale_log2, -mb[0]));
      const float p2 = exp2f(fmaf(s[nt][2], scale_log2, -mb[1]));
      const float p3 = exp2f(fmaf(s[nt][3], scale_log2, -mb[1]));
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pf[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ls[r];
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      acc[ot][0] *= alpha[0];
      acc[ot][1] *= alpha[0];
      acc[ot][2] *= alpha[1];
      acc[ot][3] *= alpha[1];
    }

    // acc += P v
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        // keys kk*16 + (lane % 8) + 8 * ((lane / 8) % 2), d = dp*16 + 8 * (lane / 16)
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(Vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                        dp * 16 + (lane / 16) * 8));
        mma_bf16(acc[2 * dp], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    }
  }

  if constexpr (KG > 1) {
    // key groups 1.. hand their (max, sum, P v) to group 0 through the K/V
    // stages: the lane with the same rows and columns in warp rw of group 0
    // merges them
    constexpr int ITEMS = 4 * OT + 4;      // floats per lane
    constexpr int SLOT = ITEMS * 32 * RW;  // floats per key group
    static_assert((KG - 1) * SLOT * sizeof(float) <=
                      NS * KG * TILE * 2 * sizeof(__nv_bfloat16),
                  "the merge scratch fits in the K/V stages");
    float* scratch = reinterpret_cast<float*>(Ks) + rw * ITEMS * 32 + lane;
    cp_async_wait<0>();
    __syncthreads();  // no warp reads the stages any more
    if (kg > 0) {
      float* sc = scratch + (kg - 1) * SLOT;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[(4 * ot + e) * 32] = acc[ot][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sc[(4 * OT + r) * 32] = m_run[r];
        sc[(4 * OT + 2 + r) * 32] = l_run[r];
      }
    }
    __syncthreads();
    if (kg > 0) return;  // no barrier follows
#pragma unroll
    for (int src = 1; src < KG; ++src) {
      const float* sc = scratch + (src - 1) * SLOT;
      float a0[2], a1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = sc[(4 * OT + r) * 32];  // -inf if that group had no tile
        const float m = fmaxf(m_run[r], m1);
        a0[r] = exp2f((m_run[r] - m) * scale_log2);
        a1[r] = exp2f((m1 - m) * scale_log2);
        m_run[r] = m;
        l_run[r] = l_run[r] * a0[r] + sc[(4 * OT + 2 + r) * 32] * a1[r];
      }
#pragma unroll
      for (int ot = 0; ot < OT; ++ot)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[ot][e] = acc[ot][e] * a0[e / 2] + sc[(4 * ot + e) * 32] * a1[e / 2];
    }
  }

  // stage the warp's output rows in its own Q rows, then 16-byte stores
  __nv_bfloat16* Ow = Qs + rw * 16 * LD;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
#pragma unroll
  for (int ot = 0; ot < OT; ++ot) {
    *reinterpret_cast<uint32_t*>(Ow + g * LD + ot * 8 + 2 * t) =
        pack_bf16(acc[ot][0] * inv[0], acc[ot][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * LD + ot * 8 + 2 * t) =
        pack_bf16(acc[ot][2] * inv[1], acc[ot][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + (long long)bh * S * D;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    const int row = q0 + rw * 16 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(ob + (long long)row * D + c * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * LD + c * 8);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int H,
                       int s, Strides sq, Strides sk, Strides sv, cudaStream_t stream) {
  if (s > 65535 * BQ) return cudaErrorInvalidValue;
  constexpr size_t bytes = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt(sqrt((double)D)));
  const dim3 grid(bh, (s + BQ - 1) / BQ);
  attention_fwd_kernel_f32<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, s, sq, sk, sv, scale);
  return cudaGetLastError();
}

template <int D, int KG>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int bh, int H,
                       int s, Strides sq, Strides sk, Strides sv, cudaStream_t stream) {
  const int q_tiles = (s + MMA_ROWS - 1) / MMA_ROWS;
  if ((long long)bh * q_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t bytes = mma_smem_bytes<D, KG>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel_bf16_mma<D, KG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  attention_fwd_kernel_bf16_mma<D, KG><<<bh * q_tiles, 32 * MMA_RW * KG, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, s, q_tiles,
      sq, sk, sv, scale_log2);
  return cudaGetLastError();
}

// the key groups the bf16 kernel is built for: 1 or 2
template <int D>
cudaError_t launch_mma_d(const void* q, const void* k, const void* v, void* o, int bh, int H,
                         int s, int kg, Strides sq, Strides sk, Strides sv, cudaStream_t st) {
  switch (kg) {
    case 1: return launch_mma<D, 1>(q, k, v, o, bh, H, s, sq, sk, sv, st);
    case 2: return launch_mma<D, 2>(q, k, v, o, bh, H, s, sq, sk, sv, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// One launch. `params` holds 19 int64 values: the addresses of q, k, v and o;
// b, h, s, d; dtype (0 = float32, 1 = bfloat16); the bf16 kernel's key
// groups (see launch_mma_d); the b/h/s strides, in elements, of q, k and v,
// which are [b, h, s, d] views with d contiguous (o is a contiguous array).
// Returns the launch's cudaError_t.
extern "C" int fidm_attention_fwd(const void* params, void* stream) {
  long long p[19];
  memcpy(p, params, sizeof(p));
  const void* q = reinterpret_cast<const void*>(p[0]);
  const void* k = reinterpret_cast<const void*>(p[1]);
  const void* v = reinterpret_cast<const void*>(p[2]);
  void* o = reinterpret_cast<void*>(p[3]);
  const long long b = p[4], h = p[5], s = p[6], d = p[7], dtype = p[8];
  if (b <= 0 || h <= 0 || s <= 0 || b * h > 0x7fffffffLL || s > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int bh = (int)(b * h), H = (int)h, S = (int)s;
  const Strides sq{p[10], p[11], p[12]}, sk{p[13], p[14], p[15]}, sv{p[16], p[17], p[18]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (d) {
      case 32: return (int)launch_f32<32>(q, k, v, o, bh, H, S, sq, sk, sv, st);
      case 64: return (int)launch_f32<64>(q, k, v, o, bh, H, S, sq, sk, sv, st);
      case 128: return (int)launch_f32<128>(q, k, v, o, bh, H, S, sq, sk, sv, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int kg = (int)p[9];
  switch (d) {
    case 32: return (int)launch_mma_d<32>(q, k, v, o, bh, H, S, kg, sq, sk, sv, st);
    case 64: return (int)launch_mma_d<64>(q, k, v, o, bh, H, S, kg, sq, sk, sv, st);
    case 128: return (int)launch_mma_d<128>(q, k, v, o, bh, H, S, kg, sq, sk, sv, st);
  }
  return (int)cudaErrorInvalidValue;
}
