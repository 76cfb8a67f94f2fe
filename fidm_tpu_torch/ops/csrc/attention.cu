// Fused multi-head attention forward for Hopper (sm_90a): flash kernels on
// the tensor cores, in bf16 and in float32 (3xTF32).
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
// (S=4096: 0.139 ms). In float32 the bytes double and every product is three
// TF32 products at 494.7 TFLOP/s: bound by operations from S of about 256 up
// (S=256: 3.26 us; S=4096: 0.833 ms).
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
// float32: both products on the tensor cores in TF32 -> f32. One TF32 product
// keeps 11 bits of each operand and would miss the f32 check against the
// plain version (1e-5) by 10-80x; so each operand is split, x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and a b is taken as
// al bh + ah bl + ah bh, which leaves an error of about 2^-22 of each product
// (CUTLASS's fast-f32 split; tests/test_torch_port_tf32_split.py emulates it).
// The tensor cores' adder truncates, so a sum carried through every product
// of a row drifts as S grows (3 x S/8 products in P v; in development it
// neared the 1e-5 gate at S=4096): every chain of products starts from zero
// within a tile and is added to the running sums in f32, which holds both
// kernels near 1e-6 of the plain version. q and k are multiplied unscaled and
// s4^2 * log2(e) (s4 = D^-1/4 in f32, as the plain version rounds it) is
// applied in the softmax's exp2f. Masking follows the bf16 kernel, and the
// output is written from the accumulators. Two kernels, one per D range; the
// wrapper picks 64 or 128 query rows a block from the shape and the card
// (ops/attention.py:_f32_tiling):
// - attention_fwd_kernel_f32_wgmma (D = 32, 64; the UNet's 64): warpgroups of
//   4 warps issue wgmma.m64nNk8 TF32, B from K/V tiles split once per block
//   in shared memory, A (Q's and P's split fragments) from registers; one or
//   two warpgroups a block. The mma.sync kernel below, built for D=64 too,
//   was 1.1-1.7x slower there (PERF.md). ptxas: 255 registers and 48-60
//   bytes of spills at D=64, none at D=32.
// - attention_fwd_kernel_f32_3xtf32 (D = 128, where the wgmma kernel's Q
//   fragments and split tiles outgrow the registers and shared memory):
//   mma.sync.m16n8k8, a warp per 16 rows, 4 or 8 warps a block, each warp
//   splitting its fragments as it reads them, K/V two cp.async stages deep.
//   ptxas: 186-188 registers, no spills.
//
// Times, device time by torch.profiler (chip_smoke.py phase 2, NVIDIA H100
// 80GB HBM3 at a 700 W power limit), bf16, B=4, H=8, D=64: S=256 0.00659 ms
// (the CUDA-core kernel this design replaced: 0.02917; PyTorch's
// scaled_dot_product_attention 0.00592; bound 0.00125, bytes); S=64 0.00331
// (was 0.00935; SDPA 0.00504); S=4096 0.711 (was 5.397; SDPA 0.305; bound
// 0.139, operations). float32 (the wgmma kernel), B=4, H=8, D=64: S=256
// 0.01777 ms (the CUDA-core kernel this design replaced: 0.03199; SDPA 0.03026;
// bound 0.00326, operations); S=64 0.00663 (0.01004; SDPA 0.00930); S=4096
// 2.141 (5.680; SDPA 4.123; bound 0.833). PERF.md keeps the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

struct Strides {  // of a [B, H, S, D] view, in elements; D's stride is 1
  long long b, h, s;
};

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

// ---------------------------------------------------------------- float32

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero), as
// the 32-bit pattern the tensor cores read
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 of x, each part a TF32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b: a 16x8 row-major, b 8x8 column-major, TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, a = ah + al and b = bh + bl: the two small products
// first, then the large one (al bl, about 2^-22 of a b, is dropped)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

constexpr int F32_BK = 64;                  // keys per shared-memory tile
constexpr size_t MAX_SMEM_BYTES = 232448;   // a block's shared memory on sm_90

// Padded rows, in floats. Q and K rows are read as float4 by lanes (g, t) at
// column 4t of row g: a row of D + 16 (= 16 mod 32 words) puts each group of
// 8 lanes on 32 distinct banks. V rows are read as floats by lanes (g, t) at
// rows 2t and 2t+1, column g: D + 4 (= 4 mod 32) does the same.
template <int D> __host__ __device__ constexpr int f32_ldk() { return D + 16; }
template <int D> __host__ __device__ constexpr int f32_ldv() { return D + 4; }

// K/V stages: two, so one tile loads while the other is multiplied (a third
// does not fit beside 128 rows of Q at D=128)
constexpr int F32_STAGES = 2;

template <int D, int RW>
constexpr size_t f32_smem_bytes() {
  // Qs[16 RW][LDK] + Ks[NS][F32_BK][LDK] + Vs[NS][F32_BK][LDV]
  return sizeof(float) * (16 * RW * f32_ldk<D>() +
                          F32_STAGES * F32_BK * (f32_ldk<D>() + f32_ldv<D>()));
}

// Fragment layouts of m16n8k8 with TF32 (g = lane / 4, t = lane % 4):
//   A (16x8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8x8):  b0 (k t, n g), b1 (k t+4, n g)
//   C (16x8): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
//
// The block layout is the bf16 kernel's: a warp owns 16 query rows; a block
// of RW such warps over 16 RW rows shares K/V tiles of 64 keys brought in by
// cp.async. The products are permuted along their sums, which changes no
// result and saves data movement:
// - q k^T sums over d. In each chunk of 16 columns lane t takes d = 4t..4t+3:
//   k-step 2c pairs k = t, t+4 with d = 16c+4t, 16c+4t+1, k-step 2c+1 with
//   16c+4t+2, 16c+4t+3, so one float4 of a Q or K row feeds two k-steps.
// - P v sums over keys. A thread holds scores of keys 2t, 2t+1 of each 8-key
//   tile (C layout) where A wants k = t, t+4: k = t is taken as key 2t and
//   k = t+4 as key 2t+1, and V's B fragment is read from those rows, so P
//   goes from the score registers to the product without a shuffle.
template <int D, int RW>
__global__ void __launch_bounds__(32 * RW)
attention_fwd_kernel_f32_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ o, int H,
                                int S, int q_tiles, Strides sq, Strides sk, Strides sv,
                                float scale_log2) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int NS = F32_STAGES;
  constexpr int ROWS = 16 * RW;       // query rows per block
  constexpr int T = 32 * RW;          // threads
  constexpr int LDK = f32_ldk<D>();
  constexpr int LDV = f32_ldv<D>();
  constexpr int CH = D / 4;           // 16-byte chunks per row
  constexpr int NT = F32_BK / 8;      // score tiles of 8 keys
  constexpr int OT = D / 8;           // output tiles of 8 columns
  constexpr int KC = D / 16;          // chunks of 16 columns of d, two k-steps each
  constexpr int KTILE = F32_BK * LDK; // floats of one K tile
  constexpr int VTILE = F32_BK * LDV; // floats of one V tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + ROWS * LDK;     // [NS] tiles
  float* Vs = Ks + NS * KTILE;      // [NS] tiles

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * ROWS;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  // rows r0.. of a [S, D] view into `dst`; rows past S are zero-filled
  auto load_rows = [&](float* dst, int ld, const float* src, long long ss, int r0, int rows) {
    for (int i = tid; i < rows * CH; i += T) {
      const int r = i / CH, c = i % CH;
      const bool ok = r0 + r < S;
      cp_async_16(smem_addr(dst + r * ld + c * 4),
                  ok ? src + (long long)(r0 + r) * ss + c * 4 : src, ok);
    }
  };
  const int n_tiles = (S + F32_BK - 1) / F32_BK;
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      load_rows(Ks + (j % NS) * KTILE, LDK, kb, sk.s, j * F32_BK, F32_BK);
      load_rows(Vs + (j % NS) * VTILE, LDV, vb, sv.s, j * F32_BK, F32_BK);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  load_rows(Qs, LDK, qb, sq.s, q0, ROWS);
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) load_tile(j);

  // chunk c of this warp's rows of q as A fragments of k-steps 2c, 2c+1, split
  auto load_q = [&](int c, uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
    const float4 x = *reinterpret_cast<const float4*>(Qs + (rw * 16 + g) * LDK + c * 16 + 4 * t);
    const float4 y =
        *reinterpret_cast<const float4*>(Qs + (rw * 16 + g + 8) * LDK + c * 16 + 4 * t);
    split_tf32(x.x, hi[0][0], lo[0][0]);
    split_tf32(y.x, hi[0][1], lo[0][1]);
    split_tf32(x.y, hi[0][2], lo[0][2]);
    split_tf32(y.y, hi[0][3], lo[0][3]);
    split_tf32(x.z, hi[1][0], lo[1][0]);
    split_tf32(y.z, hi[1][1], lo[1][1]);
    split_tf32(x.w, hi[1][2], lo[1][2]);
    split_tf32(y.w, hi[1][3], lo[1][3]);
  };

  float acc[OT][4];  // P v, f32
  float m_run[2];    // rows g and g+8, unscaled scores
  float l_run[2];    // this lane's part of the row sums
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile j (and q) have landed
    __syncthreads();          // everyone's have, and everyone is done with tile j-1
    load_tile(j + NS - 1);    // into the stage of tile j-1

    const int key0 = j * F32_BK;
    const float* Kt = Ks + (j % NS) * KTILE;
    const float* Vt = Vs + (j % NS) * VTILE;

    // s = q k^T for 16 rows x F32_BK keys, unscaled
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    auto qk_chunk = [&](int c, const uint32_t (&ah)[2][4], const uint32_t (&al)[2][4]) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 z =
            *reinterpret_cast<const float4*>(Kt + (nt * 8 + g) * LDK + c * 16 + 4 * t);
        uint32_t h0, l0, h1, l1;
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // a short chain (see the header)
        split_tf32(z.x, h0, l0);
        split_tf32(z.y, h1, l1);
        mma_3xtf32(part, ah[0], al[0], h0, h1, l0, l1);
        split_tf32(z.z, h0, l0);
        split_tf32(z.w, h1, l1);
        mma_3xtf32(part, ah[1], al[1], h0, h1, l0, l1);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += part[e];
      }
    };
    // Q's split fragments would crowd out the accumulators at D=128: each
    // chunk is read from shared memory and split again per tile
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t ch[2][4], cl[2][4];
      load_q(c, ch, cl);
      qk_chunk(c, ch, cl);
    }
    if (key0 + F32_BK > S) {  // the ragged last tile
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + nt * 8 + 2 * t + (e & 1) >= S) s[nt][e] = -INFINITY;
    }

    // online softmax; the four lanes of a quad hold one row's columns
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
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], scale_log2, -mb[e / 2]));  // masked: 0
        ls[e / 2] += s[nt][e];
      }
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

    // acc += P v, 8 keys a step: k = t is key 2t, k = t+4 key 2t+1
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t ph[4], pl[4];
      split_tf32(s[nt][0], ph[0], pl[0]);  // (g, key 2t)
      split_tf32(s[nt][2], ph[1], pl[1]);  // (g+8, key 2t)
      split_tf32(s[nt][1], ph[2], pl[2]);  // (g, key 2t+1)
      split_tf32(s[nt][3], ph[3], pl[3]);  // (g+8, key 2t+1)
      const float* v0 = Vt + (nt * 8 + 2 * t) * LDV + g;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        uint32_t h0, l0, h1, l1;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        split_tf32(v0[ot * 8], h0, l0);
        split_tf32(v0[LDV + ot * 8], h1, l1);
        mma_3xtf32(part, ph, pl, h0, h1, l0, l1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ot][e] += part[e];
      }
    }
  }

  // rows g and g+8 of the warp, two adjacent columns a lane: every quad
  // writes 32 contiguous bytes of a row
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
  float* ob = o + (long long)bh * S * D;
  const int row = q0 + rw * 16 + g;
#pragma unroll
  for (int ot = 0; ot < OT; ++ot) {
    if (row < S)
      *reinterpret_cast<float2*>(ob + (long long)row * D + ot * 8 + 2 * t) =
          make_float2(acc[ot][0] * inv[0], acc[ot][1] * inv[0]);
    if (row + 8 < S)
      *reinterpret_cast<float2*>(ob + (long long)(row + 8) * D + ot * 8 + 2 * t) =
          make_float2(acc[ot][2] * inv[1], acc[ot][3] * inv[1]);
  }
}

// ------------------------------------------------------- float32, wgmma

// a wgmma matrix descriptor, K-major without swizzle: `lbo` bytes between
// core matrices (8 rows of 16 bytes) adjacent along K, `sbo` along M or N
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of this thread become visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= a b, m64n64k8, TF32 in, f32 accumulate: a (this warp's 16 rows of
// the 64) from registers in the m16n8k8 A layout, b from shared memory; `acc`
// 0 overwrites d
__device__ __forceinline__ void wg_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (+)= a b, m64n32k8, TF32 in, f32 accumulate: a (this warp's 16 rows of
// the 64) from registers in the m16n8k8 A layout, b from shared memory; `acc`
// 0 overwrites d
__device__ __forceinline__ void wg_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wg_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                      int acc) {
  if constexpr (N == 64) wg_rs_n64(d, a, db, acc);
  else wg_rs_n32(d, a, db, acc);
}

template <int D>
constexpr size_t wg_smem_bytes() {
  // two sets of split K/V tiles (Kh, Kl [64][D]; Vh, Vl [D][64]) and two raw
  // K, V stages [64][D+4]
  return sizeof(float) * (2 * 4 * F32_BK * D + 2 * 2 * F32_BK * (D + 4));
}

// offset, in floats, of element (r, c) of an operand stored K-major in core
// matrices of 8 rows x 4 floats, `rows` rows: core matrix (c / 4, r / 8) at
// ((c / 4) * rows / 8 + r / 8) * 32
__device__ __forceinline__ int canon(int r, int c4, int rows) {
  return (c4 * (rows / 8) + r / 8) * 32 + (r % 8) * 4;
}

__device__ __forceinline__ void store_split4(float* hi, float* lo, int off, float4 x) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The wgmma kernel. A warpgroup (4 warps) owns 64 query rows, and a block of
// WG warpgroups shares K/V tiles of 64 keys. wgmma reads B from shared memory
// only, and TF32 only K-major, so each tile is split once per block (not per
// warp) into hi and lo copies in the core-matrix layout: K as stored, V
// transposed, its 8-key groups in the order of P's registers (the P v
// permutation above). Q's split fragments and P's are the A operands, from
// registers. Each product keeps its large (hi hi) and small (lo hi + hi lo)
// parts in separate accumulators, each chain from zero per tile (the
// truncating adder, see the header), summed in f32. Raw K/V tiles arrive by
// cp.async two stages deep, and tile j+1 is split while the wgmmas of q k^T
// for tile j run. Built for D = 32 and 64: at D=128, Q's fragments and the
// tiles exceed the registers and the shared memory.
template <int D, int WG>
__global__ void __launch_bounds__(128 * WG)
attention_fwd_kernel_f32_wgmma(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ o, int H,
                               int S, int q_tiles, Strides sq, Strides sk, Strides sv,
                               float scale_log2) {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  constexpr int ROWS = 64 * WG;
  constexpr int T = 128 * WG;
  constexpr int LDR = D + 4;        // raw rows: 16 bytes apart mod 128, 8 rows on all banks
  constexpr int CH = D / 4;
  constexpr int KS = D / 8;         // k-steps of q k^T
  constexpr int NT = F32_BK / 8;     // 8-key blocks, the k-steps of P v
  constexpr int OT = D / 8;
  constexpr int SPLIT = 4 * F32_BK * D;  // floats of one set of split K/V tiles
  constexpr int RAW = F32_BK * LDR;      // floats of one raw K or V tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* split = reinterpret_cast<float*>(smem_raw);  // [2] x {Kh, Kl, Vh, Vl}
  float* Kr = split + 2 * SPLIT;                        // [2][F32_BK][LDR]
  float* Vr = Kr + 2 * RAW;
  float* Qr = split + SPLIT;  // raw q in the second split set, read before tile 1's split
  static_assert(ROWS * LDR <= SPLIT, "raw q fits in a split set");

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, wq = (tid / 32) % 4;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * ROWS;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  auto load_rows = [&](float* dst, const float* src, long long ss, int r0, int rows) {
    for (int i = tid; i < rows * CH; i += T) {
      const int r = i / CH, c = i % CH;
      const bool ok = r0 + r < S;
      cp_async_16(smem_addr(dst + r * LDR + c * 4),
                  ok ? src + (long long)(r0 + r) * ss + c * 4 : src, ok);
    }
  };
  const int n_tiles = (S + F32_BK - 1) / F32_BK;
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      load_rows(Kr + (j % 2) * RAW, kb, sk.s, j * F32_BK, F32_BK);
      load_rows(Vr + (j % 2) * RAW, vb, sv.s, j * F32_BK, F32_BK);
    }
    cp_async_commit();
  };
  // raw K/V tile j into split set j % 2: K as is, V transposed with keys 2i + hh
  // of each 8 taken as k = 4 hh + i (the P v permutation)
  auto split_tile = [&](int j) {
    const float* kr = Kr + (j % 2) * RAW;
    const float* vr = Vr + (j % 2) * RAW;
    float* Kh = split + (j % 2) * SPLIT;
    float* Kl = Kh + F32_BK * D;
    float* Vh = Kl + F32_BK * D;
    float* Vl = Vh + D * F32_BK;
    for (int i = tid; i < F32_BK * CH; i += T) {
      const int n = i % F32_BK, c4 = i / F32_BK;
      store_split4(Kh, Kl, canon(n, c4, F32_BK),
                   *reinterpret_cast<const float4*>(kr + n * LDR + c4 * 4));
    }
    for (int i = tid; i < D * NT * 2; i += T) {
      const int d = i % D, kk = (i / D) / 2, hh = (i / D) % 2;
      const float* col = vr + (kk * 8 + hh) * LDR + d;
      store_split4(Vh, Vl, canon(d, 2 * kk + hh, D),
                   make_float4(col[0], col[2 * LDR], col[4 * LDR], col[6 * LDR]));
    }
    fence_proxy_async();
  };

  load_rows(Qr, qb, sq.s, q0, ROWS);
  load_tile(0);
  cp_async_wait<0>();
  __syncthreads();
  // this warp's rows of q as A fragments over D, split
  uint32_t qh[KS][4], ql[KS][4];
  {
    const float* qr = Qr + (wg * 64 + wq * 16 + g) * LDR;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      split_tf32(qr[ks * 8 + t], qh[ks][0], ql[ks][0]);
      split_tf32(qr[8 * LDR + ks * 8 + t], qh[ks][1], ql[ks][1]);
      split_tf32(qr[ks * 8 + t + 4], qh[ks][2], ql[ks][2]);
      split_tf32(qr[8 * LDR + ks * 8 + t + 4], qh[ks][3], ql[ks][3]);
    }
  }
  load_tile(1);
  split_tile(0);
  __syncthreads();  // split set 0 is complete; raw q is read

  float acc[OT * 4];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < OT * 4; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const float* Kh = split + (j % 2) * SPLIT;
    const float* Kl = Kh + F32_BK * D;
    const float* Vh = Kl + F32_BK * D;
    const float* Vl = Vh + D * F32_BK;

    // s = q k^T for this warpgroup's 64 rows x 64 keys, issued; the large
    // products and the small ones in separate chains, each from zero
    float sb[32], sl[32];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t kh = wg_desc(Kh + 2 * ks * 8 * 32, 8 * 128, 128);
      const uint64_t kl = wg_desc(Kl + 2 * ks * 8 * 32, 8 * 128, 128);
      wg_rs_n64(sl, ql[ks], kh, ks > 0);
      wg_rs_n64(sl, qh[ks], kl, 1);
      wg_rs_n64(sb, qh[ks], kh, ks > 0);
    }
    wg_commit();

    // meanwhile tile j+1 is split into the other set, and tile j+2 loads
    if (j + 1 < n_tiles) {
      cp_async_wait<0>();  // tile j+1 has landed
      __syncthreads();     // everyone's copies; every wgmma of tile j-1 is done
      load_tile(j + 2);
      split_tile(j + 1);
    }
    wg_wait0();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = sb[4 * nt + e] + sl[4 * nt + e];
    const int key0 = j * F32_BK;
    if (key0 + F32_BK > S) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + nt * 8 + 2 * t + (e & 1) >= S) s[nt][e] = -INFINITY;
    }
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
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f((m_run[r] - m_new) * scale_log2);
      m_run[r] = m_new;
      mb[r] = m_new * scale_log2;
    }
    float ls[2] = {0.f, 0.f};
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(fmaf(s[nt][e], scale_log2, -mb[e / 2]));
        ls[e / 2] += s[nt][e];
      }
      split_tf32(s[nt][0], ph[nt][0], pl[nt][0]);  // (g, key 2t) as k = t
      split_tf32(s[nt][2], ph[nt][1], pl[nt][1]);  // (g+8, key 2t)
      split_tf32(s[nt][1], ph[nt][2], pl[nt][2]);  // (g, key 2t+1) as k = t+4
      split_tf32(s[nt][3], ph[nt][3], pl[nt][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ls[r];

    // P v for 64 rows x D columns, large and small chains from zero
    float ob[OT * 4], ol[OT * 4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const uint64_t vh = wg_desc(Vh + 2 * kk * (D / 8) * 32, (D / 8) * 128, 128);
      const uint64_t vl = wg_desc(Vl + 2 * kk * (D / 8) * 32, (D / 8) * 128, 128);
      wg_rs<D>(ol, pl[kk], vh, kk > 0);
      wg_rs<D>(ol, ph[kk], vl, 1);
      wg_rs<D>(ob, ph[kk], vh, kk > 0);
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int i = 0; i < OT * 4; ++i)
      acc[i] = fmaf(acc[i], alpha[(i % 4) / 2], ob[i] + ol[i]);
    __syncthreads();  // split set (j+1) % 2 is complete before its products
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
  }
  float* ob_ = o + (long long)bh * S * D;
  const int row = q0 + wg * 64 + wq * 16 + g;
#pragma unroll
  for (int ot = 0; ot < OT; ++ot) {
    if (row < S)
      *reinterpret_cast<float2*>(ob_ + (long long)row * D + ot * 8 + 2 * t) =
          make_float2(acc[4 * ot] * inv[0], acc[4 * ot + 1] * inv[0]);
    if (row + 8 < S)
      *reinterpret_cast<float2*>(ob_ + (long long)(row + 8) * D + ot * 8 + 2 * t) =
          make_float2(acc[4 * ot + 2] * inv[1], acc[4 * ot + 3] * inv[1]);
  }
}

// D^-1/2 log2(e), with D^-1/4 rounded to f32 as the plain version computes it
template <int D>
float f32_scale_log2() {
  const float s4 = 1.f / sqrtf(sqrtf((float)D));
  return (float)((double)s4 * (double)s4 * 1.4426950408889634);
}

template <int D, int RW>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int H,
                       int s, Strides sq, Strides sk, Strides sv, cudaStream_t stream) {
  constexpr size_t bytes = f32_smem_bytes<D, RW>();
  static_assert(bytes <= MAX_SMEM_BYTES, "the stages fit in a block's shared memory");
  const int q_tiles = (s + 16 * RW - 1) / (16 * RW);
  if ((long long)bh * q_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel_f32_3xtf32<D, RW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  attention_fwd_kernel_f32_3xtf32<D, RW><<<bh * q_tiles, 32 * RW, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, s, q_tiles, sq, sk, sv,
      f32_scale_log2<D>());
  return cudaGetLastError();
}

template <int D, int WG>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o, int bh, int H,
                      int s, Strides sq, Strides sk, Strides sv, cudaStream_t stream) {
  constexpr size_t bytes = wg_smem_bytes<D>();
  static_assert(bytes <= MAX_SMEM_BYTES, "the tiles fit in a block's shared memory");
  const int q_tiles = (s + 64 * WG - 1) / (64 * WG);
  if ((long long)bh * q_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel_f32_wgmma<D, WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  attention_fwd_kernel_f32_wgmma<D, WG><<<bh * q_tiles, 128 * WG, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, s, q_tiles, sq, sk, sv,
      f32_scale_log2<D>());
  return cudaGetLastError();
}

// the float32 tilings (ops/attention.py:F32_TILINGS): 1 = 64 query rows a
// block, 2 = 128. The kernel follows D: wgmma for D <= 64 (one or two
// warpgroups), mma.sync at D=128 (4 or 8 warps)
template <int D>
cudaError_t launch_f32_d(const void* q, const void* k, const void* v, void* o, int bh, int H,
                         int s, int tiling, Strides sq, Strides sk, Strides sv,
                         cudaStream_t st) {
  if (tiling != 1 && tiling != 2) return cudaErrorInvalidValue;
  if constexpr (D <= 64) {
    return tiling == 1 ? launch_wg<D, 1>(q, k, v, o, bh, H, s, sq, sk, sv, st)
                       : launch_wg<D, 2>(q, k, v, o, bh, H, s, sq, sk, sv, st);
  } else {
    return tiling == 1 ? launch_f32<D, 4>(q, k, v, o, bh, H, s, sq, sk, sv, st)
                       : launch_f32<D, 8>(q, k, v, o, bh, H, s, sq, sk, sv, st);
  }
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
// b, h, s, d; dtype (0 = float32, 1 = bfloat16); the tiling, the bf16
// kernel's key groups (see launch_mma_d) or the float32 kernel's tiling (see
// launch_f32_d); the b/h/s strides, in elements, of q, k and v,
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
  const int tiling = (int)p[9];
  if (dtype == 0) {
    switch (d) {
      case 32: return (int)launch_f32_d<32>(q, k, v, o, bh, H, S, tiling, sq, sk, sv, st);
      case 64: return (int)launch_f32_d<64>(q, k, v, o, bh, H, S, tiling, sq, sk, sv, st);
      case 128: return (int)launch_f32_d<128>(q, k, v, o, bh, H, S, tiling, sq, sk, sv, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return (int)launch_mma_d<32>(q, k, v, o, bh, H, S, tiling, sq, sk, sv, st);
    case 64: return (int)launch_mma_d<64>(q, k, v, o, bh, H, S, tiling, sq, sk, sv, st);
    case 128: return (int)launch_mma_d<128>(q, k, v, o, bh, H, S, tiling, sq, sk, sv, st);
  }
  return (int)cudaErrorInvalidValue;
}
