// The bf16 BigBird middle query blocks for Hopper (sm_90a), launched by
// bigbird_sparse.cu for dtype 1: the forward (ctx and the fp32 lse) and
// the backward (dq, and dK, dV added into fp32 accumulators).  The slot
// map, the penalties and the geometry are shared with the fp32 bodies of
// bigbird_sparse.cu.
//
// Middle query block j (query rows of block i = j + 1) attends its 5 + r
// key slots [g0 | window i-1, i, i+1 | g_last | random r]; slot key c of
// block blk takes the penalty (1 - mask[b, 64 blk + c]) * -10000, and the
// duplicate window slot at j = 0 (block 0 = g0) and j = nb - 3 (block nb - 1
// = g_last) takes -10000 outright.  Repeated blocks (the all-zero eval
// plan) are separate keys.  Logits as _mid_logits
// (stonkgs_tpu/ops/bigbird_sparse_pallas.py:70): s = round(round(Q K^T) *
// scale) + penalty, Q K^T in fp32, the roundings to bf16; scale =
// 1/sqrt(64) is a power of two (the C entry points check it), so the
// second rounding is exact and the kernels make only the first.
//
// Both kernels have the dense attention's shape (attention_sm90.cuh): 384
// threads, a producer warpgroup (setmaxnreg.dec) whose first warp streams
// key tiles through a ring of full/empty mbarriers with TMA (one 4-D map
// per tensor over (B, S, H, 64), built from the strides it is given, box
// 64 x 64, 128-byte swizzle) and writes each tile's 64 penalties beside
// it, and two consumer warpgroups (setmaxnreg.inc) that own one query
// block each: 64 rows, the wgmma M.  A block takes the query blocks 2x
// and 2x + 1 of one (b, h), and a ring stage holds slot t of both (g0,
// g_last and the window tiles of neighbouring query blocks are read from
// L2: the grid's x, the query-block pair, runs fastest).  With nb - 2 odd
// the last block's second consumer repeats the last query block and
// writes nothing.  Measured on the H100 (PERF.md, the BigBird
// redesign): three consumers a block ran no faster than two, two blocks
// an SM leave ptxas 80 registers a thread (it spills), and reading the
// penalties a stage ahead in the producer ran 9% slower than reading
// them after the stage frees.
//
// Forward (bigbird_fwd_sm90_kernel), two passes over the slots, because
// the TPU kernel normalises before it rounds:
//   pass 1: S = Q K^T of each slot (wgmma.m64n64k16, both operands K-major
//           from shared memory); the logits in registers; each row's
//           running max m and sum l of exp(s - m);
//   pass 2: S recomputed; p = exp(s - m) * (1/l), rounded; O += P V with P
//           from registers (the packed accumulator is the A fragment) and
//           the V tile MN-major.
// So the design's floor is three products of 2 * 64 * 64 * 64 flops a
// slot and query block, and two exps a score: at B=8, S=4096, H=12, 195 M
// scores need 0.093 ms of the SFU (16 ex2 a clock an SM at 1.98 GHz)
// against 0.076 ms of products at 989 TFLOP/s and 0.060 ms of bytes.  The
// roundings to bf16 run on the same quarter-rate unit as the exps (the
// single rounding made the forward 10% faster).
//
// Backward (bigbird_bwd_sm90_kernel), query-major as the TPU kernel: a
// consumer keeps its block's Q and dO (and, for delta = rowsum(dO * O),
// O) in shared memory and dQ in registers; per slot
//   S = Q K^T, dP = dO V^T                         (wgmma from shared memory)
//   p = exp(s - lse), dS = p (dP - delta) * scale  (fp32, registers)
//   round(p), and dS as hi = round(dS) and lo = round(dS - hi) (16 of its
//   24 significant bits), written to shared memory;
//   dQ += dS K (hi and lo), dK = dS^T Q (hi and lo), dV = round(p)^T dO:
//   wgmma from shared memory, dS^T and P^T as M-major A operands, K, Q
//   and dO as MN-major B operands;
// then the slot's fp32 dK and dV tiles go to shared memory (128-byte
// swizzle) and one thread adds them into the fp32 (B, S, H, 64)
// accumulators with four TMA reduce-adds (cp.reduce.async.bulk.tensor
// .add, 32 columns a box), where the old design made 65,536 scalar
// atomics a query block (red.global.add.v4.f32 from registers, without
// the staging, measured 27% slower).  Blocks run in no order, so the adds
// into a key row land in an order that changes from run to run.  Seven
// products a slot (dS's two halves count twice in dQ and dK) and one exp
// a score: at B=2 0.044 ms of products against 0.012 ms of the SFU.
//
// Numerics against the plain versions (ops/bigbird_sparse.py): products
// summed in another order; exp(s - x) as ex2.approx of s log2 e - x log2 e
// (a few ulps from an IEEE exp), times a per-row reciprocal of l in the
// forward;
// so a rounded probability, or dS, moves by at most one bf16 step where
// it sits at a rounding boundary: inside chip_smoke.py's ATTN_STEP and
// GRAD_TOL limits.  s, m and lse stay in the natural domain.

#pragma once

#include <cmath>
#include <cstdint>

#include "sm90.cuh"

namespace stonkgs {
namespace bigbird {

constexpr int kBlock = 64;            // block size (query and key rows of a tile)
constexpr float kPenalty = -10000.f;  // BigBird's mask penalty

struct Geo {
  int S, H, nb, r;
  long long sb, ss, sh;  // element strides of q, k, v
  float scale;
};

// key block of slot t of middle query block j
__device__ __forceinline__ int slot_block(const int* rand_hj, int t, int j, int nb) {
  if (t == 0) return 0;
  if (t <= 3) return j + t - 1;
  if (t == 4) return nb - 1;
  return rand_hj[t - 5];
}

// the window slot that repeats a global block: block 0 at j = 0, block
// nb - 1 at j = nb - 3
__device__ __forceinline__ bool dup_slot(int t, int j, int nb) {
  return (t == 1 && j == 0) || (t == 3 && j == nb - 3);
}

// the penalty of key c of slot block blk, mask_b the batch row's (S) mask
__device__ __forceinline__ float slot_penalty(const float* mask_b, int blk, int c, bool dup) {
  return dup ? kPenalty : (1.f - __ldg(mask_b + blk * kBlock + c)) * kPenalty;
}

}  // namespace bigbird

namespace bigbird90 {

using namespace sm90;
using bigbird::Geo;
using bigbird::kBlock;

constexpr int kD = 64;
// consumer warpgroups (one query block each) and ring stages of the
// forward and of the backward
constexpr int kFwdConsumers = 2;
constexpr int kFwdStages = 4;
constexpr int kBwdConsumers = 2;
constexpr int kBwdStages = 2;
// a producer thread's registers (setmaxnreg.dec; the backward's address
// arithmetic for three row tiles needs more)
constexpr int kFwdProducerRegs = 40;
constexpr int kBwdProducerRegs = 56;
__host__ __device__ constexpr int threads_of(int consumers) { return 128 * (consumers + 1); }
// a consumer thread's registers (setmaxnreg) beside a producer's: the
// SM's 65,536 shared out, in multiples of 8
__host__ __device__ constexpr int consumer_regs(int consumers, int producer) {
  return (65536 / 128 - producer) / consumers / 8 * 8;
}
constexpr int kTile = kBlock * kD;            // elements of a 64 x 64 tile
constexpr uint32_t kTileBytes = kTile * 2;    // 8 KB in bf16
constexpr uint32_t kStep = 16 * 128 / 16;     // 16 lines of 128 bytes, in descriptor units
constexpr float kLog2e = 1.4426950408889634f;

template <int C, int S>
struct alignas(1024) SmemFwd {
  bf16 q[C][kTile];
  bf16 k[S][C][kTile];
  bf16 v[S][C][kTile];
  float pen[S][C][kBlock];
  uint64_t full[S];
  uint64_t empty[S];
  uint64_t rowbar;  // the blocks' own tiles
};

template <int C, int S>
struct alignas(1024) SmemBwd {
  bf16 q[C][kTile];
  bf16 dout[C][kTile];
  bf16 p[C][kTile];    // O (for delta), then each slot's round(p)
  bf16 dsh[C][kTile];  // dS, hi
  bf16 dsl[C][kTile];  // dS, lo
  float dk[C][2][kBlock * 32];  // a slot's fp32 dK: two 32-column boxes
  float dv[C][2][kBlock * 32];
  bf16 k[S][C][kTile];
  bf16 v[S][C][kTile];
  float pen[S][C][kBlock];
  float delta[C][kBlock];
  uint64_t full[S];
  uint64_t empty[S];
  uint64_t rowbar;
};

// the ring's barriers: the producer warp's 32 lanes fill a stage (lane 0
// with the TMA bytes), each consumer warp empties it
template <int C, int kStages, typename SmemT>
__device__ __forceinline__ void init_ring(SmemT& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], 4 * C);
    }
    mbar_init(&sm.rowbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// pointers into one ring stage
struct Stage {
  bf16 (*k)[kTile];
  bf16 (*v)[kTile];
  float (*pen)[kBlock];
  uint64_t* full;
};

// the producer warp fills a free ring stage with slot t of the C
// consumers' query blocks jc[c] (their random blocks at rand_c[c]): lane 0
// issues the K (and V) tiles' TMA loads first, then every lane writes its
// two penalties of each tile (keys lane and lane + 32) and arrives
// (reading the penalties a stage ahead instead measured 9% slower in the
// forward)
template <int C>
__device__ __forceinline__ void fill_stage(const Stage& st, const CUtensorMap* map_k,
                                           const CUtensorMap* map_v, const int* jc,
                                           const int* const* rand_c, const float* mask_b, int t,
                                           int h, int b, int nb, bool with_v, int lane) {
  int blk[C];
  float pen[C][2];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    blk[c] = bigbird::slot_block(rand_c[c], t, jc[c], nb);
    const bool dup = bigbird::dup_slot(t, jc[c], nb);
    pen[c][0] = bigbird::slot_penalty(mask_b, blk[c], lane, dup);
    pen[c][1] = bigbird::slot_penalty(mask_b, blk[c], lane + 32, dup);
  }
  if (lane == 0) {
    mbar_expect_tx(st.full, (with_v ? 2 : 1) * C * kTileBytes);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tma_load_4d(st.k[c], map_k, 0, h, blk[c] * kBlock, b, st.full);
      if (with_v) tma_load_4d(st.v[c], map_v, 0, h, blk[c] * kBlock, b, st.full);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    st.pen[c][lane] = pen[c][0];
    st.pen[c][lane + 32] = pen[c][1];
  }
  mbar_arrive(st.full);
}

// round(round(a) * scale) and round(round(b) * scale), the roundings to
// bf16: scale is a power of two (checked at launch), so round(a) * scale
// is a bf16 value already and the second rounding is the identity
__device__ __forceinline__ float2 rounded_logits(float a, float b, float scale) {
  const float2 r = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  return make_float2(r.x * scale, r.y * scale);
}

// the masked logits of a 64 x 64 Q K^T accumulator, in place
__device__ __forceinline__ void logits(float (&s)[32], const float* pen, float scale, int lane) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const float2 pv = *reinterpret_cast<const float2*>(pen + acc_col(i, lane));
    const float2 x = rounded_logits(s[i], s[i + 1], scale);
    s[i] = x.x + pv.x;
    s[i + 1] = x.y + pv.y;
  }
}

// S (+)= A B^T over D = 64 (4 k-steps), both tiles K-major in shared memory
__device__ __forceinline__ void product_abt(float (&s)[32], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_qk64(s, da + 2 * kk, db + 2 * kk, kk);
}

// a warpgroup's 64 x 64 fp32 accumulator, rounded, into rows `row` and
// row + 8 (the thread's) of a bf16 (.., 64) array whose row `row` is dst0
// and row + 8 is dst8
__device__ __forceinline__ void store_acc(bf16* dst0, bf16* dst8, const float (&d)[32], int lane) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    bf16* dst = acc_row(i) ? dst8 : dst0;
    *reinterpret_cast<uint32_t*>(dst + acc_col(i, lane)) = pack_bf16(d[i], d[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int C, int S>
__global__ void __launch_bounds__(threads_of(C), 1)
bigbird_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const float* __restrict__ mask, const int* __restrict__ rand,
                        bf16* __restrict__ out, float* __restrict__ lse, Geo g) {
  extern __shared__ unsigned char smem_raw[];
  SmemFwd<C, S>& sm = aligned_smem<SmemFwd<C, S>>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_mid = g.nb - 2, slots = 5 + g.r;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init_ring<C, S>(sm);

  if (wg == C) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kFwdProducerRegs));
    if (warp == 0) {
      int jc[C];
      const int* rand_c[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        jc[c] = min(int(blockIdx.x) * C + c, n_mid - 1);
        rand_c[c] = rand + (size_t(h) * n_mid + jc[c]) * g.r;
      }
      if (lane == 0) {
        mbar_arrive_tx(&sm.rowbar, C * kTileBytes);
#pragma unroll
        for (int c = 0; c < C; ++c)
          tma_load_4d(sm.q[c], &map_q, 0, h, (jc[c] + 1) * kBlock, b, &sm.rowbar);
      }
      const float* mask_b = mask + size_t(b) * g.S;
      for (int it = 0; it < 2 * slots; ++it) {
        const int stage = it % S;
        mbar_wait(&sm.empty[stage], ((it / S) & 1) ^ 1);
        const Stage st{sm.k[stage], sm.v[stage], sm.pen[stage], &sm.full[stage]};
        fill_stage<C>(st, &map_k, &map_v, jc, rand_c, mask_b, it % slots, h, b, g.nb,
                      it >= slots, lane);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs(C, kFwdProducerRegs)));
    const int j = blockIdx.x * C + wg;  // the middle query block (may be n_mid)
    const int lrow = warp * 16 + lane / 4;       // the thread's rows: lrow, lrow + 8
    const uint64_t dq = desc_sw128(sm.q[wg]);
    float acc[32];

    // the logits of slot tile `stage`
    auto scores = [&](int stage) {
      fence_regs(acc);
      wgmma_fence();
      product_abt(acc, dq, desc_sw128(sm.k[stage][wg]));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      logits(acc, sm.pen[stage][wg], g.scale, lane);
    };
    mbar_wait(&sm.rowbar, 0);

    // pass 1: each row's max m and sum l of exp(s - m); l is kept per
    // thread (over its 16 columns, scaled by the row's shared m) and
    // summed across the quad at the end
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int t = 0; t < slots; ++t) {
      const int stage = t % S;
      mbar_wait(&sm.full[stage], (t / S) & 1);
      scores(stage);
      release_stage(&sm.empty[stage], lane);
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) tmax[acc_row(i)] = fmaxf(tmax[acc_row(i)], acc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float m_new = fmaxf(m[r], tmax[r]);
        l[r] *= ex2((m[r] - m_new) * kLog2e);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        l[acc_row(i)] += ex2(fmaf(acc[i], kLog2e, -m[acc_row(i)] * kLog2e));
    }
    const size_t n_rows = size_t(n_mid) * kBlock;  // middle rows of a (b, h)
    float inv_l[2], ml[2];  // 1/l and m log2 e of the thread's rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (j < n_mid && (lane & 3) == 0)
        lse[(size_t(b) * g.H + h) * n_rows + size_t(j) * kBlock + lrow + 8 * r] = m[r] + logf(l[r]);
      inv_l[r] = 1.f / l[r];
      ml[r] = m[r] * kLog2e;
    }

    // pass 2: O = P V, P = round(exp(s - m) / l)
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    for (int t = 0; t < slots; ++t) {
      const int it = slots + t, stage = it % S;
      mbar_wait(&sm.full[stage], (it / S) & 1);
      scores(stage);
      uint32_t pa[16];  // the A fragments of k-step kk are pa[4kk .. 4kk+3]
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = 2 * u, r = acc_row(i);
        pa[u] = pack_bf16(ex2(fmaf(acc[i], kLog2e, -ml[r])) * inv_l[r],
                          ex2(fmaf(acc[i + 1], kLog2e, -ml[r])) * inv_l[r]);
      }
      const uint64_t dv = desc_sw128(sm.v[stage][wg]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) wgmma_pv(o, pa + 4 * kk, dv + kk * kStep);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release_stage(&sm.empty[stage], lane);
    }
    if (j < n_mid) {
      bf16* row0 = out + ((size_t(b) * n_rows + size_t(j) * kBlock + lrow) * g.H + h) * kD;
      store_acc(row0, row0 + size_t(8) * g.H * kD, o, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// a 64 x 64 fp32 accumulator into two 64-line boxes of 32 floats (128-byte
// swizzle), the layout of a TMA box of the fp32 accumulator's map
__device__ __forceinline__ void stage_f32(float (*boxes)[kBlock * 32], const float (&d)[32],
                                          int lrow, int lane) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = lrow + 8 * acc_row(i), col = acc_col(i, lane);
    unsigned char* box = reinterpret_cast<unsigned char*>(boxes[col >> 5]);
    *reinterpret_cast<float2*>(box + sw128_byte(row, (col & 31) * 4)) = make_float2(d[i], d[i + 1]);
  }
}

__device__ __forceinline__ void st_shared_u32(bf16* tile, uint32_t byte_off, uint32_t v) {
  *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(tile) + byte_off) = v;
}

template <int C, int S>
__global__ void __launch_bounds__(threads_of(C), 1)
bigbird_bwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_dk,
                        const __grid_constant__ CUtensorMap map_dv,
                        const float* __restrict__ mask, const int* __restrict__ rand,
                        const float* __restrict__ lse, bf16* __restrict__ dq, Geo g) {
  extern __shared__ unsigned char smem_raw[];
  SmemBwd<C, S>& sm = aligned_smem<SmemBwd<C, S>>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_mid = g.nb - 2, slots = 5 + g.r;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init_ring<C, S>(sm);

  if (wg == C) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdProducerRegs));
    if (warp == 0) {
      int jc[C];
      const int* rand_c[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        jc[c] = min(int(blockIdx.x) * C + c, n_mid - 1);
        rand_c[c] = rand + (size_t(h) * n_mid + jc[c]) * g.r;
      }
      if (lane == 0) {
        mbar_arrive_tx(&sm.rowbar, 3 * C * kTileBytes);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          tma_load_4d(sm.q[c], &map_q, 0, h, (jc[c] + 1) * kBlock, b, &sm.rowbar);
          tma_load_4d(sm.dout[c], &map_do, 0, h, jc[c] * kBlock, b, &sm.rowbar);
          tma_load_4d(sm.p[c], &map_o, 0, h, jc[c] * kBlock, b, &sm.rowbar);
        }
      }
      const float* mask_b = mask + size_t(b) * g.S;
      for (int t = 0; t < slots; ++t) {
        const int stage = t % S;
        mbar_wait(&sm.empty[stage], ((t / S) & 1) ^ 1);
        const Stage st{sm.k[stage], sm.v[stage], sm.pen[stage], &sm.full[stage]};
        fill_stage<C>(st, &map_k, &map_v, jc, rand_c, mask_b, t, h, b, g.nb, true, lane);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs(C, kBwdProducerRegs)));
    const int j = blockIdx.x * C + wg;  // the middle query block (may be n_mid)
    const bool valid = j < n_mid;
    const int jc = min(j, n_mid - 1);
    const int tid = threadIdx.x % 128;
    const int lrow = warp * 16 + lane / 4;  // the thread's rows: lrow, lrow + 8
    const int bar = 1 + wg;                 // the warpgroup's named barrier
    const int* rand_j = rand + (size_t(h) * n_mid + jc) * g.r;
    mbar_wait(&sm.rowbar, 0);

    // delta = rowsum(dO * O), two threads a row of 32 columns each
    {
      const int row = tid >> 1, half = tid & 1;
      const unsigned char* dob = reinterpret_cast<const unsigned char*>(sm.dout[wg]);
      const unsigned char* ob = reinterpret_cast<const unsigned char*>(sm.p[wg]);
      float s = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const uint32_t off = sw128_byte(row, half * 64 + cc * 16);
        const uint4 x = *reinterpret_cast<const uint4*>(dob + off);
        const uint4 y = *reinterpret_cast<const uint4*>(ob + off);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
          const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
          s = fmaf(a.x, c.x, s);
          s = fmaf(a.y, c.y, s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (half == 0) sm.delta[wg][row] = s;
    }
    named_barrier(bar, 128);  // delta is in and O is read: sm.p is free
    float lse_l[2], delta_r[2];  // lse log2 e and delta of the thread's rows
    const size_t n_rows = size_t(n_mid) * kBlock;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_l[r] = kLog2e * lse[(size_t(b) * g.H + h) * n_rows + size_t(jc) * kBlock + lrow + 8 * r];
      delta_r[r] = sm.delta[wg][lrow + 8 * r];
    }
    const uint64_t dqd = desc_sw128(sm.q[wg]), dod = desc_sw128(sm.dout[wg]);
    const uint64_t dpd = desc_sw128(sm.p[wg]);
    const uint64_t dshd = desc_sw128(sm.dsh[wg]), dsld = desc_sw128(sm.dsl[wg]);
    float dq_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;

    for (int t = 0; t < slots; ++t) {
      const int stage = t % S;
      mbar_wait(&sm.full[stage], (t / S) & 1);
      const uint64_t dkd = desc_sw128(sm.k[stage][wg]), dvd = desc_sw128(sm.v[stage][wg]);
      // S = Q K^T and dP = dO V^T
      float s[32], dp[32];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      product_abt(s, dqd, dkd);
      product_abt(dp, dod, dvd);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      logits(s, sm.pen[stage][wg], g.scale, lane);
      // p = exp(s - lse), dS = p (dP - delta) * scale; round(p), dS hi and lo
      // into shared memory (the previous slot's products are done: every
      // warp passed the barriers below since)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = acc_row(i);
        const float p0 = ex2(fmaf(s[i], kLog2e, -lse_l[r]));
        const float p1 = ex2(fmaf(s[i + 1], kLog2e, -lse_l[r]));
        const float d0 = p0 * (dp[i] - delta_r[r]) * g.scale;
        const float d1 = p1 * (dp[i + 1] - delta_r[r]) * g.scale;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(d0, d1);
        const float2 hf = __bfloat1622float2(hi);
        const uint32_t off = sw128_offset(lrow + 8 * r, acc_col(i, lane));
        st_shared_u32(sm.p[wg], off, pack_bf16(p0, p1));
        st_shared_u32(sm.dsh[wg], off, *reinterpret_cast<const uint32_t*>(&hi));
        st_shared_u32(sm.dsl[wg], off, pack_bf16(d0 - hf.x, d1 - hf.y));
      }
      fence_async_shared();  // the tiles, written by this thread, to the products
      named_barrier(bar, 128);
      // dQ += dS K; dK = dS^T Q; dV = round(p)^T dO
      float dk_acc[32], dv_acc[32];
      fence_regs(dq_acc);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
        wgmma_ss64<0, 1>(dq_acc, dshd + 2 * kk, dkd + kk * kStep, 1);
        wgmma_ss64<0, 1>(dq_acc, dsld + 2 * kk, dkd + kk * kStep, 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
        wgmma_ss64<1, 1>(dk_acc, dshd + kk * kStep, dqd + kk * kStep, kk);
        wgmma_ss64<1, 1>(dk_acc, dsld + kk * kStep, dqd + kk * kStep, 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        wgmma_ss64<1, 1>(dv_acc, dpd + kk * kStep, dod + kk * kStep, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      release_stage(&sm.empty[stage], lane);
      // the slot's dK and dV, staged in shared memory, then added into the
      // accumulators with four TMA reduce-adds
      if (tid == 0) tma_store_read_done();  // the previous slot's adds have read the staging
      named_barrier(bar, 128);
      stage_f32(sm.dk[wg], dk_acc, lrow, lane);
      stage_f32(sm.dv[wg], dv_acc, lrow, lane);
      fence_async_shared();
      named_barrier(bar, 128);
      if (tid == 0 && valid) {
        const int key0 = bigbird::slot_block(rand_j, t, jc, g.nb) * kBlock;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          tma_reduce_add_4d(&map_dk, sm.dk[wg][x], 32 * x, h, key0, b);
          tma_reduce_add_4d(&map_dv, sm.dv[wg][x], 32 * x, h, key0, b);
        }
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_done();
    if (valid) {
      bf16* row0 = dq + ((size_t(b) * g.S + size_t(j + 1) * kBlock + lrow) * g.H + h) * kD;
      store_acc(row0, row0 + size_t(8) * g.H * kD, dq_acc, lane);
    }
  }
}

// --- host side --------------------------------------------------------------

// 4-D map of a (B, S, H, 64) tensor of T with element strides (sb, ss, sh)
// and a unit last stride: dims (64, H, S, B), box (box_d, 1, 64, 1)
template <typename T>
inline bool make_map_bshd(CUtensorMap* map, const void* base, int B, int S, int H, long long sb,
                          long long ss, long long sh, int box_d) {
  const cuuint64_t dims[4] = {cuuint64_t(kD), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * sizeof(T), cuuint64_t(ss) * sizeof(T),
                                 cuuint64_t(sb) * sizeof(T)};
  const cuuint32_t box[4] = {cuuint32_t(box_d), 1, cuuint32_t(kBlock), 1};
  return encode_map(map, MapType<T>::kType, base, 4, dims, strides, box);
}

// the same for a contiguous (B, S, H, 64) tensor
template <typename T>
inline bool make_map_dense(CUtensorMap* map, const void* base, int B, int S, int H, int box_d) {
  const long long row = (long long)H * kD;
  return make_map_bshd<T>(map, base, B, S, H, row * S, row, kD, box_d);
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

inline dim3 grid_of(int B, const Geo& g, int consumers) {
  return dim3((g.nb - 2 + consumers - 1) / consumers, g.H, B);
}

inline int launch_fwd_sm90(const void* q, const void* k, const void* v, const float* mask,
                           const int* rand, void* out, float* lse, int B, const Geo& g,
                           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map_bshd<bf16>(&mq, q, B, g.S, g.H, g.sb, g.ss, g.sh, kD) ||
      !make_map_bshd<bf16>(&mk, k, B, g.S, g.H, g.sb, g.ss, g.sh, kD) ||
      !make_map_bshd<bf16>(&mv, v, B, g.S, g.H, g.sb, g.ss, g.sh, kD))
    return kErrTensorMap;
  constexpr int C = kFwdConsumers;
  constexpr size_t smem = sizeof(SmemFwd<C, kFwdStages>) + 1024;
  auto kernel = bigbird_fwd_sm90_kernel<C, kFwdStages>;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<grid_of(B, g, C), threads_of(C), smem, stream>>>(
      mq, mk, mv, mask, rand, static_cast<bf16*>(out), lse, g);
  return int(cudaGetLastError());
}

inline int launch_bwd_sm90(const void* q, const void* k, const void* v, const float* mask,
                           const int* rand, const void* out, const float* lse, const void* dout,
                           void* dq, float* dk, float* dv, int B, const Geo& g,
                           cudaStream_t stream) {
  const int n_rows = (g.nb - 2) * kBlock;
  CUtensorMap mq, mk, mv, mo, mdo, mdk, mdv;
  if (!make_map_bshd<bf16>(&mq, q, B, g.S, g.H, g.sb, g.ss, g.sh, kD) ||
      !make_map_bshd<bf16>(&mk, k, B, g.S, g.H, g.sb, g.ss, g.sh, kD) ||
      !make_map_bshd<bf16>(&mv, v, B, g.S, g.H, g.sb, g.ss, g.sh, kD) ||
      !make_map_dense<bf16>(&mo, out, B, n_rows, g.H, kD) ||
      !make_map_dense<bf16>(&mdo, dout, B, n_rows, g.H, kD) ||
      !make_map_dense<float>(&mdk, dk, B, g.S, g.H, 32) ||
      !make_map_dense<float>(&mdv, dv, B, g.S, g.H, 32))
    return kErrTensorMap;
  constexpr int C = kBwdConsumers;
  constexpr size_t smem = sizeof(SmemBwd<C, kBwdStages>) + 1024;
  auto kernel = bigbird_bwd_sm90_kernel<C, kBwdStages>;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<grid_of(B, g, C), threads_of(C), smem, stream>>>(
      mq, mk, mv, mo, mdo, mdk, mdv, mask, rand, lse, static_cast<bf16*>(dq), g);
  return int(cudaGetLastError());
}

}  // namespace bigbird90
}  // namespace stonkgs
