// The bf16 attention backward for Hopper (sm_90a), launched by
// flash_attention_train.cu after the delta pass:
//
//   p  = exp(S*scale + bias - lse)        (S = Q K^T, the saved fp32 lse)
//   dP = (dO V^T) * mr                    (mr = 1/(1-rate) where the hash
//                                          keeps, 0 where it drops)
//   dS = p * (dP - delta)                 (fp32; delta = rowsum(dO * O))
//   dQ = scale * round(dS) K,  dK = scale * round(dS)^T Q,
//   dV = round(p * mr)^T dO,   db[b, key] = sum over heads and rows of dS
//
// over (B, S, H, D) bf16 q, k, v, dO and dq, dk, dv, D a multiple of 8 from
// 8 to 256 run on the instance of its padded width P (attention_sm90.cuh:
// tensor maps of dim 0 D and boxes P wide, zero columns past D, which add
// nothing to S or dP~ and whose dQ, dK and dV columns are not stored), with
// an optional (B, S) fp32 key bias.  Rounding points as the TPU kernel
// (stonkgs_tpu/ops/flash_attention.py:131-178): dS rounded to bf16 before
// the dQ and dK products, the dropped p rounded for dV, the scale applied
// after the products; the dropout mask is the forward's hash of
// ((b*H + h)*s_pad + row)*s_pad + col.
//
// Two kernels, as the SIMT fp32 backward of flash_attention_train.cu:
// dQ in one, dK, dV and db in the other, so neither needs atomics on a
// gradient (db adds its keys' sums over all rows with one atomicAdd a key
// and head).  Both recompute S and dP~, so the backward is 7 products of
// 2*B*H*S^2*D flops and two exps a score (one per kernel), plus the hash
// of each score twice when training with dropout.
//
// Each has the forward's shape (attention_sm90.cuh): 384 threads, a
// producer warpgroup (setmaxnreg.dec) whose first warp streams 128-row
// tiles of the other operand pair through a ring with TMA
// (the forward's 4-D tensor maps over (B, S, H, D), one box a column
// block; TMA zero-fills rows >= S) and writes the tile's fp32 vectors beside
// them, and two consumer warpgroups of 64 rows each.  The ring is 3 stages
// deep, 2 at P = 128 (a stage's two 32 KB tiles beside the block's own two
// leave no room for a third).  The register split
// is 56 for the producer (its address arithmetic for the lse and delta
// vectors spills at the forward's 40) and 224 for the consumers.  The
// consumers take a stage in sub-steps of 64 rows (32 in dK/dV at P = 128):
// with the whole 128-row tile, two 64-float score tiles, the accumulators
// and the packed fragments (256 registers in dK/dV at P = 64) spilled.
// At P = 128 the dK/dV kernel has one consumer warpgroup of 64 keys (256
// threads, so 255 registers a thread): its dK and dV accumulators are 128
// floats a thread, and beside the score tiles they spilled in a 384-thread
// block (whose threads ptxas holds to 168 registers).
// * attn_bwd_dq_sm90_kernel: a block per 128 query rows of one (b, h); Q
//   and dO loaded once; K and V tiles stream with the keys' bias (-inf
//   for keys >= S, which makes p = 0 there).  Per half, S = Q K^T and dP~
//   = dO V^T by wgmma.m64n64k16 from shared memory (both K-major, P/16
//   k-steps), the element pass in registers, then dQ += dS K by
//   wgmma.m64nPk16 (two m64n64k16 at P = 128) with dS from registers (the
//   packed accumulator is the A fragment) and the K rows MN-major (its keys
//   are the product's k).
// * attn_bwd_dkdv_sm90_kernel: a block per 128 keys of one (b, h) (64 at
//   P = 128); K and V loaded once; Q and dO tiles stream with the rows' lse (+inf for rows
//   >= S, which makes p = 0) and delta.  The transposed form: S^T = K Q^T
//   and dP~^T = V dO^T (rows are keys, columns queries), then dV +=
//   round(p*mr)^T dO and dK += round(dS)^T Q with dO and Q MN-major.  dK
//   and dV stay in fp32 registers across all query tiles (P floats a
//   thread: 128 at P = 128, hence the one consumer and the 32-query
//   sub-steps there); db's row
//   sums of the fp32 dS are kept per thread and summed across the quad
//   that shares a key at the end.
// The element pass packs each pair of results to bf16x2 as it goes; the
// peak is two score tiles, their packed fragments and the accumulators
// (P/2 floats in dQ, P in dK/dV).
//
// The wide instance, P = 256 (Width<256>: 64-row tiles, one consumer
// warpgroup, 256 threads, 255 registers a thread).  dQ: a block per 64
// query rows, the 64-key K and V tiles in a 2-stage ring (Q and dO 64 KB,
// a stage 64 KB), taken in sub-steps of 32 keys (the 128-float dQ
// accumulator beside two 16-float score tiles).  dK/dV: a block's dK and
// dV accumulators for 64 keys at 256 columns would be 256 floats a thread,
// past the 255 registers a thread may hold, so a block takes 64 keys and
// half of the columns (kParts = 2 column halves of 128, two column blocks
// each: blockIdx.x = 2 * key tile + half).  Both halves form S^T and dP~^T
// over all 256 columns (the scores are computed twice more, the price of
// no accumulator in shared memory) and multiply into their own columns of
// Q and dO; only half 0 adds db.  Its ring streams 64-row Q and dO tiles,
// 2 stages (K, V 64 KB, a stage 64 KB), in sub-steps of 32 queries.
//
// Numerics against the plain version: products summed in another order;
// p = exp2((S*scale + bias - lse) * log2 e) on the SFU (ex2.approx), a
// few ulps from an IEEE exp, so a rounded dS or p*mr moves by at most one
// bf16 step where it sits at a rounding boundary, inside chip_smoke.py's
// GRAD_TOL[bf16].  The argument stays in the natural domain, so a row
// whose keys all carry the -1e9 bias gets the plain version's p.

#pragma once

#include "attention_sm90.cuh"

namespace stonkgs {
namespace attn90 {

// keys of a dQ sub-step at padded width kP
template <int kP> constexpr int kHalf = kP > 128 ? 32 : 64;
// the backward's ring depth at padded width kP
template <int kP> constexpr int kBwdRing = kP >= 128 ? 2 : 3;
// queries of a dK/dV sub-step at padded width kP
template <int kP> constexpr int kKvSub = kP >= 128 ? 32 : 64;
// consumer warpgroups (64 keys each) of a dK/dV block at padded width kP
template <int kP> constexpr int kKvConsumers = kP >= 128 ? 1 : kConsumers;
// column parts of a dK/dV block's outputs (blocks over the columns) at kP
template <int kP> constexpr int kParts = kP > 128 ? 2 : 1;

template <int kP>
struct alignas(1024) SmemBwdQ {
  static constexpr int kRing = kBwdRing<kP>;
  static constexpr int kRows = Width<kP>::kRows;
  bf16 q[kRows * kP];
  bf16 dout[kRows * kP];
  bf16 k[kRing][kRows * kP];
  bf16 v[kRing][kRows * kP];
  float bias[kRing][kRows];
  uint64_t full[kRing];
  uint64_t empty[kRing];
  uint64_t rowbar;
};

// K and V: the block's 64 * kKvConsumers keys, in a tile of kRows (its
// first rows used where kRows is more)
template <int kP>
struct alignas(1024) SmemBwdKV {
  static constexpr int kRing = kBwdRing<kP>;
  static constexpr int kRows = Width<kP>::kRows;
  bf16 k[kRows * kP];
  bf16 v[kRows * kP];
  bf16 q[kRing][kRows * kP];
  bf16 dout[kRing][kRows * kP];
  float lse[kRing][kRows];
  float delta[kRing][kRows];
  uint64_t full[kRing];
  uint64_t empty[kRing];
  uint64_t rowbar;
};
static_assert(sizeof(SmemBwdQ<128>) + 1024 <= kMaxSmem, "dQ's ring fits at P = 128");
static_assert(sizeof(SmemBwdKV<128>) + 1024 <= kMaxSmem, "dK/dV's ring fits at P = 128");
static_assert(sizeof(SmemBwdKV<64>) + 1024 <= kMaxSmem, "dK/dV's ring fits at P = 64");
static_assert(sizeof(SmemBwdQ<256>) + 1024 <= kMaxSmem, "dQ's ring fits at P = 256");
static_assert(sizeof(SmemBwdKV<256>) + 1024 <= kMaxSmem, "dK/dV's ring fits at P = 256");

template <int kP>
__global__ void __launch_bounds__(Width<kP>::kThreads, 1)
attn_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ key_bias, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, int S, int H,
                        int D, float scale, Dropout drop) {
  using W = Width<kP>;
  using SmemT = SmemBwdQ<kP>;
  constexpr int kRing = SmemT::kRing;
  constexpr int kR = W::kRows;  // query rows of the block, keys of a tile
  constexpr int NC = W::kNC;
  constexpr int kH = kHalf<kP>;  // keys of a sub-step
  constexpr uint32_t kTile = W::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  SmemT& sm = aligned_smem<SmemT>(smem_raw);
  const int q0 = blockIdx.x * kR, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + kR - 1) / kR;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init_ring<NC>(sm);

  if (wg == NC) {
    // ---------------- producer ----------------
    if constexpr (NC == kConsumers) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_tx(&sm.rowbar, 2 * kTile);
        W::load(sm.q, &map_q, h, q0, b, &sm.rowbar);
        W::load(sm.dout, &map_do, h, q0, b, &sm.rowbar);
      }
      const float* kb = key_bias ? key_bias + size_t(b) * S : nullptr;
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kRing, k0 = it * kR;
        mbar_wait(&sm.empty[stage], ((it / kRing) & 1) ^ 1);
#pragma unroll
        for (int t = 0; t < kR / 32; ++t) {
          const int key = k0 + t * 32 + lane;
          sm.bias[stage][t * 32 + lane] = key < S ? (kb ? __ldg(kb + key) : 0.f) : -INFINITY;
        }
        if (lane == 0) {
          mbar_arrive_tx(&sm.full[stage], 2 * kTile);
          W::load(sm.k[stage], &map_k, h, k0, b, &sm.full[stage]);
          W::load(sm.v[stage], &map_v, h, k0, b, &sm.full[stage]);
        } else {
          mbar_arrive(&sm.full[stage]);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    if constexpr (NC == kConsumers) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // the thread's rows: row0, row0 + 8
    const size_t stat0 = (size_t(b) * H + h) * S;          // (b, h, 0) of lse and delta
    float lse_r[2], delta_r[2];
    uint32_t base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse_r[r] = row < S ? lse[stat0 + row] : 0.f;
      delta_r[r] = row < S ? delta[stat0 + row] : 0.f;
      base[r] = drop.row_base(b * H + h, row);
    }
    const uint64_t dqd = desc_sw<W::kLine>(sm.q + wg * 64 * W::kCB);
    const uint64_t dod = desc_sw<W::kLine>(sm.dout + wg * 64 * W::kCB);
    float acc[kP / 2];
#pragma unroll
    for (int i = 0; i < kP / 2; ++i) acc[i] = 0.f;

    mbar_wait(&sm.rowbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kRing;
      mbar_wait(&sm.full[stage], (j / kRing) & 1);
#pragma unroll 1
      for (int half = 0; half < kR / kH; ++half) {
        // S = Q K^T and dP~ = dO V^T over the sub-step's kH keys
        const int c0 = half * kH, k0 = j * kR + c0;
        const uint64_t dk = desc_sw<W::kLine>(sm.k[stage] + c0 * W::kCB);
        const uint64_t dv = desc_sw<W::kLine>(sm.v[stage] + c0 * W::kCB);
        float s[kH / 2], dp[kH / 2];
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk)
          wgmma_ss<kH / 2, 0, 0>(s, W::kstep(dqd, kk), W::kstep(dk, kk), kk);
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk)
          wgmma_ss<kH / 2, 0, 0>(dp, W::kstep(dod, kk), W::kstep(dv, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // dS = p (dP~ * mr - delta), packed to bf16 pairs as it goes
        const float* bs = sm.bias[stage] + c0;
        uint32_t pa[kH / 4];
#pragma unroll
        for (int t = 0; t < kH / 4; ++t) {
          const int i = 2 * t, r = acc_row(i), c = acc_col(i, lane);
          const float2 bv = *reinterpret_cast<const float2*>(bs + c);
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2((fmaf(s[i + e], scale, e ? bv.y : bv.x) - lse_r[r]) * kLog2e);
            float d = dp[i + e];
            if (drop.enabled)
              d = drop.keep(base[r] + uint32_t(k0 + c + e)) ? d * drop.keep_scale : 0.f;
            ds[e] = p * (d - delta_r[r]);
          }
          pa[t] = pack_bf16(ds[0], ds[1]);
        }
        // dQ += dS K: the sub-step's K rows MN-major, its kH keys the k of kH/16 steps
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kH / 16; ++kk)
          W::mma_rows(acc, pa + 4 * kk, dk + kk * W::kLine);  // 16 keys = 16 lines = kLine units
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      release_stage(&sm.empty[stage], lane);
    }
    store_rows_sm90<kP>(dq + (size_t(b) * S * H + h) * D, acc, row0, S, size_t(H) * D, D, scale,
                        lane);
  }
}

template <int kP>
__global__ void __launch_bounds__(128 * (kKvConsumers<kP> + 1), 1)
attn_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ key_bias, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, float* __restrict__ db, int S, int H, int D,
                          float scale, Dropout drop) {
  using W = Width<kP>;
  using SmemT = SmemBwdKV<kP>;
  constexpr int kRing = SmemT::kRing;
  constexpr int kR = W::kRows;      // rows of a tile: queries a stage
  constexpr int kSub = kKvSub<kP>;  // queries of a sub-step
  constexpr int NC = kKvConsumers<kP>;
  constexpr int kNP = kParts<kP>;   // column parts
  constexpr int kN = kP / kNP;      // output columns of the block
  constexpr uint32_t kTile = W::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  SmemT& sm = aligned_smem<SmemT>(smem_raw);
  // the block's 64 * NC keys (its K and V tiles are kR rows all the same)
  // and its part of the output columns, [part * kN, part * kN + kN)
  const int part = blockIdx.x % kNP;
  const int k0 = blockIdx.x / kNP * 64 * NC, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + kR - 1) / kR;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const size_t stat0 = (size_t(b) * H + h) * S;
  init_ring<NC>(sm);

  if (wg == NC) {
    // ---------------- producer ----------------
    if constexpr (NC == kConsumers) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_tx(&sm.rowbar, 2 * kTile);
        W::load(sm.k, &map_k, h, k0, b, &sm.rowbar);
        W::load(sm.v, &map_v, h, k0, b, &sm.rowbar);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kRing, q0 = it * kR;
        mbar_wait(&sm.empty[stage], ((it / kRing) & 1) ^ 1);
#pragma unroll
        for (int t = 0; t < kR / 32; ++t) {
          const int row = q0 + t * 32 + lane;
          sm.lse[stage][t * 32 + lane] = row < S ? __ldg(lse + stat0 + row) : INFINITY;
          sm.delta[stage][t * 32 + lane] = row < S ? __ldg(delta + stat0 + row) : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_tx(&sm.full[stage], 2 * kTile);
          W::load(sm.q[stage], &map_q, h, q0, b, &sm.full[stage]);
          W::load(sm.dout[stage], &map_do, h, q0, b, &sm.full[stage]);
        } else {
          mbar_arrive(&sm.full[stage]);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    if constexpr (NC == kConsumers) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int key0 = k0 + wg * 64 + warp * 16 + lane / 4;  // the thread's keys: key0, key0 + 8
    const int bh = b * H + h;
    float bias_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      bias_r[r] = key < S ? (key_bias ? key_bias[size_t(b) * S + key] : 0.f) : -INFINITY;
    }
    const uint64_t dkd = desc_sw<W::kLine>(sm.k + wg * 64 * W::kCB);
    const uint64_t dvd = desc_sw<W::kLine>(sm.v + wg * 64 * W::kCB);
    // the part's first column block, in the MN-major products' descriptors
    const uint64_t part_off = uint64_t(part) * (kN / W::kCB) * W::kBlock;
    float dk_acc[kN / 2], dv_acc[kN / 2], db_acc[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(&sm.rowbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kRing;
      mbar_wait(&sm.full[stage], (j / kRing) & 1);
#pragma unroll 1
      for (int sub = 0; sub < kR / kSub; ++sub) {
        // S^T = K Q^T over the sub-step's queries (rows keys, columns queries)
        const int c0 = sub * kSub, q0 = j * kR + c0;
        const uint64_t dq = desc_sw<W::kLine>(sm.q[stage] + c0 * W::kCB);
        const uint64_t ddo = desc_sw<W::kLine>(sm.dout[stage] + c0 * W::kCB);
        float s[kSub / 2], dp[kSub / 2];
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk)
          wgmma_ss<kSub / 2, 0, 0>(s, W::kstep(dkd, kk), W::kstep(dq, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        // p in place of S, the keep bits, round(p*mr) packed to bf16 pairs
        const float* ls = sm.lse[stage] + c0;
        uint32_t kept = 0xFFFFFFFFu, pa[kSub / 4];
#pragma unroll
        for (int t = 0; t < kSub / 4; ++t) {
          const int i = 2 * t, r = acc_row(i), c = acc_col(i, lane);
          const float2 lv = *reinterpret_cast<const float2*>(ls + c);
          float pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2((fmaf(s[i + e], scale, bias_r[r]) - (e ? lv.y : lv.x)) * kLog2e);
            s[i + e] = p;
            pd[e] = p;
            if (drop.enabled) {
              if (drop.keep(drop.row_base(bh, q0 + c + e) + uint32_t(key0 + 8 * r))) {
                pd[e] = p * drop.keep_scale;
              } else {
                kept &= ~(1u << (i + e));
                pd[e] = 0.f;
              }
            }
          }
          pa[t] = pack_bf16(pd[0], pd[1]);
        }
        // dV += round(p*mr)^T dO (dO MN-major, the sub-step's queries the k
        // of kSub/16 steps) and dP~^T = V dO^T, one group
        fence_regs(dv_acc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)
          W::template mma_rows<kN>(dv_acc, pa + 4 * kk, ddo + part_off + kk * W::kLine);
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk)
          wgmma_ss<kSub / 2, 0, 0>(dp, W::kstep(dvd, kk), W::kstep(ddo, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dp);
        // dS = p (dP~ * mr - delta) packed to bf16 pairs; db's fp32 row sums
        const float* dl = sm.delta[stage] + c0;
        uint32_t pb[kSub / 4];
#pragma unroll
        for (int t = 0; t < kSub / 4; ++t) {
          const int i = 2 * t, r = acc_row(i), c = acc_col(i, lane);
          const float2 dlv = *reinterpret_cast<const float2*>(dl + c);
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float d = dp[i + e];
            if (drop.enabled) d = (kept >> (i + e)) & 1u ? d * drop.keep_scale : 0.f;
            ds[e] = s[i + e] * (d - (e ? dlv.y : dlv.x));
            db_acc[r] += ds[e];
          }
          pb[t] = pack_bf16(ds[0], ds[1]);
        }
        // dK += round(dS)^T Q: Q MN-major
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)
          W::template mma_rows<kN>(dk_acc, pb + 4 * kk, dq + part_off + kk * W::kLine);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk_acc);
      }
      release_stage(&sm.empty[stage], lane);
    }
    const size_t head0 = (size_t(b) * S * H + h) * D + size_t(part) * kN;
    store_rows_sm90<kN>(dv + head0, dv_acc, key0, S, size_t(H) * D, D - part * kN, 1.f, lane);
    store_rows_sm90<kN>(dk + head0, dk_acc, key0, S, size_t(H) * D, D - part * kN, scale, lane);
    if (db && part == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = db_acc[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int key = key0 + 8 * r;
        if ((lane & 3) == 0 && key < S) atomicAdd(db + size_t(b) * S + key, v);
      }
    }
  }
}

// the two kernels after the delta pass; delta (B, H, S) fp32 is written
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// the dQ and dK/dV kernels at padded width kP (D <= kP)
template <int kP>
int launch_bwd_sm90(const void* q, const void* k, const void* v, const float* key_bias,
                    const float* lse, const void* dout, const float* delta, void* dq, void* dk,
                    void* dv, float* db, int B, int S, int H, int D, float scale, Dropout drop,
                    cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<kP>(&mq, q, B, S, H, D) || !make_map<kP>(&mk, k, B, S, H, D) ||
      !make_map<kP>(&mv, v, B, S, H, D) || !make_map<kP>(&mdo, dout, B, S, H, D))
    return kErrTensorMap;
  constexpr size_t smem_q = sizeof(SmemBwdQ<kP>) + 1024;
  constexpr size_t smem_kv = sizeof(SmemBwdKV<kP>) + 1024;
  cudaError_t e = set_smem(attn_bwd_dq_sm90_kernel<kP>, smem_q);
  if (e != cudaSuccess) return int(e);
  e = set_smem(attn_bwd_dkdv_sm90_kernel<kP>, smem_kv);
  if (e != cudaSuccess) return int(e);
  using W = Width<kP>;
  const dim3 grid((S + W::kRows - 1) / W::kRows, H, B);
  attn_bwd_dq_sm90_kernel<kP><<<grid, W::kThreads, smem_q, stream>>>(
      mq, mk, mv, mdo, key_bias, lse, delta, static_cast<bf16*>(dq), S, H, D, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  constexpr int kKeys = 64 * kKvConsumers<kP>;  // keys of a dK/dV block
  const dim3 grid_kv((S + kKeys - 1) / kKeys * kParts<kP>, H, B);
  attn_bwd_dkdv_sm90_kernel<kP><<<grid_kv, 128 * (kKvConsumers<kP> + 1), smem_kv, stream>>>(
      mq, mk, mv, mdo, key_bias, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      db, S, H, D, scale, drop);
  return int(cudaGetLastError());
}

}  // namespace attn90
}  // namespace stonkgs
