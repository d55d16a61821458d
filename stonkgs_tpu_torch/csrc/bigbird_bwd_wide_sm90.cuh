// The bf16 BigBird middle-block backward past the Hopper instances' widest
// head width (d > 64), for Hopper (sm_90a), launched by bigbird_sparse.cu
// for dtype 1: dq, and dK, dV added into fp32 accumulators, as
// bigbird_bwd_sm90_kernel (bigbird_sm90.cuh) computes them up to 64.  It
// replaces the TPU kernel _mid_blocks_bwd_kernel
// (stonkgs_tpu/ops/bigbird_sparse_pallas.py:113, launched at :272) at
// those widths: per middle query block j and key slot of [g0 | window
// i-1, i, i+1 | g_last | random r] (i = j + 1)
//   s  = round(round(Q K^T) * scale) + penalty  (the scale 1/sqrt(d) in bf16)
//   p  = exp(s - lse),  dP = dO V^T,  delta = rowsum(dO * O) over the full d
//   dS = p (dP - delta) / sqrt(d)                (fp32)
//   dQ = dS K,  dK = dS^T Q,  dV = round(p)^T dO
// with dS fed to the tensor cores as hi = round(dS) and lo = round(dS -
// hi), 16 of its 24 significant bits, in dQ and dK alike, and dK, dV of
// each 64-key sub-tile added in fp32 into the slot's key rows.  Rows past
// a partial block get p = dS = 0; keys past the block (penalty -inf) get p
// = 0, so their rows take adds of zero.  The slot map, the penalties and
// the 64-row tiles are bigbird_sm90.cuh's.
//
// What bounds it on the H100: at the 6-head training plan (B=2, S=4096, 6
// heads of 128, bs 64, r 3) five products of 2 B H (nb-2) bs 512 d (6.24
// GFLOP each: 0.032 ms at 989 TFLOP/s) over the bytes (q, k, v, o, dO
// read, dq, dk, dv written: 0.030 ms at 3.35 TB/s); this design's floor
// is seven products (dS's two halves in dQ and dK): 0.044 ms.
//
// Why a design of its own: bigbird_sm90.cuh's backward keeps two
// consumers' Q and dO tiles, their fp32 64 x d dK and dV staging and a
// ring of 64 x d K and V tiles in shared memory, more than 227 KB at d =
// 128.  So, query-major as the TPU kernel, with the block shape of
// bigbird_wide_sm90.cuh:
// * a CTA is one warpgroup of 128 threads that owns one 64-row tile of a
//   middle query block (T = ceil(bs / 64) CTAs a block) and one output
//   part of 128 columns (two column blocks of 64; a grid axis past d =
//   128); its first warp also feeds a 4-stage TMA ring.  One CTA an SM
//   (219 KB of shared memory), 255 registers a thread;
// * per 64-key slot sub-tile the scores S = Q K^T and dP = dO V^T run over
//   the full d in column blocks of 64 (four wgmma.m64n64k16 k-steps each),
//   one ring item a block: K's and V's block, and outside the part Q's
//   and dO's too (the part's own Q and dO blocks stay in shared memory,
//   loaded once).  Each block's dP goes to a fresh accumulator and is
//   added in fp32 (one wgmma chain over the columns drifts, PERF.md);
// * the part's blocks come last and stay in the ring until dQ has read
//   K's: dQ += dS K for the part's 128 columns in registers across the
//   CTA's sub-tiles (wgmma.m64n64k16 with dS hi and lo from registers,
//   the packed accumulator as the A fragment);
// * round(p), dS hi and dS lo go to shared memory (64 keys a 128-byte
//   line); dK = dS^T Q and dV = round(p)^T dO of the part's columns run
//   one column block at a time (dS^T and P^T as M-major A operands, Q and
//   dO MN-major), each staged in fp32 boxes of 64 x 32 with the 128-byte
//   swizzle and added by one thread with TMA reduce-adds
//   (cp.reduce.async.bulk.tensor): adds in L2, in an order that changes
//   from run to run, clipped at S and d.
// Products a sub-tile and part: 2 ncb score blocks, then dQ (four a
// column block), dK (two) and dV (one): at d = 128 the seven products.
// Past 128 each part forms the scores again: parts + 6 products at
// parts = ceil(d / 128).
//
// Numerics: those of bigbird_bwd_sm90_kernel (p = ex2.approx of s log2 e
// - lse log2 e, products summed in another order), held to the same bf16
// limits in chip_smoke.py.

#pragma once

#include <cmath>
#include <cstdint>

#include "bigbird_wide_sm90.cuh"  // attn90::wide::desc_at, attn90::kMaxSmem, the bf16 helpers

namespace stonkgs {
namespace bigbird90 {
namespace bwide {

constexpr int kCB = 64;                          // columns of a column block
constexpr int kPartBlocks = 2;                   // column blocks of an output part
constexpr int kRing = 4;                         // ring stages
constexpr int kStageTiles = 4;                   // K, V and, outside the part, Q and dO blocks
constexpr int kTileElems = kRows * kCB;          // a 64 x 64 tile
constexpr uint32_t kTileBytes = kTileElems * 2;  // 8 KB
constexpr int kStageCols = 32;                     // columns of an fp32 staging box (128 bytes)
constexpr int kStageElems = kRows * kStageCols;      // 8 KB of fp32
constexpr int kThreads = 128;                    // one consumer warpgroup
// shared memory from its 1024-byte aligned start: the barriers (full,
// empty, the part's Q and dO), the stages' penalties, then the ring's
// tiles, the part's Q and dO blocks, round(p), dS hi and lo, and the
// staging of a column block's dK and dV (two boxes each)
constexpr int kPenOffset = 128;
constexpr int kTilesOffset = 2048;
static_assert(kPenOffset + kRing * kRows * 4 <= kTilesOffset, "the penalties fit");
constexpr size_t kQOffset = kTilesOffset + size_t(kRing) * kStageTiles * kTileBytes;
constexpr size_t kDoOffset = kQOffset + kPartBlocks * kTileBytes;
constexpr size_t kPOffset = kDoOffset + kPartBlocks * kTileBytes;
constexpr size_t kStagingOffset = kPOffset + 3 * kTileBytes;
constexpr size_t kSmem = 1024 + kStagingOffset + 4 * size_t(kStageElems) * 4;
static_assert(kSmem <= attn90::kMaxSmem, "the ring and the tiles fit");

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == kRing) {
    stage = 0;
    phase ^= 1u;
  }
}

}  // namespace bwide

__global__ void __launch_bounds__(bwide::kThreads, 1)
bigbird_bwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const __grid_constant__ CUtensorMap map_dk,
                             const __grid_constant__ CUtensorMap map_dv,
                             const float* __restrict__ mask, const int* __restrict__ rand,
                             const bf16* __restrict__ out, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, bf16* __restrict__ dq, Geo g,
                             int ncb) {
  using namespace bwide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kRing;
  uint64_t* rowbar = empty + kRing;  // the part's Q and dO blocks
  float* pen = reinterpret_cast<float*>(base + kPenOffset);
  bf16* ring = reinterpret_cast<bf16*>(base + kTilesOffset);
  bf16* qs = reinterpret_cast<bf16*>(base + kQOffset);
  bf16* dos = reinterpret_cast<bf16*>(base + kDoOffset);
  bf16* ps = reinterpret_cast<bf16*>(base + kPOffset);  // round(p), then dS hi and lo
  bf16* dsh = ps + kTileElems;
  bf16* dsl = dsh + kTileElems;
  float* dkst = reinterpret_cast<float*>(base + kStagingOffset);
  float* dvst = dkst + 2 * kStageElems;
  const int parts = (ncb + kPartBlocks - 1) / kPartBlocks;
  const int tile = int(blockIdx.x) / parts, part = int(blockIdx.x) - tile * parts;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bs = g.bs, T = tiles_of(bs);
  const int n_mid = g.nb - 2, steps = (5 + g.r) * T;  // slot sub-tiles
  const int j = tile / T, u = tile - j * T;            // the middle query block, its row tile
  const int mrow = j * bs + u * kRows;                 // the tile's first row among the middle rows
  const int pc0 = part * kPartBlocks, npc = min(kPartBlocks, ncb - pc0);  // the part's blocks
  const int nout = ncb - npc;                          // blocks outside the part, streamed
  const int* rand_j = rand + (size_t(h) * n_mid + j) * g.r;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 32);  // the feeding warp's lanes, lane 0 with the bytes
      mbar_init(&empty[s], 4);  // the warps
    }
    mbar_init(rowbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // ---------------- the feeding warp (warp 0) ----------------
  // Per sub-tile one item a column block, the blocks outside the part
  // first (K's, V's, Q's and dO's block), then the part's (K's and V's),
  // kRing items ahead; the sub-tile's penalties ride in the stage of its
  // last item.  Each item is released in the order it was loaded (the
  // part's after dQ), and every release refills that stage.
  const bool feeder = threadIdx.x < 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* mask_b = mask + size_t(b) * g.S;
  int f_x = 0, f_i = 0, f_stage = 0;
  uint32_t f_phase = 0;
  float f_pen[2];  // the sub-tile's penalties (keys lane, lane + 32), read at its first item
  auto feed = [&]() {
    if (f_x >= steps) return;
    mbar_wait(&empty[f_stage], f_phase ^ 1u);
    const int t = f_x / T, uk = f_x - t * T;
    const int key0 = bigbird::slot_block(rand_j, t, j, g.nb) * bs + uk * kRows;
    if (f_i == 0) {
      const bool dup = bigbird::dup_slot(t, j, g.nb);
      f_pen[0] = bigbird::tile_penalty<true>(mask_b, key0, lane, uk, bs, dup);
      f_pen[1] = bigbird::tile_penalty<true>(mask_b, key0, lane + 32, uk, bs, dup);
    }
    if (f_i == ncb - 1) {
      pen[f_stage * kRows + lane] = f_pen[0];
      pen[f_stage * kRows + lane + 32] = f_pen[1];
    }
    uint64_t* bar = &full[f_stage];
    if (lane == 0) {
      const bool outside = f_i < nout;
      const int c = outside ? (f_i < pc0 ? f_i : f_i + npc) : pc0 + (f_i - nout);
      bf16* dst = ring + f_stage * kStageTiles * kTileElems;
      mbar_arrive_tx(bar, (outside ? 4u : 2u) * kTileBytes);
      tma_load_4d(dst, &map_k, c * kCB, h, key0, b, bar);
      tma_load_4d(dst + kTileElems, &map_v, c * kCB, h, key0, b, bar);
      if (outside) {
        tma_load_4d(dst + 2 * kTileElems, &map_q, c * kCB, h, bs + mrow, b, bar);
        tma_load_4d(dst + 3 * kTileElems, &map_do, c * kCB, h, mrow, b, bar);
      }
    } else {
      mbar_arrive(bar);
    }
    if (++f_i == ncb) {
      f_i = 0;
      ++f_x;
    }
    advance(f_stage, f_phase);
    __syncwarp();  // reconverged before the warpgroup's next wgmma
  };
  if (feeder) {
    if (lane == 0) {
      mbar_arrive_tx(rowbar, uint32_t(2 * npc) * kTileBytes);
      for (int c = 0; c < npc; ++c) {
        tma_load_4d(qs + c * kTileElems, &map_q, (pc0 + c) * kCB, h, bs + mrow, b, rowbar);
        tma_load_4d(dos + c * kTileElems, &map_do, (pc0 + c) * kCB, h, mrow, b, rowbar);
      }
    }
    for (int i = 0; i < kRing; ++i) feed();
  }
  auto release = [&](int stage) {
    release_stage(&empty[stage], lane);
    if (feeder) feed();
  };

  // ---------------- the warpgroup: 64 query rows ----------------
  const int lrow = warp * 16 + lane / 4;  // the thread's rows of the tile: lrow, lrow + 8
  const int brow = u * kRows + lrow;      // ... and of the block
  const bool live[2] = {brow < bs, brow + 8 < bs};  // rows of the block: the others add nothing
  const size_t n_rows = size_t(n_mid) * bs;        // middle rows of a (b, h)
  const size_t row0 = size_t(mrow) + lrow;         // the thread's first row among them
  // lse (times log2 e) and delta = rowsum(dO * O) over the full d of the
  // thread's rows, the four threads of a row summing every fourth 8-column
  // chunk
  float lse_l[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float acc = 0.f;
    if (live[r]) {
      const size_t off = ((size_t(b) * n_rows + row0 + 8 * r) * g.H + h) * size_t(g.d);
      for (int c = (lane & 3) * 8; c < g.d; c += 32) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(dout + off + c));
        const uint4 y = __ldg(reinterpret_cast<const uint4*>(out + off + c));
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
          const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
          acc = fmaf(a.x, o.x, acc);
          acc = fmaf(a.y, o.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta_r[r] = acc;
    lse_l[r] = live[r] ? kLog2e * lse[(size_t(b) * g.H + h) * n_rows + row0 + 8 * r] : 0.f;
  }
  const uint32_t ring_s = smem_u32(ring), qs_s = smem_u32(qs), dos_s = smem_u32(dos);
  const uint64_t dpd = desc_sw128(ps), dshd = desc_sw128(dsh), dsld = desc_sw128(dsl);
  float dqa[64];  // dQ of the part's 128 columns (m64n128's register map)
#pragma unroll
  for (int i = 0; i < 64; ++i) dqa[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(rowbar, 0);

  for (int x = 0; x < steps; ++x) {
    // S and dP over the column blocks: the items outside the part are
    // released once their products are done, the part's held for dQ
    float s[32], dp[32], dpc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    for (int i = 0; i < ncb; ++i) {
      mbar_wait(&full[stage], phase);
      const uint32_t st = ring_s + stage * kStageTiles * kTileBytes;
      const bool outside = i < nout;
      const uint64_t dk = attn90::wide::desc_at(st);
      const uint64_t dv = attn90::wide::desc_at(st + kTileBytes);
      const uint64_t dqd = attn90::wide::desc_at(
          outside ? st + 2 * kTileBytes : qs_s + uint32_t(i - nout) * kTileBytes);
      const uint64_t ddo = attn90::wide::desc_at(
          outside ? st + 3 * kTileBytes : dos_s + uint32_t(i - nout) * kTileBytes);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCB / 16; ++kk) wgmma_qk64(s, dqd + 2 * kk, dk + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < kCB / 16; ++kk) wgmma_qk64(dpc, ddo + 2 * kk, dv + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dpc);
#pragma unroll
      for (int e = 0; e < 32; ++e) dp[e] += dpc[e];
      if (outside) release(stage);
      advance(stage, phase);
    }
    // the part's items, the sub-tile's last, sit in the stages before `stage`
    const int held0 = (stage + kRing - npc) % kRing, held1 = (held0 + 1) % kRing;
    logits<64, true>(s, pen + (npc > 1 ? held1 : held0) * kRows, lane, g.logit);
    // p = exp(s - lse), dS = p (dP - delta) / sqrt(d), both 0 on rows past
    // the block; round(p), dS hi and lo into shared memory (the previous
    // sub-tile's products are done: every warp passed the barriers below
    // since), dS hi and lo also as dQ's A fragments
    uint32_t ah[16], al[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = acc_row(i);
      float p0 = 0.f, p1 = 0.f, d0 = 0.f, d1 = 0.f;
      if (live[r]) {
        p0 = ex2(fmaf(s[i], kLog2e, -lse_l[r]));
        p1 = ex2(fmaf(s[i + 1], kLog2e, -lse_l[r]));
        d0 = p0 * (dp[i] - delta_r[r]) * g.scale;
        d1 = p1 * (dp[i + 1] - delta_r[r]) * g.scale;
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(d0, d1);
      const float2 hf = __bfloat1622float2(hi);
      ah[i / 2] = *reinterpret_cast<const uint32_t*>(&hi);
      al[i / 2] = pack_bf16(d0 - hf.x, d1 - hf.y);
      const uint32_t off = sw128_offset(lrow + 8 * r, acc_col(i, lane));
      st_shared_u32(ps, off, pack_bf16(p0, p1));
      st_shared_u32(dsh, off, ah[i / 2]);
      st_shared_u32(dsl, off, al[i / 2]);
    }
    fence_async_shared();  // the tiles, written by this thread, to the products
    __syncthreads();

    // dQ += dS K over the part's columns (K's blocks in the held stages);
    // dK = dS^T Q and dV = round(p)^T dO of each of the part's blocks,
    // staged and added into the accumulators
    const int t = x / T, uk = x - t * T;
    const int key0 = bigbird::slot_block(rand_j, t, j, g.nb) * bs + uk * kRows;
    for (int c = 0; c < npc; ++c) {
      float dka[32], dva[32];
      const uint64_t dqc = attn90::wide::desc_at(qs_s + uint32_t(c) * kTileBytes);
      const uint64_t ddoc = attn90::wide::desc_at(dos_s + uint32_t(c) * kTileBytes);
      fence_regs(dqa);
      wgmma_fence();  // orders the writes of the fragments and dQ before the products
      if (c == 0) {
        const uint64_t dk0 = attn90::wide::desc_at(ring_s + held0 * kStageTiles * kTileBytes);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {  // 16 keys = 16 lines = 128 units
          wgmma_pv_at<0>(dqa, ah + 4 * kk, dk0 + kk * 128);
          wgmma_pv_at<0>(dqa, al + 4 * kk, dk0 + kk * 128);
        }
        if (npc > 1) {
          const uint64_t dk1 =
              attn90::wide::desc_at(ring_s + held1 * kStageTiles * kTileBytes);
#pragma unroll
          for (int kk = 0; kk < kRows / 16; ++kk) {
            wgmma_pv_at<32>(dqa, ah + 4 * kk, dk1 + kk * 128);
            wgmma_pv_at<32>(dqa, al + 4 * kk, dk1 + kk * 128);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        wgmma_ss<32, 1, 1>(dka, dshd + kk * kPStep, dqc + kk * 128, kk);
        wgmma_ss<32, 1, 1>(dka, dsld + kk * kPStep, dqc + kk * 128, 1);
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_ss<32, 1, 1>(dva, dpd + kk * kPStep, ddoc + kk * 128, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_regs(dka);
      fence_regs(dva);
      if (c == 0) {  // dQ has read K's blocks
        release(held0);
        if (npc > 1) release(held1);
      }
      if (threadIdx.x == 0) tma_store_read_done();  // the previous adds have read the staging
      __syncthreads();
      stage_f32<64>(dkst, dka, lrow, lane);
      stage_f32<64>(dvst, dva, lrow, lane);
      fence_async_shared();
      __syncthreads();
      if (threadIdx.x == 0) {
        const int col = (pc0 + c) * kCB;
#pragma unroll
        for (int xb = 0; xb < kCB / kStageCols; ++xb) {
          if (col + kStageCols * xb >= g.d) break;  // a box wholly past the accumulators' d
          tma_reduce_add_4d(&map_dk, dkst + xb * kStageElems, col + kStageCols * xb, h, key0, b);
          tma_reduce_add_4d(&map_dv, dvst + xb * kStageElems, col + kStageCols * xb, h, key0, b);
        }
        tma_store_commit();
      }
    }
  }
  if (threadIdx.x == 0) tma_store_done();
  // dQ of the part's columns < d, the rows of the block
  if (live[0] || live[1]) {
    const int c0 = pc0 * kCB;
    bf16* dst = dq + ((size_t(b) * g.S + bs + row0) * g.H + h) * size_t(g.d) + c0;
    store_acc<true>(dst, dst + size_t(8) * g.H * g.d, live[0], live[1], dqa, lane, g.d - c0);
  }
}

// --- host side --------------------------------------------------------------

// the calls of launch_bwd_wide_sm90 that launched its kernel (exported as
// bigbird_mid_bwd_wide_calls: the route a check reads without a profiler)
inline int& bwd_wide_calls() {
  static int calls = 0;
  return calls;
}

// The bf16 backward at d > 64 (a multiple of 8): out and dout (B, (nb-2)
// bs, H, d) contiguous, dk and dv (B, S, H, d) fp32 accumulators,
// contiguous and zeroed
inline int launch_bwd_wide_sm90(const void* q, const void* k, const void* v, const float* mask,
                                const int* rand, const void* out, const float* lse,
                                const void* dout, void* dq, float* dk, float* dv, int B,
                                const Geo& g, cudaStream_t stream) {
  using namespace bwide;
  if (g.d <= 64 || g.d % 8 != 0) return int(cudaErrorInvalidValue);
  const int n_rows = (g.nb - 2) * g.bs;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;  // bf16 boxes of 64 rows x 64 columns, fp32 of 32
  if (!make_map_bshd<bf16>(&mq, q, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, kCB) ||
      !make_map_bshd<bf16>(&mk, k, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, kCB) ||
      !make_map_bshd<bf16>(&mv, v, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, kCB) ||
      !make_map_dense<bf16>(&mdo, dout, B, n_rows, g.H, g.d, kCB) ||
      !make_map_dense<float>(&mdk, dk, B, g.S, g.H, g.d, kStageCols) ||
      !make_map_dense<float>(&mdv, dv, B, g.S, g.H, g.d, kStageCols))
    return kErrTensorMap;
  const int ncb = (g.d + kCB - 1) / kCB, parts = (ncb + kPartBlocks - 1) / kPartBlocks;
  const cudaError_t e = set_smem(bigbird_bwd_wide_sm90_kernel, kSmem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((g.nb - 2) * tiles_of(g.bs) * parts, g.H, B);
  bigbird_bwd_wide_sm90_kernel<<<grid, kThreads, kSmem, stream>>>(
      mq, mk, mv, mdo, mdk, mdv, mask, rand, static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), g, ncb);
  const int status = int(cudaGetLastError());
  if (status == 0) ++bwd_wide_calls();
  return status;
}

}  // namespace bigbird90
}  // namespace stonkgs
