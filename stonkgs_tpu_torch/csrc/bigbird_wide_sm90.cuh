// The bf16 BigBird middle-block forward past the Hopper instances' widest
// head width (d > 64), for Hopper (sm_90a), launched by bigbird_sparse.cu
// for dtype 1: ctx and the fp32 lse of the middle query blocks, as
// bigbird_fwd_sm90_kernel (bigbird_sm90.cuh) computes them up to 64.  It
// replaces the TPU kernel _mid_blocks_kernel
// (stonkgs_tpu/ops/bigbird_sparse_pallas.py:83, with _gather_kv at :51
// and _mid_logits at :70) at those widths: middle query block j attends
// its 5 + r key slots, s = round(round(Q K^T) * scale) + penalty with the
// scale 1/sqrt(d) of the true d in bf16 (rounded twice: no instance fixes
// it here), fp32 statistics, p = exp(s - m) / l rounded to bf16 before
// P V, lse = m + log l.  The slot map, the penalties (-inf past a partial
// block), the row tiles of 64 and the two ways of filling a CTA (Q = 2:
// two query blocks at bs <= 64; Q = 1: two row tiles of one block) are
// bigbird_sm90.cuh's.
//
// What bounds it on the H100: at the 6-head trunk's serving call (B=8,
// S=4096, 6 heads of 128, bs 64, r 3) the bytes (q's middle rows, k, v,
// out: 0.059 ms at 3.35 TB/s) over the two products of 2 x B x H x
// (nb-2) x bs x 512 x d (0.050 ms); this design's floor is three products
// (0.076 ms at 989 TFLOP/s, the scores formed again in pass 2).
//
// Why a design of its own: bigbird_sm90.cuh's ring stages hold 64 x d K
// and V tiles of two query blocks (256 KB at d = 128).  So, as
// attention_wide_sm90.cuh does for the dense forward past 256:
// * the scores run over the full d in column blocks of 64 (a 128-byte
//   line, the widest swizzle), each block four wgmma.m64n64k16 k-steps
//   into the 64 x 64 fp32 score tile of a slot sub-tile; TMA zero-fills the
//   columns of the last block past d;
// * O is cut into column parts of 128 (two column blocks): wgmma.m64n64k16
//   with P from registers against the part's columns of V only;
// * 256 threads: two consumer warpgroups of 64 query rows, the first warp
//   also feeding a 4-stage TMA ring (ptxas gives a 256-thread block 255
//   registers a thread, a 288- or 384-thread one 168).  A ring item is up
//   to four 8 KB tiles (64 rows x 64 columns): per sub-tile the K blocks
//   of the CTA's Q key tiles, both column blocks of the head in one item
//   at d <= 128 and one block an item past it, with the consumers' two Q
//   blocks beside it where Q does not stay in shared memory beside the
//   ring (d > 320); in pass 2 then one item of the part's two V blocks.
//   The sub-tile's penalties ride in the stage of its last score item;
// * at d <= 128 one part covers the head: one launch runs both passes
//   (kBoth), three score-sized products.  Past 128 pass 1 is the same for
//   every part, so a statistics launch (kStats) writes each row's (m, 1/l)
//   to an fp32 (B, H, (nb-2) bs) x 2 scratch and lse, and the part blocks
//   (kPart) run pass 2: parts + 2 products, parts + 1 exps a score.
//
// Numerics: those of bigbird_fwd_sm90_kernel (exp2 on the SFU and a
// per-row reciprocal of l; the products summed in another order), held to
// the same bf16 limits in chip_smoke.py.  The lse it writes is what
// bigbird_bwd_wide_sm90.cuh's backward reads.

#pragma once

#include <cmath>
#include <cstdint>

#include "attention_wide_sm90.cuh"  // attn90::wide::desc_at, attn90::kMaxSmem
#include "bigbird_sm90.cuh"

namespace stonkgs {
namespace bigbird90 {
namespace wide {

constexpr int kCB = 64;                           // columns of a column block
constexpr int kPartBlocks = 2;                    // column blocks of an output part
constexpr int kPartCols = kCB * kPartBlocks;      // 128
constexpr int kRing = 4;                          // ring stages
constexpr int kStageTiles = 4;                    // 64 x 64 tiles a stage
constexpr int kTileElems = kRows * kCB;
constexpr uint32_t kTileBytes = kTileElems * 2;   // 8 KB
constexpr int kBlockThreads = 2 * 128;            // two consumer warpgroups
// shared memory from its 1024-byte aligned start: the barriers (full,
// empty, Q's), the stages' penalties (kRing x 2 x 64 floats), then the
// ring's tiles and Q's (two tiles a column block, one a consumer)
constexpr int kPenOffset = 128;
constexpr int kTilesOffset = 3072;
static_assert(kPenOffset + kRing * 2 * kRows * 4 <= kTilesOffset, "the penalties fit");

enum Mode { kBoth = 0, kStats = 1, kPart = 2 };

// dynamic shared memory at ncb column blocks, Q staying or streamed (1024
// bytes of alignment slack included)
inline size_t smem_bytes(int ncb, bool q_stays) {
  return 1024 + kTilesOffset +
         size_t(kRing * kStageTiles + (q_stays ? 2 * ncb : 0)) * kTileBytes;
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == kRing) {
    stage = 0;
    phase ^= 1u;
  }
}

}  // namespace wide

// Q query blocks' key tiles a ring item (2: two query blocks, bs <= 64; 1:
// two row tiles of one block), the mode
template <int Q, int kMode>
__global__ void __launch_bounds__(wide::kBlockThreads, 1)
bigbird_fwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const float* __restrict__ mask, const int* __restrict__ rand,
                             bf16* __restrict__ out, float* __restrict__ lse,
                             float2* __restrict__ stats, Geo g, int ncb, int q_stays) {
  using namespace wide;
  // column blocks a score item: both of the head's in one launch of both
  // passes (d <= 128, Q staying), one past it
  constexpr int CPI = kMode == kBoth ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kRing;
  uint64_t* rowbar = empty + kRing;  // Q, when it stays
  float* pen = reinterpret_cast<float*>(base + kPenOffset);
  bf16* ring = reinterpret_cast<bf16*>(base + kTilesOffset);
  bf16* qs = ring + kRing * kStageTiles * kTileElems;  // Q's tiles, when it stays
  const int parts = kMode == kPart ? (ncb + kPartBlocks - 1) / kPartBlocks : 1;
  const int cta = int(blockIdx.x) / parts, part = int(blockIdx.x) - cta * parts;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bs = g.bs, T = tiles_of(bs);
  const int n_mid = g.nb - 2, steps = (5 + g.r) * T;  // slot sub-tiles a pass
  const int ni = (ncb + CPI - 1) / CPI;  // score items a sub-tile
  // the middle query block and 64-row tile of consumer w (bigbird_sm90.cuh's
  // block_and_tile): the block may be n_mid and the tile T (nothing to write)
  auto tile_of = [&](int w) -> int2 {
    if constexpr (Q == 2) return make_int2(cta * 2 + w, 0);
    const int per = (T + 1) / 2;
    return make_int2(cta / per, (cta % per) * 2 + w);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 32);  // the feeding warp's lanes, lane 0 with the bytes
      mbar_init(&empty[s], 8);  // the consumers' warps
    }
    mbar_init(rowbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // ---------------- the feeding warp (warp 0) ----------------
  // It loads the ring's items in the order the consumers take them (per
  // pass and sub-tile the score items, then in pass 2 the part's V item),
  // kRing ahead: each item it releases, it refills with the one kRing
  // further once every consumer warp has released it too.
  const bool feeder = threadIdx.x < 32;
  const int lane = threadIdx.x % 32;
  const float* mask_b = mask + size_t(b) * g.S;
  int jq[Q];            // the query block of each key tile of an item
  const int* rq[Q];     // its random blocks
#pragma unroll
  for (int c = 0; c < Q; ++c) {
    jq[c] = min(tile_of(c).x, n_mid - 1);
    rq[c] = rand + (size_t(h) * n_mid + jq[c]) * g.r;
  }
  int qrow[2];  // each consumer's first query row (a row of S), clamped to a real tile
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int2 jt = tile_of(w);
    qrow[w] = (min(jt.x, n_mid - 1) + 1) * bs + min(jt.y, T - 1) * kRows;
  }
  constexpr int kFirstPass = kMode == kPart ? 2 : 1, kLastPass = kMode == kStats ? 1 : 2;
  int f_pass = kFirstPass, f_x = 0, f_i = 0, f_stage = 0;  // the next item
  uint32_t f_phase = 0;
  float f_pen[Q][2];  // the sub-tile's penalties (keys lane, lane + 32), read at its first item
  auto feed = [&]() {
    if (f_pass > kLastPass) return;
    mbar_wait(&empty[f_stage], f_phase ^ 1u);
    const int t = f_x / T, u = f_x - t * T;
    int key0[Q];
#pragma unroll
    for (int c = 0; c < Q; ++c) key0[c] = bigbird::slot_block(rq[c], t, jq[c], g.nb) * bs + u * kRows;
    bf16* dst = ring + f_stage * kStageTiles * kTileElems;
    uint64_t* bar = &full[f_stage];
    if (f_i < ni) {
      if (f_i == 0) {
#pragma unroll
        for (int c = 0; c < Q; ++c) {
          const bool dup = bigbird::dup_slot(t, jq[c], g.nb);
          f_pen[c][0] = bigbird::tile_penalty<true>(mask_b, key0[c], lane, u, bs, dup);
          f_pen[c][1] = bigbird::tile_penalty<true>(mask_b, key0[c], lane + 32, u, bs, dup);
        }
      }
      if (f_i == ni - 1) {
#pragma unroll
        for (int c = 0; c < Q; ++c) {
          pen[(f_stage * 2 + c) * kRows + lane] = f_pen[c][0];
          pen[(f_stage * 2 + c) * kRows + lane + 32] = f_pen[c][1];
        }
      }
      if (lane == 0) {
        const int c0 = f_i * CPI;
        mbar_arrive_tx(bar, uint32_t(CPI * Q + (q_stays ? 0 : 2)) * kTileBytes);
#pragma unroll
        for (int cc = 0; cc < CPI; ++cc)
#pragma unroll
          for (int c = 0; c < Q; ++c)
            tma_load_4d(dst + (cc * Q + c) * kTileElems, &map_k, (c0 + cc) * kCB, h, key0[c], b,
                        bar);
        if (!q_stays)
          for (int w = 0; w < 2; ++w)
            tma_load_4d(dst + (2 + w) * kTileElems, &map_q, c0 * kCB, h, qrow[w], b, bar);
      } else {
        mbar_arrive(bar);
      }
    } else if (lane == 0) {  // the part's V blocks; a block wholly past d is not loaded
      const int c0 = part * kPartBlocks, nv = min(kPartBlocks, ncb - c0);
      mbar_arrive_tx(bar, uint32_t(nv * Q) * kTileBytes);
      for (int vb = 0; vb < nv; ++vb)
#pragma unroll
        for (int c = 0; c < Q; ++c)
          tma_load_4d(dst + (vb * Q + c) * kTileElems, &map_v, (c0 + vb) * kCB, h, key0[c], b,
                      bar);
    } else {
      mbar_arrive(bar);
    }
    if (++f_i == ni + (f_pass == 2 ? 1 : 0)) {
      f_i = 0;
      if (++f_x == steps) {
        f_x = 0;
        ++f_pass;
      }
    }
    advance(f_stage, f_phase);
    __syncwarp();  // reconverged before the warpgroup's next wgmma
  };
  if (feeder) {
    if (lane == 0 && q_stays) {
      mbar_arrive_tx(rowbar, uint32_t(2 * ncb) * kTileBytes);
      for (int c = 0; c < ncb; ++c)
        for (int w = 0; w < 2; ++w)
          tma_load_4d(qs + (c * 2 + w) * kTileElems, &map_q, c * kCB, h, qrow[w], b, rowbar);
    }
    for (int i = 0; i < kRing; ++i) feed();
  }
  // a consumer warp's release of a ring stage, refilled by the feeding warp
  auto release = [&](int stage) {
    release_stage(&empty[stage], lane);
    if (feeder) feed();
  };

  // ---------------- consumers: 64 query rows each ----------------
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int qb = Q == 2 ? wg : 0;          // this consumer's key tile of an item
  const int2 jt = tile_of(wg);
  const int j = jt.x;                      // the middle query block (may be n_mid)
  const int lrow = warp * 16 + lane / 4;   // the thread's rows of the tile: lrow, lrow + 8
  const int brow = jt.y * kRows + lrow;    // ... and of the block
  const bool ok[2] = {j < n_mid && brow < bs, j < n_mid && brow + 8 < bs};  // rows to write
  const uint32_t ring_s = smem_u32(ring), qs_s = smem_u32(qs);
  const size_t n_rows = size_t(n_mid) * bs;            // middle rows of a (b, h)
  const size_t row0 = size_t(j) * bs + brow;           // the thread's first row among them
  const size_t srow = (size_t(b) * g.H + h) * n_rows;  // (b, h, 0) of lse and stats
  float acc[32];  // the 64 x 64 score tile
  int stage = 0;
  uint32_t phase = 0;
  if (q_stays) mbar_wait(rowbar, 0);

  // the logits of the next slot sub-tile (ni ring items) into acc; each
  // item's stage is released once the products after it have been issued
  // and its own have completed
  auto scores = [&]() {
    int prev = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int it = 0; it < ni; ++it) {
      mbar_wait(&full[stage], phase);
      const uint32_t st = ring_s + stage * kStageTiles * kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < CPI; ++cc) {
        const uint64_t dk = attn90::wide::desc_at(st + (cc * Q + qb) * kTileBytes);
        const uint64_t dq = attn90::wide::desc_at(
            q_stays ? qs_s + ((it * CPI + cc) * 2 + wg) * kTileBytes : st + (2 + wg) * kTileBytes);
#pragma unroll
        for (int kk = 0; kk < kCB / 16; ++kk) wgmma_qk64(acc, dq + 2 * kk, dk + 2 * kk, 1);
      }
      wgmma_commit();
      if (it > 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = stage;
      advance(stage, phase);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    logits<64, true>(acc, pen + (prev * 2 + qb) * kRows, lane, g.logit);
    release(prev);
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr (kMode != kPart) {
    // pass 1: each row's max m and sum l of exp(s - m), l kept per thread
    // and summed across the quad at the end (bigbird_fwd_sm90_kernel's)
    for (int x = 0; x < steps; ++x) {
      scores();
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
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (ok[r] && (lane & 3) == 0) {
        lse[srow + row0 + 8 * r] = m[r] + logf(l[r]);
        if constexpr (kMode == kStats) stats[srow + row0 + 8 * r] = make_float2(m[r], 1.f / l[r]);
      }
    }
  }
  if constexpr (kMode != kStats) {
    float inv_l[2], ml[2];  // 1/l and m log2 e of the thread's rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (kMode == kBoth) {
        inv_l[r] = 1.f / l[r];
        ml[r] = m[r] * kLog2e;
      } else {  // rows not written take p = 0
        const float2 st = ok[r] ? stats[srow + row0 + 8 * r] : make_float2(0.f, 0.f);
        ml[r] = st.x * kLog2e;
        inv_l[r] = st.y;
      }
    }
    // pass 2: O (the part's columns) = P V, P = round(exp(s - m) / l)
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    for (int x = 0; x < steps; ++x) {
      scores();
      uint32_t pa[16];  // the A fragments of k-step kk are pa[4kk .. 4kk+3]
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = 2 * u, r = acc_row(i);
        pa[u] = pack_bf16(ex2(fmaf(acc[i], kLog2e, -ml[r])) * inv_l[r],
                          ex2(fmaf(acc[i + 1], kLog2e, -ml[r])) * inv_l[r]);
      }
      mbar_wait(&full[stage], phase);
      const uint32_t st = ring_s + stage * kStageTiles * kTileBytes;
      const uint64_t dv0 = attn90::wide::desc_at(st + qb * kTileBytes);
      const uint64_t dv1 = attn90::wide::desc_at(st + (Q + qb) * kTileBytes);
      fence_regs(o);
      wgmma_fence();  // orders the writes of pa and o before the products read them
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {  // 16 keys = 16 lines = 128 units
        wgmma_pv_at<0>(o, pa + 4 * kk, dv0 + kk * 128);
        wgmma_pv_at<32>(o, pa + 4 * kk, dv1 + kk * 128);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(stage);
      advance(stage, phase);
    }
    // epilogue: the part's columns < d of the rows in the block
    if (ok[0] || ok[1]) {
      const int c0 = part * kPartCols;
      bf16* dst = out + ((size_t(b) * n_rows + row0) * g.H + h) * g.d + c0;
      store_acc<true>(dst, dst + size_t(8) * g.H * g.d, ok[0], ok[1], o, lane, g.d - c0);
    }
  }
}

// --- host side --------------------------------------------------------------

// the calls of launch_fwd_wide_sm90 that launched its kernels (exported
// as bigbird_mid_fwd_wide_calls: the route a check reads without a
// profiler)
inline int& fwd_wide_calls() {
  static int calls = 0;
  return calls;
}

template <int Q, int kMode>
int launch_fwd_wide_pass(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                         dim3 grid, size_t smem, const float* mask, const int* rand, void* out,
                         float* lse, float2* stats, const Geo& g, int ncb, bool q_stays,
                         cudaStream_t stream) {
  auto kernel = bigbird_fwd_wide_sm90_kernel<Q, kMode>;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<grid, wide::kBlockThreads, smem, stream>>>(mq, mk, mv, mask, rand,
                                                      static_cast<bf16*>(out), lse, stats, g, ncb,
                                                      q_stays ? 1 : 0);
  return int(cudaGetLastError());
}

// the statistics launch into `stats` (required past two column blocks),
// then the part blocks; up to two column blocks, one launch of both passes
template <int Q>
int launch_fwd_wide_q(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                      const float* mask, const int* rand, void* out, float* lse, float* stats,
                      int B, const Geo& g, cudaStream_t stream) {
  using namespace wide;
  const int ncb = (g.d + kCB - 1) / kCB, parts = (ncb + kPartBlocks - 1) / kPartBlocks;
  const bool q_stays = smem_bytes(ncb, true) <= attn90::kMaxSmem;
  const size_t smem = smem_bytes(ncb, q_stays);
  const dim3 grid = grid_of(B, g, Q);
  if (ncb <= kPartBlocks)
    return launch_fwd_wide_pass<Q, kBoth>(mq, mk, mv, grid, smem, mask, rand, out, lse, nullptr,
                                          g, ncb, q_stays, stream);
  if (!stats) return int(cudaErrorInvalidValue);
  float2* st = reinterpret_cast<float2*>(stats);
  const int e = launch_fwd_wide_pass<Q, kStats>(mq, mk, mv, grid, smem, mask, rand, out, lse, st,
                                                g, ncb, q_stays, stream);
  if (e != 0) return e;
  return launch_fwd_wide_pass<Q, kPart>(mq, mk, mv, dim3(grid.x * parts, grid.y, grid.z), smem,
                                        mask, rand, out, lse, st, g, ncb, q_stays, stream);
}

// The bf16 forward at d > 64 (a multiple of 8): `stats` a (B, H, (nb-2) bs)
// x 2 fp32 scratch, required past d = 128
inline int launch_fwd_wide_sm90(const void* q, const void* k, const void* v, const float* mask,
                                const int* rand, void* out, float* lse, float* stats, int B,
                                const Geo& g, cudaStream_t stream) {
  if (g.d <= 64 || g.d % 8 != 0) return int(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;  // boxes of 64 rows x 64 columns
  if (!make_map_bshd<bf16>(&mq, q, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, wide::kCB) ||
      !make_map_bshd<bf16>(&mk, k, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, wide::kCB) ||
      !make_map_bshd<bf16>(&mv, v, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, wide::kCB))
    return kErrTensorMap;
  const int e = tiles_of(g.bs) > 1
                    ? launch_fwd_wide_q<1>(mq, mk, mv, mask, rand, out, lse, stats, B, g, stream)
                    : launch_fwd_wide_q<2>(mq, mk, mv, mask, rand, out, lse, stats, B, g, stream);
  if (e == 0) ++fwd_wide_calls();
  return e;
}

}  // namespace bigbird90
}  // namespace stonkgs
