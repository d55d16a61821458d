// The bf16 BigBird middle query blocks for Hopper (sm_90a), launched by
// bigbird_sparse.cu for dtype 1: the forward (ctx and the fp32 lse) and
// the backward (dq, and dK, dV added into fp32 accumulators).  The slot
// map, the penalties and the geometry are shared with the fp32 bodies of
// bigbird_sparse.cu.
//
// Middle query block j (query rows of block i = j + 1) attends its 5 + r
// key slots [g0 | window i-1, i, i+1 | g_last | random r]; slot key c of
// block blk takes the penalty (1 - mask[b, bs blk + c]) * -10000, and the
// duplicate window slot at j = 0 (block 0 = g0) and j = nb - 3 (block nb - 1
// = g_last) takes -10000 outright.  Repeated blocks (the all-zero eval
// plan) are separate keys.  Logits as _mid_logits
// (stonkgs_tpu/ops/bigbird_sparse_pallas.py:70): s = round(round(Q K^T) *
// scale) + penalty, Q K^T in fp32, the roundings to bf16, scale = 1/sqrt(d)
// of the tensors' head width d, in bf16 (as JAX multiplies a bf16 array by
// a Python float).
//
// Geometry: head width d any multiple of 8 from 8 to 64 (wider heads run
// bigbird_wide_sm90.cuh's forward and bigbird_bwd_wide_sm90.cuh's
// backward in column blocks), run on the instance of
// the padded width D = 16, 32 or 64, the smallest at least d (a template
// parameter: a row of D bf16 is a line of 2D bytes, and TMA and the wgmma
// descriptors take the swizzle of that width), and any block size bs >= 1
// (TMA takes any row coordinate bs * blk; a box reaching past S is
// zero-filled on loads and clipped on reduce-adds).  At d = D (16, 32, 64 with
// the scale 1/sqrt(D)) the exact instances fix the scale by D at compile
// time (kLogitScale): at D = 16 and 64 it is a power of two, so the second
// rounding is exact and the kernels make only the first; at D = 32 they
// make both.  Every other call runs a padded instance (kPadded): the
// tensor maps take d as their dimension and a box D wide, so TMA
// zero-fills the columns from d to D (they add nothing to a product), the
// stores skip them, and the logit takes the call's scale (Geo::logit,
// 1/sqrt(d) in bf16, the true d's and not D's) rounded twice (a scale
// that is no power of two, which every d other than 16 and 64 has).  The
// padded instances take the block size at run time only.  A block is
// T = ceil(bs / 64) row tiles of 64, the wgmma M.  Blocks of 64 and 128 (the trunk's) have instances of their own
// (the template's BS) with bs and T fixed at compile time and no partial
// tile; other sizes take bs at run time (BS = 0), which ran the block-64
// forward 21-23% slower when it served every size (PERF.md).  When bs is not
// a multiple of 64 the last tile of a query block and the last key sub-tile
// of a slot are partial:
//   * keys past bs in a slot's last sub-tile (another block's keys, or
//     TMA's zero fill past S) take the penalty -inf, so their weight is 0
//     exactly (a padded key of the mask keeps -10000 and its weight);
//   * query rows past bs in the forward (the next block's rows, loaded by
//     the 64-row box) are computed and not stored; no TMA store is used,
//     so no store races with the CTA that owns those rows;
//   * query rows past bs in the backward get P = dS = 0 before the dK and
//     dV products, so they add nothing into other blocks' keys.
// A partial tile wastes 64 / bs of its products (8x at bs = 8, 16x at bs =
// 4); below 64 a tile holds rows of the next blocks too, computed and not
// stored.
//
// Both kernels have the dense attention's shape (attention_sm90.cuh): 384
// threads, a producer warpgroup (setmaxnreg.dec) whose first warp streams
// 64-key sub-tiles through a ring of full/empty mbarriers with TMA (one
// 4-D map per tensor over (B, S, H, D), built from the strides it is
// given, box D x 64) and writes each sub-tile's 64 penalties beside it,
// and two consumer warpgroups (setmaxnreg.inc) that own 64 query rows
// each.  Two ways of filling a CTA (Q, its query blocks):
//   T = 1 (bs <= 64), Q = 2: a CTA takes the query blocks 2x and 2x + 1
//             of one (b, h), one consumer each, and a ring stage holds the
//             slot's sub-tile of both (g0, g_last and the window tiles of
//             neighbouring query blocks are read from L2: the grid's x
//             runs fastest).  With nb - 2 odd the last CTA's second
//             consumer repeats the last query block and writes nothing.
//   T >= 2 (bs > 64), Q = 1: a CTA takes the row tiles 2p and 2p + 1 of
//             one query block (ceil(T / 2) CTAs a block; with T odd the
//             last one's second consumer has no tile and writes nothing),
//             and a slot is T ring steps of one 64-key sub-tile that both
//             consumers read (sub-tile u: keys bs blk + 64 u ..).  The
//             ring has twice the stages of one tile, so the bytes in
//             flight and the shared memory are those of Q = 2.  The row
//             statistics run over all (5 + r) T sub-tiles; in the backward
//             each consumer adds its own 64 x D dK and dV of the shared
//             sub-tile, so several adds land on each key row of a slot,
//             in no fixed order.
//             Widening a step to a 128-key tile would not fit: dS and P
//             of 64 x 128 push the backward's shared memory past 227 KB.
// Measured on the H100 (PERF.md, the BigBird redesign, bs = 64, D = 64):
// three consumers a block ran no faster than two, two blocks an SM leave
// ptxas 80 registers a thread (it spills), and reading the penalties a
// stage ahead in the producer ran 9% slower than reading them after the
// stage frees.
//
// Forward (bigbird_fwd_sm90_kernel), two passes over the slots' sub-tiles,
// because the TPU kernel normalises before it rounds:
//   pass 1: S = Q K^T of each sub-tile (wgmma.m64n64k16, D/16 k-steps,
//           both operands K-major from shared memory); the logits in
//           registers; each row's running max m and sum l of exp(s - m);
//   pass 2: S recomputed; p = exp(s - m) * (1/l), rounded; O += P V
//           (wgmma.m64nDk16) with P from registers (the packed
//           accumulator is the A fragment) and the V tile MN-major.
// So the design's floor is three products of 2 * 64 * 64 * D flops a
// sub-tile and 64 query rows, and two exps a score: at B=8, S=4096, H=12,
// bs=64, D=64, 195 M scores need 0.093 ms of the SFU (16 ex2 a clock an SM
// at 1.98 GHz) against 0.076 ms of products at 989 TFLOP/s and 0.060 ms of
// bytes (at bs=128: 0.180 ms against 0.146 and 0.059).  The roundings to
// bf16 run on the same quarter-rate unit as the exps (the single rounding
// made the forward 10% faster at D = 64).
//
// Backward (bigbird_bwd_sm90_kernel), query-major as the TPU kernel: a
// consumer keeps its tile's Q and dO (and, for delta = rowsum(dO * O), O)
// in shared memory and dQ in registers; per slot sub-tile
//   S = Q K^T, dP = dO V^T                         (wgmma from shared memory)
//   p = exp(s - lse), dS = p (dP - delta) * scale  (fp32, registers)
//   round(p), and dS as hi = round(dS) and lo = round(dS - hi) (16 of its
//   24 significant bits), written to shared memory (64 keys a line);
//   dQ += dS K (hi and lo), dK = dS^T Q (hi and lo), dV = round(p)^T dO:
//   wgmma.m64nDk16 from shared memory, dS^T and P^T as M-major A
//   operands, K, Q and dO as MN-major B operands;
// then the sub-tile's fp32 dK and dV go to shared memory (boxes of 32
// columns with the 128-byte swizzle; at D = 16 one box of 16, unswizzled)
// and one thread adds them into the fp32 (B, S, H, D) accumulators with
// TMA reduce-adds (cp.reduce.async.bulk.tensor.add), where the old design
// made 65,536 scalar atomics a query block (red.global.add.v4.f32 from
// registers, without the staging, measured 27% slower).  Keys past the
// accumulators' S are not written by TMA; keys past bs add zeros.  Blocks
// run in no order, so the adds into a key row land in an order that
// changes from run to run.  Seven products a sub-tile (dS's two halves
// count twice in dQ and dK) and one exp a score: at B=2, bs=64, D=64 0.044
// ms of products against 0.012 ms of the SFU.
//
// Numerics against the plain versions (ops/bigbird_sparse.py): products
// summed in another order; exp(s - x) as ex2.approx of s log2 e - x log2 e
// (a few ulps from an IEEE exp), times a per-row reciprocal of l in the
// forward; so a rounded probability, or dS, moves by at most one bf16 step
// where it sits at a rounding boundary: inside chip_smoke.py's ATTN_STEP
// and GRAD_TOL limits.  s, m and lse stay in the natural domain.

#pragma once

#include <cmath>
#include <cstdint>

#include "attention.cuh"  // attn::with_padded_head_dim
#include "sm90.cuh"

namespace stonkgs {
namespace bigbird {

constexpr int kRows = 64;             // query and key rows of a tile; a block is T of them
constexpr float kPenalty = -10000.f;  // BigBird's mask penalty

struct Geo {
  int S, H, nb, r;
  int bs;                // block size: any, with at least 5 blocks
  long long sb, ss, sh;  // element strides of q, k, v
  float scale;           // 1/sqrt(d) in fp32: dS's scale, and the fp32 bodies' logit scale
  int d;                 // the tensors' head width (at most the instance's)
  float logit;           // the scale rounded to bf16: the bf16 padded instances' logit scale
};

// 64-row tiles of a block of bs rows
__host__ __device__ __forceinline__ int tiles_of(int bs) { return (bs + kRows - 1) / kRows; }

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

// the penalty of key c (< 64) of sub-tile u of a slot, key0 the sub-tile's
// first key (a row of S), mask_b the batch row's (S) mask; -inf past the
// block (weight exactly 0; kPartial false: a block of whole tiles has none),
// -10000 for every key of the duplicate window slot
template <bool kPartial = true>
__device__ __forceinline__ float tile_penalty(const float* mask_b, int key0, int c, int u,
                                              int bs, bool dup) {
  if (kPartial && u * kRows + c >= bs) return -INFINITY;
  return dup ? kPenalty : (1.f - __ldg(mask_b + key0 + c)) * kPenalty;
}

}  // namespace bigbird

namespace bigbird90 {

using namespace sm90;
using bigbird::Geo;
using bigbird::kRows;
using bigbird::tiles_of;
using attn::with_padded_head_dim;

// consumer warpgroups (64 query rows each) and ring stages of the forward
// and of the backward at Q = 2 (a stage holds one sub-tile a query block of
// the CTA; at Q = 1, with one query block, twice the stages)
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
constexpr uint32_t kPTile = kRows * kRows;   // elements of a 64 x 64 P or dS tile
constexpr uint32_t kPStep = 16 * 128 / 16;   // 16 of its 128-byte lines, in descriptor units
constexpr float kLog2e = 1.4426950408889634f;

// the logit scale, 1/sqrt(D) rounded to bf16 (the C entry points refuse
// any other): a power of two at D = 16 and 64, 0.1767578125 at D = 32
template <int D>
constexpr float kLogitScale = D == 16 ? 0.25f : D == 32 ? 0.1767578125f : 0.125f;

// the block size and its row tiles: fixed by BS (64 or 128), or the call's
// at BS = 0
template <int BS>
__device__ __forceinline__ int block_rows(const Geo& g) { return BS ? BS : g.bs; }
template <int BS>
__device__ __forceinline__ int block_tiles(const Geo& g) { return BS ? BS / kRows : tiles_of(g.bs); }

// a 64 x D bf16 tile: elements, bytes, and its line (2D bytes: the swizzle's
// width, and the descriptor units an MN-major operand advances a k16 step)
template <int D> struct Tile {
  static constexpr int kElems = kRows * D;
  static constexpr uint32_t kBytes = kElems * 2;
  static constexpr int kLine = 2 * D;
};

// D consumers' head width, C consumers, Q query blocks a CTA, S ring stages
template <int D, int C, int Q, int S>
struct alignas(1024) SmemFwd {
  bf16 q[C][Tile<D>::kElems];
  bf16 k[S][Q][Tile<D>::kElems];
  bf16 v[S][Q][Tile<D>::kElems];
  float pen[S][Q][kRows];
  uint64_t full[S];
  uint64_t empty[S];
  uint64_t rowbar;  // the blocks' own tiles
};

// columns of one fp32 staging box of dK or dV: 32 (128-byte lines, the
// 128-byte swizzle), or 16 at D = 16 (64-byte lines, unswizzled)
template <int D> constexpr int kBoxCols = D < 32 ? D : 32;

template <int D, int C, int Q, int S>
struct alignas(1024) SmemBwd {
  bf16 q[C][Tile<D>::kElems];
  bf16 dout[C][Tile<D>::kElems];
  bf16 p[C][kPTile];    // O (for delta), then each sub-tile's round(p)
  bf16 dsh[C][kPTile];  // dS, hi
  bf16 dsl[C][kPTile];  // dS, lo
  float dk[C][kRows * D];  // a sub-tile's fp32 dK: D / kBoxCols boxes of 64 x kBoxCols
  float dv[C][kRows * D];
  bf16 k[S][Q][Tile<D>::kElems];
  bf16 v[S][Q][Tile<D>::kElems];
  float pen[S][Q][kRows];
  float delta[C][kRows];
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

// The middle query block and the 64-row tile of consumer w of this CTA:
// Q = 2, blocks 2x and 2x + 1 (tile 0); Q = 1, tiles 2p and 2p + 1 of
// block x / ceil(T / 2).  The block may be n_mid and the tile T (nothing
// to write).
template <int Q>
__device__ __forceinline__ int2 block_and_tile(int w, int T) {
  if constexpr (Q == 2) return make_int2(int(blockIdx.x) * 2 + w, 0);
  const int per = (T + 1) / 2;
  return make_int2(int(blockIdx.x) / per, (int(blockIdx.x) % per) * 2 + w);
}

// pointers into one ring stage
template <int D>
struct Stage {
  bf16 (*k)[Tile<D>::kElems];
  bf16 (*v)[Tile<D>::kElems];
  float (*pen)[kRows];
  uint64_t* full;
};

// the producer warp fills a free ring stage with sub-tile u of slot t of
// the CTA's Q query blocks jc[c] (their random blocks at rand_c[c], blocks
// of bs keys): lane 0
// issues the K (and V) tiles' TMA loads first, then every lane writes its
// two penalties of each tile (keys lane and lane + 32) and arrives
// (reading the penalties a stage ahead instead measured 9% slower in the
// forward)
template <int D, int Q, int BS>
__device__ __forceinline__ void fill_stage(const Stage<D>& st, const CUtensorMap* map_k,
                                           const CUtensorMap* map_v, const int* jc,
                                           const int* const* rand_c, const float* mask_b, int t,
                                           int u, int h, int b, int nb, int bs, bool with_v,
                                           int lane) {
  int key0[Q];
  float pen[Q][2];
#pragma unroll
  for (int c = 0; c < Q; ++c) {
    key0[c] = bigbird::slot_block(rand_c[c], t, jc[c], nb) * bs + u * kRows;
    const bool dup = bigbird::dup_slot(t, jc[c], nb);
    pen[c][0] = bigbird::tile_penalty<BS == 0>(mask_b, key0[c], lane, u, bs, dup);
    pen[c][1] = bigbird::tile_penalty<BS == 0>(mask_b, key0[c], lane + 32, u, bs, dup);
  }
  if (lane == 0) {
    mbar_expect_tx(st.full, (with_v ? 2 : 1) * Q * Tile<D>::kBytes);
#pragma unroll
    for (int c = 0; c < Q; ++c) {
      tma_load_4d(st.k[c], map_k, 0, h, key0[c], b, st.full);
      if (with_v) tma_load_4d(st.v[c], map_v, 0, h, key0[c], b, st.full);
    }
  }
#pragma unroll
  for (int c = 0; c < Q; ++c) {
    st.pen[c][lane] = pen[c][0];
    st.pen[c][lane + 32] = pen[c][1];
  }
  mbar_arrive(st.full);
}

// round(round(a) * scale) and round(round(b) * scale), the roundings to
// bf16; an exact instance takes the scale of D, and where it is a power of
// two (D = 16, 64) round(a) * scale is a bf16 value already and the second
// rounding is left out; a padded instance takes the call's scale (`logit`)
// and rounds twice
template <int D, bool kPadded>
__device__ __forceinline__ float2 rounded_logits(float a, float b, float logit) {
  const float scale = kPadded ? logit : kLogitScale<D>;
  float2 r = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  r.x *= scale;
  r.y *= scale;
  if constexpr (kPadded || D == 32) r = __bfloat1622float2(__floats2bfloat162_rn(r.x, r.y));
  return r;
}

// the masked logits of a 64 x 64 Q K^T accumulator, in place
template <int D, bool kPadded>
__device__ __forceinline__ void logits(float (&s)[32], const float* pen, int lane, float logit) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const float2 pv = *reinterpret_cast<const float2*>(pen + acc_col(i, lane));
    const float2 x = rounded_logits<D, kPadded>(s[i], s[i + 1], logit);
    s[i] = x.x + pv.x;
    s[i + 1] = x.y + pv.y;
  }
}

// S (+)= A B^T over D (D/16 k-steps of 32 bytes), both tiles K-major in
// shared memory
template <int D>
__device__ __forceinline__ void product_abt(float (&s)[32], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_qk64(s, da + 2 * kk, db + 2 * kk, kk);
}

// a warpgroup's 64 x 2R fp32 accumulator, rounded, into rows `row` and
// row + 8 (the thread's) of a bf16 (.., 2R) array whose row `row` is dst0
// and row + 8 is dst8, each only where its flag is set; kPadded: only the
// columns below `cols` (an even number)
template <bool kPadded, int R>
__device__ __forceinline__ void store_acc(bf16* dst0, bf16* dst8, bool ok0, bool ok8,
                                          const float (&d)[R], int lane, int cols) {
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    if (!(acc_row(i) ? ok8 : ok0)) continue;
    if (kPadded && acc_col(i, lane) >= cols) continue;
    bf16* dst = acc_row(i) ? dst8 : dst0;
    *reinterpret_cast<uint32_t*>(dst + acc_col(i, lane)) = pack_bf16(d[i], d[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// head width D (padded past the tensors' g.d when kPadded), Q query blocks
// a CTA, S ring stages, block size BS (0: at run time)
template <int D, int Q, int S, int BS, bool kPadded>
__global__ void __launch_bounds__(threads_of(kFwdConsumers), 1)
bigbird_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const float* __restrict__ mask, const int* __restrict__ rand,
                        bf16* __restrict__ out, float* __restrict__ lse, Geo g) {
  static_assert(BS == 0 || (BS % kRows == 0 && (Q == 2) == (BS == kRows)),
                "a fixed block is whole tiles: one a query block at Q = 2");
  constexpr int C = kFwdConsumers;
  constexpr int kLine = Tile<D>::kLine;
  using Sm = SmemFwd<D, C, Q, S>;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int bs = block_rows<BS>(g), T = block_tiles<BS>(g);
  const int n_mid = g.nb - 2, steps = (5 + g.r) * T;  // ring steps a pass
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init_ring<C, S>(sm);

  if (wg == C) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kFwdProducerRegs));
    if (warp == 0) {
      int jc[Q];
      const int* rand_c[Q];
#pragma unroll
      for (int c = 0; c < Q; ++c) {
        jc[c] = min(block_and_tile<Q>(c, T).x, n_mid - 1);
        rand_c[c] = rand + (size_t(h) * n_mid + jc[c]) * g.r;
      }
      if (lane == 0) {
        mbar_arrive_tx(&sm.rowbar, C * Tile<D>::kBytes);
#pragma unroll
        for (int w = 0; w < C; ++w) {
          const int2 jt = block_and_tile<Q>(w, T);
          const int j = min(jt.x, n_mid - 1), u = min(jt.y, T - 1);
          tma_load_4d(sm.q[w], &map_q, 0, h, (j + 1) * bs + u * kRows, b, &sm.rowbar);
        }
      }
      const float* mask_b = mask + size_t(b) * g.S;
      for (int it = 0; it < 2 * steps; ++it) {
        const int stage = it % S, step = it % steps;
        mbar_wait(&sm.empty[stage], ((it / S) & 1) ^ 1);
        const Stage<D> st{sm.k[stage], sm.v[stage], sm.pen[stage], &sm.full[stage]};
        fill_stage<D, Q, BS>(st, &map_k, &map_v, jc, rand_c, mask_b, step / T, step % T, h, b,
                             g.nb, bs, it >= steps, lane);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs(C, kFwdProducerRegs)));
    const int qb = Q == 2 ? wg : 0;           // the ring's tile of this consumer's block
    const int2 jt = block_and_tile<Q>(wg, T);
    const int j = jt.x;                       // the middle query block (may be n_mid)
    const int lrow = warp * 16 + lane / 4;    // the thread's rows of the tile: lrow, lrow + 8
    const int brow = jt.y * kRows + lrow;     // ... and of the block
    // the rows to write: in the grid's blocks and (a partial tile) in the block
    const bool ok[2] = {j < n_mid && (BS != 0 || brow < bs),
                        j < n_mid && (BS != 0 || brow + 8 < bs)};
    const uint64_t dq = desc_sw<kLine>(sm.q[wg]);
    float acc[32];

    // the logits of the sub-tile of ring stage `stage`
    auto scores = [&](int stage) {
      fence_regs(acc);
      wgmma_fence();
      product_abt<D>(acc, dq, desc_sw<kLine>(sm.k[stage][qb]));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      logits<D, kPadded>(acc, sm.pen[stage][qb], lane, g.logit);
    };
    mbar_wait(&sm.rowbar, 0);

    // pass 1: each row's max m and sum l of exp(s - m); l is kept per
    // thread (over its 16 columns, scaled by the row's shared m) and
    // summed across the quad at the end
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int t = 0; t < steps; ++t) {
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
    const size_t n_rows = size_t(n_mid) * bs;  // middle rows of a (b, h)
    const size_t row0 = size_t(j) * bs + brow;  // the thread's first row among them
    float inv_l[2], ml[2];  // 1/l and m log2 e of the thread's rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (ok[r] && (lane & 3) == 0)
        lse[(size_t(b) * g.H + h) * n_rows + row0 + 8 * r] = m[r] + logf(l[r]);
      inv_l[r] = 1.f / l[r];
      ml[r] = m[r] * kLog2e;
    }

    // pass 2: O = P V, P = round(exp(s - m) / l)
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int t = 0; t < steps; ++t) {
      const int it = steps + t, stage = it % S;
      mbar_wait(&sm.full[stage], (it / S) & 1);
      scores(stage);
      uint32_t pa[16];  // the A fragments of k-step kk are pa[4kk .. 4kk+3]
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = 2 * u, r = acc_row(i);
        pa[u] = pack_bf16(ex2(fmaf(acc[i], kLog2e, -ml[r])) * inv_l[r],
                          ex2(fmaf(acc[i + 1], kLog2e, -ml[r])) * inv_l[r]);
      }
      const uint64_t dv = desc_sw<kLine>(sm.v[stage][qb]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) wgmma_pv(o, pa + 4 * kk, dv + kk * kLine);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release_stage(&sm.empty[stage], lane);
    }
    if (ok[0] || ok[1]) {
      const int d = kPadded ? g.d : D;  // out's head width
      bf16* dst = out + ((size_t(b) * n_rows + row0) * g.H + h) * d;
      store_acc<kPadded>(dst, dst + size_t(8) * g.H * d, ok[0], ok[1], o, lane, d);
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// a 64 x D fp32 accumulator into the staging boxes of kBoxCols columns:
// 128-byte lines with the 128-byte swizzle, the layout of a TMA box of the
// fp32 accumulator's map; at D = 16 one unswizzled box of 64-byte lines
template <int D>
__device__ __forceinline__ void stage_f32(float* boxes, const float (&d)[D / 2], int lrow,
                                          int lane) {
  constexpr int BC = kBoxCols<D>;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = lrow + 8 * acc_row(i), col = acc_col(i, lane);
    unsigned char* box = reinterpret_cast<unsigned char*>(boxes + (col / BC) * kRows * BC);
    const uint32_t off = BC == 32 ? sw128_byte(row, (col % BC) * 4) : uint32_t(row * BC + col) * 4;
    *reinterpret_cast<float2*>(box + off) = make_float2(d[i], d[i + 1]);
  }
}

__device__ __forceinline__ void st_shared_u32(bf16* tile, uint32_t byte_off, uint32_t v) {
  *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(tile) + byte_off) = v;
}

// head width D (padded past the tensors' g.d when kPadded), Q query blocks
// a CTA, S ring stages, block size BS (0: at run time)
template <int D, int Q, int S, int BS, bool kPadded>
__global__ void __launch_bounds__(threads_of(kBwdConsumers), 1)
bigbird_bwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_dk,
                        const __grid_constant__ CUtensorMap map_dv,
                        const float* __restrict__ mask, const int* __restrict__ rand,
                        const float* __restrict__ lse, bf16* __restrict__ dq, Geo g) {
  static_assert(BS == 0 || (BS % kRows == 0 && (Q == 2) == (BS == kRows)),
                "a fixed block is whole tiles: one a query block at Q = 2");
  constexpr int C = kBwdConsumers;
  constexpr int kLine = Tile<D>::kLine;
  constexpr int BC = kBoxCols<D>;
  using Sm = SmemBwd<D, C, Q, S>;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = aligned_smem<Sm>(smem_raw);
  const int h = blockIdx.y, b = blockIdx.z;
  const int bs = block_rows<BS>(g), T = block_tiles<BS>(g);
  const int n_mid = g.nb - 2, steps = (5 + g.r) * T;  // ring steps
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init_ring<C, S>(sm);

  if (wg == C) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdProducerRegs));
    if (warp == 0) {
      int jc[Q];
      const int* rand_c[Q];
#pragma unroll
      for (int c = 0; c < Q; ++c) {
        jc[c] = min(block_and_tile<Q>(c, T).x, n_mid - 1);
        rand_c[c] = rand + (size_t(h) * n_mid + jc[c]) * g.r;
      }
      if (lane == 0) {
        mbar_arrive_tx(&sm.rowbar, 3 * C * Tile<D>::kBytes);
#pragma unroll
        for (int w = 0; w < C; ++w) {
          const int2 jt = block_and_tile<Q>(w, T);
          const int j = min(jt.x, n_mid - 1), u = min(jt.y, T - 1);
          const int mrow = j * bs + u * kRows;  // among the middle rows
          tma_load_4d(sm.q[w], &map_q, 0, h, bs + mrow, b, &sm.rowbar);
          tma_load_4d(sm.dout[w], &map_do, 0, h, mrow, b, &sm.rowbar);
          tma_load_4d(sm.p[w], &map_o, 0, h, mrow, b, &sm.rowbar);
        }
      }
      const float* mask_b = mask + size_t(b) * g.S;
      for (int it = 0; it < steps; ++it) {
        const int stage = it % S;
        mbar_wait(&sm.empty[stage], ((it / S) & 1) ^ 1);
        const Stage<D> st{sm.k[stage], sm.v[stage], sm.pen[stage], &sm.full[stage]};
        fill_stage<D, Q, BS>(st, &map_k, &map_v, jc, rand_c, mask_b, it / T, it % T, h, b, g.nb,
                             bs, true, lane);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs(C, kBwdProducerRegs)));
    const int qb = Q == 2 ? wg : 0;      // the ring's tile of this consumer's block
    const int2 jt = block_and_tile<Q>(wg, T);
    const bool valid = jt.x < n_mid && jt.y < T;  // the consumer has rows to write
    const int jc = min(jt.x, n_mid - 1);
    const int tid = threadIdx.x % 128;
    const int lrow = warp * 16 + lane / 4;  // the thread's rows of the tile: lrow, lrow + 8
    const int brow = jt.y * kRows + lrow;   // ... and of the block
    const bool ok[2] = {valid && (BS != 0 || brow < bs), valid && (BS != 0 || brow + 8 < bs)};
    // rows whose P and dS count: every row at a fixed block size (a
    // consumer with no rows adds nothing), the block's own at run time
    const bool live[2] = {BS != 0 || ok[0], BS != 0 || ok[1]};
    const int bar = 1 + wg;                 // the warpgroup's named barrier
    const int* rand_j = rand + (size_t(h) * n_mid + jc) * g.r;
    mbar_wait(&sm.rowbar, 0);

    // delta = rowsum(dO * O), two threads a row of D/2 columns each.  dO
    // and O share the swizzle of a 2D-byte line, which permutes 16-byte
    // chunks within a line: a line's bytes in any order make its sum.
    {
      const int row = tid >> 1, half = tid & 1;
      const unsigned char* dob = reinterpret_cast<const unsigned char*>(sm.dout[wg]);
      const unsigned char* ob = reinterpret_cast<const unsigned char*>(sm.p[wg]);
      float s = 0.f;
#pragma unroll
      for (int cc = 0; cc < D / 16; ++cc) {
        const uint32_t off = uint32_t(row) * kLine + half * D + cc * 16;
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
    const size_t n_rows = size_t(n_mid) * bs;
    const size_t row0 = size_t(jc) * bs + brow;  // the thread's first row among the middle rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_l[r] = ok[r] ? kLog2e * lse[(size_t(b) * g.H + h) * n_rows + row0 + 8 * r] : 0.f;
      delta_r[r] = sm.delta[wg][lrow + 8 * r];
    }
    const uint64_t dqd = desc_sw<kLine>(sm.q[wg]), dod = desc_sw<kLine>(sm.dout[wg]);
    const uint64_t dpd = desc_sw128(sm.p[wg]);
    const uint64_t dshd = desc_sw128(sm.dsh[wg]), dsld = desc_sw128(sm.dsl[wg]);
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    for (int it = 0; it < steps; ++it) {
      const int stage = it % S;
      mbar_wait(&sm.full[stage], (it / S) & 1);
      const uint64_t dkd = desc_sw<kLine>(sm.k[stage][qb]);
      const uint64_t dvd = desc_sw<kLine>(sm.v[stage][qb]);
      // S = Q K^T and dP = dO V^T
      float s[32], dp[32];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      product_abt<D>(s, dqd, dkd);
      product_abt<D>(dp, dod, dvd);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      logits<D, kPadded>(s, sm.pen[stage][qb], lane, g.logit);
      // p = exp(s - lse), dS = p (dP - delta) * scale, both 0 on rows past
      // the block; round(p), dS hi and lo into shared memory (the previous
      // sub-tile's products are done: every warp passed the barriers
      // below since)
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
        const uint32_t off = sw128_offset(lrow + 8 * r, acc_col(i, lane));
        st_shared_u32(sm.p[wg], off, pack_bf16(p0, p1));
        st_shared_u32(sm.dsh[wg], off, *reinterpret_cast<const uint32_t*>(&hi));
        st_shared_u32(sm.dsl[wg], off, pack_bf16(d0 - hf.x, d1 - hf.y));
      }
      fence_async_shared();  // the tiles, written by this thread, to the products
      named_barrier(bar, 128);
      // dQ += dS K; dK = dS^T Q; dV = round(p)^T dO (64 keys or 64 query
      // rows: 4 k-steps)
      float dk_acc[D / 2], dv_acc[D / 2];
      fence_regs(dq_acc);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        wgmma_ss<D / 2, 0, 1>(dq_acc, dshd + 2 * kk, dkd + kk * kLine, 1);
        wgmma_ss<D / 2, 0, 1>(dq_acc, dsld + 2 * kk, dkd + kk * kLine, 1);
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        wgmma_ss<D / 2, 1, 1>(dk_acc, dshd + kk * kPStep, dqd + kk * kLine, kk);
        wgmma_ss<D / 2, 1, 1>(dk_acc, dsld + kk * kPStep, dqd + kk * kLine, 1);
      }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_ss<D / 2, 1, 1>(dv_acc, dpd + kk * kPStep, dod + kk * kLine, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      release_stage(&sm.empty[stage], lane);
      // the sub-tile's dK and dV, staged in shared memory, then added into
      // the accumulators with TMA reduce-adds
      if (tid == 0) tma_store_read_done();  // the previous sub-tile's adds have read the staging
      named_barrier(bar, 128);
      stage_f32<D>(sm.dk[wg], dk_acc, lrow, lane);
      stage_f32<D>(sm.dv[wg], dv_acc, lrow, lane);
      fence_async_shared();
      named_barrier(bar, 128);
      if (tid == 0 && valid) {
        const int key0 =
            bigbird::slot_block(rand_j, it / T, jc, g.nb) * bs + (it % T) * kRows;
#pragma unroll
        for (int x = 0; x < D / BC; ++x) {
          if (kPadded && BC * x >= g.d) break;  // a box wholly past the accumulators' d
          tma_reduce_add_4d(&map_dk, sm.dk[wg] + x * kRows * BC, BC * x, h, key0, b);
          tma_reduce_add_4d(&map_dv, sm.dv[wg] + x * kRows * BC, BC * x, h, key0, b);
        }
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_done();
    if (ok[0] || ok[1]) {
      const int d = kPadded ? g.d : D;  // dq's head width
      bf16* dst = dq + ((size_t(b) * g.S + bs + row0) * g.H + h) * d;
      store_acc<kPadded>(dst, dst + size_t(8) * g.H * d, ok[0], ok[1], dq_acc, lane, d);
    }
  }
}

// --- host side --------------------------------------------------------------

// 4-D map of a (B, S, H, D) tensor of T with element strides (sb, ss, sh)
// and a unit last stride: dims (D, H, S, B), box (box_d, 1, 64, 1), one
// 64-row tile at every block size; the swizzle of a box_d-element line
// (128, 64 or 32 bytes) unless `swizzled` is false
template <typename T>
inline bool make_map_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                          long long sb, long long ss, long long sh, int box_d,
                          bool swizzled = true) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * sizeof(T), cuuint64_t(ss) * sizeof(T),
                                 cuuint64_t(sb) * sizeof(T)};
  const cuuint32_t box[4] = {cuuint32_t(box_d), 1, cuuint32_t(kRows), 1};
  const CUtensorMapSwizzle swizzle =
      swizzled ? swizzle_of(int(box_d * sizeof(T))) : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode_map(map, MapType<T>::kType, base, 4, dims, strides, box, swizzle);
}

// the same for a contiguous (B, S, H, D) tensor
template <typename T>
inline bool make_map_dense(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                           int box_d, bool swizzled = true) {
  const long long row = (long long)H * D;
  return make_map_bshd<T>(map, base, B, S, H, D, row * S, row, D, box_d, swizzled);
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// Q = 2: a CTA a pair of query blocks; Q = 1: ceil(T / 2) CTAs a query block
inline dim3 grid_of(int B, const Geo& g, int Q) {
  const int n_mid = g.nb - 2;
  const int x = Q == 2 ? (n_mid + 1) / 2 : n_mid * ((tiles_of(g.bs) + 1) / 2);
  return dim3(x, g.H, B);
}

template <int D, int Q, int S, int BS, bool kPadded>
inline int launch_fwd_sm90_t(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                             const float* mask, const int* rand, void* out, float* lse, int B,
                             const Geo& g, cudaStream_t stream) {
  constexpr size_t smem = sizeof(SmemFwd<D, kFwdConsumers, Q, S>) + 1024;
  auto kernel = bigbird_fwd_sm90_kernel<D, Q, S, BS, kPadded>;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<grid_of(B, g, Q), threads_of(kFwdConsumers), smem, stream>>>(
      mq, mk, mv, mask, rand, static_cast<bf16*>(out), lse, g);
  return int(cudaGetLastError());
}

// whether a call runs an exact instance: its head width is one (16, 32 or
// 64) and its scale, in bf16, that width's
inline bool exact_call(const Geo& g) {
  return (g.d == 16 && g.logit == kLogitScale<16>) || (g.d == 32 && g.logit == kLogitScale<32>) ||
         (g.d == 64 && g.logit == kLogitScale<64>);
}

// f(std::integral_constant<bool, kPadded>{}) for the call's kind of instance
template <typename F>
inline int with_exactness(const Geo& g, F&& f) {
  return exact_call(g) ? f(std::false_type{}) : f(std::true_type{});
}

inline int launch_fwd_sm90(const void* q, const void* k, const void* v, const float* mask,
                           const int* rand, void* out, float* lse, int B, const Geo& g,
                           cudaStream_t stream) {
  return with_padded_head_dim<64>(g.d, [&](auto p) {
    constexpr int kD = decltype(p)::value;
    return with_exactness(g, [&](auto pad) {
      constexpr bool kPadded = decltype(pad)::value;
      CUtensorMap mq, mk, mv;
      if (!make_map_bshd<bf16>(&mq, q, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, kD) ||
          !make_map_bshd<bf16>(&mk, k, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, kD) ||
          !make_map_bshd<bf16>(&mv, v, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, kD))
        return kErrTensorMap;
      constexpr int S1 = kFwdStages, S2 = 2 * kFwdStages;
      if constexpr (!kPadded) {
        if (g.bs == 64)
          return launch_fwd_sm90_t<kD, 2, S1, 64, false>(mq, mk, mv, mask, rand, out, lse, B, g,
                                                         stream);
        if (g.bs == 128)
          return launch_fwd_sm90_t<kD, 1, S2, 128, false>(mq, mk, mv, mask, rand, out, lse, B, g,
                                                          stream);
      }
      if (tiles_of(g.bs) > 1)
        return launch_fwd_sm90_t<kD, 1, S2, 0, kPadded>(mq, mk, mv, mask, rand, out, lse, B, g,
                                                        stream);
      return launch_fwd_sm90_t<kD, 2, S1, 0, kPadded>(mq, mk, mv, mask, rand, out, lse, B, g,
                                                      stream);
    });
  });
}

template <int D, int Q, int S, int BS, bool kPadded>
inline int launch_bwd_sm90_t(const CUtensorMap (&maps)[7], const float* mask, const int* rand,
                             const float* lse, void* dq, int B, const Geo& g,
                             cudaStream_t stream) {
  constexpr size_t smem = sizeof(SmemBwd<D, kBwdConsumers, Q, S>) + 1024;
  auto kernel = bigbird_bwd_sm90_kernel<D, Q, S, BS, kPadded>;
  const cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<grid_of(B, g, Q), threads_of(kBwdConsumers), smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], mask, rand, lse,
      static_cast<bf16*>(dq), g);
  return int(cudaGetLastError());
}

inline int launch_bwd_sm90(const void* q, const void* k, const void* v, const float* mask,
                           const int* rand, const void* out, const float* lse, const void* dout,
                           void* dq, float* dk, float* dv, int B, const Geo& g,
                           cudaStream_t stream) {
  return with_padded_head_dim<64>(g.d, [&](auto p) {
    constexpr int kD = decltype(p)::value;
    constexpr int BC = kBoxCols<kD>;
    return with_exactness(g, [&](auto pad) {
      constexpr bool kPadded = decltype(pad)::value;
      const int n_rows = (g.nb - 2) * g.bs;
      CUtensorMap maps[7];  // q, k, v, o, dO, dK, dV
      if (!make_map_bshd<bf16>(&maps[0], q, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, kD) ||
          !make_map_bshd<bf16>(&maps[1], k, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, kD) ||
          !make_map_bshd<bf16>(&maps[2], v, B, g.S, g.H, g.d, g.sb, g.ss, g.sh, kD) ||
          !make_map_dense<bf16>(&maps[3], out, B, n_rows, g.H, g.d, kD) ||
          !make_map_dense<bf16>(&maps[4], dout, B, n_rows, g.H, g.d, kD) ||
          !make_map_dense<float>(&maps[5], dk, B, g.S, g.H, g.d, BC, BC == 32) ||
          !make_map_dense<float>(&maps[6], dv, B, g.S, g.H, g.d, BC, BC == 32))
        return kErrTensorMap;
      constexpr int S1 = kBwdStages, S2 = 2 * kBwdStages;
      if constexpr (!kPadded) {
        if (g.bs == 64)
          return launch_bwd_sm90_t<kD, 2, S1, 64, false>(maps, mask, rand, lse, dq, B, g, stream);
        if (g.bs == 128)
          return launch_bwd_sm90_t<kD, 1, S2, 128, false>(maps, mask, rand, lse, dq, B, g,
                                                          stream);
      }
      if (tiles_of(g.bs) > 1)
        return launch_bwd_sm90_t<kD, 1, S2, 0, kPadded>(maps, mask, rand, lse, dq, B, g, stream);
      return launch_bwd_sm90_t<kD, 2, S1, 0, kPadded>(maps, mask, rand, lse, dq, B, g, stream);
    });
  });
}

}  // namespace bigbird90
}  // namespace stonkgs
