// The bf16 attention backward past the Hopper instances' widest padded
// width (D > 256), for Hopper (sm_90a), launched by flash_attention_train.cu
// after the delta pass:
//
//   p  = exp(S*scale + bias - lse),  dP = (dO V^T) * mr,  dS = p (dP - delta)
//   dQ = scale * round(dS) K,  dK = scale * round(dS)^T Q,  dV = round(p mr)^T dO,
//   db[b, key] = sum over heads and rows of the fp32 dS
//
// over (B, S, H, D) bf16 q, k, v, dO and dq, dk, dv, D any multiple of 8
// above 256, with an optional (B, S) fp32 key bias.  It replaces the TPU
// kernel _train_bwd_kernel (stonkgs_tpu/ops/flash_attention.py:118) at
// those widths and computes what attention_bwd_sm90.cuh computes up to
// 256: the TPU kernel's rounding points (dS rounded to bf16 before the dQ
// and dK products, the dropped p rounded for dV, the scale after the
// products) and the hash dropout at the true position.
//
// What bounds it on the H100: at the 2-head trunk (B=32, S=512, 2 heads of
// 384) the five products S, dP~, dQ, dK, dV of 2*B*H*S^2*D flops (12.9
// GFLOP each: 0.065 ms at 989 TFLOP/s) over the bytes (q, k, v, o, dO read,
// dq, dk, dv written: 0.030 ms at 3.35 TB/s).
//
// Why a design of its own: past 256 a 64-row accumulator of D fp32 columns
// is more than a thread's registers, and the flash-style pair of
// attention_bwd_sm90.cuh would form S and dP~ again for every column part
// of its outputs (15 products at D = 384).  The TPU kernel rounds dS and
// the dropped p to bf16 before every product that reads them, so writing
// those two matrices out in bf16 changes no number, and the backward
// becomes
// * a dS pass (attn_bwd_ds_wide_sm90_kernel), key-major as the dK/dV
//   kernel up to 256: a block of 256 threads owns 128 keys (two consumer
//   warpgroups of 64, the first warp also feeding the ring, as
//   attention_wide_sm90.cuh) and walks the query tiles of 64; per query
//   tile it forms S^T = K Q^T and dP~^T = V dO^T over the full D in column
//   blocks of 64 (four wgmma.m64n64k16 k-steps each a block, the items of
//   a 4-stage TMA ring holding the block of K and V of the keys and of Q
//   and dO of the rows: 48 KB; each block's dP~^T summed apart and added
//   in fp32, which keeps db within its fp32 check at D = 768 and above),
//   the element pass in registers (p, the keep bit of the hash, dS, the
//   fp32 sums of dS over the rows for db: one atomicAdd a key and head),
//   and writes round(dS)^T and round(p mr)^T into two bf16 (heads, S,
//   rows) scratch matrices, keys by query rows;
// * hand-written wgmma GEMMs over that scratch
//   (attn_bwd_gemm_wide_sm90_kernel), output tiles of 128 rows x 128
//   columns in fp32 registers (two consumer warpgroups of 64 rows, warp 0
//   feeding a 4-stage ring of 64-deep K steps): dK = scale dS^T Q and dV =
//   (p mr)^T dO in one launch (A the scratch K-major), dQ = scale dS K in
//   another (A the scratch read M-major, as wgmma takes a bf16 A), B the
//   (B, S, H, D) operand MN-major, two 64-column blocks a step.
// Five score-sized products, against seven up to 256 and fifteen for the
// flash-style pair here.  The scratch's bytes (4 B·H·S^2) are bounded by
// the caller: a call runs over groups of heads and, where one head's
// scratch passes the bound, over chunks of query rows, dK and dV carried
// in fp32 across the chunks (ops/flash_attention.py::wide_backward_plan).
//
// Numerics: as attention_bwd_sm90.cuh (p = exp2 on the SFU, products
// summed in another order), held to the same bf16 limits in chip_smoke.py.

#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "attention_wide_sm90.cuh"

namespace stonkgs {
namespace attn90 {
namespace bwide {

constexpr int kRows = 128;                     // keys of a dS block, rows of a GEMM tile
constexpr int kQRows = 64;                     // query rows of a dS block's tiles
constexpr int kCB = 64;                        // columns of a column block
constexpr int kPartCols = 128;                 // output columns of a GEMM tile
constexpr int kDsRing = 4;                     // the dS pass's stages (K, V, Q, dO blocks)
constexpr int kGemmRing = 4;                   // the GEMMs' stages (A and B of a K step)
constexpr int kBlockElems = kRows * kCB;       // a 128-row column block
constexpr uint32_t kBlockBytes = kBlockElems * 2;  // 16 KB
constexpr uint32_t kHalfBytes = kBlockBytes / 2;   // its 64 rows: 8 KB
constexpr uint32_t kDsItemBytes = 2 * kBlockBytes + 2 * kHalfBytes;  // K, V, Q, dO: 48 KB
constexpr int kBlockThreads = 2 * 128;         // two consumer warpgroups
// shared memory from its 1024-byte aligned start: the barriers, the dS
// pass's lse and delta of each stage's query tile, then the ring's tiles
constexpr int kVecOffset = 64;
constexpr int kTilesOffset = 4096;
static_assert(kVecOffset + kDsRing * 2 * kQRows * 4 <= kTilesOffset, "the vectors fit");
constexpr size_t kDsSmem = 1024 + kTilesOffset + size_t(kDsRing) * kDsItemBytes;
constexpr size_t kGemmSmem = 1024 + kTilesOffset + size_t(kGemmRing) * 2 * kBlockBytes;
static_assert(kDsSmem <= kMaxSmem && kGemmSmem <= kMaxSmem, "the rings fit");

template <int kRing>
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == kRing) {
    stage = 0;
    phase ^= 1u;
  }
}

// the descriptor of an MN-major operand at shared address `addr` whose
// 64-wide column blocks are `lbo` bytes apart (128-byte swizzle)
__device__ __forceinline__ uint64_t desc_lbo(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

}  // namespace bwide

// The dS pass over keys [128 x, +128) of head bh0 + y and the query rows
// [q0, q0 + n_q) (a chunk): round(dS)^T and round(p mr)^T into ds and pd,
// (n_bh, S, ld) bf16, keys by the chunk's rows; db (B, S) gets each key's
// fp32 sum of dS over the chunk's rows (one atomicAdd a key), when given
__global__ void __launch_bounds__(bwide::kBlockThreads, 1)
attn_bwd_ds_wide_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const float* __restrict__ key_bias, const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ ds,
                             bf16* __restrict__ pd, float* __restrict__ db, int S, int H, int ncb,
                             int bh0, int q0, int n_q, int ld, float scale, Dropout drop) {
  using namespace bwide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kDsRing;
  float* vec = reinterpret_cast<float*>(base + kVecOffset);  // [stage][lse, delta][kQRows]
  bf16* ring = reinterpret_cast<bf16*>(base + kTilesOffset);
  const int k0 = blockIdx.x * kRows, y = blockIdx.y, bh = bh0 + y;
  const int b = bh / H, h = bh - b * H;
  const int n_qt = (n_q + kQRows - 1) / kQRows;
  const size_t stat0 = size_t(bh) * S + q0;  // (b, h, q0) of lse and delta
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDsRing; ++s) {
      mbar_init(&full[s], 32);  // the feeding warp's lanes, lane 0 with the bytes
      mbar_init(&empty[s], 8);  // the consumers' warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The feeding warp (warp 0) loads per query tile and column block one
  // item (the block of K and V of the block's 128 keys, of Q and dO of the
  // tile's 64 rows), kDsRing ahead; the tile's lse (+inf past the chunk,
  // which makes p = 0) and delta ride in the stage of its last block.
  const bool feeder = threadIdx.x < 32;
  const int lane = threadIdx.x % 32;
  int f_j = 0, f_c = 0, f_stage = 0;
  uint32_t f_phase = 0;
  float f_lse[kQRows / 32], f_delta[kQRows / 32];
  auto feed = [&]() {
    if (f_j >= n_qt) return;
    mbar_wait(&empty[f_stage], f_phase ^ 1u);
    if (f_c == 0) {
#pragma unroll
      for (int t = 0; t < kQRows / 32; ++t) {
        const int row = f_j * kQRows + t * 32 + lane;  // of the chunk
        const bool live = row < n_q;
        f_lse[t] = live ? __ldg(lse + stat0 + row) : INFINITY;
        f_delta[t] = live ? __ldg(delta + stat0 + row) : 0.f;
      }
    }
    if (f_c == ncb - 1) {
#pragma unroll
      for (int t = 0; t < kQRows / 32; ++t) {
        vec[(f_stage * 2) * kQRows + t * 32 + lane] = f_lse[t];
        vec[(f_stage * 2 + 1) * kQRows + t * 32 + lane] = f_delta[t];
      }
    }
    uint64_t* bar = &full[f_stage];
    if (lane == 0) {
      bf16* dst = ring + f_stage * (kDsItemBytes / 2);
      const int row0 = q0 + f_j * kQRows, c = f_c * kCB;
      mbar_arrive_tx(bar, kDsItemBytes);
      tma_load_4d(dst, &map_k, c, h, k0, b, bar);
      tma_load_4d(dst + kBlockElems, &map_v, c, h, k0, b, bar);
      tma_load_4d(dst + 2 * kBlockElems, &map_q, c, h, row0, b, bar);
      tma_load_4d(dst + 2 * kBlockElems + kBlockElems / 2, &map_do, c, h, row0, b, bar);
    } else {
      mbar_arrive(bar);
    }
    if (++f_c == ncb) {
      f_c = 0;
      ++f_j;
    }
    advance<kDsRing>(f_stage, f_phase);
    __syncwarp();  // reconverged before the warpgroup's next wgmma
  };
  if (feeder)
    for (int i = 0; i < kDsRing; ++i) feed();
  auto release = [&](int stage) {
    release_stage(&empty[stage], lane);
    if (feeder) feed();
  };

  // ---------------- consumers: 64 keys each ----------------
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int key0 = k0 + wg * 64 + warp * 16 + lane / 4;  // the thread's keys: key0, key0 + 8
  float bias_r[2], db_acc[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    bias_r[r] = key < S ? (key_bias ? key_bias[size_t(b) * S + key] : 0.f) : -INFINITY;
  }
  bf16* ds_h = ds + size_t(y) * S * ld;
  bf16* pd_h = pd + size_t(y) * S * ld;
  const uint32_t ring_s = smem_u32(ring), wg_rows = uint32_t(wg) * kHalfBytes;
  // S^T and dP~^T of 64 keys x 64 query rows.  S^T accumulates over the
  // column blocks; each block's dP~^T goes to a fresh accumulator (two, in
  // turns) and is added to dp in fp32: in one chain over D > 256 columns
  // the products' sum drifts by up to 2^-17 of its size (D = 768, S = 1:
  // 1.1e-4 of db, against the 1e-4 its fp32 check allows), and dS = p (dP
  // - delta) cancels most of it.
  float s[32], dp[32], dpa[32], dpb[32];
  int stage = 0;
  uint32_t phase = 0;
  // the products of the next item, into s and the fresh dpn
  auto issue = [&](float (&dpn)[32]) {
    mbar_wait(&full[stage], phase);
    const uint32_t st = ring_s + stage * kDsItemBytes;
    const uint64_t dk = wide::desc_at(st + wg_rows);
    const uint64_t dv = wide::desc_at(st + kBlockBytes + wg_rows);
    const uint64_t dq = wide::desc_at(st + 2 * kBlockBytes);
    const uint64_t ddo = wide::desc_at(st + 2 * kBlockBytes + kHalfBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCB / 16; ++kk) wgmma_qk64(s, dk + 2 * kk, dq + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < kCB / 16; ++kk) wgmma_qk64(dpn, dv + 2 * kk, ddo + 2 * kk, kk);
    wgmma_commit();
  };
  auto fold = [&](float (&dpo)[32]) {
    fence_regs(dpo);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] += dpo[i];
  };
  for (int j = 0; j < n_qt; ++j) {
    // each item's stage is released once the products after it have been
    // issued and its own have completed (its dP~ block then added to dp)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    int prev = 0;
    for (int c = 0; c < ncb; c += 2) {
      issue(dpa);  // block c
      if (c > 0) {
        wgmma_wait<1>();
        fold(dpb);
        release(prev);
      }
      prev = stage;
      advance<kDsRing>(stage, phase);
      if (c + 1 == ncb) break;
      issue(dpb);  // block c + 1
      wgmma_wait<1>();
      fold(dpa);
      release(prev);
      prev = stage;
      advance<kDsRing>(stage, phase);
    }
    wgmma_wait<0>();
    fence_regs(s);
    if (ncb % 2) fold(dpa);
    else fold(dpb);
    // the element pass: p, the keep bit, dS; db's row sums; round(dS) and
    // round(p mr) into the scratch (keys < S, the chunk's rows)
    const float* lse_s = vec + (prev * 2) * kQRows;
    const float* delta_s = vec + (prev * 2 + 1) * kQRows;
    const int col0 = j * kQRows;  // the tile's first row of the chunk
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = acc_row(i), c = acc_col(i, lane);
      const float2 lv = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
      const int key = key0 + 8 * r;
      float dsv[2], pdv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2((fmaf(s[i + e], scale, bias_r[r]) - (e ? lv.y : lv.x)) * kLog2e);
        float d = dp[i + e], pm = p;
        if (drop.enabled) {
          const bool kept = drop.keep(drop.row_base(bh, q0 + col0 + c + e) + uint32_t(key));
          pm = kept ? p * drop.keep_scale : 0.f;
          d = kept ? d * drop.keep_scale : 0.f;
        }
        dsv[e] = p * (d - (e ? dl.y : dl.x));
        db_acc[r] += dsv[e];
        pdv[e] = pm;
      }
      if (key < S && col0 + c < n_q) {
        const size_t at = size_t(key) * ld + col0 + c;
        *reinterpret_cast<uint32_t*>(ds_h + at) = pack_bf16(dsv[0], dsv[1]);
        *reinterpret_cast<uint32_t*>(pd_h + at) = pack_bf16(pdv[0], pdv[1]);
      }
    }
    release(prev);
  }
  if (db) {
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

// How a GEMM tile's epilogue meets the chunks of query rows: kStore (the
// call's only chunk, or dQ) and kLast write bf16, kFirst and kMiddle the
// fp32 carry (B, S, H, D) that kMiddle and kLast add
enum CarryMode { kStore = 0, kFirst = 1, kMiddle = 2, kLast = 3 };

// out[row m0 + m, h, cols] = scale * sum_k A[m, k] B[kb0 + k, h, cols] over
// a 128 x 128 output tile of head bh0 + y: A (M x K) the scratch of local
// head y, K-major (kTransA false: the (M rows, K columns) matrix) or read
// M-major from its transpose (true: (K rows, M columns)); B the (B, S, H,
// D) operand.  blockIdx.z picks the operand set (a0, b0, out0, carry0,
// scale0) or (a1, ...)
template <bool kTransA>
__global__ void __launch_bounds__(bwide::kBlockThreads, 1)
attn_bwd_gemm_wide_sm90_kernel(const __grid_constant__ CUtensorMap map_a0,
                               const __grid_constant__ CUtensorMap map_a1,
                               const __grid_constant__ CUtensorMap map_b0,
                               const __grid_constant__ CUtensorMap map_b1,
                               bf16* __restrict__ out0, bf16* __restrict__ out1,
                               float* __restrict__ carry0, float* __restrict__ carry1,
                               float scale0, float scale1, int M, int K, int S, int H, int D,
                               int ncb, int bh0, int m0, int kb0, int carry_mode) {
  using namespace bwide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kGemmRing;
  bf16* ring = reinterpret_cast<bf16*>(base + kTilesOffset);
  const int parts = (ncb + 1) / 2;
  const int mt = int(blockIdx.x) / parts, part = int(blockIdx.x) - mt * parts;
  const int y = blockIdx.y, bh = bh0 + y, b = bh / H, h = bh - b * H;
  const bool second = blockIdx.z != 0;
  const CUtensorMap* ma = second ? &map_a1 : &map_a0;
  const CUtensorMap* mb = second ? &map_b1 : &map_b0;
  const int n_k = (K + kCB - 1) / kCB;
  const int n0 = part * kPartCols, nbv = min(2, ncb - 2 * part);  // B blocks below D
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmRing; ++s) {
      mbar_init(&full[s], 1);   // the feeding warp's lane 0, with the bytes
      mbar_init(&empty[s], 8);  // the consumers' warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp 0 feeds the ring kGemmRing K steps ahead: A's 128 x 64 (two 64 x
  // 64 boxes when read M-major), B's 64 x 128 as two 64-column blocks (a
  // block wholly past D is not loaded: its columns are not stored)
  const bool feeder = threadIdx.x < 32;
  const int lane = threadIdx.x % 32;
  int f_k = 0, f_stage = 0;
  uint32_t f_phase = 0;
  auto feed = [&]() {
    if (f_k >= n_k) return;
    mbar_wait(&empty[f_stage], f_phase ^ 1u);
    if (lane == 0) {
      bf16* dst = ring + f_stage * 2 * kBlockElems;
      uint64_t* bar = &full[f_stage];
      mbar_arrive_tx(bar, kBlockBytes + uint32_t(nbv) * kHalfBytes);
      if constexpr (kTransA) {
        tma_load_3d(dst, ma, mt * kRows, f_k * kCB, y, bar);
        tma_load_3d(dst + kBlockElems / 2, ma, mt * kRows + 64, f_k * kCB, y, bar);
      } else {
        tma_load_3d(dst, ma, f_k * kCB, mt * kRows, y, bar);
      }
      for (int t = 0; t < nbv; ++t)
        tma_load_4d(dst + kBlockElems + t * (kBlockElems / 2), mb, n0 + t * kCB, h,
                    kb0 + f_k * kCB, b, bar);
    }
    ++f_k;
    advance<kGemmRing>(f_stage, f_phase);
    __syncwarp();
  };
  if (feeder)
    for (int i = 0; i < kGemmRing; ++i) feed();
  auto release = [&](int stage) {
    release_stage(&empty[stage], lane);
    if (feeder) feed();
  };

  // ---------------- consumers: 64 rows each ----------------
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const uint32_t ring_s = smem_u32(ring);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int kc = 0; kc < n_k; ++kc) {
    mbar_wait(&full[stage], phase);
    const uint32_t st = ring_s + stage * 2 * kBlockBytes;
    // A: this consumer's 64 rows (8 KB into a K-major 128-row box) or its
    // 64-column box of the transpose; B: 16 K lines a k-step
    const uint64_t da = wide::desc_at(st + uint32_t(wg) * kHalfBytes);
    const uint64_t dbb = desc_lbo(st + kBlockBytes, kHalfBytes);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCB / 16; ++kk) {
      if constexpr (kTransA) wgmma_n128<1, 1>(acc, da + kk * 128, dbb + kk * 128, 1);
      else wgmma_n128<1>(acc, da + 2 * kk, dbb + kk * 128, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done: free its stage
    fence_regs(acc);
    if (kc > 0) release(prev);
    prev = stage;
    advance<kGemmRing>(stage, phase);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (n_k > 0) release(prev);

  // epilogue: rows < M, columns < D of the (B, S, H, D) output
  bf16* out = second ? out1 : out0;
  float* carry = second ? carry1 : carry0;
  const float scale = second ? scale1 : scale0;
  const int mrow = mt * kRows + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = mrow + 8 * r;
    if (m >= M) continue;
    const size_t row = ((size_t(b) * S + m0 + m) * H + h) * size_t(D);
#pragma unroll
    for (int i = 2 * r; i < 64; i += 4) {
      const int col = n0 + acc_col(i, lane);  // even; D is a multiple of 8
      if (col >= D) continue;
      float x0 = acc[i] * scale, x1 = acc[i + 1] * scale;
      if (carry_mode == kMiddle || carry_mode == kLast) {
        const float2 c = *reinterpret_cast<const float2*>(carry + row + col);
        x0 += c.x;
        x1 += c.y;
      }
      if (carry_mode == kFirst || carry_mode == kMiddle)
        *reinterpret_cast<float2*>(carry + row + col) = make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(out + row + col) = pack_bf16(x0, x1);
    }
  }
}

// --- host side --------------------------------------------------------------

// the calls of launch_bwd_wide_sm90 that launched its kernels (exported as
// flash_attention_train_bwd_wide_calls)
inline int& bwd_wide_calls() {
  static int calls = 0;
  return calls;
}

// 3-D map of a (n, S, rows) bf16 scratch of row stride ld elements: dims
// (rows, S, n) (the chunk's rows innermost), box (64, box_rows, 1) with the
// 128-byte swizzle; rows past `rows` and keys past S read as zero
inline bool make_scratch_map(CUtensorMap* map, const void* base, int n, int S, int rows, int ld,
                             int box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(rows), cuuint64_t(S), cuuint64_t(n)};
  const cuuint64_t strides[2] = {cuuint64_t(ld) * 2, cuuint64_t(ld) * 2 * cuuint64_t(S)};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  return encode_map(map, MapType<bf16>::kType, base, 3, dims, strides, box);
}

// 4-D map of a (B, S, H, D) bf16 tensor, boxes of 64 rows x 64 columns (a
// dS pass's query tile of one column block; a GEMM's B operand, 64 K lines
// of one column block)
inline bool make_map_rows64(CUtensorMap* map, const void* base, int B, int S, int H, int D) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t row = cuuint64_t(D) * 2;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return encode_map(map, MapType<bf16>::kType, base, 4, dims, strides, box);
}

template <typename Kernel>
inline cudaError_t set_wide_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// whether launch_bwd_wide_sm90 takes these arguments (checked before the
// delta pass, so that a refused call launches nothing)
inline bool bwd_wide_args_ok(int B, int H, int S, int D, int group, int chunk, const void* ds,
                             const void* pd, const float* dk_carry, const float* dv_carry) {
  return D > attn::kMaxHeadDim && D % 8 == 0 && group >= 1 && group <= 65535 && chunk >= 1 &&
         (long long)B * H <= 0x7fffffffLL && ds && pd && (chunk >= S || (dk_carry && dv_carry));
}

// The bf16 backward at D > 256 (a multiple of 8) after the delta pass, over
// groups of `group` heads (of the B*H) and chunks of `chunk` query rows:
// ds and pd a (group, S, ld) bf16 scratch each, ld = chunk rounded up to
// a multiple of 8; dk_carry and dv_carry (B, S, H, D) fp32, required when
// chunk < S
inline int launch_bwd_wide_sm90(const void* q, const void* k, const void* v,
                                const float* key_bias, const float* lse, const void* dout,
                                const float* delta, void* dq, void* dk, void* dv, float* db,
                                void* ds, void* pd, float* dk_carry, float* dv_carry, int B,
                                int S, int H, int D, int group, int chunk, float scale,
                                Dropout drop, cudaStream_t stream) {
  using namespace bwide;
  const long long n_heads = (long long)B * H;
  if (!bwd_wide_args_ok(B, H, S, D, group, chunk, ds, pd, dk_carry, dv_carry))
    return int(cudaErrorInvalidValue);
  // K and V in boxes of 128 keys (the dS pass); Q, K and dO in boxes of 64
  // rows (the dS pass's query tiles, the GEMMs' B operands)
  CUtensorMap mk, mv, bq, bk, bdo;
  if (!make_map<128>(&mk, k, B, S, H, D) || !make_map<128>(&mv, v, B, S, H, D) ||
      !make_map_rows64(&bq, q, B, S, H, D) || !make_map_rows64(&bk, k, B, S, H, D) ||
      !make_map_rows64(&bdo, dout, B, S, H, D))
    return kErrTensorMap;
  cudaError_t e = set_wide_smem(attn_bwd_ds_wide_sm90_kernel, kDsSmem);
  if (e == cudaSuccess) e = set_wide_smem(attn_bwd_gemm_wide_sm90_kernel<false>, kGemmSmem);
  if (e == cudaSuccess) e = set_wide_smem(attn_bwd_gemm_wide_sm90_kernel<true>, kGemmSmem);
  if (e != cudaSuccess) return int(e);
  const int ncb = (D + kCB - 1) / kCB, parts = (ncb + 1) / 2;
  const int ld = (chunk + 7) / 8 * 8;
  const unsigned key_tiles = unsigned((S + kRows - 1) / kRows);
  bf16* dqt = static_cast<bf16*>(dq);
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dv);
  for (long long g0 = 0; g0 < n_heads; g0 += group) {
    const int bh0 = int(g0), n_bh = int(std::min<long long>(group, n_heads - g0));
    for (int q0 = 0; q0 < S; q0 += chunk) {
      const int n_q = std::min(chunk, S - q0);
      const int carry = chunk >= S ? kStore : q0 == 0 ? kFirst : q0 + n_q >= S ? kLast : kMiddle;
      CUtensorMap ads, ads_t, apd;  // the scratch: K-major for dK, dV; M-major for dQ
      if (!make_scratch_map(&ads, ds, n_bh, S, n_q, ld, kRows) ||
          !make_scratch_map(&ads_t, ds, n_bh, S, n_q, ld, 64) ||
          !make_scratch_map(&apd, pd, n_bh, S, n_q, ld, kRows))
        return kErrTensorMap;
      attn_bwd_ds_wide_sm90_kernel<<<dim3(key_tiles, n_bh), kBlockThreads, kDsSmem, stream>>>(
          bq, mk, mv, bdo, key_bias, lse, delta, static_cast<bf16*>(ds), static_cast<bf16*>(pd),
          db, S, H, ncb, bh0, q0, n_q, ld, scale, drop);
      e = cudaGetLastError();
      if (e != cudaSuccess) return int(e);
      // dK = scale dS^T Q and dV = (p mr)^T dO: M the keys, K the chunk's rows
      attn_bwd_gemm_wide_sm90_kernel<false>
          <<<dim3(key_tiles * parts, n_bh, 2), kBlockThreads, kGemmSmem, stream>>>(
              ads, apd, bq, bdo, dkt, dvt, dk_carry, dv_carry, scale, 1.f, S, n_q, S, H, D, ncb,
              bh0, 0, q0, carry);
      e = cudaGetLastError();
      if (e != cudaSuccess) return int(e);
      // dQ = scale dS K: M the chunk's rows, K the keys
      const unsigned row_tiles = unsigned((n_q + kRows - 1) / kRows);
      attn_bwd_gemm_wide_sm90_kernel<true>
          <<<dim3(row_tiles * parts, n_bh, 1), kBlockThreads, kGemmSmem, stream>>>(
              ads_t, ads_t, bk, bk, dqt, dqt, nullptr, nullptr, scale, scale, n_q, S, S, H, D,
              ncb, bh0, q0, 0, kStore);
      e = cudaGetLastError();
      if (e != cudaSuccess) return int(e);
    }
  }
  ++bwd_wide_calls();
  return 0;
}

}  // namespace attn90
}  // namespace stonkgs
