// The bf16 attention forward past the Hopper instances' widest padded width
// (D > 256), for Hopper (sm_90a), shared by the inference and the training
// entry points (flash_attention_infer.cu and flash_attention_train.cu):
//
//   out = dropout(softmax(Q K^T * scale + key_bias)) V
//
// over (B, S, H, D) bf16 q, k, v and out, D any multiple of 8 above 256,
// with an optional (B, S) fp32 key bias; training also writes the fp32
// logsumexp (B, H, S).  It replaces the TPU kernels _infer_kernel and
// _train_fwd_kernel (stonkgs_tpu/ops/flash_attention.py:359 and :92) at
// those widths and computes what attn_fwd_sm90_kernel (attention_sm90.cuh)
// computes up to 256: two passes over the keys (the TPU kernels normalise,
// drop and only then round the probabilities), fp32 statistics, p =
// ex2((s - m) log2 e) * (1/l) rounded to bf16 before P V, keys >= S at
// -inf, the training kernel's S_pad - S padded keys at -1e9 in (m, l), and
// the hash dropout at the true key index.
//
// Why a design of its own: a 64-row O accumulator of D > 256 fp32 columns
// is more than a thread's registers, and Q and K tiles of D columns more
// than a ring of shared memory holds.  So
// * the scores run over the full D in column blocks of 64 (a 128-byte
//   line, the widest swizzle): S = sum_c Q[:, c] K[:, c]^T, each block four
//   wgmma.m64n128k16 k-steps into one 64 x 128 fp32 score tile (128 keys);
//   TMA zero-fills the columns of the last block past D;
// * O is cut into column parts of 128 (two column blocks), a grid axis: a
//   block owns 128 query rows and one part, and runs O += P V as
//   wgmma.m64n64k16 with P from registers against its part's columns of V
//   only.  A block is two consumer warpgroups of 64 rows, 256 threads,
//   which ptxas gives up to 255 registers a thread: the score tile (64)
//   and an O part of 128 columns (64) fit beside each other, an O part of
//   256 (128) would not.  Two consumers share every K and V tile, so the
//   keys are read once per 128 query rows: twice the rows of one
//   warpgroup, half the L2 traffic, and one consumer's exps overlap the
//   other's products.  Columns of the last part past D are computed on
//   whatever its V slot holds and not stored;
// * pass 1 is the same for every part, so it runs once: a statistics
//   launch (kStatsPass, no V, no O) writes each row's (m, 1/l) to an fp32
//   (B, H, S) x 2 scratch, and lse when training; the part blocks
//   (!kStatsPass) run pass 2 only.  Products: parts + 2 score-sized
//   products of 2*B*H*S^2*D flops (5 at D = 384: three parts); exps:
//   parts + 1 a score;
// * warp 0 also feeds a 3-stage TMA ring with items of one or two 16 KB
//   tiles (128 rows x 64 columns), kRing items ahead: per key tile one item a
//   column block (K's block, and Q's block when Q does not stay), then in
//   pass 2 one item of the part's two V blocks.  Q (128 x D) stays in
//   shared memory while it fits beside the ring (D <= 512: 128 KB); above
//   that its column blocks are streamed beside K's, read again for every
//   key tile.  The key bias rides in the stage of a tile's last column
//   block.
// L2 bytes of a trunk call (B=128, S=512, 2 heads of 384): K once per 128
// rows per launch (1,024 statistics blocks and 3,072 part blocks, 393 KB
// each) and the part's V columns (131 KB): about 2.0 GB, against 0.24 TB
// for the kernel of a warp a row.
//
// Numerics: those of attn_fwd_sm90_kernel (exp2 on the SFU and a per-row
// reciprocal; the products summed in another order than the plain
// version), the same bf16 limits in chip_smoke.py.  Every part draws the
// same dropout mask (the hash of the true position) and uses the same (m,
// 1/l), the scratch's.

#pragma once

#include <cmath>
#include <cstdint>

#include "attention_sm90.cuh"

namespace stonkgs {
namespace attn90 {
namespace wide {

constexpr int kRows = 128;                        // query rows of a block, keys of a tile
constexpr int kCB = 64;                           // columns of a column block
constexpr int kPartBlocks = 2;                    // column blocks of an output part
constexpr int kPartCols = kCB * kPartBlocks;      // 128
constexpr int kRing = 3;                          // ring stages of two tiles
constexpr int kTileElems = kRows * kCB;           // a column block of a 128-row tile
constexpr uint32_t kTileBytes = kTileElems * 2;   // 16 KB
constexpr uint64_t kTileUnits = kTileBytes / 16;  // the same in descriptor units
constexpr int kBlockThreads = 2 * 128;            // two consumer warpgroups
// shared memory from its 1024-byte aligned start: the ring's barriers (full,
// empty) and Q's, the ring's key biases, then the ring's tiles and Q's
constexpr int kBiasOffset = 64;
constexpr int kTilesOffset = 2048;

// dynamic shared memory at nb column blocks, Q staying or streamed (1024
// bytes of alignment slack included)
inline size_t smem_bytes(int nb, bool q_stays) {
  return 1024 + kTilesOffset + size_t(2 * kRing + (q_stays ? nb : 0)) * kTileBytes;
}

// desc_sw<128>'s descriptor of the tile at shared-space address `addr` (its
// other fields: the leading offset and the 8-line stride of 1024 bytes, the
// 128-byte swizzle); built from a 32-bit address, so that a thread keeps
// one register for its tiles' addresses, not a 64-bit descriptor
__device__ __forceinline__ uint64_t desc_at(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// the next ring stage, and the phase parity of its barriers
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == kRing) {
    stage = 0;
    phase ^= 1u;
  }
}

}  // namespace wide

// kStatsPass: pass 1 alone, writing (m, 1/l) to stats (and lse); else pass
// 2 alone, reading them
template <bool kTrain, bool kStatsPass>
__global__ void __launch_bounds__(wide::kBlockThreads, 1)
attn_fwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const float* __restrict__ key_bias, bf16* __restrict__ out,
                          float* __restrict__ lse, float2* __restrict__ stats, int S, int H,
                          int D, int nb, int q_stays, float scale, Dropout drop) {
  using namespace wide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kRing;
  uint64_t* rowbar = empty + kRing;  // Q, when it stays
  float* bias = reinterpret_cast<float*>(base + kBiasOffset);
  bf16* ring = reinterpret_cast<bf16*>(base + kTilesOffset);
  bf16* qs = ring + 2 * kRing * kTileElems;  // Q's column blocks, when it stays
  const int parts = !kStatsPass ? (nb + kPartBlocks - 1) / kPartBlocks : 1;
  const int rb = blockIdx.x / parts, part = blockIdx.x - rb * parts;
  constexpr int kA = kRows / 2;  // registers of a thread's share of the 64 x 128 score tile
  const int q0 = rb * kRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 32);  // the feeding warp's lanes, lane 0 with the bytes
      mbar_init(&empty[s], 8);  // the consumers' warps
    }
    mbar_init(rowbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // The feeding warp (warp 0) loads the ring's items in the order the
  // consumers take them: per pass and key tile, K's column blocks (and
  // Q's, streamed), then in pass 2 the part's V blocks.  It runs kRing
  // items ahead: each item it releases, it refills with the one kRing
  // further, once the other warps have released it too.  A producer warp
  // of its own would make the block 288 threads, which ptxas holds to 168
  // registers a thread (as a 384-thread block): a 64 x 128 score tile and
  // an O part of 128 columns spilled there.
  const bool feeder = threadIdx.x < 32;
  const int lane = threadIdx.x % 32;
  const float* kb = key_bias ? key_bias + size_t(b) * S : nullptr;
  int f_pass = kStatsPass ? 1 : 2, f_j = 0, f_c = 0, f_stage = 0;  // the next item
  uint32_t f_phase = 0;
  float f_bias[kRows / 32];  // the key tile's bias, read at its first item
  auto feed = [&]() {
    if (f_pass > (kStatsPass ? 1 : 2)) return;
    mbar_wait(&empty[f_stage], f_phase ^ 1u);
    const int k0 = f_j * kRows;
    bf16* dst = ring + 2 * f_stage * kTileElems;
    uint64_t* bar = &full[f_stage];
    if (f_c < nb) {
      // the key tile's bias, read from global memory at its first column
      // block (off the warp's path: a block's loads take several items)
      // and stored with its last
      if (f_c == 0) {
#pragma unroll
        for (int t = 0; t < kRows / 32; ++t) {
          const int key = k0 + t * 32 + lane;
          f_bias[t] = key < S ? (kb ? __ldg(kb + key) : 0.f) : -INFINITY;
        }
      }
      if (f_c == nb - 1) {
#pragma unroll
        for (int t = 0; t < kRows / 32; ++t) bias[f_stage * kRows + t * 32 + lane] = f_bias[t];
      }
      if (lane == 0) {
        mbar_arrive_tx(bar, q_stays ? kTileBytes : 2 * kTileBytes);
        tma_load_4d(dst, &map_k, f_c * kCB, h, k0, b, bar);
        if (!q_stays) tma_load_4d(dst + kTileElems, &map_q, f_c * kCB, h, q0, b, bar);
      } else {
        mbar_arrive(bar);
      }
    } else if (lane == 0) {  // the part's V blocks; a block wholly past D is not loaded
      const int c0 = part * kPartBlocks, nv = min(kPartBlocks, nb - c0);
      mbar_arrive_tx(bar, uint32_t(nv) * kTileBytes);
      for (int t = 0; t < nv; ++t)
        tma_load_4d(dst + t * kTileElems, &map_v, (c0 + t) * kCB, h, k0, b, bar);
    } else {
      mbar_arrive(bar);
    }
    if (++f_c == nb + (f_pass == 2 ? 1 : 0)) {
      f_c = 0;
      if (++f_j == n_tiles) {
        f_j = 0;
        ++f_pass;
      }
    }
    advance(f_stage, f_phase);
    __syncwarp();  // reconverged before the warpgroup's next wgmma
  };
  if (feeder) {
    if (lane == 0 && q_stays) {
      mbar_arrive_tx(rowbar, uint32_t(nb) * kTileBytes);
      for (int c = 0; c < nb; ++c)
        tma_load_4d(qs + c * kTileElems, &map_q, c * kCB, h, q0, b, rowbar);
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
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // the thread's rows: row0, row0 + 8
  // shared addresses: the ring's first tile, and this warpgroup's 64 rows
  // of a Q tile (8 KB into it)
  const uint32_t ring_s = smem_u32(ring), wg_rows = uint32_t(wg) * (kTileBytes / 2);
  float acc[kA];  // the 64 x 128 score tile
  int stage = 0;
  uint32_t phase = 0;
  if (q_stays) mbar_wait(rowbar, 0);

  // s = (Q K^T) * scale + bias over the next key tile (nb ring items) into
  // acc; each item's stage is released once the products after it have
  // been issued and its own have completed.  acc is zeroed first, not
  // read: that ends its last tile's live range, so that it does not stay
  // live beside O and the packed P through P V.
  auto scores = [&]() {
    int prev = 0;
#pragma unroll
    for (int i = 0; i < kA; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int c = 0; c < nb; ++c) {
      mbar_wait(&full[stage], phase);
      const uint32_t k_s = ring_s + 2 * stage * kTileBytes;
      const uint64_t dk = desc_at(k_s);
      const uint64_t dq = desc_at(
          (q_stays ? ring_s + (2 * kRing + c) * kTileBytes : k_s + kTileBytes) + wg_rows);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kCB / 16; ++kk) wgmma_qk(acc, dq + 2 * kk, dk + 2 * kk, 1);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = stage;
      advance(stage, phase);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    const float* bs = bias + prev * kRows;
#pragma unroll
    for (int i = 0; i < kA; i += 2) {
      const float2 bv = *reinterpret_cast<const float2*>(bs + acc_col(i, lane));
      acc[i] = fmaf(acc[i], scale, bv.x);
      acc[i + 1] = fmaf(acc[i + 1], scale, bv.y);
    }
    release(prev);
  };

  const size_t srow = (size_t(b) * H + h) * S;  // (b, h, 0) of lse and stats
  if constexpr (kStatsPass) {
    // pass 1: each row's max m and sum l of exp(s - m), l kept per thread
    // and summed across the quad at the end (attn_fwd_sm90_kernel's)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int j = 0; j < n_tiles; ++j) {
      scores();
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kA; ++i) tmax[acc_row(i)] = fmaxf(tmax[acc_row(i)], acc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float m_new = fmaxf(m[r], tmax[r]);
        l[r] *= ex2((m[r] - m_new) * kLog2e);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kA; ++i) l[acc_row(i)] += ex2((acc[i] - m[acc_row(i)]) * kLog2e);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if constexpr (kTrain) {
        // the TPU kernel's s_pad - S padded keys at score -1e9
        const int n_pad = drop.s_pad - S;
        if (n_pad > 0) {
          const float m_new = fmaxf(m[r], kNegBias);
          l[r] = l[r] * expf(m[r] - m_new) + float(n_pad) * expf(kNegBias - m_new);
          m[r] = m_new;
        }
        if ((lane & 3) == 0 && row < S) lse[srow + row] = m[r] + logf(l[r]);
      }
      if ((lane & 3) == 0 && row < S) stats[srow + row] = make_float2(m[r], 1.f / l[r]);
    }
  } else {
    float m[2], inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float2 st = row < S ? stats[srow + row] : make_float2(0.f, 0.f);
      m[r] = st.x;
      inv_l[r] = st.y;
    }
    // pass 2: O (the part's columns) = P V, P = round_bf16(dropout(exp(s - m) / l))
    uint32_t rbase[2] = {0u, 0u};
    if constexpr (kTrain) {
      rbase[0] = drop.row_base(b * H + h, row0);
      rbase[1] = drop.row_base(b * H + h, row0 + 8);
    }
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * kRows;
      scores();
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        float p = ex2((acc[i] - m[acc_row(i)]) * kLog2e) * inv_l[acc_row(i)];
        if constexpr (kTrain) {
          if (drop.enabled)
            p = drop.keep(rbase[acc_row(i)] + uint32_t(k0 + acc_col(i, lane)))
                    ? p * drop.keep_scale
                    : 0.f;
        }
        acc[i] = p;
      }
      // the A fragments of k-step kk are registers 8kk .. 8kk+7, in pairs
      uint32_t pa[kA / 2];
#pragma unroll
      for (int t = 0; t < kA / 2; ++t) pa[t] = pack_bf16(acc[2 * t], acc[2 * t + 1]);
      mbar_wait(&full[stage], phase);
      const uint64_t dv = desc_at(ring_s + 2 * stage * kTileBytes);
      fence_regs(o);
      wgmma_fence();  // orders the writes of pa and o before the products read them
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {  // 16 keys = 16 lines = 128 units
        wgmma_pv_at<0>(o, pa + 4 * kk, dv + kk * 128);
        wgmma_pv_at<32>(o, pa + 4 * kk, dv + kTileUnits + kk * 128);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(stage);
      advance(stage, phase);
    }
    // epilogue: the part's columns < D of rows < S
    const int c0 = part * kPartCols;
    store_rows_sm90<kPartCols>(out + (size_t(b) * S * H + h) * D + c0, o, row0, S,
                               size_t(H) * D, D - c0, 1.f, lane);
  }
}

// --- host side --------------------------------------------------------------

// the calls of launch_fwd_wide_sm90 in this library that launched its
// kernels (the entry points export it as *_wide_calls: the route a check
// reads without a profiler)
inline int& wide_calls() {
  static int calls = 0;
  return calls;
}

template <bool kTrain, bool kStatsPass>
int launch_wide_pass(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                     dim3 grid, size_t smem, const float* key_bias, void* out, float* lse,
                     float2* stats, int S, int H, int D, int nb, int q_stays, float scale,
                     Dropout drop, cudaStream_t stream) {
  auto kernel = attn_fwd_wide_sm90_kernel<kTrain, kStatsPass>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kernel<<<grid, wide::kBlockThreads, smem, stream>>>(
      mq, mk, mv, key_bias, static_cast<bf16*>(out), lse, stats, S, H, D, nb, q_stays, scale, drop);
  return int(cudaGetLastError());
}

// The bf16 forward at D > 256 (a multiple of 8): the statistics launch into
// `stats`, a (B, H, S) x 2 fp32 scratch (required), then the part blocks
template <bool kTrain>
int launch_fwd_wide_sm90(const void* q, const void* k, const void* v, const float* key_bias,
                         void* out, float* lse, float* stats, int B, int S, int H, int D,
                         float scale, Dropout drop, cudaStream_t stream) {
  using namespace wide;
  if (B <= 0 || H <= 0 || S < 1 || B > 65535 || H > 65535 || D <= attn::kMaxHeadDim ||
      D % 8 != 0 || !stats)
    return int(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;  // boxes of 128 rows x 64 columns
  if (!make_map<128>(&mq, q, B, S, H, D) || !make_map<128>(&mk, k, B, S, H, D) ||
      !make_map<128>(&mv, v, B, S, H, D))
    return kErrTensorMap;
  const int nb = (D + kCB - 1) / kCB, parts = (nb + kPartBlocks - 1) / kPartBlocks;
  const bool q_stays = smem_bytes(nb, true) <= kMaxSmem;
  const size_t smem = smem_bytes(nb, q_stays);
  const unsigned row_blocks = unsigned((S + kRows - 1) / kRows);
  float2* st = reinterpret_cast<float2*>(stats);
  const dim3 part_grid(row_blocks * parts, H, B);
  int e = launch_wide_pass<kTrain, true>(mq, mk, mv, dim3(row_blocks, H, B), smem, key_bias,
                                         out, lse, st, S, H, D, nb, q_stays, scale, drop, stream);
  if (e == 0)
    e = launch_wide_pass<kTrain, false>(mq, mk, mv, part_grid, smem, key_bias, out, lse, st, S,
                                        H, D, nb, q_stays, scale, drop, stream);
  if (e == 0) ++wide_calls();
  return e;
}

}  // namespace attn90
}  // namespace stonkgs
