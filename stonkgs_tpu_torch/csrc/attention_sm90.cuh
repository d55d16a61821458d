// The bf16 attention forward for Hopper (sm_90a), shared by the inference
// and the training entry points (flash_attention_infer.cu and
// flash_attention_train.cu):
//
//   out = dropout(softmax(Q K^T * scale + key_bias)) V
//
// over (B, S, H, D) bf16 q, k, v and out, D = 16, 32 or 64 (a template
// parameter), with an optional (B, S) fp32 key bias; training also writes
// the fp32 logsumexp (B, H, S).
//
// Two passes over the keys, because the TPU kernels normalise the
// probabilities, drop them and only then round them to bf16 before P V
// (stonkgs_tpu/ops/flash_attention.py:92-115 and :359-385); the online
// softmax rounds before it normalises and cannot give the same numbers:
//   pass 1: S = Q K^T per 128-key tile; each row's running max m and sum l
//           of exp(s - m), s = S*scale + bias in fp32;
//   pass 2: S recomputed; p = exp(s - m) * (1/l), dropped and scaled when
//           training, rounded to bf16; O += P V in fp32.
// So the floor of this design is three products (QK^T twice, PV once:
// 6*B*H*S^2*D flops) and two exps a score (one per pass).  At D=64 one
// exp a score already costs the SFU (16 ex2 a clock an SM) about as much
// time as the two products of one pass cost the tensor cores: the kernel
// is bound by the SFU and the tensor cores together, above the bytes.
//
// Design (one block per 128 query rows of one (b, h); 384 threads):
// * warpgroup 2, the producer (setmaxnreg.dec): one warp streams the key
//   tiles through a ring of kStages stages with full/empty mbarriers; its
//   lane 0 issues TMA loads (one 4-D tensor map per tensor, dims (D, H, S,
//   B), box (D, 1, 128, 1), the swizzle of a row's width: a row of D bf16
//   is one line of 2D = 128, 64 or 32 bytes, and the wgmma descriptors
//   take the same swizzle), and its 32 lanes write the tile's 128 key biases into
//   the stage (-inf for keys >= S, which masks them; TMA zero-fills the
//   ragged last tile's rows).  Pass 1 streams K tiles, pass 2 K and V
//   tiles, through the same ring.  Q (128 x D) is loaded once.  The
//   tiles shrink with D (16 KB at 64, 4 KB at 16); the ring keeps its 3
//   stages at every D.
// * warpgroups 0 and 1, the consumers (setmaxnreg.inc), own 64 rows each,
//   the wgmma M.  S = Q K^T is wgmma.m64n128k16 (A = Q and B = the K tile
//   from shared memory, both K-major, D/16 k-steps).  O += P V is
//   wgmma.m64nDk16 with A = P from registers: the fp32 S accumulator,
//   packed to bf16 pairs, is already in the A-fragment layout; B = the V
//   tile, MN-major (the transpose bit), 8 k-steps over the 128 keys.
//   S and P never touch shared memory.  The softmax runs in registers:
//   a thread owns 2 rows x 32 columns of the 64 x 128 accumulator, and a
//   row's max and sum take two shuffles across the 4 lanes that share it.
//   One consumer's exp work overlaps the other's wgmma.  Within a
//   consumer the product and the softmax take turns: starting tile j+1's
//   product before tile j's softmax (a second 64-register score tile)
//   measured slower, because ptxas serialised the wgmma in flight across
//   the loop's branches (C7515, C7518) or spilled under the 168-register
//   cap of a 384-thread block (PERF.md, the attention forward redesign).
// * O is written from registers with 4-byte stores, rows >= S skipped.
//
// Numerics against the plain version (and the SIMT fp32 body of
// attention.cuh): the products accumulate in another order, each
// probability is exp2((s - m) * log2 e) on the SFU (ex2.approx) times a
// per-row reciprocal 1/l instead of an IEEE exp and a division per score.
// Each moves the fp32 probability by a few ulps at most, so its bf16
// rounding moves by at most one step where it sits at a rounding
// boundary: inside chip_smoke.py's TOL[bf16] and its output-scaled
// ATTN_STEP limit (one bf16 step of max |out| plus one of |out|).  s, m and the logsumexp stay
// in the natural domain, so a row whose keys all carry the -1e9 bias gets
// the same uniform probabilities (and lse) as the plain version.

#pragma once

#include <cmath>
#include <cstdint>

#include "attention.cuh"
#include "sm90.cuh"

namespace stonkgs {
namespace attn90 {

using namespace sm90;
using attn::Dropout;
using attn::kNegBias;
using attn::with_head_dim;

constexpr int kBM = 128;                  // query rows of a block
constexpr int kBN = 128;                  // keys of a tile
constexpr int kStages = 3;                // ring depth
constexpr int kConsumers = 2;             // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

// one 128 x D bf16 tile, in bytes
template <int kD> constexpr uint32_t kTileBytes = kBN * kD * 2;

// Shared memory, 1024-byte aligned tiles (aligned_smem).
template <int kD>
struct alignas(1024) Smem {
  bf16 q[kBM * kD];
  bf16 k[kStages][kBN * kD];
  bf16 v[kStages][kBN * kD];
  float bias[kStages][kBN];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t rowbar;  // the block's own tile (Q)
};
template <int kD>
constexpr size_t kSmemBytes = sizeof(Smem<kD>) + 1024;  // + alignment slack

// the barriers of a ring whose stages the producer warp's 32 lanes fill
// (lane 0 with the TMA bytes) and each consumer warp empties, and rowbar
// for the block's own tiles; shared by the forward and the backward
template <typename SmemT>
__device__ __forceinline__ void init_ring(SmemT& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], 4 * kConsumers);
    }
    mbar_init(&sm.rowbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// a warpgroup's 64 x D fp32 accumulator times `scale`, rounded, into rows
// row0 and row0 + 8 (< S) of a (B, S, H, D) tensor whose (b, 0, h, 0) is
// `base`: bf16 pairs straight from the accumulator
template <int kD>
__device__ __forceinline__ void store_rows_sm90(bf16* base, const float (&d)[kD / 2], int row0,
                                                int S, int H, float scale, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    bf16* dst = base + size_t(row) * H * kD;
#pragma unroll
    for (int i = 2 * r; i < kD / 2; i += 4)
      *reinterpret_cast<uint32_t*>(dst + acc_col(i, lane)) =
          pack_bf16(d[i] * scale, d[i + 1] * scale);
  }
}

// --- the kernel -------------------------------------------------------------

template <int kD, bool kTrain>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ key_bias, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int H, float scale, Dropout drop) {
  constexpr int kLine = 2 * kD;           // bytes of a row: the swizzle's width
  constexpr uint32_t kTile = kTileBytes<kD>;
  extern __shared__ unsigned char smem_raw[];
  Smem<kD>& sm = aligned_smem<Smem<kD>>(smem_raw);
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init_ring(sm);

  if (wg == kConsumers) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_tx(&sm.rowbar, kBM * kD * 2);
        tma_load_4d(sm.q, &map_q, 0, h, q0, b, &sm.rowbar);
      }
      const float* kb = key_bias ? key_bias + size_t(b) * S : nullptr;
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int stage = it % kStages;
        const bool pass2 = it >= n_tiles;
        const int k0 = (pass2 ? it - n_tiles : it) * kBN;
        mbar_wait(&sm.empty[stage], ((it / kStages) & 1) ^ 1);
#pragma unroll
        for (int t = 0; t < kBN / 32; ++t) {
          const int key = k0 + t * 32 + lane;
          sm.bias[stage][t * 32 + lane] =
              key < S ? (kb ? __ldg(kb + key) : 0.f) : -INFINITY;
        }
        if (lane == 0) {
          mbar_arrive_tx(&sm.full[stage], pass2 ? 2 * kTile : kTile);
          tma_load_4d(sm.k[stage], &map_k, 0, h, k0, b, &sm.full[stage]);
          if (pass2) tma_load_4d(sm.v[stage], &map_v, 0, h, k0, b, &sm.full[stage]);
        } else {
          mbar_arrive(&sm.full[stage]);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // the thread's rows: row0, row0 + 8
    const uint64_t dq = desc_sw<kLine>(sm.q + wg * 64 * kD);
    float acc[64];

    // S = Q K^T of the tile in `stage`, then s = S*scale + bias in place
    auto scores = [&](int stage) {
      const uint64_t dk = desc_sw<kLine>(sm.k[stage]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)  // 16 bf16 = 32 bytes = 2 descriptor units
        wgmma_qk(acc, dq + 2 * kk, dk + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      const float* bs = sm.bias[stage];
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const float2 bv = *reinterpret_cast<const float2*>(bs + acc_col(i, lane));
        acc[i] = fmaf(acc[i], scale, bv.x);
        acc[i + 1] = fmaf(acc[i + 1], scale, bv.y);
      }
    };
    mbar_wait(&sm.rowbar, 0);

    // pass 1: each row's max m and sum l of exp(s - m); l is kept per
    // thread (over its 32 columns, scaled by the row's shared m) and
    // summed across the quad at the end
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      mbar_wait(&sm.full[stage], (it / kStages) & 1);
      scores(stage);
      release_stage(&sm.empty[stage], lane);
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) tmax[acc_row(i)] = fmaxf(tmax[acc_row(i)], acc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float m_new = fmaxf(m[r], tmax[r]);
        l[r] *= ex2((m[r] - m_new) * kLog2e);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) l[acc_row(i)] += ex2((acc[i] - m[acc_row(i)]) * kLog2e);
    }
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if constexpr (kTrain) {
        // the TPU kernel's s_pad - S padded keys at score -1e9
        const int n_pad = drop.s_pad - S;
        if (n_pad > 0) {
          const float m_new = fmaxf(m[r], kNegBias);
          l[r] = l[r] * expf(m[r] - m_new) + float(n_pad) * expf(kNegBias - m_new);
          m[r] = m_new;
        }
        const int row = row0 + 8 * r;
        if ((lane & 3) == 0 && row < S) lse[(size_t(b) * H + h) * S + row] = m[r] + logf(l[r]);
      }
      inv_l[r] = 1.f / l[r];
    }

    // pass 2: O = P V, P = round_bf16(dropout(exp(s - m) / l))
    uint32_t base[2] = {0u, 0u};
    if constexpr (kTrain) {
      base[0] = drop.row_base(b * H + h, row0);
      base[1] = drop.row_base(b * H + h, row0 + 8);
    }
    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
      const int it = n_tiles + j, stage = it % kStages, k0 = j * kBN;
      mbar_wait(&sm.full[stage], (it / kStages) & 1);
      scores(stage);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float p = ex2((acc[i] - m[acc_row(i)]) * kLog2e) * inv_l[acc_row(i)];
        if constexpr (kTrain) {
          if (drop.enabled)
            p = drop.keep(base[acc_row(i)] + uint32_t(k0 + acc_col(i, lane))) ? p * drop.keep_scale
                                                                               : 0.f;
        }
        acc[i] = p;
      }
      // the A fragments of k-step kk are registers 8kk .. 8kk+7, in pairs
      uint32_t pa[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) pa[t] = pack_bf16(acc[2 * t], acc[2 * t + 1]);
      const uint64_t dv = desc_sw<kLine>(sm.v[stage]);
      fence_regs(o);
      wgmma_fence();  // orders the writes of pa and o before the products read them
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv(o, pa + 4 * kk, dv + kk * kLine);  // 16 keys = 16 lines = kLine units
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release_stage(&sm.empty[stage], lane);
    }

    // epilogue: O rows < S
    store_rows_sm90<kD>(out + (size_t(b) * S * H + h) * kD, o, row0, S, H, 1.f, lane);
  }
}

// --- host side --------------------------------------------------------------

// 4-D map of a (B, S, H, D) bf16 tensor: dims (D, H, S, B), box (D, 1,
// 128, 1), the swizzle of a 2D-byte row
inline bool make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t row = cuuint64_t(D) * 2;  // bytes of one (b, s, h) row
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {cuuint32_t(D), 1, kBN, 1};
  return encode_map(map, MapType<bf16>::kType, base, 4, dims, strides, box,
                    swizzle_of(int(row)));
}

template <bool kTrain>
int launch_fwd_sm90(const void* q, const void* k, const void* v, const float* key_bias,
                    void* out, float* lse, int B, int S, int H, int D, float scale,
                    Dropout drop, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || S < 1 || B > 65535 || H > 65535) return int(cudaErrorInvalidValue);
  return with_head_dim(D, [&](auto d) {
    constexpr int kDh = decltype(d)::value;
    CUtensorMap mq, mk, mv;
    if (!make_map(&mq, q, B, S, H, kDh) || !make_map(&mk, k, B, S, H, kDh) ||
        !make_map(&mv, v, B, S, H, kDh))
      return kErrTensorMap;
    constexpr size_t smem = kSmemBytes<kDh>;
    cudaError_t e = cudaFuncSetAttribute(attn_fwd_sm90_kernel<kDh, kTrain>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const dim3 grid((S + kBM - 1) / kBM, H, B);
    attn_fwd_sm90_kernel<kDh, kTrain><<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, key_bias, static_cast<bf16*>(out), lse, S, H, scale, drop);
    return int(cudaGetLastError());
  });
}

}  // namespace attn90
}  // namespace stonkgs
