// The bf16 attention forward for Hopper (sm_90a), shared by the inference
// and the training entry points (flash_attention_infer.cu and
// flash_attention_train.cu):
//
//   out = dropout(softmax(Q K^T * scale + key_bias)) V
//
// over (B, S, H, D) bf16 q, k, v and out, D a multiple of 8 from 8 to 256,
// with an optional (B, S) fp32 key bias; training also writes the fp32
// logsumexp (B, H, S).
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
// is bound by the SFU and the tensor cores together, above the bytes.  At
// D=128 the products double and the exps a product halve: the tensor
// cores bound it.
//
// Head widths: the kernel is instantiated at the padded widths P = 16, 32,
// 64, 128 and 256 (a template parameter), and a head width D runs on the
// smallest P >= D.  The tensor maps' dim 0 is D itself and their boxes P
// wide (Width<P>), so TMA zero-fills the columns from D to P: they add
// nothing to Q K^T, and the columns of O past D are computed on zeros and
// not stored.  A row of P bf16 is stored as P/64 column blocks of 64 (at P
// = 128 and 256) or one block of P, each block a line of at most 128 bytes
// with the swizzle of its width (TMA's and wgmma's widest is 128 bytes): a
// tile is its column blocks one after the other, each a line per row.
//
// The wide instance, P = 256 (Width<256>::kWide).  A consumer's O
// accumulator is 64 x 256 fp32, 128 registers a thread: beside the score
// tile it spills under the 168 registers ptxas gives a thread of a
// 384-thread block, and a stage of 128 keys of K and V is 128 KB.  So a
// block there has one consumer warpgroup of 64 query rows (256 threads,
// 255 registers a thread), the tiles are 64 rows (64 keys a stage: K and V
// 64 KB, three stages beside Q's 32 KB in 225 KB), S is wgmma.m64n64k16
// and O += P V four m64n64k16 products a k-step, one a column block.
//
// Design (one block per 128 query rows of one (b, h); 384 threads; at P =
// 256 64 rows and 256 threads, as above):
// * warpgroup 2, the producer (setmaxnreg.dec): one warp streams the key
//   tiles through a ring of kStages stages with full/empty mbarriers; its
//   lane 0 issues TMA loads (one 4-D tensor map per tensor, dims (D, H, S,
//   B), box (P or 64, 1, 128, 1): one load a column block), and its 32
//   lanes write the tile's 128 key biases into the stage (-inf for keys
//   >= S, which masks them; TMA zero-fills the ragged last tile's rows).
//   Pass 1 streams K tiles, pass 2 K and V tiles, through the same ring.
//   Q (128 x P) is loaded once.  The tiles shrink with P (16 KB at 64, 4
//   KB at 16, 32 KB at 128); the ring keeps its 3 stages at every P (at
//   128 they fill the 227 KB a block may take).
// * warpgroups 0 and 1, the consumers (setmaxnreg.inc), own 64 rows each,
//   the wgmma M.  S = Q K^T is wgmma.m64n128k16 (A = Q and B = the K tile
//   from shared memory, both K-major, P/16 k-steps, the steps past 64
//   columns in the second column block).  O += P V is wgmma.m64nPk16
//   with A = P from registers: the fp32 S accumulator,
//   packed to bf16 pairs, is already in the A-fragment layout; B = the V
//   tile, MN-major (the transpose bit), 8 k-steps over the 128 keys (at P
//   = 128 two m64n64k16 products a k-step, one a column block, into the
//   two halves of the accumulator).
//   S and P never touch shared memory.  The softmax runs in registers:
//   a thread owns 2 rows x 32 columns of the 64 x 128 accumulator, and a
//   row's max and sum take two shuffles across the 4 lanes that share it.
//   One consumer's exp work overlaps the other's wgmma.  Within a
//   consumer the product and the softmax take turns: starting tile j+1's
//   product before tile j's softmax (a second 64-register score tile)
//   measured slower, because ptxas serialised the wgmma in flight across
//   the loop's branches (C7515, C7518) or spilled under the 168-register
//   cap of a 384-thread block (PERF.md, the attention forward redesign).
// * O is written from registers with 4-byte stores, rows >= S and columns
//   >= D skipped.
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
using attn::with_padded_head_dim;

constexpr int kBM = 128;                  // query rows of a block (P <= 128)
constexpr int kBN = 128;                  // keys of a tile (P <= 128)
constexpr int kStages = 3;                // the forward's ring depth
constexpr int kConsumers = 2;             // consumer warpgroups, 64 rows each (P <= 128)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;       // shared memory a block may take

// The block shape and tile layout at padded width kP.  A tile is kRows
// rows (the block's query rows, and a stage's keys): 128 up to P = 128,
// 64 in the wide instance (P = 256), whose block has one consumer
// warpgroup.  A tile is kNB column blocks of kCB columns, each kRows lines
// of kLine bytes with that swizzle, one after the other.  Descriptors step
// by kBlock units from one column block to the next.
template <int kP>
struct Width {
  static constexpr bool kWide = kP > 128;
  static constexpr int kNC = kWide ? 1 : kConsumers;  // consumer warpgroups, 64 rows each
  static constexpr int kRows = 64 * kNC;              // rows of a tile
  static constexpr int kThreads = 128 * (kNC + 1);
  static constexpr int kCB = kP < 64 ? kP : 64;   // columns of a block
  static constexpr int kNB = kP / kCB;            // column blocks
  static constexpr int kLine = 2 * kCB;           // bytes of a line: the swizzle's width
  static constexpr int kSteps = kCB / 16;         // k16 steps in a block
  static constexpr uint64_t kBlock = uint64_t(kRows) * kLine / 16;
  static constexpr uint32_t kTileBytes = kRows * kP * 2;

  // the descriptor of k-step kk (columns 16kk .. 16kk + 15) of a K-major
  // operand whose first column block has descriptor d0
  static __device__ __forceinline__ uint64_t kstep(uint64_t d0, int kk) {
    return d0 + uint64_t(kk / kSteps) * kBlock + 2 * (kk % kSteps);
  }

  // d (64 x kN, fp32) += A (64 x 16 bf16, registers) . B (16 x kN,
  // MN-major): B's column block at descriptor db and the kN / kCB - 1
  // after it, one m64n64k16 product a block into its 32 registers of d
  // (kN = kP, all of B; or, in the wide dK/dV kernel, 128, half of it)
  template <int kN = kP>
  static __device__ __forceinline__ void mma_rows(float (&d)[kN / 2], const uint32_t* a,
                                                  uint64_t db) {
    if constexpr (kNB == 1) {
      wgmma_pv(d, a, db);
    } else {
      blocks<kN / kCB>(d, a, db);
    }
  }
  template <int kN, int nb = 0, int R>
  static __device__ __forceinline__ void blocks(float (&d)[R], const uint32_t* a, uint64_t db) {
    if constexpr (nb < kN) {
      wgmma_pv_at<32 * nb>(d, a, db + nb * kBlock);
      blocks<kN, nb + 1>(d, a, db);
    }
  }

  // S (64 x kRows, fp32) (+)= A (64 x 16, desc) . B^T (B kRows x 16, desc),
  // both K-major: one k-step of the scores over a key tile
  static __device__ __forceinline__ void qk(float (&d)[kRows / 2], uint64_t da, uint64_t db,
                                            int acc) {
    if constexpr (kRows == 128) wgmma_qk(d, da, db, acc);
    else wgmma_qk64(d, da, db, acc);
  }

  // TMA: a kRows-row tile at rows (row0, h, b) of `map` into `dst`, one box
  // a column block, completing on `bar`
  static __device__ __forceinline__ void load(bf16* dst, const CUtensorMap* map, int h, int row0,
                                              int b, uint64_t* bar) {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
      tma_load_4d(dst + nb * kRows * kCB, map, nb * kCB, h, row0, b, bar);
  }
};

// Shared memory, 1024-byte aligned tiles (aligned_smem).
template <int kP>
struct alignas(1024) Smem {
  static constexpr int kRing = kStages;
  static constexpr int kRows = Width<kP>::kRows;
  bf16 q[kRows * kP];
  bf16 k[kRing][kRows * kP];
  bf16 v[kRing][kRows * kP];
  float bias[kRing][kRows];
  uint64_t full[kRing];
  uint64_t empty[kRing];
  uint64_t rowbar;  // the block's own tile (Q)
};
template <int kP>
constexpr size_t kSmemBytes = sizeof(Smem<kP>) + 1024;  // + alignment slack
static_assert(kSmemBytes<128> <= kMaxSmem, "the forward's ring fits at P = 128");
static_assert(kSmemBytes<256> <= kMaxSmem, "the forward's ring fits at P = 256");

// the barriers of a ring whose stages the producer warp's 32 lanes fill
// (lane 0 with the TMA bytes) and each warp of the NC consumer warpgroups
// empties, and rowbar for the block's own tiles; shared by the forward
// and the backward
template <int NC = kConsumers, typename SmemT>
__device__ __forceinline__ void init_ring(SmemT& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < SmemT::kRing; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], 4 * NC);
    }
    mbar_init(&sm.rowbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// a warpgroup's 64 x kN fp32 accumulator times `scale`, rounded, into rows
// row0 and row0 + 8 (< S), columns < cols, of rows `ld` elements apart
// from `base` (a (B, S, H, D) tensor's (b, 0, h, c0): ld = H*D, cols = D -
// c0): bf16 pairs straight from the accumulator
template <int kN>
__device__ __forceinline__ void store_rows_sm90(bf16* base, const float (&d)[kN / 2], int row0,
                                                int S, size_t ld, int cols, float scale,
                                                int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    bf16* dst = base + size_t(row) * ld;
#pragma unroll
    for (int i = 2 * r; i < kN / 2; i += 4) {
      const int col = acc_col(i, lane);  // even; cols is a multiple of 8
      if (col < cols)
        *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(d[i] * scale, d[i + 1] * scale);
    }
  }
}

// --- the kernel -------------------------------------------------------------

template <int kP, bool kTrain>
__global__ void __launch_bounds__(Width<kP>::kThreads, 1)
attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ key_bias, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int D, float scale, Dropout drop) {
  using W = Width<kP>;
  using SmemT = Smem<kP>;
  constexpr int kRing = SmemT::kRing;
  constexpr int kR = W::kRows;  // query rows of the block, keys of a tile
  constexpr int NC = W::kNC;
  constexpr uint32_t kTile = W::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  SmemT& sm = aligned_smem<SmemT>(smem_raw);
  const int q0 = blockIdx.x * kR, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + kR - 1) / kR;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init_ring<NC>(sm);

  if (wg == NC) {
    // ---------------- producer ----------------
    if constexpr (NC == kConsumers) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_tx(&sm.rowbar, kTile);
        W::load(sm.q, &map_q, h, q0, b, &sm.rowbar);
      }
      const float* kb = key_bias ? key_bias + size_t(b) * S : nullptr;
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int stage = it % kRing;
        const bool pass2 = it >= n_tiles;
        const int k0 = (pass2 ? it - n_tiles : it) * kR;
        mbar_wait(&sm.empty[stage], ((it / kRing) & 1) ^ 1);
#pragma unroll
        for (int t = 0; t < kR / 32; ++t) {
          const int key = k0 + t * 32 + lane;
          sm.bias[stage][t * 32 + lane] =
              key < S ? (kb ? __ldg(kb + key) : 0.f) : -INFINITY;
        }
        if (lane == 0) {
          mbar_arrive_tx(&sm.full[stage], pass2 ? 2 * kTile : kTile);
          W::load(sm.k[stage], &map_k, h, k0, b, &sm.full[stage]);
          if (pass2) W::load(sm.v[stage], &map_v, h, k0, b, &sm.full[stage]);
        } else {
          mbar_arrive(&sm.full[stage]);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    if constexpr (NC == kConsumers) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // the thread's rows: row0, row0 + 8
    const uint64_t dq = desc_sw<W::kLine>(sm.q + wg * 64 * W::kCB);
    constexpr int kA = kR / 2;  // score accumulator registers: 64 x kR
    float acc[kA];

    // S = Q K^T of the tile in `stage`, then s = S*scale + bias in place
    auto scores = [&](int stage) {
      const uint64_t dk = desc_sw<W::kLine>(sm.k[stage]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk)
        W::qk(acc, W::kstep(dq, kk), W::kstep(dk, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      const float* bs = sm.bias[stage];
#pragma unroll
      for (int i = 0; i < kA; i += 2) {
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
      const int stage = it % kRing;
      mbar_wait(&sm.full[stage], (it / kRing) & 1);
      scores(stage);
      release_stage(&sm.empty[stage], lane);
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
    float o[kP / 2];
#pragma unroll
    for (int i = 0; i < kP / 2; ++i) o[i] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
      const int it = n_tiles + j, stage = it % kRing, k0 = j * kR;
      mbar_wait(&sm.full[stage], (it / kRing) & 1);
      scores(stage);
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        float p = ex2((acc[i] - m[acc_row(i)]) * kLog2e) * inv_l[acc_row(i)];
        if constexpr (kTrain) {
          if (drop.enabled)
            p = drop.keep(base[acc_row(i)] + uint32_t(k0 + acc_col(i, lane))) ? p * drop.keep_scale
                                                                               : 0.f;
        }
        acc[i] = p;
      }
      // the A fragments of k-step kk are registers 8kk .. 8kk+7, in pairs
      uint32_t pa[kA / 2];
#pragma unroll
      for (int t = 0; t < kA / 2; ++t) pa[t] = pack_bf16(acc[2 * t], acc[2 * t + 1]);
      const uint64_t dv = desc_sw<W::kLine>(sm.v[stage]);
      fence_regs(o);
      wgmma_fence();  // orders the writes of pa and o before the products read them
#pragma unroll
      for (int kk = 0; kk < kR / 16; ++kk)
        W::mma_rows(o, pa + 4 * kk, dv + kk * W::kLine);  // 16 keys = 16 lines = kLine units
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release_stage(&sm.empty[stage], lane);
    }

    // epilogue: O rows < S, columns < D
    store_rows_sm90<kP>(out + (size_t(b) * S * H + h) * D, o, row0, S, size_t(H) * D, D, 1.f,
                        lane);
  }
}

// --- host side --------------------------------------------------------------

// 4-D map of a (B, S, H, D) bf16 tensor for tiles of padded width kP: dims
// (D, H, S, B), box (kCB, 1, kRows, 1) with the swizzle of a kCB-wide line;
// the columns of a box past D read as zero
template <int kP>
inline bool make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D) {
  using W = Width<kP>;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t row = cuuint64_t(D) * 2;  // bytes of one (b, s, h) row
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {cuuint32_t(W::kCB), 1, cuuint32_t(W::kRows), 1};
  return encode_map(map, MapType<bf16>::kType, base, 4, dims, strides, box,
                    swizzle_of(W::kLine));
}

template <bool kTrain>
int launch_fwd_sm90(const void* q, const void* k, const void* v, const float* key_bias,
                    void* out, float* lse, int B, int S, int H, int D, float scale,
                    Dropout drop, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || S < 1 || B > 65535 || H > 65535) return int(cudaErrorInvalidValue);
  return with_padded_head_dim(D, [&](auto p) {
    constexpr int kP = decltype(p)::value;
    CUtensorMap mq, mk, mv;
    if (!make_map<kP>(&mq, q, B, S, H, D) || !make_map<kP>(&mk, k, B, S, H, D) ||
        !make_map<kP>(&mv, v, B, S, H, D))
      return kErrTensorMap;
    constexpr size_t smem = kSmemBytes<kP>;
    cudaError_t e = cudaFuncSetAttribute(attn_fwd_sm90_kernel<kP, kTrain>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    using W = Width<kP>;
    const dim3 grid((S + W::kRows - 1) / W::kRows, H, B);
    attn_fwd_sm90_kernel<kP, kTrain><<<grid, W::kThreads, smem, stream>>>(
        mq, mk, mv, key_bias, static_cast<bf16*>(out), lse, S, H, D, scale, drop);
    return int(cudaGetLastError());
  });
}

}  // namespace attn90
}  // namespace stonkgs
