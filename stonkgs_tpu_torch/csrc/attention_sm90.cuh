// The bf16 attention forward for Hopper (sm_90a), shared by the inference
// and the training entry points (flash_attention_infer.cu and
// flash_attention_train.cu):
//
//   out = dropout(softmax(Q K^T * scale + key_bias)) V
//
// over (B, S, H, D=64) bf16 q, k, v and out, with an optional (B, S) fp32
// key bias; training also writes the fp32 logsumexp (B, H, S).
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
//   B), box (64, 1, 128, 1), 128-byte swizzle: a row of 64 bf16 is one
//   128-byte line), and its 32 lanes write the tile's 128 key biases into
//   the stage (-inf for keys >= S, which masks them; TMA zero-fills the
//   ragged last tile's rows).  Pass 1 streams K tiles, pass 2 K and V
//   tiles, through the same ring.  Q (128 x 64) is loaded once.
// * warpgroups 0 and 1, the consumers (setmaxnreg.inc), own 64 rows each,
//   the wgmma M.  S = Q K^T is wgmma.m64n128k16 (A = Q and B = the K tile
//   from shared memory, both K-major, 4 k-steps over D).  O += P V is
//   wgmma.m64n64k16 with A = P from registers: the fp32 S accumulator,
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

#include <cuda.h>  // CUtensorMap and its enums (the driver is reached through the runtime)

#include <cmath>
#include <cstdint>

#include "attention.cuh"

namespace stonkgs {
namespace attn90 {

using attn::Dropout;
using attn::kD;
using attn::kNegBias;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                  // query rows of a block
constexpr int kBN = 128;                  // keys of a tile
constexpr int kStages = 3;                // ring depth
constexpr int kConsumers = 2;             // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kTileBytes = kBN * kD * 2;  // one 128 x 64 bf16 tile, 16 KB
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, 1024-byte aligned tiles (the 128-byte swizzle repeats
// every 8 lines, and the wgmma descriptors assume base offset 0).
struct alignas(1024) Smem {
  bf16 q[kBM * kD];
  bf16 k[kStages][kBN * kD];
  bf16 v[kStages][kBN * kD];
  float bias[kStages][kBN];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t qbar;
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

// --- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase with the given parity has completed; a
// wait far longer than any tile load (a fault in the ring's protocol)
// traps, so that the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: a (64, 1, 128, 1) box at (0, h, s0, b) of a 4-D map -> shared
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int h, int s0, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(s0), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte lines with the
// 128-byte swizzle: start address, leading offset (unused by K-major
// swizzled operands; for the MN-major V it would step between 64-wide
// atoms, of which V has one), stride 1024 bytes between 8-line groups.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(64) << 16) | (uint64_t(64) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator accesses across the async products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define STONKGS_ACC8(d, i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) (+)= A (64 x 16, desc) . B^T (B 128 x 16, desc), both K-major
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : STONKGS_ACC8(d, 0), STONKGS_ACC8(d, 8), STONKGS_ACC8(d, 16), STONKGS_ACC8(d, 24),
        STONKGS_ACC8(d, 32), STONKGS_ACC8(d, 40), STONKGS_ACC8(d, 48), STONKGS_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, fp32) += A (64 x 16 bf16, registers) . B (16 x 64, desc, MN-major)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : STONKGS_ACC8(d, 0), STONKGS_ACC8(d, 8), STONKGS_ACC8(d, 16), STONKGS_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef STONKGS_ACC8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator layout of a wgmma with M = 64 (PTX ISA, wgmma D
// fragments): in warp w of the warpgroup, lane l, register i holds
//   row 16w + l/4 + 8*((i/2) % 2),  column 8*(i/4) + 2*(l%4) + i%2.
// The key mask, the bias, the padded keys and the dropout index all use
// this map; a register pair (2j, 2j+1) is also one bf16x2 of the A
// fragment of the next product (columns 16kk.. of S are k-step kk).
__device__ __forceinline__ int acc_row(int i) { return (i >> 1) & 1; }  // + l/4 + 16w
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// --- the kernel -------------------------------------------------------------

template <bool kTrain>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ key_bias, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int H, float scale, Dropout drop) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);                // the producer warp's lanes (+ TMA bytes)
      mbar_init(&sm.empty[s], 4 * kConsumers);   // one arrival per consumer warp
    }
    mbar_init(&sm.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_tx(&sm.qbar, kBM * kD * 2);
        tma_load(sm.q, &map_q, h, q0, b, &sm.qbar);
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
          mbar_arrive_tx(&sm.full[stage], pass2 ? 2 * kTileBytes : kTileBytes);
          tma_load(sm.k[stage], &map_k, h, k0, b, &sm.full[stage]);
          if (pass2) tma_load(sm.v[stage], &map_v, h, k0, b, &sm.full[stage]);
        } else {
          mbar_arrive(&sm.full[stage]);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // the thread's rows: row0, row0 + 8
    const uint64_t dq = desc_sw128(sm.q + wg * 64 * kD);
    float acc[64];

    // S = Q K^T of the tile in `stage`, then s = S*scale + bias in place
    auto scores = [&](int stage) {
      const uint64_t dk = desc_sw128(sm.k[stage]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)  // 16 bf16 = 32 bytes = 2 descriptor units
        wgmma_qk(acc, dq + 2 * kk, dk + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      const float* bs = sm.bias[stage];
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const float2 bv = *reinterpret_cast<const float2*>(bs + acc_col(i, lane));
        acc[i] = fmaf(acc[i], scale, bv.x);
        acc[i + 1] = fmaf(acc[i + 1], scale, bv.y);
      }
    };
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
    };

    mbar_wait(&sm.qbar, 0);

    // pass 1: each row's max m and sum l of exp(s - m); l is kept per
    // thread (over its 32 columns, scaled by the row's shared m) and
    // summed across the quad at the end
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      mbar_wait(&sm.full[stage], (it / kStages) & 1);
      scores(stage);
      release(stage);
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
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
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
      const uint64_t dv = desc_sw128(sm.v[stage]);
      fence_regs(o);
      wgmma_fence();  // orders the writes of pa and o before the products read them
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv(o, pa + 4 * kk, dv + kk * (16 * 128 / 16));  // 16 keys = 16 lines of 128 B
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      release(stage);
    }

    // epilogue: O rows < S, bf16 pairs straight from the accumulator
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      bf16* dst = out + ((size_t(b) * S + row) * H + h) * kD;
#pragma unroll
      for (int i = 2 * r; i < 32; i += 4)
        *reinterpret_cast<uint32_t*>(dst + acc_col(i, lane)) = pack_bf16(o[i], o[i + 1]);
    }
  }
}

// --- host side --------------------------------------------------------------

// returned when a TMA tensor map cannot be encoded (no cudaError_t is negative;
// ops/_build.py names it)
constexpr int kErrTensorMap = -1;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda)
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    const bool ok = e == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// 4-D map of a (B, S, H, 64) bf16 tensor: dims (64, H, S, B), box (64, 1, 128, 1)
inline bool make_map(CUtensorMap* map, const void* base, int B, int S, int H) {
  const EncodeTiled encode = encode_fn();
  if (!encode) return false;
  const cuuint64_t dims[4] = {cuuint64_t(kD), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t row = kD * 2;  // bytes of one (b, s, h) row
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {kD, 1, kBN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kTrain>
int launch_fwd_sm90(const void* q, const void* k, const void* v, const float* key_bias,
                    void* out, float* lse, int B, int S, int H, float scale, Dropout drop,
                    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || S < 1 || B > 65535 || H > 65535) return int(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, H) || !make_map(&mk, k, B, S, H) || !make_map(&mv, v, B, S, H))
    return kErrTensorMap;
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_sm90_kernel<kTrain>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(kSmemBytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((S + kBM - 1) / kBM, H, B);
  attn_fwd_sm90_kernel<kTrain><<<grid, kThreads, kSmemBytes, stream>>>(
      mq, mk, mv, key_bias, static_cast<bf16*>(out), lse, S, H, scale, drop);
  return int(cudaGetLastError());
}

}  // namespace attn90
}  // namespace stonkgs
