// The bf16 training FFN for Hopper (sm_90a), launched by ffn_train.cu.
//
// Forward, y = round(round(gelu(x @ W1 + b1)) @ W2 + b2): the serving
// block's two GEMMs without its LayerNorms (ffn_sm90.cuh,
// launch_ffn_gemms), h (M, I) through a bf16 scratch of the caller.
//
// Backward, from x, the cotangent g (both (M, H)), W1 (H, I), b1 and W2
// (I, H), each read as it lies (no transposed copies), two launches:
//
//   dual GEMM, a 128 x 128 tile of (M, I) a block, K = H:
//     Hx = x @ W1[:, tile]     A = x K-major, B = W1 MN-major (two 64 x 64
//                              TMA boxes, as the forward's W)
//     P  = g @ W2[tile, :]^T   A = g K-major, B = W2 K-major (one box of
//                              128 lines of 64 H values)
//     h = Hx + b1 (fp32, never stored), a = round(gelu(h)),
//     dh = round(P * gelu'(h))                   ffn_bwd_dual_sm90_kernel
//   dx = round(dh @ W1^T)      A = dh (M, I) K-major, B = W1 (H, I)
//                              K-major; no bias   gemm_sm90_kernel<kNoAct, true>
//
// Rounding points as the TPU kernel (stonkgs_tpu/ops/fused_ffn.py:206-250):
// h, gelu and gelu' in fp32; a rounded; dh rounded before the dx product.
// dW1 = x^T dh, dW2 = a^T g and the bias sums are the caller's, as the TPU
// kernel leaves them to XLA.
//
// The dual GEMM's block is the serving GEMM's (ffn_sm90.cuh): a producer
// warpgroup (setmaxnreg.dec) streams, per 64-deep K step, x's and g's 128 x
// 64 tiles and W1's and W2's 64 x 128 tiles (64 KB) through a 3-stage TMA
// ring; two consumer warpgroups (setmaxnreg.inc), 64 rows each, issue per
// step four wgmma.m64n128k16 into each of two fp32 accumulators (Hx and P,
// 64 registers each: the serving GEMM's one m64n256; Hx starts at b1).
// Both accumulators have the same register map, so the epilogue pairs
// h[i] with P[i]: it computes gelu and gelu' together without branches
// (gelu_grad_sel), writes a and dh as bf16 pairs into the free ring, and
// stores them with TMA.  TMA zero-fills a ragged M, I or H edge of the
// loads and skips it in the stores; the tensor maps take the true widths
// and the padded layout's row strides (ffn_sm90.cuh), so the same holds
// for an H or I that is not a multiple of 8.

#pragma once

#include "ffn_sm90.cuh"

namespace stonkgs {
namespace ffn90 {

constexpr int kDualBN = 128;  // intermediate columns of a dual tile
constexpr int kDualStages = 3;
constexpr uint32_t kDualStepBytes = 2 * kBM * kBK * 2 + 2 * kBK * kDualBN * 2;  // 64 KB

struct alignas(1024) SmemDual {
  bf16 x[kDualStages][kBM * kBK];
  bf16 g[kDualStages][kBM * kBK];
  bf16 w1[kDualStages][kBK * kDualBN];  // two 64-wide column blocks of kBK lines (MN-major)
  bf16 w2[kDualStages][kDualBN * kBK];  // kDualBN lines of kBK values (K-major)
  uint64_t full[kDualStages];
  uint64_t empty[kDualStages];
};
constexpr size_t kDualSmemBytes = sizeof(SmemDual) + 1024;  // + alignment slack

// a = round(gelu(x @ W1 + b1)), dh = round((g @ W2^T) * gelu'(x @ W1 + b1))
// over a 128 x 128 tile of (M, I); kAct 0 gelu (erf), 1 gelu_new (tanh)
template <int kAct>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_dual_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_g,
                         const __grid_constant__ CUtensorMap map_w1,
                         const __grid_constant__ CUtensorMap map_w2,
                         const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_dh,
                         const float* __restrict__ b1, int M, int I, int H) {
  extern __shared__ unsigned char smem_raw[];
  SmemDual& sm = aligned_smem<SmemDual>(smem_raw);
  const int n0 = blockIdx.x * kDualBN, m0 = blockIdx.y * kBM;
  const int nk = (H + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDualStages; ++s) {
      mbar_init(&sm.full[s], 1);                // the producer thread (+ TMA bytes)
      mbar_init(&sm.empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0 && lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int stage = kt % kDualStages;
        uint64_t* full = &sm.full[stage];
        mbar_wait(&sm.empty[stage], ((kt / kDualStages) & 1) ^ 1);
        mbar_arrive_tx(full, kDualStepBytes);
        tma_load_2d(sm.x[stage], &map_x, kt * kBK, m0, full);
        tma_load_2d(sm.g[stage], &map_g, kt * kBK, m0, full);
#pragma unroll
        for (int j = 0; j < kDualBN / 64; ++j)
          tma_load_2d(sm.w1[stage] + j * (kBBlock / 2), &map_w1, n0 + 64 * j, kt * kBK, full);
        tma_load_2d(sm.w2[stage], &map_w2, kt * kBK, n0, full);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // x W1 accumulates onto b1 (as the GEMM's products onto its bias)
    float hx[64], pg[64];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const float2 bv = bias_pair(b1, n0 + acc_col(i, lane), I);
      hx[i] = bv.x;
      hx[i + 1] = bv.y;
      pg[i] = pg[i + 1] = 0.f;
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int stage = kt % kDualStages;
      mbar_wait(&sm.full[stage], (kt / kDualStages) & 1);
      const uint64_t ax = desc_sw128(sm.x[stage] + wg * 64 * kBK);
      const uint64_t ag = desc_sw128(sm.g[stage] + wg * 64 * kBK);
      const uint64_t bw1 = desc_sw128(sm.w1[stage], kBBlock);
      const uint64_t bw2 = desc_sw128(sm.w2[stage]);
      fence_regs(hx);
      fence_regs(pg);
      wgmma_fence();
      // A and the K-major W2: 16 bf16 = 2 descriptor units; the MN-major W1: 16 lines
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_n128<1>(hx, ax + 2 * kk, bw1 + kk * (16 * 128 / 16), 1);
        wgmma_n128<0>(pg, ag + 2 * kk, bw2 + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      fence_regs(hx);
      fence_regs(pg);
      if (kt > 0) release_stage(&sm.empty[(kt - 1) % kDualStages], lane);
    }
    wgmma_wait<0>();
    fence_regs(hx);
    fence_regs(pg);
    if (nk > 0) release_stage(&sm.empty[(nk - 1) % kDualStages], lane);

    // epilogue: every value computed without branches, a and dh written
    // into the free x and g ring as the consumer's 64 x 64 swizzled boxes,
    // then stored with TMA (as the GEMM's epilogue, ffn_sm90.cuh)
    constexpr int kBoxes = kDualBN / 64;  // of a, and of dh, a consumer
    static_assert(sizeof(SmemDual::x) + sizeof(SmemDual::g) >= kConsumers * 2 * kBoxes * kOutBox,
                  "a and dh staging fits in x's and g's ring");
    named_barrier(1, 128 * kConsumers);
    unsigned char* tile_a = reinterpret_cast<unsigned char*>(sm.x) + wg * 2 * kBoxes * kOutBox;
    unsigned char* tile_dh = tile_a + kBoxes * kOutBox;
    const int r = warp * 16 + lane / 4;  // + 8 acc_row(i), of the consumer's 64 rows
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int c = acc_col(i, lane);
      float a0, a1, d0, d1;
      gelu_grad_sel<kAct>(hx[i], a0, d0);
      gelu_grad_sel<kAct>(hx[i + 1], a1, d1);
      const uint32_t off = (c / 64) * kOutBox + sw128_offset(r + 8 * acc_row(i), c % 64);
      *reinterpret_cast<uint32_t*>(tile_a + off) = pack_bf16(a0, a1);
      *reinterpret_cast<uint32_t*>(tile_dh + off) = pack_bf16(pg[i] * d0, pg[i + 1] * d1);
    }
    fence_async_shared();
    named_barrier(2 + wg, 128);
    if (warp == 0 && lane == 0) {
      const int row0 = m0 + wg * 64;
      for (int j = 0; j < kBoxes && row0 < M && n0 + 64 * j < I; ++j) {
        tma_store_2d(&map_a, tile_a + j * kOutBox, n0 + 64 * j, row0);
        tma_store_2d(&map_dh, tile_dh + j * kOutBox, n0 + 64 * j, row0);
      }
      tma_store_wait_read();
    }
  }
}

template <int kAct>
inline int launch_dual(const CUtensorMap& mx, const CUtensorMap& mg, const CUtensorMap& mw1,
                       const CUtensorMap& mw2, const CUtensorMap& ma, const CUtensorMap& mdh,
                       const float* b1, int M, int H, int I, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(ffn_bwd_dual_sm90_kernel<kAct>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(kDualSmemBytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((I + kDualBN - 1) / kDualBN, (M + kBM - 1) / kBM);
  ffn_bwd_dual_sm90_kernel<kAct>
      <<<grid, kThreads, kDualSmemBytes, stream>>>(mx, mg, mw1, mw2, ma, mdh, b1, M, I, H);
  return int(cudaGetLastError());
}

// the training backward: (dx, dh, a) from x, g (M, H), W1 (H, I), b1, W2
// (I, H), at the true widths H and I on arrays in the padded layout
inline int launch_ffn_train_bwd_sm90(const void* x, const void* g, const void* w1,
                                     const float* b1, const void* w2, void* dx, void* dh,
                                     void* a, int M, int H, int I, int act,
                                     cudaStream_t stream) {
  if (!gemm_shapes_ok(M, H, I, act)) return int(cudaErrorInvalidValue);
  const int Hp = ffn::padded_width(H, 1), Ip = ffn::padded_width(I, 1);
  // loads: x, g, W1 (MN-major), W2 (K-major); stores: a, dh; the dx GEMM:
  // dh, W1 (K-major), dx
  CUtensorMap mx, mg, mw1, mw2, ma, mdh_out, mdh, mw1k, mdx;
  if (!make_map_2d(&mx, x, M, H, kBK, kBM, Hp) || !make_map_2d(&mg, g, M, H, kBK, kBM, Hp) ||
      !make_map_2d(&mw1, w1, H, I, 64, kBK, Ip) ||
      !make_map_2d(&mw2, w2, I, H, kBK, kDualBN, Hp) || !make_map_2d(&ma, a, M, I, 64, 64, Ip) ||
      !make_map_2d(&mdh_out, dh, M, I, 64, 64, Ip) ||
      !make_map_2d(&mdh, dh, M, I, kBK, kBM, Ip) || !make_map_2d(&mw1k, w1, H, I, kBK, kBN, Ip) ||
      !make_map_2d(&mdx, dx, M, H, 64, 64, Hp))
    return kErrTensorMap;
  const int s1 = act == 0 ? launch_dual<0>(mx, mg, mw1, mw2, ma, mdh_out, b1, M, H, I, stream)
                          : launch_dual<1>(mx, mg, mw1, mw2, ma, mdh_out, b1, M, H, I, stream);
  if (s1 != 0) return s1;
  return launch_gemm<kNoAct, true>(mdh, mw1k, mdx, nullptr, M, H, I, stream);
}

}  // namespace ffn90
}  // namespace stonkgs
