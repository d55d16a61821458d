// The bf16 serving FFN block for Hopper (sm_90a), launched by
// ffn_ln_block.cu:
//
//   x2  = round(LN1(x + attn))                 add_layer_norm_kernel
//   h   = round(gelu(x2 @ W1 + b1))  (M, I)    gemm_sm90_kernel<act>
//   ff  = round(h @ W2 + b2)         (M, H)    gemm_sm90_kernel<kNoAct>
//   out = round(LN2(x2 + ff))                  add_layer_norm_kernel
//
// Rounding points as the TPU kernel (stonkgs_tpu/ops/fused_ffn.py:444-467):
// statistics, sums and gelu in fp32, each of x2, h, ff and out rounded to
// bf16 once.  x2 and h are scratch of the caller; ff is written into out,
// and LN2 then runs in place, row by row.
//
// Why not one fused kernel: the fused shape keeps a block's fp32 (rows,
// H) accumulator in registers, which caps the row tile (48 rows at
// H = 768), and every row block re-streams both whole weight matrices
// from L2 (ffn.cuh, the fp32 and training instantiations).  Split at h,
// each product is a plain GEMM at a 128 x 256 tile: the (M, I)
// intermediate makes a round trip through device memory in bf16 (402 MB
// at M = 65,536, I = 3,072), which the products, bound by operations,
// hide.
//
// The GEMM: C (M, N) = A (M, K) @ W (K, N), A and W row-major bf16, an fp32
// bias over N and an epilogue (+ bias, optional gelu / gelu_new, round),
// one block per 128 x 256 tile of C, 384 threads:
// * warpgroup 2, the producer (setmaxnreg.dec): one thread streams the K
//   axis in 64-deep steps through a kStages-deep ring with TMA and
//   full/empty mbarriers: A's 128 x 64 tile (K-major, one 128-byte
//   swizzled line a row) and W's 64 x 256 tile as four 64 x 64 boxes
//   (MN-major: each box is 64 lines of 64 columns, and the four boxes
//   are the wgmma B operand's four 64-wide column blocks, 8 KB apart);
//   TMA zero-fills rows >= M and a ragged K or N edge;
// * warpgroups 0 and 1, the consumers (setmaxnreg.inc), own 64 rows each:
//   per step four wgmma.m64n256k16 with A and B from shared memory, B
//   MN-major (W is read as it lies, with no transposed copy), into a
//   128-float fp32 accumulator; a step's stage is released once the next
//   step's products are issued (wgmma.wait_group 1), so the tensor cores
//   never wait for a release;
// * the epilogue adds the bias in fp32, applies the activation (gelu_sel,
//   without branches), rounds and stores bf16 pairs from registers; the
//   stores of rows >= M and columns >= N are skipped.
// The LayerNorm passes are bound by bytes: one warp a row, 16-byte loads
// and stores, the row's H / 32 values in registers.

#pragma once

#include "ffn.cuh"
#include "sm90.cuh"

namespace stonkgs {
namespace ffn90 {

using namespace sm90;

constexpr int kBM = 128;       // rows of a C tile (two consumers of 64)
constexpr int kBN = 256;       // columns of a C tile
constexpr int kBK = 64;        // K of a ring stage (one 128-byte line of bf16)
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kABytes = kBM * kBK * 2;  // 16 KB
constexpr uint32_t kBBytes = kBK * kBN * 2;  // 32 KB
constexpr uint32_t kBBlock = kBK * 64 * 2;   // one 64-wide column block of B, 8 KB
constexpr int kNoAct = -1;                   // epilogue without gelu

struct alignas(1024) SmemGemm {
  bf16 a[kStages][kBM * kBK];
  bf16 b[kStages][kBK * kBN];  // kBN / 64 column blocks of kBK lines each
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kGemmSmemBytes = sizeof(SmemGemm) + 1024;  // + alignment slack

// gelu (kAct 0, with erf) or gelu_new (1, with tanh) of an fp32 value,
// without branches, so that the epilogue's independent values interleave
// (erff and tanhf branch on |x|, which leaves each value's chain of
// dependent instructions exposed).  Both follow the plain version's
// formula, 0.5 h (1 + erf(h / sqrt 2)) and 0.5 h (1 + tanh(sqrt(2/pi) (h
// + 0.044715 h^3))), in fp32:
// * erf(z): for |z| < 0.921875, z + z P(z^2) with P of degree 6; else
//   sign(z) (1 - exp(R(|z|))), R of degree 8 fitted to log(erfc) on
//   [0.921875, 4] (|z| clamped to 4, where erf rounds to 1).  One Horner
//   chain evaluates whichever applies, its coefficients selected per
//   value (P's two highest are 0).  Fitted by least squares in double,
//   within 1.3 ulp of erf over [-6, 6] in fp32 (CUDA's erff: 2 ulp);
// * tanh(u) = sign(u) (1 - 2 / (exp(2|u|) + 1)), within a few 1e-8 of
//   tanh in absolute terms, which is what 1 + tanh needs.
// exp runs on the SFU (ex2.approx, a relative error of about 2^-22).
template <int kAct>
__device__ __forceinline__ float gelu_sel(float h) {
  constexpr float kLog2e = 1.4426950408889634f;
  if constexpr (kAct == 0) {
    const float z = h * 0.70710678118654752f;
    const bool small = fabsf(z) < 0.921875f;
    const float x = small ? z * z : fminf(fabsf(z), 4.0f);
    float r = small ? 0.0f : 1.613091118e-06f;
    r = fmaf(r, x, small ? 0.0f : -4.557097782e-05f);
    r = fmaf(r, x, small ? 8.461760155e-05f : 5.926000286e-04f);
    r = fmaf(r, x, small ? -8.165880161e-04f : -4.739410013e-03f);
    r = fmaf(r, x, small ? 5.203235866e-03f : 2.636235909e-02f);
    r = fmaf(r, x, small ? -2.686036991e-02f : -1.099740105e-01f);
    r = fmaf(r, x, small ? 1.128371515e-01f : -6.319416728e-01f);
    r = fmaf(r, x, small ? -3.761263525e-01f : -1.130163957e+00f);
    r = fmaf(r, x, small ? 1.283791669e-01f : 3.025367787e-04f);
    const float erf_z = small ? fmaf(z, r, z) : copysignf(1.0f - ex2(r * kLog2e), z);
    return 0.5f * h * (1.0f + erf_z);
  } else {
    const float u = 0.79788456080286536f * (h + 0.044715f * h * h * h);
    const float e = ex2(2.0f * fabsf(u) * kLog2e);
    const float t = copysignf(1.0f - __fdividef(2.0f, e + 1.0f), u);
    return 0.5f * h * (1.0f + t);
  }
}

// C = epilogue(A @ W + bias); kAct: kNoAct, 0 gelu (erf), 1 gelu_new (tanh)
template <int kAct>
__global__ void __launch_bounds__(kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                 bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  SmemGemm& sm = aligned_smem<SmemGemm>(smem_raw);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
        const int stage = kt % kStages;
        mbar_wait(&sm.empty[stage], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_tx(&sm.full[stage], kABytes + kBBytes);
        tma_load_2d(sm.a[stage], &map_a, kt * kBK, m0, &sm.full[stage]);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          tma_load_2d(sm.b[stage] + j * (kBBlock / 2), &map_w, n0 + 64 * j, kt * kBK,
                      &sm.full[stage]);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int stage = kt % kStages;
      mbar_wait(&sm.full[stage], (kt / kStages) & 1);
      const uint64_t da = desc_sw128(sm.a[stage] + wg * 64 * kBK);
      const uint64_t db = desc_sw128(sm.b[stage], kBBlock);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // A: 16 bf16 = 2 descriptor units; B: 16 lines
        wgmma_n256(acc, da + 2 * kk, db + kk * (16 * 128 / 16));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      fence_regs(acc);
      if (kt > 0) release_stage(&sm.empty[(kt - 1) % kStages], lane);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (nk > 0) release_stage(&sm.empty[(nk - 1) % kStages], lane);

    // epilogue: the thread's rows r0 and r0 + 8, 64 column pairs.  With
    // gelu every value is computed and only the stores are guarded, so
    // the epilogue is one block of independent chains that interleave (a
    // branch per pair, or erff's and tanhf's own, leaves each chain's
    // latency exposed); without gelu, the values are skipped with the
    // stores (computing them all as well made ptxas spill)
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int col = n0 + acc_col(i, lane), row = r0 + 8 * acc_row(i);
      const bool live = col < N && row < M;
      if constexpr (kAct == kNoAct) {
        if (!live) continue;
      }
      const float2 bv =
          col < N ? __ldg(reinterpret_cast<const float2*>(bias + col)) : make_float2(0.f, 0.f);
      float v0 = acc[i] + bv.x, v1 = acc[i + 1] + bv.y;
      if constexpr (kAct != kNoAct) {
        v0 = gelu_sel<kAct>(v0);
        v1 = gelu_sel<kAct>(v1);
      }
      if (live) *reinterpret_cast<uint32_t*>(out + size_t(row) * N + col) = pack_bf16(v0, v1);
    }
  }
}

// out = round(LN(a + b)) over rows of width H, statistics in fp32; one warp
// a row, each lane H / 256 16-byte vectors.  out may be b (in place: a
// row's values are all read before any is written).
template <int H>
__global__ void __launch_bounds__(256)
add_layer_norm_kernel(const bf16* a, const bf16* b, const float* __restrict__ g,
                      const float* __restrict__ beta, float eps, bf16* out, int M) {
  constexpr int V = H / 256;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t off = size_t(row) * H;
  float v[8 * V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = (lane + 32 * j) * 8;
    const uint4 ua = *reinterpret_cast<const uint4*>(a + off + c);
    const uint4 ub = *reinterpret_cast<const uint4*>(b + off + c);
    const bf16* ea = reinterpret_cast<const bf16*>(&ua);
    const bf16* eb = reinterpret_cast<const bf16*>(&ub);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[8 * j + e] = to_f(ea[e]) + to_f(eb[e]);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8 * V; ++i) s += v[i];
  const float mean = warp_sum(s) / H;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 8 * V; ++i) {
    const float d = v[i] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / H + eps);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = (lane + 32 * j) * 8;
    uint4 uo;
    uint32_t* eo = reinterpret_cast<uint32_t*>(&uo);
#pragma unroll
    for (int e = 0; e < 8; e += 2)
      eo[e / 2] = pack_bf16((v[8 * j + e] - mean) * rstd * g[c + e] + beta[c + e],
                            (v[8 * j + e + 1] - mean) * rstd * g[c + e + 1] + beta[c + e + 1]);
    *reinterpret_cast<uint4*>(out + off + c) = uo;
  }
}

template <int kAct>
inline int launch_gemm(const CUtensorMap& ma, const CUtensorMap& mw, const float* bias,
                       bf16* out, int M, int N, int K, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_sm90_kernel<kAct>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kGemmSmemBytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_sm90_kernel<kAct><<<grid, kThreads, kGemmSmemBytes, stream>>>(ma, mw, bias, out, M, N, K);
  return int(cudaGetLastError());
}

// the block at hidden width H (768 or 1024); x2 (M, H) and h (M, I) are
// the caller's scratch
template <int H>
int launch_ffn_ln_width(const bf16* x, const bf16* attn, const ffn::LnArgs& ln, const bf16* w1,
                        const float* b1, const bf16* w2, const float* b2, bf16* x2, bf16* h,
                        bf16* out, int M, int I, int act, cudaStream_t stream) {
  if (M <= 0 || I <= 0 || I % 8 != 0 || (act != 0 && act != 1) ||
      (M + kBM - 1) / kBM > 65535 || !x2 || !h)
    return int(cudaErrorInvalidValue);
  CUtensorMap ma1, mw1, ma2, mw2;
  if (!make_map_2d(&ma1, x2, M, H, kBK, kBM) || !make_map_2d(&mw1, w1, H, I, 64, kBK) ||
      !make_map_2d(&ma2, h, M, I, kBK, kBM) || !make_map_2d(&mw2, w2, I, H, 64, kBK))
    return kErrTensorMap;
  const unsigned ln_blocks = unsigned((M + 7) / 8);
  add_layer_norm_kernel<H><<<ln_blocks, 256, 0, stream>>>(x, attn, ln.g1, ln.be1, ln.eps, x2, M);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int s1 = act == 0 ? launch_gemm<0>(ma1, mw1, b1, h, M, I, H, stream)
                          : launch_gemm<1>(ma1, mw1, b1, h, M, I, H, stream);
  if (s1 != 0) return s1;
  const int s2 = launch_gemm<kNoAct>(ma2, mw2, b2, out, M, H, I, stream);
  if (s2 != 0) return s2;
  add_layer_norm_kernel<H><<<ln_blocks, 256, 0, stream>>>(x2, out, ln.g2, ln.be2, ln.eps, out, M);
  return int(cudaGetLastError());
}

inline int launch_ffn_ln_sm90(const void* x, const void* attn, const ffn::LnArgs& ln,
                              const void* w1, const float* b1, const void* w2, const float* b2,
                              void* x2, void* h, void* out, int M, int H, int I, int act,
                              cudaStream_t stream) {
  const auto* xb = static_cast<const bf16*>(x);
  const auto* ab = static_cast<const bf16*>(attn);
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* w2b = static_cast<const bf16*>(w2);
  auto* x2b = static_cast<bf16*>(x2);
  auto* hb = static_cast<bf16*>(h);
  auto* ob = static_cast<bf16*>(out);
  if (H == 768)
    return launch_ffn_ln_width<768>(xb, ab, ln, w1b, b1, w2b, b2, x2b, hb, ob, M, I, act, stream);
  if (H == 1024)
    return launch_ffn_ln_width<1024>(xb, ab, ln, w1b, b1, w2b, b2, x2b, hb, ob, M, I, act, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace ffn90
}  // namespace stonkgs
