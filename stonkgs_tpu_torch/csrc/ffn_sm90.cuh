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
// from L2 (ffn.cuh, the fp32 body).  Split at h,
// each product is a plain GEMM at a 128 x 256 tile: the (M, I)
// intermediate makes a round trip through device memory in bf16 (402 MB
// at M = 65,536, I = 3,072), which the products, bound by operations,
// hide.
//
// The GEMM: C (M, N) = A (M, K) @ W (K, N), A and W row-major bf16, an
// optional fp32 bias over N and an epilogue (+ bias, optional gelu /
// gelu_new, round), one block per 128 x 256 tile of C, 384 threads.  The
// training FFN (ffn_train_sm90.cuh) launches it too: its forward is these
// two GEMMs without the LayerNorms, and its backward's dx = dh @ W1^T takes
// W as it lies, (N, K) row-major, the K-major B operand (kBKMajor):
// * warpgroup 2, the producer (setmaxnreg.dec): one thread streams the K
//   axis in 64-deep steps through a kStages-deep ring with TMA and
//   full/empty mbarriers: A's 128 x 64 tile (K-major, one 128-byte
//   swizzled line a row) and W's 64 x 256 tile as four 64 x 64 boxes
//   (MN-major: each box is 64 lines of 64 columns, and the four boxes
//   are the wgmma B operand's four 64-wide column blocks, 8 KB apart),
//   or, K-major, as one box of 256 lines of 64 K values;
//   TMA zero-fills rows >= M and a ragged K or N edge;
// * warpgroups 0 and 1, the consumers (setmaxnreg.inc), own 64 rows each:
//   per step four wgmma.m64n256k16 with A and B from shared memory (W
//   is read as it lies, with no transposed copy), into a 128-float fp32
//   accumulator (without gelu it starts at the bias: the fp32 sum of the
//   products and the bias in another order than the plain version's); a
//   step's stage is released once the next step's products are issued
//   (wgmma.wait_group 1), so the tensor cores never wait for a release;
// * the epilogue adds the bias and applies the activation (gelu_sel,
//   without branches), rounds, and writes bf16 pairs into the free ring as
//   64 x 64 swizzled boxes, which one thread a consumer stores with TMA
//   (rows >= M and columns >= N are not written).
// The LayerNorm passes are bound by bytes: one warp a row, the row's values
// in registers, loaded and stored as the widest vectors H allows (16 bytes
// when H is a multiple of 256).
//
// Widths: any H >= 1 and I >= 1 (ffn.cuh, widths_ok), each row of the
// arrays ld(H) = H rounded up to a multiple of 8 elements long (ld(I)
// likewise): TMA needs 16-byte row strides.  The tensor maps take the true
// width as the dimension and ld as the stride, so TMA zero-fills the
// columns past it in every load (an operand's K edge adds nothing) and
// skips them in every store; the padding is never read.  Every offset is
// TMA's (64-bit) or a size_t: M x I reaches 2^31 elements at the trunk's
// rows and I = 32,768.  The LayerNorm pass takes its statistics over the
// true H: for H a multiple of 32 up to 1024 the instances above, for any
// other H up to 2048 a masked one with 16-byte vectors over ld(H), and
// above 2048, where a row no longer fits a lane's registers (80 values a
// lane at H = 2,560, 256 at 8,192 would spill), ffn.cuh's
// layer_norm_rows_kernel, which walks the row in 16-byte chunks three
// times (sum, centred sum of squares from a second read out of L2, then
// the normalised values), its statistics in fp32 over the true H.

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
constexpr uint32_t kOutBox = 64 * 64 * 2;    // one 64 x 64 bf16 box of C, 8 KB
constexpr int kNoAct = -1;                   // epilogue without gelu
using ffn::kRowHidden;

struct alignas(1024) SmemGemm {
  bf16 a[kStages][kBM * kBK];
  bf16 b[kStages][kBK * kBN];  // kBN / 64 column blocks of kBK lines each
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kGemmSmemBytes = sizeof(SmemGemm) + 1024;  // + alignment slack

// gelu (kAct 0, with erf) or gelu_new (1, with tanh) of an fp32 value,
// and its derivative, without branches, so that the epilogue's
// independent values interleave (erff and tanhf branch on |x|, which
// leaves each value's chain of dependent instructions exposed).  Both
// follow the plain version's formulas in fp32 (ops/fused_ffn.py, _gelu and
// _gelu_and_grad):
//   gelu      0.5 h (1 + erf(h / sqrt 2)),
//             gelu' = 0.5 (1 + erf(h / sqrt 2)) + h phi(h);
//   gelu_new  0.5 h (1 + t), t = tanh(u), u = sqrt(2/pi) (h + 0.044715 h^3),
//             gelu' = 0.5 (1 + t) + 0.5 h (1 - t^2) sqrt(2/pi) (1 + 3 * 0.044715 h^2).
// * erf(z): for |z| < 0.921875, z + z P(z^2) with P of degree 6; else
//   sign(z) (1 - exp(R(|z|))), R of degree 8 fitted to log(erfc) on
//   [0.921875, 4] (|z| clamped to 4, where erf rounds to 1).  One Horner
//   chain evaluates whichever applies, its coefficients selected per
//   value (P's two highest are 0).  Fitted by least squares in double,
//   within 1.3 ulp of erf over [-6, 6] in fp32 (CUDA's erff: 2 ulp);
// * tanh(u) = sign(u) (1 - q), q = 2 / (exp(2|u|) + 1), within a few 1e-8
//   of tanh in absolute terms, which is what 1 + t needs; 1 - t^2 is
//   q (2 - q), without the cancellation of 1 - t*t.
// exp runs on the SFU (ex2.approx, a relative error of about 2^-22).
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSqrt2OverPi = 0.79788456080286536f;

__device__ __forceinline__ float erf_sel(float z) {
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
  return small ? fmaf(z, r, z) : copysignf(1.0f - ex2(r * kLog2e), z);
}

// q = 1 - |tanh(u)|
__device__ __forceinline__ float tanh_gap(float u) {
  return __fdividef(2.0f, ex2(2.0f * fabsf(u) * kLog2e) + 1.0f);
}

template <int kAct>
__device__ __forceinline__ float gelu_sel(float h) {
  if constexpr (kAct == 0) {
    return 0.5f * h * (1.0f + erf_sel(h * 0.70710678118654752f));
  } else {
    const float u = kSqrt2OverPi * (h + 0.044715f * h * h * h);
    return 0.5f * h * (1.0f + copysignf(1.0f - tanh_gap(u), u));
  }
}

// gelu(h) -> a and gelu'(h) -> da
template <int kAct>
__device__ __forceinline__ void gelu_grad_sel(float h, float& a, float& da) {
  if constexpr (kAct == 0) {
    const float half1p = 0.5f * (1.0f + erf_sel(h * 0.70710678118654752f));
    const float phi = 0.39894228040143268f * ex2(-0.5f * h * h * kLog2e);
    a = h * half1p;
    da = fmaf(h, phi, half1p);
  } else {
    const float u = kSqrt2OverPi * (h + 0.044715f * h * h * h);
    const float q = tanh_gap(u);
    const float half1p = 0.5f * (1.0f + copysignf(1.0f - q, u));
    a = h * half1p;
    da = fmaf(0.5f * h * q * (2.0f - q), kSqrt2OverPi * fmaf(3.0f * 0.044715f, h * h, 1.0f),
              half1p);
  }
}

// bias[col], bias[col + 1], or zeros past n or without a bias
__device__ __forceinline__ float2 bias_pair(const float* __restrict__ bias, int col, int n) {
  return bias && col < n ? __ldg(reinterpret_cast<const float2*>(bias + col))
                         : make_float2(0.f, 0.f);
}

// C = epilogue(A @ W + bias); kAct: kNoAct, 0 gelu (erf), 1 gelu_new
// (tanh); bias may be null; kBKMajor: W is (N, K) row-major (map_w's box 64
// x 256), else (K, N) (box 64 x 64); C through map_c (box 64 x 64)
template <int kAct, bool kBKMajor>
__global__ void __launch_bounds__(kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_c, const float* __restrict__ bias,
                 int M, int N, int K) {
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
        if constexpr (kBKMajor) {
          tma_load_2d(sm.b[stage], &map_w, kt * kBK, n0, &sm.full[stage]);
        } else {
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            tma_load_2d(sm.b[stage] + j * (kBBlock / 2), &map_w, n0 + 64 * j, kt * kBK,
                        &sm.full[stage]);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // without gelu the products accumulate onto the bias, loaded while the
    // ring fills; with gelu the epilogue adds it (an accumulator that
    // starts at the bias made ptxas spill in the gelu epilogue, and adding
    // it there made the epilogue without gelu spill)
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const float2 bv = kAct == kNoAct ? bias_pair(bias, n0 + acc_col(i, lane), N)
                                       : make_float2(0.f, 0.f);
      acc[i] = bv.x;
      acc[i + 1] = bv.y;
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int stage = kt % kStages;
      mbar_wait(&sm.full[stage], (kt / kStages) & 1);
      const uint64_t da = desc_sw128(sm.a[stage] + wg * 64 * kBK);
      const uint64_t db = desc_sw128(sm.b[stage], kBBlock);
      fence_regs(acc);
      wgmma_fence();
      // A (and a K-major B): 16 bf16 = 2 descriptor units; an MN-major B: 16 lines
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_n256<kBKMajor ? 0 : 1>(acc, da + 2 * kk,
                                     db + (kBKMajor ? 2 * kk : kk * (16 * 128 / 16)));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      fence_regs(acc);
      if (kt > 0) release_stage(&sm.empty[(kt - 1) % kStages], lane);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (nk > 0) release_stage(&sm.empty[(nk - 1) % kStages], lane);

    // epilogue: with gelu, + bias and gelu_sel (without branches, so that
    // the thread's 128 values interleave); round; write into the A ring as
    // the consumer's four 64 x 64 boxes of C (128-byte swizzle: a warp's
    // stores hit 32 distinct banks); then one thread stores the boxes with
    // TMA, which skips rows >= M and columns >= N.  The ring is free once
    // both consumers' products are done.
    static_assert(sizeof(SmemGemm::a) >= kConsumers * (kBN / 64) * kOutBox,
                  "C staging fits in A's ring");
    named_barrier(1, 128 * kConsumers);
    unsigned char* tile = reinterpret_cast<unsigned char*>(sm.a) + wg * (kBN / 64) * kOutBox;
    const int r = warp * 16 + lane / 4;  // + 8 acc_row(i), of the consumer's 64 rows
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int c = acc_col(i, lane);
      float v0 = acc[i], v1 = acc[i + 1];
      if constexpr (kAct != kNoAct) {
        const float2 bv = bias_pair(bias, n0 + c, N);
        v0 = gelu_sel<kAct>(v0 + bv.x);
        v1 = gelu_sel<kAct>(v1 + bv.y);
      }
      *reinterpret_cast<uint32_t*>(tile + (c / 64) * kOutBox +
                                   sw128_offset(r + 8 * acc_row(i), c % 64)) = pack_bf16(v0, v1);
    }
    fence_async_shared();
    named_barrier(2 + wg, 128);
    if (warp == 0 && lane == 0) {
      const int row0 = m0 + wg * 64;
      for (int j = 0; j < kBN / 64 && row0 < M && n0 + 64 * j < N; ++j)
        tma_store_2d(&map_c, tile + j * kOutBox, n0 + 64 * j, row0);
      tma_store_wait_read();
    }
  }
}

// a vector of kVec bf16 (8: 16 bytes, 4, 2 or 1), as one load or store
template <int kVec> struct BfVec;
template <> struct BfVec<8> { using type = uint4; };
template <> struct BfVec<4> { using type = uint2; };
template <> struct BfVec<2> { using type = uint32_t; };
template <> struct BfVec<1> { using type = uint16_t; };

// out = round(LN(a + b)) over rows of width H, statistics in fp32; one
// warp a row, vector j of lane l at column (l + 32j) kVec, in registers.
// kMasked false: H a multiple of 32 up to 1024, each lane H / 32 values as
// H / (32 kVec) vectors of kVec (the widest that divides H / 32: 16 bytes
// at H = 256, 512, 768, 1024), rows H apart.  kMasked true: any H up to
// 2048 with rows ld apart (a multiple of 8), 16-byte vectors over the
// row's ld columns; the statistics take the first H, and the columns from
// H on are written 0.  out may be b (in place: a row's values are all read
// before any is written).
template <int kVec, bool kMasked = false>
__global__ void __launch_bounds__(256)
add_layer_norm_kernel(const bf16* a, const bf16* b, const float* __restrict__ g,
                      const float* __restrict__ beta, float eps, bf16* out, int M, int H,
                      int ld) {
  using V = typename BfVec<kVec>::type;
  // vectors a lane at the widest H
  constexpr int kMaxVecs = (kMasked ? kRowHidden : 1024) / 32 / kVec;
  const int nv = kMasked ? (H + 32 * kVec - 1) / (32 * kVec) : H / (32 * kVec);
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t off = size_t(row) * (kMasked ? ld : H);
  // whether column c + e of the row counts
  auto in = [&](int c, int e) { return !kMasked || c + e < H; };
  float v[kVec * kMaxVecs];
#pragma unroll
  for (int j = 0; j < kMaxVecs; ++j) {
    const int c = (lane + 32 * j) * kVec;
    if (j < nv && (!kMasked || c < H)) {
      const V ua = *reinterpret_cast<const V*>(a + off + c);
      const V ub = *reinterpret_cast<const V*>(b + off + c);
      const bf16* ea = reinterpret_cast<const bf16*>(&ua);
      const bf16* eb = reinterpret_cast<const bf16*>(&ub);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        v[kVec * j + e] = in(c, e) ? to_f(ea[e]) + to_f(eb[e]) : 0.f;
    } else if constexpr (kMasked) {  // a vector wholly past H
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[kVec * j + e] = 0.f;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVecs; ++j)
    if (j < nv)
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += v[kVec * j + e];
  const float mean = warp_sum(s) / H;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVecs; ++j)
    if (j < nv) {
      const int c = (lane + 32 * j) * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = v[kVec * j + e] - mean;
        if (in(c, e)) q += d * d;
      }
    }
  const float rstd = rsqrtf(warp_sum(q) / H + eps);
#pragma unroll
  for (int j = 0; j < kMaxVecs; ++j) {
    const int c = (lane + 32 * j) * kVec;
    if (j < nv && (!kMasked || c < H)) {
      V uo;
      bf16* eo = reinterpret_cast<bf16*>(&uo);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        eo[e] = __float2bfloat16(
            in(c, e) ? (v[kVec * j + e] - mean) * rstd * g[c + e] + beta[c + e] : 0.f);
      *reinterpret_cast<V*>(out + off + c) = uo;
    }
  }
}

// the LayerNorm pass over M rows of width H, ld apart: at the widest
// vector H takes when H is a multiple of 32 up to 1024 (then ld = H),
// masked up to 2048, in chunks above
inline int launch_add_layer_norm(const bf16* a, const bf16* b, const float* g, const float* beta,
                                 float eps, bf16* out, int M, int H, int ld,
                                 cudaStream_t stream) {
  if (ld > kRowHidden)
    return ffn::launch_layer_norm_rows<bf16>(a, b, g, beta, eps, out, M, H, ld, stream);
  const unsigned blocks = unsigned((M + 7) / 8);
  const int per = H / 32;
  if (H % 32 != 0 || H > 1024)
    add_layer_norm_kernel<8, true><<<blocks, 256, 0, stream>>>(a, b, g, beta, eps, out, M, H, ld);
  else if (per % 8 == 0)
    add_layer_norm_kernel<8><<<blocks, 256, 0, stream>>>(a, b, g, beta, eps, out, M, H, ld);
  else if (per % 4 == 0)
    add_layer_norm_kernel<4><<<blocks, 256, 0, stream>>>(a, b, g, beta, eps, out, M, H, ld);
  else if (per % 2 == 0)
    add_layer_norm_kernel<2><<<blocks, 256, 0, stream>>>(a, b, g, beta, eps, out, M, H, ld);
  else
    add_layer_norm_kernel<1><<<blocks, 256, 0, stream>>>(a, b, g, beta, eps, out, M, H, ld);
  return int(cudaGetLastError());
}

template <int kAct, bool kBKMajor = false>
inline int launch_gemm(const CUtensorMap& ma, const CUtensorMap& mw, const CUtensorMap& mc,
                       const float* bias, int M, int N, int K, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(gemm_sm90_kernel<kAct, kBKMajor>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(kGemmSmemBytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_sm90_kernel<kAct, kBKMajor>
      <<<grid, kThreads, kGemmSmemBytes, stream>>>(ma, mw, mc, bias, M, N, K);
  return int(cudaGetLastError());
}

// whether the GEMMs take (M, H) rows and an intermediate width I: the
// FFN's widths (widths_ok), and the grid's y extent is at most 65,535
inline bool gemm_shapes_ok(int M, int H, int I, int act) {
  return M > 0 && ffn::widths_ok(H, I) && (act == 0 || act == 1) &&
         (M + kBM - 1) / kBM <= 65535;
}

// h = round(gelu(x @ W1 + b1)) into the (M, I) scratch h, then out =
// round(h @ W2 + b2): the FFN of the serving block and the training forward,
// at the true widths H and I on arrays in the padded layout
inline int launch_ffn_gemms(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                            const float* b2, bf16* h, bf16* out, int M, int H, int I, int act,
                            cudaStream_t stream) {
  if (!gemm_shapes_ok(M, H, I, act) || !h) return int(cudaErrorInvalidValue);
  const int Hp = ffn::padded_width(H, 1), Ip = ffn::padded_width(I, 1);
  CUtensorMap ma1, mw1, mh, ma2, mw2, mo;
  if (!make_map_2d(&ma1, x, M, H, kBK, kBM, Hp) || !make_map_2d(&mw1, w1, H, I, 64, kBK, Ip) ||
      !make_map_2d(&mh, h, M, I, 64, 64, Ip) || !make_map_2d(&ma2, h, M, I, kBK, kBM, Ip) ||
      !make_map_2d(&mw2, w2, I, H, 64, kBK, Hp) || !make_map_2d(&mo, out, M, H, 64, 64, Hp))
    return kErrTensorMap;
  const int s1 = act == 0 ? launch_gemm<0>(ma1, mw1, mh, b1, M, I, H, stream)
                          : launch_gemm<1>(ma1, mw1, mh, b1, M, I, H, stream);
  if (s1 != 0) return s1;
  return launch_gemm<kNoAct>(ma2, mw2, mo, b2, M, H, I, stream);
}

// the block at the true widths H and I (widths_ok) on arrays in the padded
// layout; x2 (M, ld(H)) and h (M, ld(I)) are the caller's scratch
inline int launch_ffn_ln_sm90(const void* x, const void* attn, const ffn::LnArgs& ln,
                              const void* w1, const float* b1, const void* w2, const float* b2,
                              void* x2, void* h, void* out, int M, int H, int I, int act,
                              cudaStream_t stream) {
  if (!gemm_shapes_ok(M, H, I, act) || !x2 || !h) return int(cudaErrorInvalidValue);
  const int Hp = ffn::padded_width(H, 1);
  auto* x2b = static_cast<bf16*>(x2);
  auto* ob = static_cast<bf16*>(out);
  int s = launch_add_layer_norm(static_cast<const bf16*>(x), static_cast<const bf16*>(attn),
                                ln.g1, ln.be1, ln.eps, x2b, M, H, Hp, stream);
  if (s != 0) return s;
  s = launch_ffn_gemms(x2b, static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
                       static_cast<bf16*>(h), ob, M, H, I, act, stream);
  if (s != 0) return s;
  return launch_add_layer_norm(x2b, ob, ln.g2, ln.be2, ln.eps, ob, M, H, Hp, stream);
}

}  // namespace ffn90
}  // namespace stonkgs
