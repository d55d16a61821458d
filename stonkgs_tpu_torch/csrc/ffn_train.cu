// The training FFN, forward and backward:
//   forward   y = gelu(x @ W1 + b1) @ W2 + b2
//   backward  h = x @ W1 + b1 (recomputed), a = gelu(h),
//             dh = (g @ W2^T) * gelu'(h) rounded to T, dx = dh @ W1^T
// with x, g, y, dx (M, H), W1 (H, I), W2 (I, H), dh and a (M, I).
//
// Replaces the TPU kernels _ffn_kernel and _ffn_bwd_kernel
// (stonkgs_tpu/ops/fused_ffn.py:54 and :206).  Both are bound on the H100
// by operations (4*M*H*I forward, 6*M*H*I backward); see
// stonkgs_tpu_torch/ops/fused_ffn.py for the design note.
//
// bf16 runs the Hopper kernels of ffn_train_sm90.cuh: the forward is two
// wgmma GEMMs through a bf16 scratch h (M, I); the backward a dual wgmma
// GEMM that writes a and dh, then the dx GEMM.  Any H and I that are
// multiples of 8.
//
// fp32 runs SIMT bodies that exist to hold the model against the CPU:
// the forward is ffn_fwd_kernel<float, false, H> of ffn.cuh (H = 768 or
// 1024); the backward, below, takes H = 768.  One block owns 16 rows of x
// and g, both kept in shared memory, and walks I in chunks of 192.  For
// each chunk:
//   h = x @ W1[:, chunk]        (W1 streamed in 64 x 192 tiles)
//   a = gelu(h + b1) -> a[:, chunk];  gelu'(h) kept
//   gw = g @ W2^T[:, chunk]     (W2^T (768, I) streamed in 64 x 192 tiles)
//   dh = gw * gelu'(h) -> dh[:, chunk], and kept in shared memory
//   acc += dh @ W1^T[chunk, :]  (W1^T (I, 768) streamed in 16 x 768 tiles)
// with the (16, 768) dx accumulator in registers.  The three weight
// streams of a chunk form one sequence through the cp.async ring of
// ffn.cuh; the caller passes W2^T and W1^T, so every tile is one of the
// two shapes the forward streams.
// dW1 = x^T dh, dW2 = a^T g and the bias sums are left to the caller, as
// the TPU kernel leaves them to XLA.
//
// C interface (all pointers on the device; b1, b2 fp32):
//   int ffn_train_fwd(int dtype /*0 fp32, 1 bf16*/, x, w1, b1, w2, b2,
//                     h /*(M, I) bf16 scratch, or NULL for fp32*/, out,
//                     int M, int H, int I, int act /*0 gelu(erf),
//                     1 gelu_new*/, cudaStream_t stream)
//   int ffn_train_bwd(int dtype, x, g, w1 (H, I), b1, w2 (I, H),
//                     w2t (H, I), w1t (I, H) /*fp32 only, else NULL*/,
//                     dx, dh (M, I), a (M, I), int M, int H, int I,
//                     int act, cudaStream_t stream)
// fp32 takes I a multiple of the width's chunk (192 at 768, 256 at 1024);
// each returns cudaGetLastError() after its launches (or -1 when a TMA
// tensor map cannot be encoded).

#include "ffn_train_sm90.cuh"

namespace stonkgs {
namespace ffn {
namespace {

// the fp32 backward kernel: two row operands (x and g), 16 rows
using BwdLayout = Layout<float, 768, 16, 2, 2>;

__global__ void __launch_bounds__(Width<768>::kThreads, 1)
ffn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gy,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2t, const float* __restrict__ w1t,
               float* __restrict__ dx, float* __restrict__ dh_out, float* __restrict__ a_out,
               int M, int I, int act) {
  using L = BwdLayout;
  using T = float;
  constexpr int STAGES = L::STAGES;
  constexpr int kChunk = L::kChunk, kThreads = L::kThreads;
  constexpr int kTiles1 = L::kTiles1, kTiles2 = L::kTiles2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + L::xs_bytes);
  unsigned char* work = smem + 2 * L::xs_bytes;
  T* wbuf = reinterpret_cast<T*>(work);
  T* hs = reinterpret_cast<T*>(work + L::wbuf_bytes);
  float* stage = reinterpret_cast<float*>(work);  // epilogue only

  const int row0 = blockIdx.x * L::BM;
  constexpr int kTiles = 2 * kTiles1 + kTiles2;  // W1, W2^T, W1^T tiles per chunk
  const int total = (I / kChunk) * kTiles;

  auto fetch = [&](int g) {
    if (g < total) {
      T* dst = wbuf + (g % STAGES) * L::WBUF;
      const int c0 = (g / kTiles) * kChunk, t = g % kTiles;
      if (t < kTiles1)
        fetch_w1<L>(dst, w1, I, c0, t);
      else if (t < 2 * kTiles1)
        fetch_w1<L>(dst, w2t, I, c0, t - kTiles1);
      else
        fetch_w2<L>(dst, w1t, c0, t - 2 * kTiles1);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) fetch(g);
  load_row_block<L>(xs, x, row0, M);
  load_row_block<L>(gs, gy, row0, M);

  int g = 0;
  auto advance = [&]() -> const T* {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(g + STAGES - 1);
    const T* cur = wbuf + (g % STAGES) * L::WBUF;
    ++g;
    return cur;
  };
  const LnArgs no_ln{};

  // thread owns chunk column tid % 192 and rows [(tid / 192) * 8, +8) in
  // the W1 and W2^T products; dx columns tid and tid + 384.
  static_assert(L::BM == 16 && kThreads == 2 * kChunk && L::kH == 2 * kThreads,
                "fp32 thread mapping");
  const int tid = threadIdx.x;
  const int hc = tid % kChunk, hr = (tid / kChunk) * 8;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int c0 = 0; c0 < I; c0 += kChunk) {
    float hacc[8], gacc[8], dact[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) hacc[r] = gacc[r] = 0.f;
    for (int t = 0; t < kTiles1; ++t) fma_w1_tile<L>(hacc, xs, advance(), t, hr, hc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float av;
      gelu_and_grad(hacc[r] + b1[c0 + hc], act, av, dact[r]);
      if (row0 + hr + r < M) a_out[size_t(row0 + hr + r) * I + c0 + hc] = av;
    }
    for (int t = 0; t < kTiles1; ++t) fma_w1_tile<L>(gacc, gs, advance(), t, hr, hc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float dh = gacc[r] * dact[r];
      hs[(hr + r) * L::HSS + hc] = dh;
      if (row0 + hr + r < M) dh_out[size_t(row0 + hr + r) * I + c0 + hc] = dh;
    }
    for (int kt = 0; kt < kTiles2; ++kt) fma_w2_tile<L>(acc, hs, advance(), kt, tid);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    stage[r * L::STS + tid] = acc[r][0];
    stage[r * L::STS + tid + kThreads] = acc[r][1];
  }
  __syncthreads();
  epilogue_rows<L, T, false>(stage, xs, 0, row0, M, nullptr, no_ln, dx);
}

int launch_bwd_f32(const void* x, const void* g, const void* w1, const float* b1,
                   const void* w2t, const void* w1t, void* dx, void* dh, void* a, int M, int H,
                   int I, int act, cudaStream_t stream) {
  using L = BwdLayout;
  if (M <= 0 || H != L::kH || I <= 0 || I % L::kChunk != 0 || (act != 0 && act != 1) ||
      !w2t || !w1t)
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ffn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(L::smem_bytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((M + L::BM - 1) / L::BM);
  ffn_bwd_kernel<<<grid, L::kThreads, L::smem_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<const float*>(w1),
      b1, static_cast<const float*>(w2t), static_cast<const float*>(w1t),
      static_cast<float*>(dx), static_cast<float*>(dh), static_cast<float*>(a), M, I, act);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace ffn
}  // namespace stonkgs

extern "C" int ffn_train_fwd(int dtype, const void* x, const void* w1, const float* b1,
                             const void* w2, const float* b2, void* h, void* out, int M, int H,
                             int I, int act, void* stream) {
  using namespace stonkgs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ffn::launch_fwd<float, false>(x, nullptr, w1, b1, w2, b2, ffn::LnArgs{}, out, M, H,
                                         I, act, s);
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    return ffn90::launch_ffn_gemms(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
                                   static_cast<const bf16*>(w2), b2, static_cast<bf16*>(h),
                                   static_cast<bf16*>(out), M, H, I, act, s);
  }
  return int(cudaErrorInvalidValue);
}

extern "C" int ffn_train_bwd(int dtype, const void* x, const void* g, const void* w1,
                             const float* b1, const void* w2, const void* w2t, const void* w1t,
                             void* dx, void* dh, void* a, int M, int H, int I, int act,
                             void* stream) {
  using namespace stonkgs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ffn::launch_bwd_f32(x, g, w1, b1, w2t, w1t, dx, dh, a, M, H, I, act, s);
  if (dtype == 1)
    return ffn90::launch_ffn_train_bwd_sm90(x, g, w1, b1, w2, dx, dh, a, M, H, I, act, s);
  return int(cudaErrorInvalidValue);
}
