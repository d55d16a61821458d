// The training FFN, forward and backward:
//   forward   y = gelu(x @ W1 + b1) @ W2 + b2
//   backward  h = x @ W1 + b1 (recomputed), a = gelu(h),
//             dh = (g @ W2^T) * gelu'(h) rounded to T, dx = dh @ W1^T
// with x, g, y, dx (M, H), W1 (H, I), W2 (I, H), dh and a (M, I); the
// forward takes H = 768 and 1024 (ProtBERT), the backward H = 768 (only
// the 768-wide trunk trains).
//
// Replaces the TPU kernels _ffn_kernel and _ffn_bwd_kernel
// (stonkgs_tpu/ops/fused_ffn.py:54 and :206).  Both are bound on the H100
// by operations (4*M*H*I forward, 6*M*768*I backward); see
// stonkgs_tpu_torch/ops/fused_ffn.py for the design note.
//
// Forward: ffn_fwd_kernel<T, false, H> of ffn.cuh, the serving block's
// kernel without its two LayerNorms.
//
// Backward: one block owns BM rows (32 for bf16, 16 for fp32) of x and g,
// both kept in shared memory, and walks I in chunks of 192.  For each
// chunk:
//   h = x @ W1[:, chunk]        (W1 streamed in 64 x 192 tiles)
//   a = round(gelu(h + b1)) -> a[:, chunk];  gelu'(h) kept in fp32
//   gw = g @ W2^T[:, chunk]     (W2^T (768, I) streamed in 64 x 192 tiles)
//   dh = round(gw * gelu'(h)) -> dh[:, chunk], and kept in shared memory
//   acc += dh @ W1^T[chunk, :]  (W1^T (I, 768) streamed in 16 x 768 tiles)
// with the (BM, 768) fp32 dx accumulator held in registers; the epilogue
// rounds it into dx.  The three weight streams of a chunk form one
// sequence through the cp.async ring of ffn.cuh.  The caller passes W2^T
// and W1^T, so every tile is one of the two shapes the forward streams.
// dW1 = x^T dh, dW2 = a^T g and the bias sums are left to the caller, as
// the TPU kernel leaves them to XLA.
//
// C interface (all pointers on the device; b1, b2 fp32):
//   int ffn_train_fwd(int dtype /*0 fp32, 1 bf16*/, x, w1, b1, w2, b2, out,
//                     int M, int H /*768 or 1024*/, int I,
//                     int act /*0 gelu(erf), 1 gelu_new*/, cudaStream_t stream)
//   int ffn_train_bwd(int dtype, x, g, w1 (768, I), b1, w2t (768, I),
//                     w1t (I, 768), dx, dh (M, I), a (M, I), int M, int I,
//                     int act, cudaStream_t stream)
// with I a multiple of the width's chunk (192 at 768, 256 at 1024); each
// returns cudaGetLastError() after its launch.

#include "ffn.cuh"

namespace stonkgs {
namespace ffn {
namespace {

// the backward kernels: two row operands (x and g), 32 rows (bf16) or 16
template <typename T> struct BwdTiling;
template <> struct BwdTiling<__nv_bfloat16> { using L = Layout<__nv_bfloat16, 768, 32, 3, 2>; };
template <> struct BwdTiling<float> { using L = Layout<float, 768, 16, 2, 2>; };

template <typename T>
__global__ void __launch_bounds__(Width<768>::kThreads, 1)
ffn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2t,
               const T* __restrict__ w1t, T* __restrict__ dx, T* __restrict__ dh_out,
               T* __restrict__ a_out, int M, int I, int act) {
  using L = typename BwdTiling<T>::L;
  constexpr int BM = L::BM, STAGES = L::STAGES;
  constexpr int kH = L::kH, kChunk = L::kChunk, kThreads = L::kThreads, kWarps = L::kWarps;
  constexpr int kTiles1 = L::kTiles1, kTiles2 = L::kTiles2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + L::xs_bytes);
  unsigned char* work = smem + 2 * L::xs_bytes;
  T* wbuf = reinterpret_cast<T*>(work);
  float* hf = reinterpret_cast<float*>(work + L::wbuf_bytes);
  T* hs = reinterpret_cast<T*>(work + L::wbuf_bytes + L::hf_bytes);
  float* stage = reinterpret_cast<float*>(work);  // epilogue only

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM;
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

  if constexpr (kIsBf16<T>) {
    // W1 and W2^T products: warp owns columns [warp*16, +16) of the chunk.
    // W1^T product: warp owns dx columns [warp*64, +64).
    constexpr int RF = BM / 16;
    constexpr int kCols = kH / kWarps;
    using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
    Acc acc[RF][kCols / 16];
#pragma unroll
    for (int i = 0; i < RF; ++i) {
#pragma unroll
      for (int j = 0; j < kCols / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    }
    for (int c0 = 0; c0 < I; c0 += kChunk) {
      // h = x @ W1[:, chunk]; a = gelu(h + b1) out, gelu'(h) into hf
      Acc hacc[RF];
#pragma unroll
      for (int i = 0; i < RF; ++i) wmma::fill_fragment(hacc[i], 0.f);
      for (int t = 0; t < kTiles1; ++t) mma_w1_tile<L>(hacc, xs, advance(), t, warp);
#pragma unroll
      for (int i = 0; i < RF; ++i)
        wmma::store_matrix_sync(hf + i * 16 * L::HFS + warp * 16, hacc[i], L::HFS,
                                wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < BM * 16; e += 32) {
        const int r = e / 16, c = warp * 16 + e % 16;
        float av, dav;
        gelu_and_grad(hf[r * L::HFS + c] + b1[c0 + c], act, av, dav);
        hf[r * L::HFS + c] = dav;
        if (row0 + r < M) a_out[size_t(row0 + r) * I + c0 + c] = from_f<T>(av);
      }
      __syncwarp();
      // gw = g @ W2^T[:, chunk]; dh = gw * gelu'(h) in the same fragment layout
      Acc gacc[RF];
#pragma unroll
      for (int i = 0; i < RF; ++i) wmma::fill_fragment(gacc[i], 0.f);
      for (int t = 0; t < kTiles1; ++t) mma_w1_tile<L>(gacc, gs, advance(), t, warp);
#pragma unroll
      for (int i = 0; i < RF; ++i) {
        Acc dact;
        float* strip = hf + i * 16 * L::HFS + warp * 16;
        wmma::load_matrix_sync(dact, strip, L::HFS, wmma::mem_row_major);
#pragma unroll
        for (int e = 0; e < gacc[i].num_elements; ++e) gacc[i].x[e] *= dact.x[e];
        wmma::store_matrix_sync(strip, gacc[i], L::HFS, wmma::mem_row_major);
      }
      __syncwarp();
      // dh rounded: to device memory and, for the dx product, to hs (the
      // barrier in the next advance() publishes hs to every warp)
      for (int e = lane; e < BM * 16; e += 32) {
        const int r = e / 16, c = warp * 16 + e % 16;
        const T dh = from_f<T>(hf[r * L::HFS + c]);
        hs[r * L::HSS + c] = dh;
        if (row0 + r < M) dh_out[size_t(row0 + r) * I + c0 + c] = dh;
      }
      // acc += dh @ W1^T[chunk, :]
      for (int kt = 0; kt < kTiles2; ++kt) mma_w2_tile<L>(acc, hs, advance(), kt, warp);
    }
    __syncthreads();  // the ring is free: stage the accumulators there
#pragma unroll
    for (int i = 0; i < RF; ++i) {
#pragma unroll
      for (int j = 0; j < kCols / 16; ++j)
        wmma::store_matrix_sync(stage + warp * kCols + j * 16, acc[i][j], L::STS,
                                wmma::mem_row_major);
      __syncthreads();
      epilogue_rows<L, T, false>(stage, xs, i * 16, row0, M, nullptr, no_ln, dx);
      __syncthreads();
    }
  } else {
    // fp32: thread owns chunk column tid % 192 and rows [(tid / 192) * 8,
    // +8) in the W1 and W2^T products; dx columns tid and tid + 384.
    static_assert(BM == 16 && kThreads == 2 * kChunk && kH == 2 * kThreads,
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
    (void)hf;
  }
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* w1, const float* b1, const void* w2t,
               const void* w1t, void* dx, void* dh, void* a, int M, int I, int act,
               cudaStream_t stream) {
  using L = typename BwdTiling<T>::L;
  if (M <= 0 || I <= 0 || I % L::kChunk != 0 || (act != 0 && act != 1))
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ffn_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(L::smem_bytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((M + L::BM - 1) / L::BM);
  ffn_bwd_kernel<T><<<grid, L::kThreads, L::smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2t), static_cast<const T*>(w1t), static_cast<T*>(dx),
      static_cast<T*>(dh), static_cast<T*>(a), M, I, act);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace ffn
}  // namespace stonkgs

extern "C" int ffn_train_fwd(int dtype, const void* x, const void* w1, const float* b1,
                             const void* w2, const float* b2, void* out, int M, int H, int I,
                             int act, void* stream) {
  using namespace stonkgs::ffn;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LnArgs no_ln{};
  if (dtype == 0)
    return launch_fwd<float, false>(x, nullptr, w1, b1, w2, b2, no_ln, out, M, H, I, act, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, false>(x, nullptr, w1, b1, w2, b2, no_ln, out, M, H, I,
                                            act, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int ffn_train_bwd(int dtype, const void* x, const void* g, const void* w1,
                             const float* b1, const void* w2t, const void* w1t, void* dx,
                             void* dh, void* a, int M, int I, int act, void* stream) {
  using namespace stonkgs::ffn;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(x, g, w1, b1, w2t, w1t, dx, dh, a, M, I, act, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, g, w1, b1, w2t, w1t, dx, dh, a, M, I, act, s);
  return int(cudaErrorInvalidValue);
}
