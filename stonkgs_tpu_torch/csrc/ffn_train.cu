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
// GEMM that writes a and dh, then the dx GEMM.  Both dtypes take any H >= 1
// and any I >= 1, on arrays in the padded layout of ffn.cuh (rows of ld(H)
// or ld(I) elements: multiples of 32 in fp32, of 8 in bf16).
//
// fp32 runs SIMT bodies that exist to hold the model against the CPU.  Up
// to a padded H of 2048 (kRowHidden): the forward is ffn_fwd_kernel<G,
// false> of ffn.cuh; the backward, below, is built from the same pieces
// with two row operands, in the same two geometries (Narrow up to a padded
// H of 1024, Wide above), at the padded widths.  Above 2048 both are split
// at h, as bf16 is, into ffn.cuh's tiled SIMT GEMM (launch_bwd_split): the
// forward's two products through an fp32 scratch h, and the backward's
// x W1 + b1 into a, then g W2^T with an epilogue that turns a's h into
// gelu(h) and writes dh = (g W2^T) gelu'(h), then dh W1^T into dx.  One block owns kBM rows of x and g, both kept in shared memory,
// and walks I in chunks of 128 (the last one narrower when I % 128 != 0).
// For each chunk:
//   h = x @ W1[:, chunk]        (W1 streamed in 32 x chunk tiles)
//   a = gelu(h + b1) -> a[:, chunk];  gelu'(h) kept
//   gw = g @ W2^T[:, chunk]     (W2^T (H, I) streamed in 32 x chunk tiles)
//   dh = gw * gelu'(h) -> dh[:, chunk], and kept in shared memory
//   acc += dh @ W1^T[chunk, :]  (W1^T (I, H) streamed in kK2 x H tiles)
// with the (kBM, H) dx accumulator in registers.  The three weight streams
// of a chunk form one sequence through the cp.async ring of ffn.cuh; the
// caller passes W2^T and W1^T, so every tile is one of the two shapes the
// forward streams.
// dW1 = x^T dh, dW2 = a^T g and the bias sums are left to the caller, as
// the TPU kernel leaves them to XLA.
//
// C interface (all pointers on the device; b1, b2 fp32; every array in the
// padded layout, x (M, ld(H)), W1 (ld(H), ld(I)) and so on):
//   int ffn_train_fwd(int dtype /*0 fp32, 1 bf16*/, x, w1, b1, w2, b2,
//                     h /*(M, I) scratch in x's dtype: bf16, and fp32 at
//                     ld(H) > 2048; else NULL*/, out, int M, int H, int I,
//                     int act /*0 gelu(erf), 1 gelu_new*/, cudaStream_t stream)
//   int ffn_train_bwd(int dtype, x, g, w1 (H, I), b1, w2 (I, H),
//                     w2t (H, I), w1t (I, H) /*fp32 only, else NULL*/,
//                     dx, dh (M, I), a (M, I), int M, int H, int I,
//                     int act, cudaStream_t stream)
// with M, H and I the true widths, H >= 1 and I >= 1; each returns
// cudaGetLastError() after its launches (cudaErrorInvalidValue, with no
// launch, for other widths or a missing scratch; -1 when a TMA tensor map
// cannot be encoded).

#include "ffn_train_sm90.cuh"

namespace stonkgs {
namespace ffn {
namespace {

// the fp32 backward kernel: two row operands (x and g), kBM rows, at the
// padded widths H and I
template <class G>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gy,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2t, const float* __restrict__ w1t,
               float* __restrict__ dx, float* __restrict__ dh_out, float* __restrict__ a_out,
               int M, int H, int I, int act, Layout L) {
  constexpr int kBM = G::kBM, kRows = G::kRowsW1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* gs = reinterpret_cast<float*>(smem + L.xs_bytes);
  unsigned char* work = smem + 2 * L.xs_bytes;
  float* wbuf = reinterpret_cast<float*>(work);
  float* hs = reinterpret_cast<float*>(work + L.wbuf_bytes);
  float* stage = reinterpret_cast<float*>(work);  // epilogue only

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBM;
  const int nt1 = H / kK1;
  const int per = 2 * nt1 + kChunk / G::kK2;  // W1, W2^T, W1^T tiles a full chunk
  const int total = stream_tiles<G>(I, per);

  auto fetch = [&](int g) {
    if (g < total) {
      float* dst = wbuf + (g % kStages) * L.WBUF;
      const int c = g / per, c0 = c * kChunk, t = g - c * per, cn = min(kChunk, I - c0);
      if (t < nt1)
        fetch_w1(dst, L, w1, I, c0, cn, t);
      else if (t < 2 * nt1)
        fetch_w1(dst, L, w2t, I, c0, cn, t - nt1);
      else
        fetch_w2<G>(dst, L, w1t, H, c0, t - 2 * nt1);
    }
    cp_async_commit();
  };
  fetch(0);
  load_row_block<G>(xs, L, x, row0, M, H);
  load_row_block<G>(gs, L, gy, row0, M, H);

  int g = 0;
  auto advance = [&]() -> const float* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(g + kStages - 1);
    const float* cur = wbuf + (g % kStages) * L.WBUF;
    ++g;
    return cur;
  };
  const LnArgs no_ln{};

  // thread owns chunk column tid % 128 of kRowsW1 rows from hr in the W1
  // and W2^T products; dx columns tid + 256j below H.
  const int hc = tid % kChunk, hr = (tid / kChunk) * kRows;
  float acc[kBM][G::kCols];
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int j = 0; j < G::kCols; ++j) acc[r][j] = 0.f;
  for (int c0 = 0; c0 < I; c0 += kChunk) {
    const int cn = min(kChunk, I - c0);
    const bool live = hc < cn;
    float hacc[kRows], gacc[kRows], dact[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) hacc[r] = gacc[r] = 0.f;
    for (int t = 0; t < nt1; ++t) fma_w1_tile<G>(hacc, xs, L, advance(), t, hr, hc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float av = 0.f;
      dact[r] = 0.f;
      if (live) gelu_and_grad(hacc[r] + b1[c0 + hc], act, av, dact[r]);
      if (live && row0 + hr + r < M) a_out[size_t(row0 + hr + r) * I + c0 + hc] = av;
    }
    for (int t = 0; t < nt1; ++t) fma_w1_tile<G>(gacc, gs, L, advance(), t, hr, hc);
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dh = gacc[r] * dact[r];
        hs[(hr + r) * L.HSS + hc] = dh;
        if (row0 + hr + r < M) dh_out[size_t(row0 + hr + r) * I + c0 + hc] = dh;
      }
    }
    for (int kt = 0; kt < cn / G::kK2; ++kt) fma_w2_tile<G>(acc, hs, L, advance(), kt, H);
  }
  __syncthreads();
  stage_acc<G>(stage, L, acc, H);
  __syncthreads();
  epilogue_rows<G, false>(stage, xs, L, row0, M, H, nullptr, no_ln, dx);
}

// the split fp32 backward at the padded widths Hp > kRowHidden and Ip:
// a = x W1 + b1 (h, in a's place), then dh = (g W2^T) gelu'(h) with a =
// gelu(h) in the same epilogue, then dx = dh W1^T
int launch_bwd_split(const void* x, const void* g, const void* w1, const float* b1,
                     const void* w2t, const void* w1t, void* dx, void* dh, void* a, int M, int Hp,
                     int Ip, int act, cudaStream_t stream) {
  float* af = static_cast<float*>(a);
  int s = launch_gemm_f32<kEpiBias>(x, w1, b1, a, nullptr, M, Ip, Hp, act, stream);
  if (s != 0) return s;
  s = launch_gemm_f32<kEpiGeluGrad>(g, w2t, nullptr, dh, af, M, Ip, Hp, act, stream);
  if (s != 0) return s;
  return launch_gemm_f32<kEpiBias>(dh, w1t, nullptr, dx, nullptr, M, Hp, Ip, act, stream);
}

// the fp32 backward at the true widths H and I (widths_ok), on arrays in
// the padded layout
int launch_bwd_f32(const void* x, const void* g, const void* w1, const float* b1,
                   const void* w2t, const void* w1t, void* dx, void* dh, void* a, int M, int H,
                   int I, int act, cudaStream_t stream) {
  if (M <= 0 || !widths_ok(H, I) || (act != 0 && act != 1) || !w2t || !w1t)
    return int(cudaErrorInvalidValue);
  const int Hp = padded_width(H, 0), Ip = padded_width(I, 0);
  if (Hp > kRowHidden)
    return launch_bwd_split(x, g, w1, b1, w2t, w1t, dx, dh, a, M, Hp, Ip, act, stream);
  return with_geometry(Hp, [&](auto geo) {
    using G = decltype(geo);
    const Layout L = make_layout<G>(Hp);
    const size_t smem = L.smem_bytes(2);
    cudaError_t e = cudaFuncSetAttribute(ffn_bwd_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const dim3 grid((M + G::kBM - 1) / G::kBM);
    ffn_bwd_kernel<G><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(w1), b1, static_cast<const float*>(w2t),
        static_cast<const float*>(w1t), static_cast<float*>(dx), static_cast<float*>(dh),
        static_cast<float*>(a), M, Hp, Ip, act, L);
    return int(cudaGetLastError());
  });
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
    return ffn::launch_fwd<false>(x, nullptr, w1, b1, w2, b2, ffn::LnArgs{}, nullptr, h, out, M,
                                  H, I, act, s);
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
