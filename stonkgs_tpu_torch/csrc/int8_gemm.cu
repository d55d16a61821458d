// Tiled GEMM probe: C = A . B for row-major A (M, K) and B (K, N), int8 ->
// int32 or, as the control, bf16 -> fp32, on the tensor cores.
//
// Replaces the TPU kernel _matmul_kernel (benchmarks/bench_int8_gemm.py:27),
// the probe of whether an int8 GEMM reaches twice the bf16 rate (on the
// H100: 1,979 int8 TOP/s against 989 bf16 TFLOP/s).  Bound by operations at
// 4096^3 (0.069 ms int8, 0.139 ms bf16); see
// stonkgs_tpu_torch/benchmarks/bench_int8_gemm.py.
//
// The TPU kernel walks k sequentially in its grid and carries the sum in a
// VMEM scratch accumulator.  Here one block of 8 warps owns a BM x BN tile
// of C and walks K itself, the sum in registers (wmma accumulators, each
// warp a (BM/2) x (BN/4) sub-tile of 16 x 16 fragments); the BM x BK and
// BK x BN tiles stream through a ring of STAGES shared buffers filled by
// cp.async, STAGES - 1 tiles ahead.  Shared tiles are kept in 16-wide
// k-blocks (A as [k/16][m][16], B as [n/16][k][16]) so that every wmma
// fragment is contiguous.  The tile shapes are template parameters; a
// shape the tiles do not divide is refused.
//
// C interface (all pointers on the device, contiguous):
//   int int8_gemm(int dtype /*0 int8 -> int32, 1 bf16 -> fp32*/, int bm,
//                 int bn, int bk, a, b, c, int M, int N, int K,
//                 cudaStream_t stream)
// with (bm, bn, bk) one of the instantiated tiles (kTiles below) dividing
// (M, N, K); returns cudaGetLastError() after the launch.

#include <mma.h>

#include "common.cuh"

namespace stonkgs {
namespace gemm {

using namespace nvcuda;

constexpr int kThreads = 256, kStages = 3;

template <typename T> struct Types;
template <> struct Types<signed char> { using Acc = int; };
template <> struct Types<__nv_bfloat16> { using Acc = float; };

// one 16-byte cp.async piece per (row, k-block piece) of A and per (k
// row, n-block piece) of B; P pieces a 16-wide block row.  A 32-lane unit
// covers 8 rows and 32 / (8 P) blocks, so that a quarter warp fills 128
// contiguous bytes of shared memory.
template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            typename Types<T>::Acc* __restrict__ c, int M, int N, int K) {
  using Acc = typename Types<T>::Acc;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, Acc>;
  constexpr int WM = BM / 2, WN = BN / 4, FM = WM / 16, FN = WN / 16;
  constexpr int V = 16 / sizeof(T), P = 16 / V, U = 32 / (P * 8);
  constexpr int A_ELEMS = BM * BK, B_ELEMS = BK * BN;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile shape");
  static_assert((BK / 16) % U == 0 && (BN / 16) % U == 0 && BM % 8 == 0 && BK % 8 == 0,
                "load units");

  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);   // kStages x (A tile, B tile)

  const int warp = threadIdx.x / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp / 4, wn = warp % 4;
  const int tiles = K / BK;

  auto fetch = [&](int t) {
    if (t < tiles) {
      T* as = ring + (t % kStages) * (A_ELEMS + B_ELEMS);
      T* bs = as + A_ELEMS;
      const int k0 = t * BK;
      for (int v = threadIdx.x; v < A_ELEMS / V; v += kThreads) {
        const int u = v / 32, l = v % 32;
        const int r = (u % (BM / 8)) * 8 + (l / P) % 8;
        const int kb = (u / (BM / 8)) * U + l / (P * 8);
        const int cc = (l % P) * V;
        cp_async16(as + (kb * BM + r) * 16 + cc, a + size_t(m0 + r) * K + k0 + kb * 16 + cc);
      }
      for (int v = threadIdx.x; v < B_ELEMS / V; v += kThreads) {
        const int u = v / 32, l = v % 32;
        const int r = (u % (BK / 8)) * 8 + (l / P) % 8;
        const int nb = (u / (BK / 8)) * U + l / (P * 8);
        const int cc = (l % P) * V;
        cp_async16(bs + (nb * BK + r) * 16 + cc, b + size_t(k0 + r) * N + n0 + nb * 16 + cc);
      }
    }
    cp_async_commit();
  };

  FragC acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], Acc(0));
  }

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t is in (this thread's pieces)
    __syncthreads();               // ... everyone's; buffer (t-1) % kStages is free
    fetch(t + kStages - 1);
    const T* as = ring + (t % kStages) * (A_ELEMS + B_ELEMS);
    const T* bs = as + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragB bf[FN];
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], bs + ((wn * FN + j) * BK + kk * 16) * 16, 16);
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        FragA af;
        wmma::load_matrix_sync(af, as + (kk * BM + wm * WM + i * 16) * 16, 16);
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af, bf[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(c + size_t(m0 + wm * WM + i * 16) * N + n0 + wn * WN + j * 16,
                              acc[i][j], N, wmma::mem_row_major);
  }
}

template <typename T, int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % BK || M / BM > 65535)
    return int(cudaErrorInvalidValue);
  constexpr size_t smem = size_t(kStages) * (BM * BK + BK * BN) * sizeof(T);
  auto* kernel = gemm_kernel<T, BM, BN, BK>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kernel<<<dim3(N / BN, M / BM), kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<typename Types<T>::Acc*>(c), M, N, K);
  return int(cudaGetLastError());
}

// the instantiated tiles (bm, bn, bk), both types; kept in step with
// TILES in stonkgs_tpu_torch/benchmarks/bench_int8_gemm.py
template <typename T>
int dispatch(int bm, int bn, int bk, const void* a, const void* b, void* c, int M, int N, int K,
             cudaStream_t s) {
#define STONKGS_TILE(BM_, BN_, BK_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return launch<T, BM_, BN_, BK_>(a, b, c, M, N, K, s);
  STONKGS_TILE(64, 128, 64)
  STONKGS_TILE(128, 128, 64)
  STONKGS_TILE(128, 128, 128)
  STONKGS_TILE(128, 256, 64)
  STONKGS_TILE(256, 128, 64)
#undef STONKGS_TILE
  return int(cudaErrorInvalidValue);
}

}  // namespace gemm
}  // namespace stonkgs

extern "C" int int8_gemm(int dtype, int bm, int bn, int bk, const void* a, const void* b,
                         void* c, int M, int N, int K, void* stream) {
  using namespace stonkgs::gemm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<signed char>(bm, bn, bk, a, b, c, M, N, K, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(bm, bn, bk, a, b, c, M, N, K, s);
  return int(cudaErrorInvalidValue);
}
