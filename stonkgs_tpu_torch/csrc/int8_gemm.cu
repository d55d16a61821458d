// GEMM probe: C = A . B for row-major A (M, K) and a K-major B, given as
// B^T (N, K) row-major, int8 -> int32 or, as the control, bf16 -> fp32, on
// the tensor cores through wgmma.
//
// Replaces the TPU kernel _matmul_kernel (benchmarks/bench_int8_gemm.py:27),
// the probe of whether an int8 GEMM reaches twice the bf16 rate (on the
// H100: 1,979 int8 TOP/s against 989 bf16 TFLOP/s).  Bound by operations at
// 4096^3 (0.069 ms int8, 0.139 ms bf16); see
// stonkgs_tpu_torch/benchmarks/bench_int8_gemm.py.
//
// The TPU kernel walks k sequentially in its grid and carries the sum in a
// VMEM scratch accumulator.  Here the int8 dense's GEMM core
// (int8_sm90.cuh, gemm_kmajor_sm90_kernel without its dequantizing
// epilogue) owns a BM x BN tile of C and walks K itself, the sum in
// registers: a producer warpgroup streams one 128-byte swizzled line of K
// a stage (128 int8 or 64 bf16 values) of A and B through a TMA ring, two
// consumer warpgroups issue wgmma.m64nNk32.s32.s8.s8 (the control:
// wgmma.m64nNk16.f32.bf16.bf16, both operands K-major as well), and C
// leaves through the free ring with TMA stores.  One design for both
// types, so the probe compares int8 with bf16 and nothing else.
//
// C interface (all pointers on the device, contiguous, 16-byte aligned):
//   int int8_gemm(int dtype /*0 int8 -> int32, 1 bf16 -> fp32*/, int bm,
//                 int bn, int bk, a, bt, c, int M, int N, int K,
//                 cudaStream_t stream)
// with (bm, bn, bk) one of the instantiated tiles (below; bk = 128, the K
// bytes of a ring stage) and bt = B^T (N, K); returns cudaGetLastError()
// after the launch (or -1 when a tensor map cannot be encoded).

#include "int8_sm90.cuh"

namespace stonkgs {
namespace int8_90 {

// the instantiated tiles (bm, bn, bk) and their ring depths, both types;
// kept in step with TILES in stonkgs_tpu_torch/benchmarks/bench_int8_gemm.py
template <typename TIn, typename TOut>
int dispatch(int bm, int bn, int bk, const void* a, const void* bt, void* c, int M, int N,
             int K, cudaStream_t s) {
#define STONKGS_TILE(BM_, BN_, STAGES_)                                                 \
  if (bm == BM_ && bn == BN_ && bk == kLineBytes)                                       \
    return launch_gemm<TIn, TOut, BM_, BN_, STAGES_, false>(a, bt, c, N, nullptr, nullptr, \
                                                            nullptr, M, N, K, s);
  STONKGS_TILE(128, 128, 5)
  STONKGS_TILE(128, 256, 3)
  STONKGS_TILE(256, 128, 3)
#undef STONKGS_TILE
  return int(cudaErrorInvalidValue);
}

}  // namespace int8_90
}  // namespace stonkgs

extern "C" int int8_gemm(int dtype, int bm, int bn, int bk, const void* a, const void* bt,
                         void* c, int M, int N, int K, void* stream) {
  using namespace stonkgs::int8_90;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<int8_t, int>(bm, bn, bk, a, bt, c, M, N, K, s);
  if (dtype == 1) return dispatch<__nv_bfloat16, float>(bm, bn, bk, a, bt, c, M, N, K, s);
  return int(cudaErrorInvalidValue);
}
