// Fused int8 dense: per-row absmax quantization of x, int8 x int8 -> int32
// on the tensor cores, and the epilogue acc * s_x * s_w + bias:
//   s_x[m] = max(max_k |x[m, k]| / 127, 1e-12)
//   q[m, k] = clip(rint(x[m, k] / s_x[m]), -127, 127)
//   y[m, n] = round_T(((float(sum_k q[m, k] * W[k, n]) * s_x[m]) * s_w[n]) + b[n])
//
// Replaces the TPU kernel _fused_kernel (stonkgs_tpu/ops/quantization_pallas.py:33).
// Bound on the H100 by bytes at the 768 -> 768 projections and by
// operations at the 768 <-> 3072 products (see
// stonkgs_tpu_torch/ops/quantization.py for the design note).
//
// Two launches a call (int8_sm90.cuh), so that each row is quantized once:
//   1. quantize_rows_kernel: x -> the int8 codes q (M, K) and s_x (M,),
//      scratch of the caller;
//   2. gemm_kmajor_sm90_kernel<int8_t, T, 256, 128, 3, true>: q . W with W
//      K-major, (N, K) row-major (wgmma takes 8-bit operands only K-major;
//      ops/quantization.py keeps the weight so on the card), s32
//      accumulators, and the dequantizing epilogue into y, stored with TMA;
//      one persistent block an SM walks 256 x 128 tiles of y.
// IEEE division and rintf (round half to even) give the codes of the
// plain version exactly; the epilogue's products are rounded one by one
// (no fused multiply-add), as the plain version computes them.
//
// Any K >= 1.  Kp is K rounded up to a multiple of 16, the pass's and the
// GEMM's step: x comes as Kp-wide rows whose columns past K are zero (the
// wrapper pads a ragged K; a zero leaves the row's absmax as it is and
// quantizes to code 0), the codes q are (M, Kp), and the GEMM's tensor
// maps take the true K with rows Kp (codes) and ldw (W) apart, so TMA
// zero-fills the last k-step's columns past K and W's padding is never
// read.  ops/quantization.py::quantized_to lays W out so once, on the card.
//
// C interface (all pointers on the device, 16-byte aligned; x has rows of
// stride ldx elements and a unit column stride, ldx * sizeof(T) a multiple
// of 16, its columns K to Kp zero; q (M, Kp) int8 and s_x (M,) fp32 the
// caller's scratch; w (N, K) row-major int8 with rows ldw >= K elements
// apart, ldw a multiple of 16; w_scale and bias fp32, bias may be null;
// out (M, N) in x's dtype with rows ldo elements apart, ldo * sizeof(T) a
// multiple of 16):
//   int dense_int8(int dtype /*0 fp32, 1 bf16*/, x, long long ldx, q, s_x,
//                  w, long long ldw, w_scale, bias, out, long long ldo,
//                  int M, int K, int N, cudaStream_t stream)
// with M >= 1, N >= 1 and K >= 1; returns cudaGetLastError() after the
// launches (or -1 when a tensor map cannot be encoded).  The two launches
// are also exposed on their own (dense_int8_quantize over Kp-wide rows,
// dense_int8_gemm with the true K) for checks and timing.

#include "int8_sm90.cuh"

namespace stonkgs {
namespace int8_90 {

// the codes' and W's rows are K rounded up to a multiple of 16 apart
inline long long padded_k(int K) { return (K + 15LL) / 16 * 16; }

template <typename T>
int launch_dense_gemm(const void* q, const float* sx, const void* w, long long ldw,
                      const float* w_scale, const float* bias, void* out, long long ldo, int M,
                      int K, int N, cudaStream_t stream) {
  return launch_gemm<int8_t, T, 256, 128, 3, true>(q, w, out, ldo, sx, w_scale, bias, M, N, K,
                                                   stream, padded_k(K), ldw);
}

}  // namespace int8_90
}  // namespace stonkgs

extern "C" int dense_int8_quantize(int dtype, const void* x, long long ldx, void* q, float* sx,
                                   int M, int K, void* stream) {
  using namespace stonkgs::int8_90;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_quantize<float>(x, ldx, q, sx, M, K, s);
  if (dtype == 1) return launch_quantize<__nv_bfloat16>(x, ldx, q, sx, M, K, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int dense_int8_gemm(int dtype, const void* q, const float* sx, const void* w,
                               long long ldw, const float* w_scale, const float* bias, void* out,
                               long long ldo, int M, int K, int N, void* stream) {
  using namespace stonkgs::int8_90;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dense_gemm<float>(q, sx, w, ldw, w_scale, bias, out, ldo, M, K, N, s);
  if (dtype == 1)
    return launch_dense_gemm<__nv_bfloat16>(q, sx, w, ldw, w_scale, bias, out, ldo, M, K, N, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int dense_int8(int dtype, const void* x, long long ldx, void* q, float* sx,
                          const void* w, long long ldw, const float* w_scale, const float* bias,
                          void* out, long long ldo, int M, int K, int N, void* stream) {
  using stonkgs::int8_90::padded_k;
  if (N <= 0 || K <= 0) return int(cudaErrorInvalidValue);
  // the pass quantizes the Kp-wide zero-padded rows (x's padding is zero)
  const int status = dense_int8_quantize(dtype, x, ldx, q, sx, M, int(padded_k(K)), stream);
  if (status != 0) return status;
  return dense_int8_gemm(dtype, q, sx, w, ldw, w_scale, bias, out, ldo, M, K, N, stream);
}
