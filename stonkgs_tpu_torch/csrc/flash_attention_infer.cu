// Inference attention: out = softmax(Q K^T * scale + key_bias) V, with q, k,
// v and out in the (B, S, H, D=64) layout, read with strides.
//
// Replaces the TPU kernel _infer_kernel
// (stonkgs_tpu/ops/flash_attention.py:359).  Bound on the H100 by the bytes
// of q, k, v and out at the trunk's shape (or by operations, 4*B*H*S^2*D,
// at longer S); see stonkgs_tpu_torch/ops/flash_attention.py for the
// design note.
//
// The kernel is attn_fwd_kernel<T, false> of attention.cuh: one block per
// (64-row query tile, head, batch) with 4 warps, K streamed through shared
// memory twice (row statistics, then normalised P rounded to T and P V).
// Keys >= S take no part.  About 54 KB of shared memory (bf16), so four
// blocks share an SM.
//
// C interface:
//   int flash_attention_infer(int dtype /*0 fp32, 1 bf16*/, q, k, v,
//                             const float* key_bias /*(B, S) or NULL*/, out,
//                             int B, int S, int H, float scale,
//                             cudaStream_t stream)
// returns cudaGetLastError() after the launch.

#include "attention.cuh"

extern "C" int flash_attention_infer(int dtype, const void* q, const void* k, const void* v,
                                     const float* key_bias, void* out, int B, int S, int H,
                                     float scale, void* stream) {
  using namespace stonkgs::attn;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout none{};
  if (dtype == 0)
    return launch_fwd<float, false>(q, k, v, key_bias, out, nullptr, B, S, H, scale, none, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, false>(q, k, v, key_bias, out, nullptr, B, S, H, scale,
                                            none, s);
  return int(cudaErrorInvalidValue);
}
