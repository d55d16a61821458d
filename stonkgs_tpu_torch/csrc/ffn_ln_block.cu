// Post-attention half of a post-LN BERT layer in one kernel:
//   out = LN2(x2 + (gelu(x2 @ W1 + b1) @ W2 + b2)),  x2 = LN1(x + attn_out)
//
// Replaces the TPU kernel _ffn_ln_kernel (stonkgs_tpu/ops/fused_ffn.py:438).
// Bound on the H100 by operations (4*M*H*I); see
// stonkgs_tpu_torch/ops/fused_ffn.py for the design note.
//
// The kernel is ffn_fwd_kernel<T, true, H> of ffn.cuh, at H = 768 (BERT-base
// layers and the BigBird trunk) or 1024 (ProtBERT).  One block owns BM rows
// (H = 768: 48 for bf16, 16 for fp32, 384 threads; H = 1024: 32 for bf16,
// 16 for fp32, 512 threads):
//   1. LN1 of its rows into shared memory (x2, rounded to T);
//   2. for each chunk (192 or 256 wide) of the intermediate axis:
//        h = x2 @ W1[:, chunk]    (W1 streamed in 64 x chunk tiles)
//        h = round_T(gelu(h + b1))
//        acc += h @ W2[chunk, :]  (W2 streamed in 16 x H tiles)
//      with the (BM, H) fp32 accumulator held in registers;
//   3. epilogue per 16 rows: ff = round_T(acc + b2), LN2(x2 + ff) -> out.
//
// C interface (all pointers on the device; LayerNorm and bias vectors fp32):
//   int ffn_ln_block(int dtype /*0 fp32, 1 bf16*/, x, attn_out, ln1_scale,
//                    ln1_bias, w1 (H, I), b1, w2 (I, H), b2, ln2_scale,
//                    ln2_bias, out, int M, int H, int I, int act /*0 gelu(erf),
//                    1 gelu_new(tanh)*/, float eps, cudaStream_t stream)
// with H 768 or 1024 and I a multiple of its chunk (192 or 256); returns
// cudaGetLastError() after the launch.

#include "ffn.cuh"

extern "C" int ffn_ln_block(int dtype, const void* x, const void* attn_out,
                            const float* ln1_scale, const float* ln1_bias, const void* w1,
                            const float* b1, const void* w2, const float* b2,
                            const float* ln2_scale, const float* ln2_bias, void* out, int M,
                            int H, int I, int act, float eps, void* stream) {
  using namespace stonkgs::ffn;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LnArgs ln{ln1_scale, ln1_bias, ln2_scale, ln2_bias, eps};
  if (dtype == 0)
    return launch_fwd<float, true>(x, attn_out, w1, b1, w2, b2, ln, out, M, H, I, act, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, true>(x, attn_out, w1, b1, w2, b2, ln, out, M, H, I, act,
                                           s);
  return int(cudaErrorInvalidValue);
}
