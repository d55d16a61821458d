// Post-attention half of a post-LN BERT layer:
//   out = LN2(x2 + (gelu(x2 @ W1 + b1) @ W2 + b2)),  x2 = LN1(x + attn_out)
//
// Replaces the TPU kernel _ffn_ln_kernel (stonkgs_tpu/ops/fused_ffn.py:438).
// Bound on the H100 by operations (4*M*H*I); see
// stonkgs_tpu_torch/ops/fused_ffn.py for the design note.
//
// bf16 runs the Hopper kernels of ffn_sm90.cuh, four launches: LN1 into
// the scratch x2, the wgmma GEMM x2 @ W1 with a b1 + gelu epilogue into
// the scratch h (M, I), the wgmma GEMM h @ W2 with a b2 epilogue into out,
// and LN2 in place.  fp32 runs ffn_fwd_kernel<true> of ffn.cuh in one
// launch up to a padded H of 2048 (one block owns 16 rows: LN1 into shared
// memory, the intermediate axis walked in chunks with the (16, H) fp32
// accumulator in registers, LN2 in the epilogue) and the split path of
// ffn.cuh above it (chunked LayerNorm passes, two SIMT GEMMs through an
// fp32 scratch h); it exists to hold the model against the CPU.  Both take
// any H >= 1 (768 in BERT-base layers and the BigBird trunk, 1024 in
// ProtBERT, 384 in MiniLM-L12-H384, the KG vectors' width in the command
// line's configs: 2,560 from a 2,560-wide TSV) and any I >= 1, on arrays
// in the padded layout of ffn.cuh (rows of ld(H) or ld(I) elements:
// multiples of 32 in fp32, of 8 in bf16); the LayerNorm statistics run
// over the true H.
//
// C interface (all pointers on the device; LayerNorm and bias vectors fp32;
// every array in the padded layout, x (M, ld(H)), W1 (ld(H), ld(I)) and so
// on):
//   int ffn_ln_block(int dtype /*0 fp32, 1 bf16*/, x, attn_out, ln1_scale,
//                    ln1_bias, w1 (H, I), b1, w2 (I, H), b2, ln2_scale,
//                    ln2_bias, x2 /*(M, ld(H)) scratch in x's dtype: bf16,
//                    and fp32 at ld(H) > 2048; else NULL*/, h /*(M, ld(I))
//                    scratch, likewise*/, out, int M, int H, int I,
//                    int act /*0 gelu(erf), 1 gelu_new(tanh)*/, float eps,
//                    cudaStream_t stream)
// with M, H and I the true widths; returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue, with no launch, for H or I below 8 or a
// missing scratch; -1 when a TMA tensor map cannot be encoded).

#include "ffn_sm90.cuh"

extern "C" int ffn_ln_block(int dtype, const void* x, const void* attn_out,
                            const float* ln1_scale, const float* ln1_bias, const void* w1,
                            const float* b1, const void* w2, const float* b2,
                            const float* ln2_scale, const float* ln2_bias, void* x2, void* h,
                            void* out, int M, int H, int I, int act, float eps, void* stream) {
  using namespace stonkgs::ffn;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LnArgs ln{ln1_scale, ln1_bias, ln2_scale, ln2_bias, eps, H};
  if (dtype == 0)
    return launch_fwd<true>(x, attn_out, w1, b1, w2, b2, ln, x2, h, out, M, H, I, act, s);
  if (dtype == 1)
    return stonkgs::ffn90::launch_ffn_ln_sm90(x, attn_out, ln, w1, b1, w2, b2, x2, h, out, M, H,
                                              I, act, s);
  return int(cudaErrorInvalidValue);
}
