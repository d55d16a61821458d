// Inference attention: out = softmax(Q K^T * scale + key_bias) V, with q, k,
// v and out in the (B, S, H, D) layout, D any multiple of 8 (up to 256 run
// on the instance of its padded width 16, 32, 64, 128 or 256, the columns
// past D zero; past it, in bf16, the Hopper kernel of attention_wide_sm90.cuh
// in column parts of 128), read with strides.
//
// Replaces the TPU kernel _infer_kernel
// (stonkgs_tpu/ops/flash_attention.py:359).  The table's bound on the H100
// is the bytes of q, k, v and out at the trunk's shape (or operations,
// 4*B*H*S^2*D, at longer S); the design's own floor is higher: two passes
// over the keys (the TPU kernel normalises, then rounds, which rules out
// the online softmax) make three products (QK^T twice, PV once) and two
// exps a score, and at D=64 the SFU's exps cost about as much as the
// products.  Design note: stonkgs_tpu_torch/ops/flash_attention.py.
//
// bf16 up to D = 256: attn_fwd_sm90_kernel<false> of attention_sm90.cuh,
// for Hopper: a block per 128 query rows of one (b, h) (64 at D > 128); a
// producer warpgroup streams 128-key tiles (64 at D > 128) and their key
// bias through a 3-stage TMA ring; two consumer warpgroups (one at D >
// 128) run S = Q K^T and O += P V as wgmma, P from registers, the softmax
// in registers.  Numerics: exp2 on the SFU and a per-row reciprocal
// instead of an IEEE exp and a division per score (a bf16 probability
// moves by at most one step at a rounding boundary).  bf16 past D = 256:
// attn_fwd_wide_sm90_kernel of attention_wide_sm90.cuh (the same numerics;
// the scores over the full D in column blocks of 64, O in column parts of
// 128 a grid axis, the statistics of pass 1 from a launch of their own
// into the `stats` scratch).  fp32: attn_fwd_kernel<false> of
// attention.cuh, the SIMT body (64-row tiles, K streamed twice; a warp a
// row above D = 128, attn_fwd_rows_kernel), which holds the model against
// the CPU.
// Keys >= S take no part; rows >= S are not written.
//
// C interface:
//   int flash_attention_infer(int dtype /*0 fp32, 1 bf16*/, q, k, v,
//                             const float* key_bias /*(B, S) or NULL*/, out,
//                             float* stats /*bf16 at D > 256: (B, H, S) x 2
//                             fp32 scratch, required; else unused*/,
//                             int B, int S, int H, int D, float scale,
//                             cudaStream_t stream)
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue, with
// nothing launched, for a D that is not a positive multiple of 8);
//   int flash_attention_infer_wide_calls(void)
// the calls so far that ran attn_fwd_wide_sm90_kernel (bf16 past D = 256).

#include "attention_wide_sm90.cuh"

extern "C" int flash_attention_infer(int dtype, const void* q, const void* k, const void* v,
                                     const float* key_bias, void* out, float* stats, int B,
                                     int S, int H, int D, float scale, void* stream) {
  using namespace stonkgs::attn;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout none{};
  if (dtype == 0)
    return launch_fwd_f32<false>(q, k, v, key_bias, out, nullptr, B, S, H, D, scale, none, s);
  if (dtype == 1 && D > kMaxHeadDim)
    return stonkgs::attn90::launch_fwd_wide_sm90<false>(q, k, v, key_bias, out, nullptr, stats,
                                                        B, S, H, D, scale, none, s);
  if (dtype == 1)
    return stonkgs::attn90::launch_fwd_sm90<false>(q, k, v, key_bias, out, nullptr, B, S, H, D,
                                                   scale, none, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int flash_attention_infer_wide_calls() { return stonkgs::attn90::wide_calls(); }
