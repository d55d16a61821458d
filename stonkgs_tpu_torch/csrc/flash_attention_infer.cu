// Inference attention: out = softmax(Q K^T * scale + key_bias) V, with q, k,
// v and out in the (B, S, H, D=64) layout, read with strides.
//
// Replaces the TPU kernel _infer_kernel
// (stonkgs_tpu/ops/flash_attention.py:359).  Bound on the H100 by
// operations (4*B*H*S^2*D) or, at short S, by the bytes of q, k, v and
// out; see stonkgs_tpu_torch/ops/flash_attention.py for the design note.
//
// One block per (64-row query tile, head, batch) with 4 warps; warp w owns
// query rows [16w, 16w+16) of the tile.  Keys stream through shared memory
// in 64-key tiles, twice:
//   pass 1: S = Q K^T for the tile into the warp's fp32 staging tile; each
//           row's running max m and sum l of exp(s - m), s = S*scale+bias;
//   pass 2: S recomputed, p = exp(s - m) / l rounded to T (normalise, then
//           round, as the TPU kernel), O += P V in fp32.
// Keys >= S take no part.  O is rounded to T and stored for rows < S.
// Recomputing S costs half again the products but keeps shared memory at
// ~54 KB (bf16), so four blocks share an SM.  bf16 products use the tensor
// cores through nvcuda::wmma; fp32 products are plain FMAs.
//
// C interface:
//   int flash_attention_infer(int dtype /*0 fp32, 1 bf16*/, q, k, v,
//                             const float* key_bias /*(B, S) or NULL*/, out,
//                             int B, int S, int H, float scale,
//                             cudaStream_t stream)
// returns cudaGetLastError() after the launch.

#include <mma.h>

#include <cmath>

#include "common.cuh"

namespace stonkgs {
namespace {

using namespace nvcuda;

constexpr int kD = 64;      // head width
constexpr int kBQ = 64;     // query rows per block
constexpr int kBK = 64;     // keys per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSST = kBK + 4;  // fp32 staging row stride

template <typename T> struct Pad;
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 8; };
template <> struct Pad<float> { static constexpr int value = 4; };

template <typename T> struct Layout {
  static constexpr int TS = kD + Pad<T>::value;  // q/k/v/P tile row stride (T)
  static constexpr size_t tile_bytes = align128(size_t(64) * TS * sizeof(T));
  static constexpr size_t sst_bytes = align128(size_t(kWarps) * 16 * kSST * sizeof(float));
  static constexpr size_t pst_bytes = align128(size_t(kWarps) * 16 * TS * sizeof(T));
  static constexpr size_t bias_bytes = align128(kBK * sizeof(float));
  // q, k, v tiles; per-warp score and probability staging; bias tile
  static constexpr size_t smem_bytes = 3 * tile_bytes + sst_bytes + pst_bytes + bias_bytes;
};

// 64 rows of D elements: global (row stride gs) -> shared (row stride TS);
// rows >= n are zero.  16-byte vectors spread over the block.
template <typename T>
__device__ __forceinline__ void load_rows(T* s, const T* g, size_t gs, int n) {
  constexpr int V = 16 / sizeof(T), VPR = kD / V, TS = Layout<T>::TS;
  for (int i = threadIdx.x; i < 64 * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) val = *reinterpret_cast<const uint4*>(g + r * gs + c);
    *reinterpret_cast<uint4*>(s + r * TS + c) = val;
  }
}

// The key tile [k0, k0+64): K (and, when vg is given, V) rows and the bias.
template <typename T>
__device__ __forceinline__ void load_keys(T* ks, T* vs, float* bs, const T* kg, const T* vg,
                                          size_t rs, const float* kb, int k0, int S) {
  const int n = min(kBK, S - k0);
  __syncthreads();  // the previous tile is consumed
  load_rows<T>(ks, kg + size_t(k0) * rs, rs, n);
  if (vg) load_rows<T>(vs, vg + size_t(k0) * rs, rs, n);
  if (threadIdx.x < kBK) bs[threadIdx.x] = (kb && int(threadIdx.x) < n) ? kb[k0 + threadIdx.x] : 0.f;
  __syncthreads();
}

// Raw scores Q K^T of the warp's 16 rows against the key tile -> sw (16 x kSST).
template <typename T>
__device__ __forceinline__ void score_tile(const T* qw, const T* ks, float* sw, int lane) {
  constexpr int TS = Layout<T>::TS;
  if constexpr (kIsBf16<T>) {
    using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
    using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
    FragA qa[kD / 16];
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) wmma::load_matrix_sync(qa[kk], qw + kk * 16, TS);
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBt kf;  // K^T: element (d, key) at ks[key * TS + d]
        wmma::load_matrix_sync(kf, ks + n * 16 * TS + kk * 16, TS);
        wmma::mma_sync(c, qa[kk], kf, c);
      }
      wmma::store_matrix_sync(sw + n * 16, c, kSST, wmma::mem_row_major);
    }
  } else {
    // lane owns keys lane and lane + 32
    float acc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int d = 0; d < kD; ++d) {
      const float ka = to_f(ks[lane * TS + d]), kb = to_f(ks[(lane + 32) * TS + d]);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qv = to_f(qw[r * TS + d]);
        acc[r][0] += qv * ka;
        acc[r][1] += qv * kb;
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      sw[r * kSST + lane] = acc[r][0];
      sw[r * kSST + lane + 32] = acc[r][1];
    }
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_infer_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ key_bias,
                  T* __restrict__ out, int S, int H, float scale) {
  using L = Layout<T>;
  constexpr int TS = L::TS;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;

  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::tile_bytes);
  T* vs = reinterpret_cast<T*>(smem + 2 * L::tile_bytes);
  float* sst = reinterpret_cast<float*>(smem + 3 * L::tile_bytes);
  T* pst = reinterpret_cast<T*>(smem + 3 * L::tile_bytes + L::sst_bytes);
  float* bs = reinterpret_cast<float*>(smem + 3 * L::tile_bytes + L::sst_bytes + L::pst_bytes);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t rs = size_t(H) * kD;                   // stride between positions
  const size_t head0 = (size_t(b) * S * H + h) * kD;  // (b, 0, h, 0)
  const T* kg = k + head0;
  const T* vg = v + head0;
  const float* kb = key_bias ? key_bias + size_t(b) * S : nullptr;
  const T* qw = qs + warp * 16 * TS;  // the warp's 16 query rows
  float* sw = sst + warp * 16 * kSST;  // the warp's fp32 score tile
  T* pw = pst + warp * 16 * TS;        // the warp's probability tile, in T

  load_rows<T>(qs, q + head0 + size_t(q0) * rs, rs, min(kBQ, S - q0));

  // Row statistics: lanes 2r and 2r+1 share row r, each taking every other
  // key of the tile (columns 2c + half), which keeps bank conflicts 2-way.
  const int row = lane >> 1, half = lane & 1;
  float m = -INFINITY, l = 0.f;

  // pass 1: running max and sum of exp over all keys
  for (int k0 = 0; k0 < S; k0 += kBK) {
    load_keys<T>(ks, vs, bs, kg, nullptr, rs, kb, k0, S);
    score_tile<T>(qw, ks, sw, lane);
    const int n = min(kBK, S - k0);
    float tmax = -INFINITY;
    for (int c = half; c < n; c += 2) tmax = fmaxf(tmax, sw[row * kSST + c] * scale + bs[c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float tsum = 0.f;
    for (int c = half; c < n; c += 2) tsum += expf(sw[row * kSST + c] * scale + bs[c] - m_new);
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l = l * expf(m - m_new) + tsum;
    m = m_new;
    __syncwarp();  // sw is rewritten by the next tile
  }

  // pass 2: O = P V with P = round_T(exp(s - m) / l)
  const size_t out0 = head0 + size_t(q0 + warp * 16) * rs;
  const int rows_left = S - (q0 + warp * 16);  // rows of this warp inside S
  if constexpr (kIsBf16<T>) {
    using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
    using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[kD / 16];
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(o[n], 0.f);
    for (int k0 = 0; k0 < S; k0 += kBK) {
      load_keys<T>(ks, vs, bs, kg, vg, rs, kb, k0, S);
      score_tile<T>(qw, ks, sw, lane);
      const int n = min(kBK, S - k0);
      for (int c = half; c < kBK; c += 2) {
        const float p = c < n ? expf(sw[row * kSST + c] * scale + bs[c] - m) / l : 0.f;
        pw[row * TS + c] = from_f<T>(p);
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        FragA pa;
        wmma::load_matrix_sync(pa, pw + kk * 16, TS);
#pragma unroll
        for (int j = 0; j < kD / 16; ++j) {
          FragB vf;
          wmma::load_matrix_sync(vf, vs + kk * 16 * TS + j * 16, TS);
          wmma::mma_sync(o[j], pa, vf, o[j]);
        }
      }
      __syncwarp();
    }
    // stage O in the warp's fp32 tile, round and store the rows inside S
#pragma unroll
    for (int j = 0; j < kD / 16; ++j)
      wmma::store_matrix_sync(sw + j * 16, o[j], kSST, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * kD; e += 32) {
      const int r = e / kD, c = e % kD;
      if (r < rows_left) out[out0 + r * rs + c] = from_f<T>(sw[r * kSST + c]);
    }
  } else {
    // lane owns output columns lane and lane + 32
    float o[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) o[r][0] = o[r][1] = 0.f;
    for (int k0 = 0; k0 < S; k0 += kBK) {
      load_keys<T>(ks, vs, bs, kg, vg, rs, kb, k0, S);
      score_tile<T>(qw, ks, sw, lane);
      const int n = min(kBK, S - k0);
      for (int c = half; c < kBK; c += 2)
        pw[row * TS + c] = c < n ? expf(sw[row * kSST + c] * scale + bs[c] - m) / l : 0.f;
      __syncwarp();
      for (int j = 0; j < kBK; ++j) {
        const float va = to_f(vs[j * TS + lane]), vb = to_f(vs[j * TS + lane + 32]);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float p = to_f(pw[r * TS + j]);
          o[r][0] += p * va;
          o[r][1] += p * vb;
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r < rows_left) {
        out[out0 + r * rs + lane] = from_f<T>(o[r][0]);
        out[out0 + r * rs + lane + 32] = from_f<T>(o[r][1]);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* key_bias, void* out,
           int B, int S, int H, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || S < 1 || B > 65535 || H > 65535) return int(cudaErrorInvalidValue);
  constexpr size_t smem = Layout<T>::smem_bytes;
  cudaError_t e = cudaFuncSetAttribute(attn_infer_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  attn_infer_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      key_bias, static_cast<T*>(out), S, H, scale);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace stonkgs

extern "C" int flash_attention_infer(int dtype, const void* q, const void* k, const void* v,
                                     const float* key_bias, void* out, int B, int S, int H,
                                     float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stonkgs::launch<float>(q, k, v, key_bias, out, B, S, H, scale, s);
  if (dtype == 1)
    return stonkgs::launch<__nv_bfloat16>(q, k, v, key_bias, out, B, S, H, scale, s);
  return int(cudaErrorInvalidValue);
}
