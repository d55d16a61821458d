// Pieces shared by the attention kernels (flash_attention_infer.cu,
// flash_attention_train.cu and bigbird_sparse.cu): 64-row tiles of the
// (B, S, H, D=64) layout in shared memory, the two per-warp tile products,
// the dropout hash, and the fp32 forward kernel.  The bf16 attention
// forward and backward and the bf16 BigBird pair are the Hopper kernels of
// attention_sm90.cuh, attention_bwd_sm90.cuh and bigbird_sm90.cuh (wgmma
// and TMA): the SIMT bodies that use these pieces (the forward here, dQ
// and dK/dV in flash_attention_train.cu, the BigBird pair in
// bigbird_sparse.cu) are fp32 only, and exist to hold the whole model
// against the CPU.
//
// A block has 4 warps; in a product each warp owns 16 rows of the block's
// 64-row tile, in plain fp32 FMAs:
//   score_tile: sw (16 x 64, fp32) = A_w (16 x D) . B^T, B a 64 x D tile;
//   PvAcc:      acc (16 x D, fp32) += P_w (16 x 64) . V, V a 64 x D tile.

#pragma once

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace stonkgs {
namespace attn {

constexpr int kD = 64;           // head width
constexpr int kTile = 64;        // rows of a q, k, v or dO tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSST = kTile + 4;  // fp32 staging row stride
constexpr float kNegBias = -1e9f;  // score of a padded key (the JAX package's NEG_BIAS)

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };

template <typename T> struct Sizes {
  static constexpr int TS = kD + Pad<T>::value;  // row stride of a tile in T
  static constexpr size_t tile = align128(size_t(kTile) * TS * sizeof(T));
  // per-warp 16-row tiles: fp32 staging, and T operands
  static constexpr size_t stage = align128(size_t(kWarps) * 16 * kSST * sizeof(float));
  static constexpr size_t wtile = align128(size_t(kWarps) * 16 * TS * sizeof(T));
  static constexpr size_t vec = align128(kTile * sizeof(float));
};

// 64 rows of D elements: global (row stride gs) -> shared (row stride TS);
// rows >= n are zero.  16-byte vectors spread over the block.
template <typename T>
__device__ __forceinline__ void load_rows(T* s, const T* g, size_t gs, int n) {
  constexpr int V = 16 / sizeof(T), VPR = kD / V, TS = Sizes<T>::TS;
  for (int i = threadIdx.x; i < kTile * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) val = *reinterpret_cast<const uint4*>(g + r * gs + c);
    *reinterpret_cast<uint4*>(s + r * TS + c) = val;
  }
}

// 64 fp32 values g[0, n) -> s, zero past n (or everywhere when g is null)
__device__ __forceinline__ void load_vec(float* s, const float* g, int n) {
  if (threadIdx.x < kTile) s[threadIdx.x] = (g && int(threadIdx.x) < n) ? g[threadIdx.x] : 0.f;
}

// sw (16 x kSST, fp32) = aw (16 x D) . bs^T, bs a 64 x D tile (both stride
// TS); lane owns columns lane and lane + 32 (rows of bs)
template <typename T>
__device__ __forceinline__ void score_tile(const T* aw, const T* bs, float* sw, int lane) {
  constexpr int TS = Sizes<T>::TS;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int d = 0; d < kD; ++d) {
    const float b0 = to_f(bs[lane * TS + d]), b1 = to_f(bs[(lane + 32) * TS + d]);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = to_f(aw[r * TS + d]);
      acc[r][0] += a * b0;
      acc[r][1] += a * b1;
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    sw[r * kSST + lane] = acc[r][0];
    sw[r * kSST + lane + 32] = acc[r][1];
  }
  __syncwarp();
}

// A warp's fp32 (16 x D) accumulator of P . V products.
template <typename T> struct PvAcc;

template <> struct PvAcc<float> {
  using T = float;
  static constexpr int TS = Sizes<T>::TS;
  float o[16][2];  // lane owns columns lane and lane + 32

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 16; ++r) o[r][0] = o[r][1] = 0.f;
  }
  __device__ __forceinline__ void mma(const T* pw, const T* vs, int lane) {
    for (int j = 0; j < kTile; ++j) {
      const float va = vs[j * TS + lane], vb = vs[j * TS + lane + 32];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = pw[r * TS + j];
        o[r][0] += p * va;
        o[r][1] += p * vb;
      }
    }
  }
  __device__ __forceinline__ void store(float* sw, int lane) const {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      sw[r * kSST + lane] = o[r][0];
      sw[r * kSST + lane + 32] = o[r][1];
    }
    __syncwarp();
  }
};

// Rows [r0, r0 + 16) of a (B, S, H, D) tensor from a warp's fp32 staging
// tile, times `mul`, rounded to T; rows >= rows_left are not written.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, size_t rs, const float* sw, int rows_left,
                                           float mul, int lane) {
  for (int e = lane; e < 16 * kD; e += 32) {
    const int r = e / kD, c = e % kD;
    if (r < rows_left) dst[r * rs + c] = from_f<T>(sw[r * kSST + c] * mul);
  }
}

// Attention dropout of the JAX package (_dropout_keep,
// stonkgs_tpu/ops/flash_attention.py:69-89): a murmur3-finalizer hash of
// the position ((b*H + h)*s_pad + row)*s_pad + col and the two seed words,
// every step modulo 2^32; a position is kept iff hash < threshold.
struct Dropout {
  int enabled;         // 0: no dropout
  int s_pad;           // S padded to the TPU kernel's query block
  uint32_t threshold;  // min(round((1 - rate) * 2^32), 2^32 - 1)
  uint32_t seed0, seed1;
  float keep_scale;    // 1 / (1 - rate)

  // first hashed index of row `row` of head `bh` = b*H + h
  __device__ __forceinline__ uint32_t row_base(int bh, int row) const {
    return (uint32_t(bh) * uint32_t(s_pad) + uint32_t(row)) * uint32_t(s_pad);
  }
  __device__ __forceinline__ bool keep(uint32_t idx) const {
    uint32_t x = idx ^ seed0;
    x *= 0x85EBCA6Bu;
    x = x ^ (x >> 16) ^ seed1;
    x *= 0xC2B2AE35u;
    x ^= x >> 13;
    x *= 0x27D4EB2Fu;
    x ^= x >> 16;
    return x < threshold;
  }
};

// The fp32 forward attention kernel: out = dropout(softmax(Q K^T * scale +
// key_bias)) V over (B, S, H, D), one block per (64-row query tile, head,
// batch), K streamed through shared memory in 64-key tiles twice:
//   pass 1: S = Q K^T; each row's running max m and sum l of exp(s - m),
//           s = S*scale + bias (lanes 2r and 2r+1 share row r, each taking
//           every other key, which keeps bank conflicts 2-way);
//   pass 2: S recomputed; p = exp(s - m) / l (normalise, then round, as the
//           TPU kernels), dropped and scaled when training, rounded to T;
//           O += P V in fp32.
// kTrain adds the training kernel's outputs and numerics: the fp32
// logsumexp m + log(l) per row into lse (B, H, S), the dropout, and the
// TPU kernel's padded keys (s_pad - S keys of score -1e9, which matter
// only for a row whose every key is masked).
template <bool kTrain>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ key_bias,
                float* __restrict__ out, float* __restrict__ lse, int S, int H, float scale,
                Dropout drop) {
  using T = float;
  using Z = Sizes<T>;
  constexpr int TS = Z::TS;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;

  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + Z::tile);
  T* vs = reinterpret_cast<T*>(smem + 2 * Z::tile);
  float* sst = reinterpret_cast<float*>(smem + 3 * Z::tile);
  T* pst = reinterpret_cast<T*>(smem + 3 * Z::tile + Z::stage);
  float* bs = reinterpret_cast<float*>(smem + 3 * Z::tile + Z::stage + Z::wtile);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t rs = size_t(H) * kD;                   // stride between positions
  const size_t head0 = (size_t(b) * S * H + h) * kD;  // (b, 0, h, 0)
  const T* kg = k + head0;
  const T* vg = v + head0;
  const float* kb = key_bias ? key_bias + size_t(b) * S : nullptr;
  const T* qw = qs + warp * 16 * TS;   // the warp's 16 query rows
  float* sw = sst + warp * 16 * kSST;  // the warp's fp32 score tile
  T* pw = pst + warp * 16 * TS;        // the warp's probability tile, in T

  load_rows<T>(qs, q + head0 + size_t(q0) * rs, rs, min(kTile, S - q0));

  // the key tile [k0, k0 + 64): K (and, in pass 2, V) rows and the bias
  auto load_keys = [&](int k0, bool with_v) {
    const int n = min(kTile, S - k0);
    __syncthreads();  // the previous tile is consumed
    load_rows<T>(ks, kg + size_t(k0) * rs, rs, n);
    if (with_v) load_rows<T>(vs, vg + size_t(k0) * rs, rs, n);
    load_vec(bs, kb ? kb + k0 : nullptr, n);
    __syncthreads();
    return n;
  };

  const int row = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * 16 + row;  // this lane's query row
  float m = -INFINITY, l = 0.f;

  // pass 1: running max and sum of exp over all keys
  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int n = load_keys(k0, false);
    score_tile<T>(qw, ks, sw, lane);
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
  if constexpr (kTrain) {
    const int n_pad = drop.s_pad - S;
    if (n_pad > 0) {
      const float m_new = fmaxf(m, kNegBias);
      l = l * expf(m - m_new) + float(n_pad) * expf(kNegBias - m_new);
      m = m_new;
    }
    if (half == 0 && qrow < S) lse[(size_t(b) * H + h) * S + qrow] = m + logf(l);
  }

  // pass 2: O = P V with P = round_T(dropout(exp(s - m) / l))
  const uint32_t base = kTrain ? drop.row_base(b * H + h, qrow) : 0u;
  PvAcc<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int n = load_keys(k0, true);
    score_tile<T>(qw, ks, sw, lane);
    for (int c = half; c < kTile; c += 2) {
      float p = c < n ? expf(sw[row * kSST + c] * scale + bs[c] - m) / l : 0.f;
      if constexpr (kTrain) {
        if (drop.enabled) p = drop.keep(base + uint32_t(k0 + c)) ? p * drop.keep_scale : 0.f;
      }
      pw[row * TS + c] = from_f<T>(p);
    }
    __syncwarp();
    acc.mma(pw, vs, lane);
    __syncwarp();
  }
  acc.store(sw, lane);
  store_rows<T>(out + head0 + size_t(q0 + warp * 16) * rs, rs, sw, S - (q0 + warp * 16), 1.f,
                lane);
}

// Shared memory of attn_fwd_kernel: q, k, v tiles, score staging,
// probability tiles, bias tile.
constexpr size_t fwd_smem_bytes() {
  using Z = Sizes<float>;
  return 3 * Z::tile + Z::stage + Z::wtile + Z::vec;
}

template <bool kTrain>
int launch_fwd_f32(const void* q, const void* k, const void* v, const float* key_bias,
                   void* out, float* lse, int B, int S, int H, float scale, Dropout drop,
                   cudaStream_t stream) {
  if (B <= 0 || H <= 0 || S < 1 || B > 65535 || H > 65535) return int(cudaErrorInvalidValue);
  constexpr size_t smem = fwd_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<kTrain>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  attn_fwd_kernel<kTrain><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      key_bias, static_cast<float*>(out), lse, S, H, scale, drop);
  return int(cudaGetLastError());
}

}  // namespace attn
}  // namespace stonkgs
