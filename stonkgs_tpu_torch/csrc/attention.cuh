// Pieces shared by the attention kernels (flash_attention_infer.cu,
// flash_attention_train.cu and bigbird_sparse.cu): 64-row tiles of the
// (B, S, H, D) layout in shared memory, the two per-warp tile products,
// the dropout hash, the fp32 forward kernel, and the kernels of a warp a
// row past the tiled widths.  The bf16 attention forward and backward and
// the bf16 BigBird pair are the Hopper kernels of attention_sm90.cuh,
// attention_bwd_sm90.cuh and bigbird_sm90.cuh (wgmma and TMA) up to their
// widest instances (D = 256 for attention, 64 for BigBird), and the bf16
// attention forward past 256 is attention_wide_sm90.cuh's; the SIMT bodies
// that use these pieces (the forward here, dQ and dK/dV in
// flash_attention_train.cu, the BigBird pair in bigbird_sparse.cu) run
// fp32, which holds the whole model against the CPU, and bf16 past those
// instances (the attention backward past D = 256, BigBird past D = 64).
//
// A block has 4 warps; in a product each warp owns 16 rows of the block's
// 64-row tile, in plain fp32 FMAs:
//   score_tile: sw (16 x 64, fp32) (+)= A_w (16 x D) . B^T, B a 64 x D tile;
//   PvAcc:      acc (16 x D, fp32) += P_w (16 x 64) . V, V a 64 x D tile
//               (lane owns columns lane, lane + 32, ... below D).
// The tile width is a template parameter.  with_padded_head_dim gives it
// from a run-time head width D, any multiple of 8 from 8 to 256 (the
// attention kernels' instances; up to 64 for BigBird's), run on the
// instance of the padded width P = 16, 32, 64, 128 or 256, the smallest at
// least D: the loads zero the columns from D to P, which add nothing to a
// product, and the stores write columns < D.
//
// Above the tiled widths (fp32 past P = 128, where four 64-row fp32 tiles
// of 256 columns are 266 KB, past the 227 KB of a block; bf16 past P = 256
// runs the wgmma kernels of attention_wide_sm90.cuh and
// attention_bwd_wide_sm90.cuh) a warp owns one row (attn_fwd_rows_kernel
// here, the backward's in flash_attention_train.cu, all in fp32 only), at
// any D that is a multiple of 8: each score
// is a warp-wide sum over the whole row, a lane reading 8 columns at a
// time (16 or 32 bytes) from L2, and the row's outputs are cut into column
// parts of 256 (kPartCols), 8 columns a lane, one warp a part: a part's
// warp forms every score over the full D again, keeps its own softmax
// statistics over the true scores, and accumulates only its columns, so no
// lane holds more than 8 accumulators at any D (2,560 is 10 parts).  The
// scores are formed once a part (twice at D = 384), kRowKeys keys' sums in
// flight a warp; every warp reads all of K and V from L2, so L2 bounds them
// (about 0.24 TB a call at B=128, S=512, 2 heads of 384: 54.8 ms in bf16,
// 67x SDPA, before the wgmma kernels took bf16).  They exist to hold the
// model against the CPU; right matters more than fast.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace stonkgs {
namespace attn {

constexpr int kD = 64;           // BigBird's widest head width
constexpr int kTile = 64;        // rows of a q, k, v or dO tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSST = kTile + 4;  // fp32 staging row stride
constexpr float kNegBias = -1e9f;  // score of a padded key (the JAX package's NEG_BIAS)

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
// bf16 rows of D + 8 elements stay 16-byte aligned for load_rows' vectors
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 8; };

// the widest instance of the attention kernels (the bf16 Hopper kernels
// take D up to it), and the widest padded width of the tiled fp32 bodies;
// wider heads run the wide wgmma kernels in bf16, a warp a row in fp32
constexpr int kMaxHeadDim = 256;
constexpr int kTiledMaxHeadDim = 128;

// the head widths the C entry points take (the wrappers pad any other D
// with zero columns): any multiple of 8, whose rows are multiples of 16
// bytes, as TMA's strides and the 16-byte loads need
inline bool head_dim_ok(int D) { return D >= 8 && D % 8 == 0; }

// f(std::integral_constant<int, P>{}) for a head width D that is a multiple
// of 8 from 8 to kMax (256, or 64 for BigBird), P = 16, 32, 64, 128 or 256
// the smallest width at least D (a row of D elements is then a multiple of
// 16 bytes, as TMA's strides and the 16-byte loads need);
// cudaErrorInvalidValue for any other D.  No instance between 128 and 256:
// D from 136 to 256 runs at 256 (at most twice the products of its true
// width), one wide shape to build and hold to the registers and shared
// memory of a block.
template <int kMax = kMaxHeadDim, typename F>
inline int with_padded_head_dim(int D, F&& f) {
  static_assert(kMax == 64 || kMax == kMaxHeadDim, "instances at P = 16, 32, 64 (to 256)");
  if (D < 8 || D > kMax || D % 8 != 0) return int(cudaErrorInvalidValue);
  if (D <= 16) return f(std::integral_constant<int, 16>{});
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  if constexpr (kMax == 64) {
    return f(std::integral_constant<int, 64>{});
  } else {
    if (D <= 64) return f(std::integral_constant<int, 64>{});
    if (D <= 128) return f(std::integral_constant<int, 128>{});
    return f(std::integral_constant<int, 256>{});
  }
}

template <typename T, int D = kD> struct Sizes {
  static constexpr int TS = D + Pad<T>::value;  // row stride of a q, k, v or dO tile in T
  // row stride of a warp's 16 x 64 probability (or dS) tile in T: 64 keys
  // a row, whatever D
  static constexpr int PS = kTile + Pad<T>::value;
  static constexpr size_t tile = align128(size_t(kTile) * TS * sizeof(T));
  // per-warp 16-row tiles: fp32 staging, and T operands
  static constexpr size_t stage = align128(size_t(kWarps) * 16 * kSST * sizeof(float));
  // row stride of a warp's fp32 staging tile of 16 output rows (D columns,
  // or a 64-key score row where D is narrower), and the block's such tiles
  static constexpr int OS = (D > kTile ? D : kTile) + 4;
  static constexpr size_t ostage = align128(size_t(kWarps) * 16 * OS * sizeof(float));
  static constexpr size_t wtile = align128(size_t(kWarps) * 16 * PS * sizeof(T));
  static constexpr size_t vec = align128(kTile * sizeof(float));
};

// 64 rows of D elements: global (row stride gs) -> shared (row stride TS);
// rows >= n and columns >= d (a multiple of 16 bytes) are zero.  16-byte
// vectors spread over the block.
template <typename T, int D = kD>
__device__ __forceinline__ void load_rows(T* s, const T* g, size_t gs, int n, int d = D) {
  constexpr int V = 16 / sizeof(T), VPR = D / V, TS = Sizes<T, D>::TS;
  for (int i = threadIdx.x; i < kTile * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && c < d) val = *reinterpret_cast<const uint4*>(g + r * gs + c);
    *reinterpret_cast<uint4*>(s + r * TS + c) = val;
  }
}

// 64 fp32 values g[0, n) -> s, zero past n (or everywhere when g is null)
__device__ __forceinline__ void load_vec(float* s, const float* g, int n) {
  if (threadIdx.x < kTile) s[threadIdx.x] = (g && int(threadIdx.x) < n) ? g[threadIdx.x] : 0.f;
}

// sw (16 x kSST, fp32) = aw (16 x D) . bs^T, bs a 64 x D tile (both stride
// TS); lane owns columns lane and lane + 32 (rows of bs); `add`: sw +=
// (a sum over another chunk of the columns)
template <typename T, int D = kD>
__device__ __forceinline__ void score_tile(const T* aw, const T* bs, float* sw, int lane,
                                           bool add = false) {
  constexpr int TS = Sizes<T, D>::TS;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    acc[r][0] = add ? sw[r * kSST + lane] : 0.f;
    acc[r][1] = add ? sw[r * kSST + lane + 32] : 0.f;
  }
  for (int d = 0; d < D; ++d) {
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

// A warp's fp32 (16 x D) accumulator of P . V products; P is a 16 x 64
// tile (of T, or of fp32 with its own row stride), V a 64 x D tile of T of
// row stride TS; store() writes it to a staging tile of row stride OS.
template <typename T, int D = kD> struct PvAcc {
  static constexpr int TS = Sizes<T, D>::TS, PS = Sizes<T, D>::PS;
  static constexpr int kC = (D + 31) / 32;  // columns a lane
  float o[16][kC];  // lane owns columns lane + 32c below D

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) o[r][c] = 0.f;
  }
  template <typename TP>
  __device__ __forceinline__ void mma(const TP* pw, const T* vs, int lane, int ps = PS) {
    for (int j = 0; j < kTile; ++j) {
      float vv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        vv[c] = lane + 32 * c < D ? to_f(vs[j * TS + lane + 32 * c]) : 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = to_f(pw[r * ps + j]);
#pragma unroll
        for (int c = 0; c < kC; ++c) o[r][c] += p * vv[c];
      }
    }
  }
  __device__ __forceinline__ void store(float* sw, int lane) const {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (lane + 32 * c < D) sw[r * Sizes<T, D>::OS + lane + 32 * c] = o[r][c];
    __syncwarp();
  }
};

// Rows [r0, r0 + 16) of a (B, S, H, D) tensor from a warp's fp32 staging
// tile (row stride OS), times `mul`, rounded to T; rows >= rows_left and
// columns >= d are not written.
template <typename T, int D = kD>
__device__ __forceinline__ void store_rows(T* dst, size_t rs, const float* sw, int rows_left,
                                           float mul, int lane, int d = D) {
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, c = e % D;
    if (r < rows_left && c < d) dst[r * rs + c] = from_f<T>(sw[r * Sizes<T, D>::OS + c] * mul);
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
// only for a row whose every key is masked).  The tiles are kP wide (the
// padded width); D <= kP is the tensors' head width.
template <int kP, bool kTrain>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ key_bias,
                float* __restrict__ out, float* __restrict__ lse, int S, int H, int D,
                float scale, Dropout drop) {
  using T = float;
  using Z = Sizes<T, kP>;
  constexpr int TS = Z::TS;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;

  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + Z::tile);
  T* vs = reinterpret_cast<T*>(smem + 2 * Z::tile);
  float* sst = reinterpret_cast<float*>(smem + 3 * Z::tile);
  T* pst = reinterpret_cast<T*>(smem + 3 * Z::tile + Z::ostage);
  float* bs = reinterpret_cast<float*>(smem + 3 * Z::tile + Z::ostage + Z::wtile);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t rs = size_t(H) * D;                   // stride between positions
  const size_t head0 = (size_t(b) * S * H + h) * D;  // (b, 0, h, 0)
  const T* kg = k + head0;
  const T* vg = v + head0;
  const float* kb = key_bias ? key_bias + size_t(b) * S : nullptr;
  const T* qw = qs + warp * 16 * TS;   // the warp's 16 query rows
  float* sw = sst + warp * 16 * Z::OS;  // the warp's fp32 score (then output) tile
  T* pw = pst + warp * 16 * Z::PS;    // the warp's probability tile, in T

  load_rows<T, kP>(qs, q + head0 + size_t(q0) * rs, rs, min(kTile, S - q0), D);

  // the key tile [k0, k0 + 64): K (and, in pass 2, V) rows and the bias
  auto load_keys = [&](int k0, bool with_v) {
    const int n = min(kTile, S - k0);
    __syncthreads();  // the previous tile is consumed
    load_rows<T, kP>(ks, kg + size_t(k0) * rs, rs, n, D);
    if (with_v) load_rows<T, kP>(vs, vg + size_t(k0) * rs, rs, n, D);
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
    score_tile<T, kP>(qw, ks, sw, lane);
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
  PvAcc<T, kP> acc;
  acc.zero();
  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int n = load_keys(k0, true);
    score_tile<T, kP>(qw, ks, sw, lane);
    for (int c = half; c < kTile; c += 2) {
      float p = c < n ? expf(sw[row * kSST + c] * scale + bs[c] - m) / l : 0.f;
      if constexpr (kTrain) {
        if (drop.enabled) p = drop.keep(base + uint32_t(k0 + c)) ? p * drop.keep_scale : 0.f;
      }
      pw[row * Z::PS + c] = from_f<T>(p);
    }
    __syncwarp();
    acc.mma(pw, vs, lane);
    __syncwarp();
  }
  acc.store(sw, lane);
  store_rows<T, kP>(out + head0 + size_t(q0 + warp * 16) * rs, rs, sw, S - (q0 + warp * 16),
                    1.f, lane, D);
}

// Shared memory of attn_fwd_kernel: q, k, v tiles, score staging,
// probability tiles, bias tile.
template <int kP>
constexpr size_t fwd_smem_bytes() {
  using Z = Sizes<float, kP>;
  return 3 * Z::tile + Z::ostage + Z::wtile + Z::vec;
}

// --- past the tiled widths: a warp a (row, column part) ----------------------

constexpr int kRowWarps = 8;    // rows (warps) of a block of the row kernels
constexpr int kPartCols = 256;  // output columns of a part: 8 a lane
constexpr int kRowKeys = 4;     // keys (or query rows) a warp walks at a time

// column parts of a row of D values
__host__ __device__ __forceinline__ int parts_of(int D) {
  return (D + kPartCols - 1) / kPartCols;
}

// the 8 values at g (16 bytes of bf16 or 32 of fp32, aligned) as fp32
template <typename T>
__device__ __forceinline__ void load8(float (&x)[8], const T* g) {
  if constexpr (kIsBf16<T>) {
    // a bf16 is the high half of its fp32: the element at the lower
    // address is a word's low half
    const uint4 u = *reinterpret_cast<const uint4*>(g);
    x[0] = __uint_as_float(u.x << 16), x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16), x[3] = __uint_as_float(u.y & 0xffff0000u);
    x[4] = __uint_as_float(u.z << 16), x[5] = __uint_as_float(u.z & 0xffff0000u);
    x[6] = __uint_as_float(u.w << 16), x[7] = __uint_as_float(u.w & 0xffff0000u);
  } else {
    const float4 a = reinterpret_cast<const float4*>(g)[0];
    const float4 b = reinterpret_cast<const float4*>(g)[1];
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
  }
}

// the dot products of the row at a with the rows base + u rs, u < n <=
// kKeys (the others 0), rows of D values of T (D a multiple of 8) in fp32,
// each summed over the warp: a lane takes the columns 8 lane + 256 i ..
// + 7.  The kKeys sums are in flight together, the row at a loaded once:
// one warp-wide sum a key left a row kernel waiting on its shuffles.
template <typename T, int kKeys>
__device__ __forceinline__ void row_dots(float (&s)[kKeys], const T* a, const T* base,
                                         size_t rs, int n, int D, int lane) {
#pragma unroll
  for (int u = 0; u < kKeys; ++u) s[u] = 0.f;
  for (int c = 8 * lane; c < D; c += kPartCols) {
    float x[8];
    load8(x, a + c);
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      if (u < n) {
        float y[8];
        load8(y, base + u * rs + c);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[u] = fmaf(x[e], y[e], s[u]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < kKeys; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
}

// acc += w * (the 8 values at g)
template <typename T>
__device__ __forceinline__ void axpy8(float (&acc)[8], float w, const T* g) {
  float x[8];
  load8(x, g);
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = fmaf(w, x[e], acc[e]);
}

// x * mul, rounded to T, into the 8 values at g
template <typename T>
__device__ __forceinline__ void store8(T* g, const float (&x)[8], float mul) {
#pragma unroll
  for (int e = 0; e < 8; ++e) g[e] = from_f<T>(x[e] * mul);
}

// the row and column part of this warp of a row kernel over B x H x S
// rows of D columns (the grid's x the (s, part) pairs of a head, in blocks
// of kRowWarps, y the head, z the batch row: no 64-bit division); false
// past the last
struct RowPart {
  int b, h, s, part;
  size_t bhs;  // (b H + h) S + s: the row of lse and delta
};
__device__ __forceinline__ bool row_part(int S, int H, int D, RowPart& rp) {
  const int parts = parts_of(D);
  const int w = int(blockIdx.x) * kRowWarps + int(threadIdx.x) / 32;
  if (w >= S * parts) return false;
  rp.part = w % parts;
  rp.s = w / parts;
  rp.h = blockIdx.y;
  rp.b = blockIdx.z;
  rp.bhs = (size_t(rp.b) * H + rp.h) * S + rp.s;
  return true;
}

// a row kernel's grid
inline dim3 row_grid(int B, int S, int H, int D) {
  return dim3(unsigned((size_t(S) * parts_of(D) + kRowWarps - 1) / kRowWarps), H, B);
}

// The forward past the tiled widths, as attn_fwd_kernel computes it: a
// warp a (b, h, query row, column part), the keys walked twice from L2
// (pass 1 the running max and sum of exp, pass 2 the normalised, dropped
// probabilities times the part's columns of V), each score a warp-wide sum
// over the full D, kRowKeys keys at a time; fp32 only (bf16 past D = 256
// runs attention_wide_sm90.cuh)
template <bool kTrain>
__global__ void __launch_bounds__(32 * kRowWarps, 1)
attn_fwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ key_bias,
                     float* __restrict__ out, float* __restrict__ lse, int S, int H, int D,
                     float scale, Dropout drop) {
  RowPart rp;
  if (!row_part(S, H, D, rp)) return;
  const int lane = threadIdx.x % 32;
  const size_t rs = size_t(H) * D, head0 = (size_t(rp.b) * S * H + rp.h) * D;
  const int c0 = rp.part * kPartCols + 8 * lane;  // the lane's 8 output columns
  const float* kb = key_bias ? key_bias + size_t(rp.b) * S : nullptr;
  const float* qr = q + head0 + size_t(rp.s) * rs;
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < S; j0 += kRowKeys) {
    const int n = min(kRowKeys, S - j0);
    float dots[kRowKeys];
    row_dots(dots, qr, k + head0 + size_t(j0) * rs, rs, n, D, lane);
#pragma unroll
    for (int u = 0; u < kRowKeys; ++u) {
      if (u >= n) break;
      const float sc = dots[u] * scale + (kb ? kb[j0 + u] : 0.f);
      const float m_new = fmaxf(m, sc);
      l = l * expf(m - m_new) + expf(sc - m_new);
      m = m_new;
    }
  }
  if constexpr (kTrain) {
    const int n_pad = drop.s_pad - S;
    if (n_pad > 0) {
      const float m_new = fmaxf(m, kNegBias);
      l = l * expf(m - m_new) + float(n_pad) * expf(kNegBias - m_new);
      m = m_new;
    }
    if (rp.part == 0 && lane == 0) lse[rp.bhs] = m + logf(l);
  }
  const uint32_t base = kTrain ? drop.row_base(rp.b * H + rp.h, rp.s) : 0u;
  float o[8] = {};
  for (int j0 = 0; j0 < S; j0 += kRowKeys) {
    const int n = min(kRowKeys, S - j0);
    float dots[kRowKeys];
    row_dots(dots, qr, k + head0 + size_t(j0) * rs, rs, n, D, lane);
#pragma unroll
    for (int u = 0; u < kRowKeys; ++u) {
      if (u >= n) break;
      const int j = j0 + u;
      float p = expf(dots[u] * scale + (kb ? kb[j] : 0.f) - m) / l;
      if constexpr (kTrain) {
        if (drop.enabled) p = drop.keep(base + uint32_t(j)) ? p * drop.keep_scale : 0.f;
      }
      if (c0 < D) axpy8(o, p, v + head0 + size_t(j) * rs + c0);
    }
  }
  if (c0 < D) store8(out + head0 + size_t(rp.s) * rs + c0, o, 1.f);
}

// whether the attention kernels take (B, S, H) at head width D
inline bool shape_ok(int B, int S, int H, int D) {
  return B > 0 && H > 0 && S >= 1 && B <= 65535 && H <= 65535 && head_dim_ok(D);
}

// the fp32 forward: the tiled body up to P = 128, a warp a row past it
template <bool kTrain>
int launch_fwd_f32(const void* q, const void* k, const void* v, const float* key_bias,
                   void* out, float* lse, int B, int S, int H, int D, float scale, Dropout drop,
                   cudaStream_t stream) {
  if (!shape_ok(B, S, H, D)) return int(cudaErrorInvalidValue);
  if (D > kTiledMaxHeadDim) {
    attn_fwd_rows_kernel<kTrain><<<row_grid(B, S, H, D), 32 * kRowWarps, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        key_bias, static_cast<float*>(out), lse, S, H, D, scale, drop);
    return int(cudaGetLastError());
  }
  return with_padded_head_dim(D, [&](auto p) {
    constexpr int kP = decltype(p)::value;
    if constexpr (kP > kTiledMaxHeadDim) {
      return int(cudaErrorInvalidValue);  // taken by the row kernel above
    } else {
      constexpr size_t smem = fwd_smem_bytes<kP>();
      cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<kP, kTrain>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return int(e);
      const dim3 grid((S + kTile - 1) / kTile, H, B);
      attn_fwd_kernel<kP, kTrain><<<grid, kThreads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), key_bias, static_cast<float*>(out), lse, S, H, D, scale,
          drop);
      return int(cudaGetLastError());
    }
  });
}

}  // namespace attn
}  // namespace stonkgs
