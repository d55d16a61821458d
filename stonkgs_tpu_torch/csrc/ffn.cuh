// The fp32 FFN bodies (ffn_ln_block.cu, ffn_train.cu), which exist to hold
// the model against the CPU: the tiling of the (rows, H) x (H, I) x (I, H)
// products, the weight-tile stream, gelu and its derivative, and the fused
// forward kernel that the fp32 training FFN and the fp32 serving block
// (LN1 -> FFN -> LN2) launch; LnArgs is shared with ffn_sm90.cuh.  bf16
// runs the Hopper kernels of ffn_sm90.cuh and ffn_train_sm90.cuh.
//
// Two hidden widths, each with its own thread count and chunk (Width):
// H = 768 (BERT-base, BioBERT, the BigBird trunk): 384 threads (12 warps),
// chunks of 192; H = 1024 (ProtBERT): 512 threads (16 warps), chunks of
// 256.  A block owns BM rows.  The intermediate axis is walked in chunks;
// the weight tiles of all chunks form one stream through a ring of STAGES
// shared-memory buffers filled by cp.async, STAGES - 1 tiles ahead of the
// tile in use, with one block barrier per tile.  Two tile shapes:
//   "W1 tile": 64 x chunk of an (H, I) matrix (rows t*64, columns chunk);
//   "W2 tile": 16 x H of an (I, H) matrix (rows chunk + t*16).
// The products are plain FMAs on 16-row blocks.

#pragma once

#include "common.cuh"

namespace stonkgs {
namespace ffn {

constexpr int kK1 = 64;      // rows (hidden axis) of a W1 tile
constexpr int kK2 = 16;      // rows (intermediate axis) of a W2 tile

// hidden width -> threads of a block (768: 384, 1024: 512) and
// intermediate-axis chunk (768: 192, 1024: 256)
template <int H> struct Width {
  static constexpr int kH = H, kThreads = H / 2, kChunk = H / 4;
};

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };

// Shared memory of a kernel of hidden width H with BM rows, NROW (BM, H)
// row operands and a STAGES-deep weight ring; after the row operands, a
// work area (ring, h chunk) that the epilogue reuses as its staging.  It
// also carries the width's thread mapping.
template <typename T, int H, int BM_, int STAGES_, int NROW>
struct Layout {
  static constexpr int kH = H, kThreads = Width<H>::kThreads, kChunk = Width<H>::kChunk;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPer = kH / 32;           // row values per lane in the LayerNorms
  static constexpr int kTiles1 = kH / kK1;       // W1 tiles per chunk
  static constexpr int kTiles2 = kChunk / kK2;   // W2 tiles per chunk
  static constexpr int BM = BM_, STAGES = STAGES_, PAD = Pad<T>::value;
  static constexpr int XS = kH + PAD;       // row operand stride (T)
  static constexpr int W1S = kChunk + PAD;  // W1 tile row stride (T)
  static constexpr int W2S = kH + PAD;      // W2 tile row stride (T)
  static constexpr int WBUF = kK1 * W1S > kK2 * W2S ? kK1 * W1S : kK2 * W2S;
  static constexpr int HSS = kChunk + PAD;  // rounded h chunk row stride (T)
  static constexpr int STS = kH + 4;        // fp32 epilogue staging row stride
  static constexpr size_t xs_bytes = align128(size_t(BM) * XS * sizeof(T));
  static constexpr size_t wbuf_bytes = align128(size_t(STAGES) * WBUF * sizeof(T));
  static constexpr size_t hs_bytes = align128(size_t(BM) * HSS * sizeof(T));
  static constexpr size_t work_bytes = wbuf_bytes + hs_bytes;
  static constexpr size_t stage_bytes = size_t(16) * STS * sizeof(float);
  static constexpr size_t smem_bytes =
      NROW * xs_bytes + (work_bytes > stage_bytes ? work_bytes : stage_bytes);
};

// the forward kernels, one row operand, 16 rows (at H = 1024: 215,552
// bytes of shared memory of the 232,448 a block may have)
template <typename T, int H> struct FwdTiling;
template <> struct FwdTiling<float, 768> { using L = Layout<float, 768, 16, 2, 1>; };
template <> struct FwdTiling<float, 1024> { using L = Layout<float, 1024, 16, 2, 1>; };

__device__ __forceinline__ float gelu(float h, int act) {
  if (act == 0) return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
  const float c = 0.79788456080286536f;  // sqrt(2 / pi)
  return 0.5f * h * (1.0f + tanhf(c * (h + 0.044715f * h * h * h)));
}

// gelu(h) and its derivative, in fp32 (exact erf, or the tanh gelu_new)
__device__ __forceinline__ void gelu_and_grad(float h, int act, float& a, float& da) {
  if (act == 0) {
    const float e = erff(h * 0.70710678118654752f);
    a = 0.5f * h * (1.0f + e);
    da = 0.5f * (1.0f + e) + h * 0.39894228040143268f * expf(-0.5f * h * h);
  } else {
    const float c = 0.79788456080286536f;
    const float u = tanhf(c * (h + 0.044715f * h * h * h));
    a = 0.5f * h * (1.0f + u);
    da = 0.5f * (1.0f + u) + 0.5f * h * (1.0f - u * u) * c * (1.0f + 3.0f * 0.044715f * h * h);
  }
}

// rows x cols elements of T, global (row stride gs) -> shared (row stride ss),
// in 16-byte cp.async pieces spread over the block
template <typename L, typename T>
__device__ __forceinline__ void load_tile_async(T* s, int ss, const T* g, size_t gs,
                                                int rows, int cols) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols / V;
  for (int i = threadIdx.x; i < rows * vpr; i += L::kThreads) {
    const int r = i / vpr, c = (i % vpr) * V;
    cp_async16(s + r * ss + c, g + r * gs + c);
  }
}

// W1 tile t of chunk c0 of an (H, I) matrix
template <typename L, typename T>
__device__ __forceinline__ void fetch_w1(T* dst, const T* w, int I, int c0, int t) {
  load_tile_async<L>(dst, L::W1S, w + size_t(t) * kK1 * I + c0, size_t(I), kK1, L::kChunk);
}

// W2 tile t of chunk c0 of an (I, H) matrix
template <typename L, typename T>
__device__ __forceinline__ void fetch_w2(T* dst, const T* w, int c0, int t) {
  load_tile_async<L>(dst, L::W2S, w + size_t(c0 + t * kK2) * L::kH, size_t(L::kH), kK2, L::kH);
}

// BM rows of a (M, H) matrix -> shared (stride XS); rows >= M are zero
template <typename L, typename T>
__device__ __forceinline__ void load_row_block(T* s, const T* g, int row0, int M) {
  constexpr int V = 16 / sizeof(T), VPR = L::kH / V;
  for (int i = threadIdx.x; i < L::BM * VPR; i += L::kThreads) {
    const int r = i / VPR, c = (i % VPR) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < M) val = *reinterpret_cast<const uint4*>(g + size_t(row0 + r) * L::kH + c);
    *reinterpret_cast<uint4*>(s + r * L::XS + c) = val;
  }
}

// fp32: hacc[r] += a[hr + r, t*64 + kk] * W1 tile[kk, hc] (rows hr..hr+8)
template <typename L>
__device__ __forceinline__ void fma_w1_tile(float (&hacc)[8], const float* as, const float* cur,
                                            int t, int hr, int hc) {
  for (int kk = 0; kk < kK1; ++kk) {
    const float w = cur[kk * L::W1S + hc];
#pragma unroll
    for (int r = 0; r < 8; ++r) hacc[r] += as[(hr + r) * L::XS + t * kK1 + kk] * w;
  }
}

// fp32: acc[r][*] += hs[r, kt*16 + kk] * W2 tile[kk, tid and tid + threads]
template <typename L>
__device__ __forceinline__ void fma_w2_tile(float (&acc)[16][2], const float* hs,
                                            const float* cur, int kt, int tid) {
  for (int kk = 0; kk < kK2; ++kk) {
    const float wa = cur[kk * L::W2S + tid], wb = cur[kk * L::W2S + tid + L::kThreads];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float h = hs[r * L::HSS + kt * kK2 + kk];
      acc[r][0] += h * wa;
      acc[r][1] += h * wb;
    }
  }
}

// LayerNorm of one row of width H held as H / 32 values per lane (column
// lane + 32*i)
template <int H>
__device__ __forceinline__ void layer_norm_row(float (&v)[H / 32], const float* g,
                                               const float* b, float eps, int lane) {
  constexpr int kPer = H / 32;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) s += v[i];
  const float mean = warp_sum(s) / H;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float d = v[i] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / H + eps);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    v[i] = (v[i] - mean) * rstd * g[c] + b[c];
  }
}

// LayerNorm parameters of the serving block (both null for the plain FFN)
struct LnArgs {
  const float* g1;
  const float* be1;
  const float* g2;
  const float* be2;
  float eps;
};

// Epilogue for 16 rows [r0, r0+16) of the block, whose W2 product sits in
// `stage` (fp32, 16 x STS): ff = round(acc + b2) (b2 may be null);
// out = LN2(x2 + ff) for the serving block, out = ff otherwise.
template <typename L, typename T, bool kLN>
__device__ __forceinline__ void epilogue_rows(const float* stage, const T* xs, int r0, int row0,
                                              int M, const float* b2, const LnArgs& ln, T* out) {
  constexpr int kPer = L::kPer;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < 16; r += L::kWarps) {
    const int gr = row0 + r0 + r;
    if (gr >= M) continue;
    T* o = out + size_t(gr) * L::kH;
    float v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      v[i] = round_to<T>(stage[r * L::STS + c] + (b2 ? b2[c] : 0.f));
      if constexpr (kLN) v[i] += to_f(xs[(r0 + r) * L::XS + c]);
    }
    if constexpr (kLN) layer_norm_row<L::kH>(v, ln.g2, ln.be2, ln.eps, lane);
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[lane + 32 * i] = from_f<T>(v[i]);
  }
}

// The forward FFN kernel, y = gelu(x2 @ W1 + b1) @ W2 + b2, with
//   kLN: x2 = LN1(x + attn) in fp32, rounded, and out = LN2(x2 + y) (the
//        serving block, _ffn_ln_kernel of the JAX package);
//   else x2 = x and out = y (the training FFN, _ffn_kernel).
// Rounding points as the TPU kernels: h accumulated in fp32, + b1, gelu in
// fp32, rounded to T; y = h @ W2 + b2 rounded.  The (BM, I) intermediate
// never reaches device memory; the (BM, H) fp32 accumulator stays in
// registers across the whole walk.
template <typename T, bool kLN, int H>
__global__ void __launch_bounds__(Width<H>::kThreads, 1)
ffn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, LnArgs ln, T* __restrict__ out, int M, int I,
               int act) {
  using L = typename FwdTiling<T, H>::L;
  constexpr int BM = L::BM, STAGES = L::STAGES;
  constexpr int kH = L::kH, kChunk = L::kChunk, kThreads = L::kThreads, kWarps = L::kWarps;
  constexpr int kPer = L::kPer, kTiles1 = L::kTiles1, kTiles2 = L::kTiles2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  unsigned char* work = smem + L::xs_bytes;
  T* wbuf = reinterpret_cast<T*>(work);
  T* hs = reinterpret_cast<T*>(work + L::wbuf_bytes);
  float* stage = reinterpret_cast<float*>(work);  // epilogue only

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM;
  constexpr int kTiles = kTiles1 + kTiles2;   // W1 then W2 tiles per chunk
  const int total = (I / kChunk) * kTiles;    // weight tiles in the stream

  // tile g of the stream into ring buffer g % STAGES; one cp.async group
  // per call, empty past the end
  auto fetch = [&](int g) {
    if (g < total) {
      T* dst = wbuf + (g % STAGES) * L::WBUF;
      const int c0 = (g / kTiles) * kChunk, t = g % kTiles;
      if (t < kTiles1)
        fetch_w1<L>(dst, w1, I, c0, t);
      else
        fetch_w2<L>(dst, w2, c0, t - kTiles1);
    }
    cp_async_commit();
  };

  // the first tiles fly while the row block loads
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) fetch(g);

  if constexpr (kLN) {
    // x2 = LN1(x + attn_out), statistics in fp32, rounded to T
    for (int r = warp; r < BM; r += kWarps) {
      const int gr = row0 + r;
      T* xr = xs + r * L::XS;
      if (gr >= M) {
        for (int i = 0; i < kPer; ++i) xr[lane + 32 * i] = from_f<T>(0.f);
        continue;
      }
      const T* xp = x + size_t(gr) * kH;
      const T* ap = a + size_t(gr) * kH;
      float v[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = lane + 32 * i;
        v[i] = to_f(xp[c]) + to_f(ap[c]);
      }
      layer_norm_row<kH>(v, ln.g1, ln.be1, ln.eps, lane);
#pragma unroll
      for (int i = 0; i < kPer; ++i) xr[lane + 32 * i] = from_f<T>(v[i]);
    }
  } else {
    load_row_block<L>(xs, x, row0, M);
  }

  // next tile of the weight stream: wait for it, then refill the buffer
  // that the previous tile used (the barrier makes it free)
  int g = 0;
  auto advance = [&]() -> const T* {
    cp_async_wait<STAGES - 2>();  // tile g is in (this thread's pieces)
    __syncthreads();              // ... everyone's; buffer (g-1) % STAGES is free
    fetch(g + STAGES - 1);
    const T* cur = wbuf + (g % STAGES) * L::WBUF;
    ++g;
    return cur;
  };

  // W1 product: thread owns h column tid % chunk and rows [(tid / chunk) *
  // 8, +8); W2 product: columns tid and tid + threads, all rows.
  static_assert(BM == 16 && kThreads == 2 * kChunk && kH == 2 * kThreads,
                "fp32 thread mapping");
  const int tid = threadIdx.x;
  const int hc = tid % kChunk, hr = (tid / kChunk) * 8;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int c0 = 0; c0 < I; c0 += kChunk) {
    float hacc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) hacc[r] = 0.f;
    for (int t = 0; t < kTiles1; ++t) fma_w1_tile<L>(hacc, xs, advance(), t, hr, hc);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      hs[(hr + r) * L::HSS + hc] = from_f<T>(gelu(hacc[r] + b1[c0 + hc], act));
    for (int kt = 0; kt < kTiles2; ++kt) fma_w2_tile<L>(acc, hs, advance(), kt, tid);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    stage[r * L::STS + tid] = acc[r][0];
    stage[r * L::STS + tid + kThreads] = acc[r][1];
  }
  __syncthreads();
  epilogue_rows<L, T, kLN>(stage, xs, 0, row0, M, b2, ln, out);
}

template <typename T, bool kLN, int H>
int launch_fwd_width(const void* x, const void* a, const void* w1, const float* b1,
                     const void* w2, const float* b2, const LnArgs& ln, void* out, int M, int I,
                     int act, cudaStream_t stream) {
  using L = typename FwdTiling<T, H>::L;
  if (M <= 0 || I <= 0 || I % L::kChunk != 0 || (act != 0 && act != 1))
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ffn_fwd_kernel<T, kLN, H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(L::smem_bytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((M + L::BM - 1) / L::BM);
  ffn_fwd_kernel<T, kLN, H><<<grid, L::kThreads, L::smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, ln, static_cast<T*>(out), M, I, act);
  return int(cudaGetLastError());
}

// the forward kernel at hidden width H (768 or 1024)
template <typename T, bool kLN>
int launch_fwd(const void* x, const void* a, const void* w1, const float* b1, const void* w2,
               const float* b2, const LnArgs& ln, void* out, int M, int H, int I, int act,
               cudaStream_t stream) {
  if (H == 768)
    return launch_fwd_width<T, kLN, 768>(x, a, w1, b1, w2, b2, ln, out, M, I, act, stream);
  if (H == 1024)
    return launch_fwd_width<T, kLN, 1024>(x, a, w1, b1, w2, b2, ln, out, M, I, act, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace ffn
}  // namespace stonkgs
