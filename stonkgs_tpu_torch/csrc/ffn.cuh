// The fp32 FFN bodies (ffn_ln_block.cu, ffn_train.cu), which exist to hold
// the model against the CPU: the tiling of the (rows, H) x (H, I) x (I, H)
// products, the weight-tile stream, gelu and its derivative, and the fused
// forward kernel that the fp32 training FFN and the fp32 serving block
// (LN1 -> FFN -> LN2) launch; LnArgs is shared with ffn_sm90.cuh.  bf16
// runs the Hopper kernels of ffn_sm90.cuh and ffn_train_sm90.cuh.
//
// The widths are run-time arguments: any hidden width H that is a multiple
// of 32 up to 1024 and any intermediate width I that is a multiple of 32
// (widths_ok), one instantiation for all.  A block of 256 threads owns
// kBM = 16 rows.  The intermediate axis is walked in chunks of 128
// columns (the last one 32, 64, 96 or 128 wide); the weight tiles of all
// chunks form one stream through a ring of two shared-memory buffers
// filled by cp.async, one tile ahead of the tile in use, with one block
// barrier per tile.  Two tile shapes:
//   "W1 tile": 32 x chunk of an (H, I) matrix (rows t*32, the chunk's columns);
//   "W2 tile": 8 x H of an (I, H) matrix (rows chunk + t*8).
// In a W1 product a thread owns one chunk column of 8 of the 16 rows; in
// a W2 product the columns tid + 256j (j < 4) below H of all 16 rows, so
// the (16, H) fp32 accumulator stays in registers (a warp's columns are
// all below H or all above it, as H is a multiple of 32).  The products
// are plain FMAs.  Shared memory at H = 1024: 140 KB with one row operand
// (the forward), 206 KB with two (the backward in ffn_train.cu).

#pragma once

#include "common.cuh"

namespace stonkgs {
namespace ffn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 16;                  // rows of a block
constexpr int kChunk = 128;              // intermediate columns of a chunk
constexpr int kK1 = 32;                  // rows (hidden axis) of a W1 tile
constexpr int kK2 = 8;                   // rows (intermediate axis) of a W2 tile
constexpr int kStages = 2;               // weight ring buffers
constexpr int kPad = 4;                  // floats of padding a shared row
constexpr int kMaxH = 1024;
constexpr int kCols = kMaxH / kThreads;  // W2-product columns a thread, at most
constexpr int kMaxPer = kMaxH / 32;      // a row's values a lane in the LayerNorms

// whether the fp32 bodies (and the bf16 LayerNorm pass) take widths H and I
inline bool widths_ok(int H, int I) {
  return H >= 32 && H <= kMaxH && H % 32 == 0 && I >= 32 && I % 32 == 0;
}

// Shared memory of a block at hidden width H: `nrow` (16, H) row operands,
// then a work area (the weight ring and the h chunk) that the epilogue
// reuses as its (16, H) fp32 staging.  Row strides in floats.
struct Layout {
  int XS;    // row operand and staging stride
  int W1S;   // W1 tile stride
  int W2S;   // W2 tile stride
  int WBUF;  // floats of a ring buffer
  int HSS;   // h chunk stride
  size_t xs_bytes, wbuf_bytes, work_bytes;

  size_t smem_bytes(int nrow) const { return nrow * xs_bytes + work_bytes; }
};

inline Layout make_layout(int H) {
  Layout L;
  L.XS = H + kPad;
  L.W1S = kChunk + kPad;
  L.W2S = H + kPad;
  L.WBUF = kK1 * L.W1S > kK2 * L.W2S ? kK1 * L.W1S : kK2 * L.W2S;
  L.HSS = kChunk + kPad;
  L.xs_bytes = align128(size_t(kBM) * L.XS * sizeof(float));
  L.wbuf_bytes = align128(size_t(kStages) * L.WBUF * sizeof(float));
  const size_t ring_and_h = L.wbuf_bytes + align128(size_t(kBM) * L.HSS * sizeof(float));
  L.work_bytes = ring_and_h > L.xs_bytes ? ring_and_h : L.xs_bytes;  // staging: (16, H)
  return L;
}

// weight tiles in the stream of an I-wide intermediate axis with `per`
// tiles a full chunk (the last chunk has fewer W2 tiles when I % 128 != 0)
__device__ __forceinline__ int stream_tiles(int I, int per) {
  const int rem = I % kChunk;
  return (I / kChunk) * per + (rem ? per - (kChunk - rem) / kK2 : 0);
}

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

// rows x cols floats, global (row stride gs) -> shared (row stride ss), in
// 16-byte cp.async pieces spread over the block
__device__ __forceinline__ void load_tile_async(float* s, int ss, const float* g, size_t gs,
                                                int rows, int cols) {
  const int vpr = cols / 4;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * 4;
    cp_async16(s + r * ss + c, g + r * gs + c);
  }
}

// W1 tile t of the chunk [c0, c0 + cn) of an (H, I) matrix
__device__ __forceinline__ void fetch_w1(float* dst, const Layout& L, const float* w, int I,
                                         int c0, int cn, int t) {
  load_tile_async(dst, L.W1S, w + size_t(t) * kK1 * I + c0, size_t(I), kK1, cn);
}

// W2 tile t of the chunk at c0 of an (I, H) matrix
__device__ __forceinline__ void fetch_w2(float* dst, const Layout& L, const float* w, int H,
                                         int c0, int t) {
  load_tile_async(dst, L.W2S, w + size_t(c0 + t * kK2) * H, size_t(H), kK2, H);
}

// kBM rows of a (M, H) matrix -> shared (stride XS); rows >= M are zero
__device__ __forceinline__ void load_row_block(float* s, const Layout& L, const float* g,
                                               int row0, int M, int H) {
  const int vpr = H / 4;
  for (int i = threadIdx.x; i < kBM * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < M) val = *reinterpret_cast<const float4*>(g + size_t(row0 + r) * H + c);
    *reinterpret_cast<float4*>(s + r * L.XS + c) = val;
  }
}

// hacc[r] += a[hr + r, t*32 + kk] * W1 tile[kk, hc] (rows hr..hr+8)
__device__ __forceinline__ void fma_w1_tile(float (&hacc)[8], const float* as, const Layout& L,
                                            const float* cur, int t, int hr, int hc) {
  for (int kk = 0; kk < kK1; ++kk) {
    const float w = cur[kk * L.W1S + hc];
#pragma unroll
    for (int r = 0; r < 8; ++r) hacc[r] += as[(hr + r) * L.XS + t * kK1 + kk] * w;
  }
}

// acc[r][j] += hs[r, kt*8 + kk] * W2 tile[kk, tid + 256j], columns below H
__device__ __forceinline__ void fma_w2_tile(float (&acc)[kBM][kCols], const float* hs,
                                            const Layout& L, const float* cur, int kt, int H) {
  const int tid = threadIdx.x;
  for (int kk = 0; kk < kK2; ++kk) {
    float w[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tid + j * kThreads;
      w[j] = c < H ? cur[kk * L.W2S + c] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBM; ++r) {
      const float h = hs[r * L.HSS + kt * kK2 + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (tid + j * kThreads < H) acc[r][j] += h * w[j];
    }
  }
}

// the (16, H) accumulator -> the fp32 staging rows (stride XS)
__device__ __forceinline__ void stage_acc(float* stage, const Layout& L,
                                          const float (&acc)[kBM][kCols], int H) {
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < H) stage[r * L.XS + c] = acc[r][j];
    }
}

// LayerNorm of one row of width H held as H / 32 values per lane (column
// lane + 32*i, i < H / 32)
__device__ __forceinline__ void layer_norm_row(float (&v)[kMaxPer], int H, const float* g,
                                               const float* b, float eps, int lane) {
  const int per = H / 32;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i)
    if (i < per) s += v[i];
  const float mean = warp_sum(s) / H;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i)
    if (i < per) {
      const float d = v[i] - mean;
      q += d * d;
    }
  const float rstd = rsqrtf(warp_sum(q) / H + eps);
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i)
    if (i < per) {
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

// Epilogue for the block's rows, whose W2 product sits in `stage` (fp32,
// stride XS): ff = acc + b2 (b2 may be null); out = LN2(x2 + ff) for the
// serving block, out = ff otherwise.
template <bool kLN>
__device__ __forceinline__ void epilogue_rows(const float* stage, const float* xs,
                                              const Layout& L, int row0, int M, int H,
                                              const float* b2, const LnArgs& ln, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, per = H / 32;
  for (int r = warp; r < kBM; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= M) continue;
    float v[kMaxPer];
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i)
      if (i < per) {
        const int c = lane + 32 * i;
        v[i] = stage[r * L.XS + c] + (b2 ? b2[c] : 0.f);
        if constexpr (kLN) v[i] += xs[r * L.XS + c];
      }
    if constexpr (kLN) layer_norm_row(v, H, ln.g2, ln.be2, ln.eps, lane);
    float* o = out + size_t(gr) * H;
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i)
      if (i < per) o[lane + 32 * i] = v[i];
  }
}

// The fp32 forward FFN kernel, y = gelu(x2 @ W1 + b1) @ W2 + b2, with
//   kLN: x2 = LN1(x + attn) and out = LN2(x2 + y) (the serving block,
//        _ffn_ln_kernel of the JAX package);
//   else x2 = x and out = y (the training FFN, _ffn_kernel).
// h accumulated in fp32, + b1, gelu in fp32; y = h @ W2 + b2 (the TPU
// kernels' rounding points are the identity in fp32).  The (16, I)
// intermediate never reaches device memory; the (16, H) fp32 accumulator
// stays in registers across the whole walk.
template <bool kLN>
__global__ void __launch_bounds__(kThreads, 1)
ffn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2, LnArgs ln,
               float* __restrict__ out, int M, int H, int I, int act, Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  unsigned char* work = smem + L.xs_bytes;
  float* wbuf = reinterpret_cast<float*>(work);
  float* hs = reinterpret_cast<float*>(work + L.wbuf_bytes);
  float* stage = reinterpret_cast<float*>(work);  // epilogue only

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const int row0 = blockIdx.x * kBM;
  const int nt1 = H / kK1;                   // W1 tiles a chunk
  const int per = nt1 + kChunk / kK2;        // W1 then W2 tiles a full chunk
  const int total = stream_tiles(I, per);    // weight tiles in the stream

  // tile g of the stream into ring buffer g % kStages; one cp.async group
  // per call, empty past the end
  auto fetch = [&](int g) {
    if (g < total) {
      float* dst = wbuf + (g % kStages) * L.WBUF;
      const int c = g / per, c0 = c * kChunk, t = g - c * per;
      if (t < nt1)
        fetch_w1(dst, L, w1, I, c0, min(kChunk, I - c0), t);
      else
        fetch_w2(dst, L, w2, H, c0, t - nt1);
    }
    cp_async_commit();
  };

  // the first tile flies while the row block loads
  fetch(0);

  if constexpr (kLN) {
    // x2 = LN1(x + attn_out), statistics in fp32
    const int per_lane = H / 32;
    for (int r = warp; r < kBM; r += kWarps) {
      const int gr = row0 + r;
      float* xr = xs + r * L.XS;
      if (gr >= M) {
        for (int i = 0; i < per_lane; ++i) xr[lane + 32 * i] = 0.f;
        continue;
      }
      const float* xp = x + size_t(gr) * H;
      const float* ap = a + size_t(gr) * H;
      float v[kMaxPer];
#pragma unroll
      for (int i = 0; i < kMaxPer; ++i)
        if (i < per_lane) v[i] = xp[lane + 32 * i] + ap[lane + 32 * i];
      layer_norm_row(v, H, ln.g1, ln.be1, ln.eps, lane);
#pragma unroll
      for (int i = 0; i < kMaxPer; ++i)
        if (i < per_lane) xr[lane + 32 * i] = v[i];
    }
  } else {
    load_row_block(xs, L, x, row0, M, H);
  }

  // next tile of the weight stream: wait for it, then refill the buffer
  // that the previous tile used (the barrier makes it free)
  int g = 0;
  auto advance = [&]() -> const float* {
    cp_async_wait<kStages - 2>();  // tile g is in (this thread's pieces)
    __syncthreads();               // ... everyone's; buffer (g-1) % kStages is free
    fetch(g + kStages - 1);
    const float* cur = wbuf + (g % kStages) * L.WBUF;
    ++g;
    return cur;
  };

  // W1 product: thread owns h column tid % 128 of rows [(tid / 128) * 8, +8)
  const int hc = tid % kChunk, hr = (tid / kChunk) * 8;
  float acc[kBM][kCols];
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  for (int c0 = 0; c0 < I; c0 += kChunk) {
    const int cn = min(kChunk, I - c0);
    float hacc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) hacc[r] = 0.f;
    for (int t = 0; t < nt1; ++t) fma_w1_tile(hacc, xs, L, advance(), t, hr, hc);
    if (hc < cn) {
#pragma unroll
      for (int r = 0; r < 8; ++r) hs[(hr + r) * L.HSS + hc] = gelu(hacc[r] + b1[c0 + hc], act);
    }
    for (int kt = 0; kt < cn / kK2; ++kt) fma_w2_tile(acc, hs, L, advance(), kt, H);
  }
  __syncthreads();
  stage_acc(stage, L, acc, H);
  __syncthreads();
  epilogue_rows<kLN>(stage, xs, L, row0, M, H, b2, ln, out);
}

// the fp32 forward kernel at any H and I that widths_ok takes
template <bool kLN>
int launch_fwd(const void* x, const void* a, const void* w1, const float* b1, const void* w2,
               const float* b2, const LnArgs& ln, void* out, int M, int H, int I, int act,
               cudaStream_t stream) {
  if (M <= 0 || !widths_ok(H, I) || (act != 0 && act != 1)) return int(cudaErrorInvalidValue);
  const Layout L = make_layout(H);
  const size_t smem = L.smem_bytes(1);
  cudaError_t e = cudaFuncSetAttribute(ffn_fwd_kernel<kLN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((M + kBM - 1) / kBM);
  ffn_fwd_kernel<kLN><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(w1), b1, static_cast<const float*>(w2), b2, ln,
      static_cast<float*>(out), M, H, I, act, L);
  return int(cudaGetLastError());
}

}  // namespace ffn
}  // namespace stonkgs
