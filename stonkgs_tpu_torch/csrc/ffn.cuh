// The fp32 FFN bodies (ffn_ln_block.cu, ffn_train.cu), which exist to hold
// the model against the CPU: the tiling of the (rows, H) x (H, I) x (I, H)
// products, the weight-tile stream, gelu and its derivative, and the fused
// forward kernel that the fp32 training FFN and the fp32 serving block
// (LN1 -> FFN -> LN2) launch; LnArgs, the widths' domain and the padded
// layout are shared with ffn_sm90.cuh.  bf16 runs the Hopper kernels of
// ffn_sm90.cuh and ffn_train_sm90.cuh.
//
// Widths: every FFN entry point takes any hidden width H >= 1 and any
// intermediate width I >= 1 (widths_ok), in both dtypes.  The
// arrays lie in a padded layout: each row of H (or I) values is ld(H) (or
// ld(I)) elements long, ld rounding up to a multiple of 32 in fp32 and of 8
// in bf16 (padded_width), the padding zero (fp32) or never read (bf16).
// The fp32 bodies run at the padded widths Hp and Ip, where the zero
// columns and rows add nothing to a product; only the LayerNorm statistics
// see the true H (LnArgs::n), and they are taken over it alone.
//
// Two instances of the fused body (Geometry): Narrow for Hp <= 1024, the
// original one, and Wide for 1024 < Hp <= 2048 (kRowHidden), with half the
// rows a block and half the rows a W2 tile, so that the (rows, Hp)
// accumulator keeps its 64 registers a thread and shared memory stays
// under 227 KB.  Above 2048 the fused shape has no room (its accumulator
// and row operands grow with H), so fp32 is split at h as bf16 is
// (ffn_sm90.cuh): a LayerNorm pass that walks a row in chunks
// (layer_norm_rows_kernel), a tiled SIMT GEMM with the bias and gelu in
// its epilogue into an (M, Ip) fp32 scratch h, a second GEMM, and the
// LayerNorm in place; the backward is three such GEMMs (ffn_train.cu).  A
// block of 256 threads owns kBM rows (16, or 8 wide).  The intermediate
// axis is walked in chunks of 128 columns (the last one 32, 64, 96 or 128
// wide); the weight tiles of all chunks form one stream through a ring of
// two shared-memory buffers filled by cp.async, one tile ahead of the tile
// in use, with one block barrier per tile.  Two tile shapes:
//   "W1 tile": 32 x chunk of an (Hp, Ip) matrix (rows t*32, the chunk's columns);
//   "W2 tile": kK2 x Hp of an (Ip, Hp) matrix (rows chunk + t*kK2; kK2 8, or 4 wide).
// In a W1 product a thread owns one chunk column of kBM / 2 rows; in a W2
// product the columns tid + 256j below Hp of all kBM rows, so the (kBM,
// Hp) fp32 accumulator stays in registers (a warp's columns are all below
// Hp or all above it, as Hp is a multiple of 32).  The products are plain
// FMAs.  Shared memory at Hp = 1024 (Narrow): 140 KB with one row operand
// (the forward), 206 KB with two (the backward in ffn_train.cu); at Hp =
// 2048 (Wide): 136 KB and 201 KB.

#pragma once

#include "common.cuh"

namespace stonkgs {
namespace ffn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;              // intermediate columns of a chunk
constexpr int kK1 = 32;                  // rows (hidden axis) of a W1 tile
constexpr int kStages = 2;               // weight ring buffers
constexpr int kPad = 4;                  // floats of padding a shared row
constexpr int kMinWidth = 1;             // the narrowest H and I (a bf16 row of
                                         // H < 8 is padded to 8, 16 bytes)
// the widest padded H of the fused fp32 bodies and of the bf16 LayerNorm
// passes that hold a row in registers; wider rows take the split fp32 path
// and the chunked LayerNorm pass
constexpr int kRowHidden = 2048;

// whether the FFN entry points take widths H and I (both dtypes)
inline bool widths_ok(int H, int I) { return H >= kMinWidth && I >= kMinWidth; }

// the row length of an n-wide array in the padded layout: a multiple of
// 32 elements in fp32 (dtype 0), of 8 (16 bytes, as TMA's strides need) in
// bf16 (dtype 1); ops/fused_ffn.py::padded_width
inline int padded_width(int n, int dtype) {
  const int m = dtype == 0 ? 32 : 8;
  return (n + m - 1) / m * m;
}

// A body's geometry: the widest padded H it takes, the rows of a block and
// the rows of a W2 tile
template <int kMaxH_, int kBM_, int kK2_>
struct Geometry {
  static constexpr int kMaxH = kMaxH_;
  static constexpr int kBM = kBM_;
  static constexpr int kK2 = kK2_;
  static constexpr int kCols = kMaxH / kThreads;        // W2-product columns a thread, at most
  static constexpr int kMaxPer = kMaxH / 32;            // a row's values a lane in the LayerNorms
  static constexpr int kRowsW1 = kBM * kChunk / kThreads;  // W1-product rows a thread
};
using Narrow = Geometry<1024, 16, 8>;
using Wide = Geometry<2048, 8, 4>;

// Shared memory of a block at padded hidden width H: `nrow` (kBM, H) row
// operands, then a work area (the weight ring and the h chunk) that the
// epilogue reuses as its (kBM, H) fp32 staging.  Row strides in floats.
struct Layout {
  int XS;    // row operand and staging stride
  int W1S;   // W1 tile stride
  int W2S;   // W2 tile stride
  int WBUF;  // floats of a ring buffer
  int HSS;   // h chunk stride
  size_t xs_bytes, wbuf_bytes, work_bytes;

  size_t smem_bytes(int nrow) const { return nrow * xs_bytes + work_bytes; }
};

template <class G>
inline Layout make_layout(int H) {
  Layout L;
  L.XS = H + kPad;
  L.W1S = kChunk + kPad;
  L.W2S = H + kPad;
  L.WBUF = kK1 * L.W1S > G::kK2 * L.W2S ? kK1 * L.W1S : G::kK2 * L.W2S;
  L.HSS = kChunk + kPad;
  L.xs_bytes = align128(size_t(G::kBM) * L.XS * sizeof(float));
  L.wbuf_bytes = align128(size_t(kStages) * L.WBUF * sizeof(float));
  const size_t ring_and_h =
      L.wbuf_bytes + align128(size_t(G::kBM) * L.HSS * sizeof(float));
  L.work_bytes = ring_and_h > L.xs_bytes ? ring_and_h : L.xs_bytes;  // staging: (kBM, H)
  return L;
}

// weight tiles in the stream of an I-wide intermediate axis with `per`
// tiles a full chunk (the last chunk has fewer W2 tiles when I % 128 != 0)
template <class G>
__device__ __forceinline__ int stream_tiles(int I, int per) {
  const int rem = I % kChunk;
  return (I / kChunk) * per + (rem ? per - (kChunk - rem) / G::kK2 : 0);
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
template <class G>
__device__ __forceinline__ void fetch_w2(float* dst, const Layout& L, const float* w, int H,
                                         int c0, int t) {
  load_tile_async(dst, L.W2S, w + size_t(c0 + t * G::kK2) * H, size_t(H), G::kK2, H);
}

// kBM rows of a (M, H) matrix -> shared (stride XS); rows >= M are zero
template <class G>
__device__ __forceinline__ void load_row_block(float* s, const Layout& L, const float* g,
                                               int row0, int M, int H) {
  const int vpr = H / 4;
  for (int i = threadIdx.x; i < G::kBM * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < M) val = *reinterpret_cast<const float4*>(g + size_t(row0 + r) * H + c);
    *reinterpret_cast<float4*>(s + r * L.XS + c) = val;
  }
}

// hacc[r] += a[hr + r, t*32 + kk] * W1 tile[kk, hc] (rows hr..hr+kRowsW1)
template <class G>
__device__ __forceinline__ void fma_w1_tile(float (&hacc)[G::kRowsW1], const float* as,
                                            const Layout& L, const float* cur, int t, int hr,
                                            int hc) {
  for (int kk = 0; kk < kK1; ++kk) {
    const float w = cur[kk * L.W1S + hc];
#pragma unroll
    for (int r = 0; r < G::kRowsW1; ++r) hacc[r] += as[(hr + r) * L.XS + t * kK1 + kk] * w;
  }
}

// acc[r][j] += hs[r, kt*kK2 + kk] * W2 tile[kk, tid + 256j], columns below H
template <class G>
__device__ __forceinline__ void fma_w2_tile(float (&acc)[G::kBM][G::kCols], const float* hs,
                                            const Layout& L, const float* cur, int kt, int H) {
  const int tid = threadIdx.x;
  for (int kk = 0; kk < G::kK2; ++kk) {
    float w[G::kCols];
#pragma unroll
    for (int j = 0; j < G::kCols; ++j) {
      const int c = tid + j * kThreads;
      w[j] = c < H ? cur[kk * L.W2S + c] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < G::kBM; ++r) {
      const float h = hs[r * L.HSS + kt * G::kK2 + kk];
#pragma unroll
      for (int j = 0; j < G::kCols; ++j)
        if (tid + j * kThreads < H) acc[r][j] += h * w[j];
    }
  }
}

// the (kBM, H) accumulator -> the fp32 staging rows (stride XS)
template <class G>
__device__ __forceinline__ void stage_acc(float* stage, const Layout& L,
                                          const float (&acc)[G::kBM][G::kCols], int H) {
#pragma unroll
  for (int r = 0; r < G::kBM; ++r)
#pragma unroll
    for (int j = 0; j < G::kCols; ++j) {
      const int c = threadIdx.x + j * kThreads;
      if (c < H) stage[r * L.XS + c] = acc[r][j];
    }
}

// LayerNorm parameters of the serving block (all null for the plain FFN):
// the scales and biases, eps, and the true hidden width n over which the
// statistics are taken
struct LnArgs {
  const float* g1;
  const float* be1;
  const float* g2;
  const float* be2;
  float eps;
  int n;
};

// LayerNorm of one row held as H / 32 values per lane (column lane + 32*i,
// i < H / 32, H the padded width), statistics over the first n columns;
// the columns from n on come out 0
template <class G>
__device__ __forceinline__ void layer_norm_row(float (&v)[G::kMaxPer], int H, int n,
                                               const float* g, const float* b, float eps,
                                               int lane) {
  const int per = H / 32;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < G::kMaxPer; ++i)
    if (i < per && lane + 32 * i < n) s += v[i];
  const float mean = warp_sum(s) / n;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < G::kMaxPer; ++i)
    if (i < per && lane + 32 * i < n) {
      const float d = v[i] - mean;
      q += d * d;
    }
  const float rstd = rsqrtf(warp_sum(q) / n + eps);
#pragma unroll
  for (int i = 0; i < G::kMaxPer; ++i)
    if (i < per) {
      const int c = lane + 32 * i;
      v[i] = c < n ? (v[i] - mean) * rstd * g[c] + b[c] : 0.f;
    }
}

// Epilogue for the block's rows, whose W2 product sits in `stage` (fp32,
// stride XS): ff = acc + b2 (b2 may be null); out = LN2(x2 + ff) for the
// serving block, out = ff otherwise.
template <class G, bool kLN>
__device__ __forceinline__ void epilogue_rows(const float* stage, const float* xs,
                                              const Layout& L, int row0, int M, int H,
                                              const float* b2, const LnArgs& ln, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, per = H / 32;
  for (int r = warp; r < G::kBM; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= M) continue;
    float v[G::kMaxPer];
#pragma unroll
    for (int i = 0; i < G::kMaxPer; ++i)
      if (i < per) {
        const int c = lane + 32 * i;
        v[i] = stage[r * L.XS + c] + (b2 ? b2[c] : 0.f);
        if constexpr (kLN) v[i] += xs[r * L.XS + c];
      }
    if constexpr (kLN) layer_norm_row<G>(v, H, ln.n, ln.g2, ln.be2, ln.eps, lane);
    float* o = out + size_t(gr) * H;
#pragma unroll
    for (int i = 0; i < G::kMaxPer; ++i)
      if (i < per) o[lane + 32 * i] = v[i];
  }
}

// The fp32 forward FFN kernel, y = gelu(x2 @ W1 + b1) @ W2 + b2, with
//   kLN: x2 = LN1(x + attn) and out = LN2(x2 + y) (the serving block,
//        _ffn_ln_kernel of the JAX package);
//   else x2 = x and out = y (the training FFN, _ffn_kernel).
// H and I are the padded widths.  h accumulated in fp32, + b1, gelu in
// fp32; y = h @ W2 + b2 (the TPU kernels' rounding points are the identity
// in fp32).  The (kBM, I) intermediate never reaches device memory; the
// (kBM, H) fp32 accumulator stays in registers across the whole walk.
template <class G, bool kLN>
__global__ void __launch_bounds__(kThreads, 1)
ffn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2, LnArgs ln,
               float* __restrict__ out, int M, int H, int I, int act, Layout L) {
  constexpr int kBM = G::kBM;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  unsigned char* work = smem + L.xs_bytes;
  float* wbuf = reinterpret_cast<float*>(work);
  float* hs = reinterpret_cast<float*>(work + L.wbuf_bytes);
  float* stage = reinterpret_cast<float*>(work);  // epilogue only

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const int row0 = blockIdx.x * kBM;
  const int nt1 = H / kK1;                   // W1 tiles a chunk
  const int per = nt1 + kChunk / G::kK2;     // W1 then W2 tiles a full chunk
  const int total = stream_tiles<G>(I, per);  // weight tiles in the stream

  // tile g of the stream into ring buffer g % kStages; one cp.async group
  // per call, empty past the end
  auto fetch = [&](int g) {
    if (g < total) {
      float* dst = wbuf + (g % kStages) * L.WBUF;
      const int c = g / per, c0 = c * kChunk, t = g - c * per;
      if (t < nt1)
        fetch_w1(dst, L, w1, I, c0, min(kChunk, I - c0), t);
      else
        fetch_w2<G>(dst, L, w2, H, c0, t - nt1);
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
      float v[G::kMaxPer];
#pragma unroll
      for (int i = 0; i < G::kMaxPer; ++i)
        if (i < per_lane) v[i] = xp[lane + 32 * i] + ap[lane + 32 * i];
      layer_norm_row<G>(v, H, ln.n, ln.g1, ln.be1, ln.eps, lane);
#pragma unroll
      for (int i = 0; i < G::kMaxPer; ++i)
        if (i < per_lane) xr[lane + 32 * i] = v[i];
    }
  } else {
    load_row_block<G>(xs, L, x, row0, M, H);
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

  // W1 product: thread owns h column tid % 128 of kRowsW1 rows from hr
  const int hc = tid % kChunk, hr = (tid / kChunk) * G::kRowsW1;
  float acc[kBM][G::kCols];
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int j = 0; j < G::kCols; ++j) acc[r][j] = 0.f;
  for (int c0 = 0; c0 < I; c0 += kChunk) {
    const int cn = min(kChunk, I - c0);
    float hacc[G::kRowsW1];
#pragma unroll
    for (int r = 0; r < G::kRowsW1; ++r) hacc[r] = 0.f;
    for (int t = 0; t < nt1; ++t) fma_w1_tile<G>(hacc, xs, L, advance(), t, hr, hc);
    if (hc < cn) {
#pragma unroll
      for (int r = 0; r < G::kRowsW1; ++r)
        hs[(hr + r) * L.HSS + hc] = gelu(hacc[r] + b1[c0 + hc], act);
    }
    for (int kt = 0; kt < cn / G::kK2; ++kt) fma_w2_tile<G>(acc, hs, L, advance(), kt, H);
  }
  __syncthreads();
  stage_acc<G>(stage, L, acc, H);
  __syncthreads();
  epilogue_rows<G, kLN>(stage, xs, L, row0, M, H, b2, ln, out);
}

// f(Narrow{}) at padded H <= 1024, f(Wide{}) above
template <typename F>
inline int with_geometry(int Hp, F&& f) {
  return Hp <= Narrow::kMaxH ? f(Narrow{}) : f(Wide{});
}

// --- the split fp32 path, above a padded H of kRowHidden ---------------------

// out = LN(a + b) (b may be null: LN(a)) over M rows of ld elements (a
// multiple of 16 bytes), statistics in fp32 over the first n columns; one
// warp a row walks it in 16-byte vectors three times, re-reading it from
// L2: the sum, the centred sum of squares, then the normalised values,
// rounded to T once; the columns from n to ld are written 0.  out may be b
// (in place: each lane reads a vector before it writes it, after the
// statistics).  Any width: the bf16 pass of ffn_sm90.cuh above
// kRowHidden, and the split fp32 path's.
template <typename T>
__global__ void __launch_bounds__(256)
layer_norm_rows_kernel(const T* a, const T* b, const float* __restrict__ g,
                       const float* __restrict__ beta, float eps, T* out, int M, int n, int ld) {
  constexpr int V = 16 / int(sizeof(T));
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t off = size_t(row) * ld;
  // the V values of a + b at columns c .. c + V - 1, zero from n on
  auto load = [&](int c, float (&v)[V]) {
    const uint4 ua = *reinterpret_cast<const uint4*>(a + off + c);
    uint4 ub = make_uint4(0u, 0u, 0u, 0u);
    if (b) ub = *reinterpret_cast<const uint4*>(b + off + c);
    const T* ea = reinterpret_cast<const T*>(&ua);
    const T* eb = reinterpret_cast<const T*>(&ub);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = c + e < n ? to_f(ea[e]) + (b ? to_f(eb[e]) : 0.f) : 0.f;
  };
  float s = 0.f, v[V];
  for (int c = lane * V; c < n; c += 32 * V) {
    load(c, v);
#pragma unroll
    for (int e = 0; e < V; ++e) s += v[e];
  }
  const float mean = warp_sum(s) / n;
  float q = 0.f;
  for (int c = lane * V; c < n; c += 32 * V) {
    load(c, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = v[e] - mean;
      if (c + e < n) q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / n + eps);
  for (int c = lane * V; c < ld; c += 32 * V) {
    load(c, v);
    uint4 uo;
    T* eo = reinterpret_cast<T*>(&uo);
#pragma unroll
    for (int e = 0; e < V; ++e)
      eo[e] = from_f<T>(c + e < n ? (v[e] - mean) * rstd * g[c + e] + beta[c + e] : 0.f);
    *reinterpret_cast<uint4*>(out + off + c) = uo;
  }
}

template <typename T>
inline int launch_layer_norm_rows(const T* a, const T* b, const float* g, const float* beta,
                                  float eps, T* out, int M, int n, int ld, cudaStream_t stream) {
  layer_norm_rows_kernel<T><<<unsigned((M + 7) / 8), 256, 0, stream>>>(a, b, g, beta, eps, out,
                                                                      M, n, ld);
  return int(cudaGetLastError());
}

// the epilogues of gemm_f32_kernel
constexpr int kEpiBias = 0;      // C = acc + bias (bias may be null)
constexpr int kEpiGelu = 1;      // C = gelu(acc + bias)
constexpr int kEpiGeluGrad = 2;  // h = aux: C = acc * gelu'(h), aux = gelu(h)

constexpr int kGemmTile = 64;  // rows and columns of C a block
constexpr int kGemmK = 16;     // K of a shared-memory step

// C (M, N) = epilogue(A (M, K) . B (K, N)) in fp32, all row-major and
// dense (the padded layout's rows); a block of 256 threads owns a 64 x 64
// tile of C, each thread 4 x 4 of it in registers, and walks K in steps of
// 16 through shared memory (A stored k-major, so that a thread's 4 rows
// are one 16-byte read); plain FMAs, edges zero-filled.  The split fp32
// FFN's products: it exists to hold the model against the CPU.
template <int kEpi>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, float* __restrict__ C, float* aux, int M, int N,
                int K, int act) {
  __shared__ __align__(16) float as[kGemmK][kGemmTile + 4];
  __shared__ __align__(16) float bs[kGemmK][kGemmTile + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kGemmTile, n0 = blockIdx.x * kGemmTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kGemmK) {
    for (int i = threadIdx.x; i < kGemmTile * kGemmK; i += 256) {
      const int r = i / kGemmK, c = i % kGemmK;
      as[c][r] = m0 + r < M && k0 + c < K ? A[size_t(m0 + r) * K + k0 + c] : 0.f;
      const int kr = i / kGemmTile, kc = i % kGemmTile;
      bs[kr][kc] = k0 + kr < K && n0 + kc < N ? B[size_t(k0 + kr) * N + n0 + kc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
      const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a4[i] * b4[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tx + j;
      if (r >= M || c >= N) continue;
      const size_t at = size_t(r) * N + c;
      float val = acc[i][j];
      if constexpr (kEpi == kEpiGeluGrad) {
        float ga, da;
        gelu_and_grad(aux[at], act, ga, da);
        aux[at] = ga;
        val *= da;
      } else {
        if (bias) val += bias[c];
        if constexpr (kEpi == kEpiGelu) val = gelu(val, act);
      }
      C[at] = val;
    }
  }
}

template <int kEpi>
inline int launch_gemm_f32(const void* a, const void* b, const float* bias, void* c, float* aux,
                           int M, int N, int K, int act, cudaStream_t stream) {
  const dim3 grid((N + kGemmTile - 1) / kGemmTile, (M + kGemmTile - 1) / kGemmTile);
  if (grid.y > 65535) return int(cudaErrorInvalidValue);
  gemm_f32_kernel<kEpi><<<grid, 256, 0, stream>>>(static_cast<const float*>(a),
                                                   static_cast<const float*>(b), bias,
                                                   static_cast<float*>(c), aux, M, N, K, act);
  return int(cudaGetLastError());
}

// the split fp32 forward at the padded widths Hp > kRowHidden and Ip:
// kLN: x2 = LN1(x + a) into the scratch x2, h = gelu(x2 W1 + b1) into the
// scratch h, out = h W2 + b2, then out = LN2(x2 + out) in place; else h =
// gelu(x W1 + b1), out = h W2 + b2
template <bool kLN>
int launch_fwd_split(const float* x, const float* a, const float* w1, const float* b1,
                     const float* w2, const float* b2, const LnArgs& ln, float* x2, float* h,
                     float* out, int M, int Hp, int Ip, int act, cudaStream_t stream) {
  if (!h || (kLN && !x2)) return int(cudaErrorInvalidValue);
  int s = 0;
  if constexpr (kLN) {
    s = launch_layer_norm_rows<float>(x, a, ln.g1, ln.be1, ln.eps, x2, M, ln.n, Hp, stream);
    if (s != 0) return s;
    x = x2;
  }
  s = launch_gemm_f32<kEpiGelu>(x, w1, b1, h, nullptr, M, Ip, Hp, act, stream);
  if (s != 0) return s;
  s = launch_gemm_f32<kEpiBias>(h, w2, b2, out, nullptr, M, Hp, Ip, act, stream);
  if (s != 0 || !kLN) return s;
  return launch_layer_norm_rows<float>(x2, out, ln.g2, ln.be2, ln.eps, out, M, ln.n, Hp, stream);
}

// the fp32 forward at the true widths H and I (widths_ok), on arrays in the
// padded layout: the fused kernel up to a padded H of kRowHidden, the split
// path above it (x2 (M, Hp), for kLN, and h (M, Ip) are then the caller's
// fp32 scratch)
template <bool kLN>
int launch_fwd(const void* x, const void* a, const void* w1, const float* b1, const void* w2,
               const float* b2, LnArgs ln, void* x2, void* h, void* out, int M, int H, int I,
               int act, cudaStream_t stream) {
  if (M <= 0 || !widths_ok(H, I) || (act != 0 && act != 1)) return int(cudaErrorInvalidValue);
  const int Hp = padded_width(H, 0), Ip = padded_width(I, 0);
  ln.n = H;
  if (Hp > kRowHidden)
    return launch_fwd_split<kLN>(
        static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(w1),
        b1, static_cast<const float*>(w2), b2, ln, static_cast<float*>(x2),
        static_cast<float*>(h), static_cast<float*>(out), M, Hp, Ip, act, stream);
  return with_geometry(Hp, [&](auto geo) {
    using G = decltype(geo);
    const Layout L = make_layout<G>(Hp);
    const size_t smem = L.smem_bytes(1);
    cudaError_t e = cudaFuncSetAttribute(ffn_fwd_kernel<G, kLN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const dim3 grid((M + G::kBM - 1) / G::kBM);
    ffn_fwd_kernel<G, kLN><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(a),
        static_cast<const float*>(w1), b1, static_cast<const float*>(w2), b2, ln,
        static_cast<float*>(out), M, Hp, Ip, act, L);
    return int(cudaGetLastError());
  });
}

}  // namespace ffn
}  // namespace stonkgs
